"""Generate engine-level golden parity fixtures.

No gfortran exists in this image, so the fixtures are produced by a
transparent scalar-loop float64 mirror of the reference engine's algorithm,
written directly against the cited Fortran:

- FCC lattice, cell-major ix/iy/iz loop with the 4-atom basis in the
  reference's order (``md_initial_config_program.f90:132-187``)
- ran3 velocity draw with seed -12345, (vx, vy, vz) per particle
  (``md_initial_config_program.f90:196-209``; bit-exact stream from
  ``ljmd_tpu/utils/ran3.py``)
- COM removal (``:218-234``), rescale to target E
  (``:244-266``)
- LJ kernel: sequential i<j scalar loop, MIC via nint, cutoff, prefactors
  4/24 restored after the loop, mean-field tail corrections
  (``scripts/physics/lj_potential_energy.f90:109-223``)
- velocity-Verlet steps (``scripts/physics/verlet.f90:41-97``)

Everything is exact-order scalar float64 accumulation — the same arithmetic
the gfortran -O2 binary performs up to instruction-level reassociation, so
agreement far tighter than the 1e-6 north-star bound is expected from any
correct engine. Output JSON files are checked in; re-run this script only to
regenerate them (python tests/golden/generate_golden.py).
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from ljmd_tpu.utils.ran3 import reference_initial_velocities  # noqa: E402


def fcc(num_cells: int, L: float) -> np.ndarray:
    a = L / num_cells
    basis = [(0.0, 0.0, 0.0), (0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0)]
    out = []
    for ix in range(num_cells):
        for iy in range(num_cells):
            for iz in range(num_cells):
                for bx, by, bz in basis:
                    out.append(((ix + bx) * a, (iy + by) * a, (iz + bz) * a))
    return np.asarray(out, dtype=np.float64)


def lj_kernel(r: np.ndarray, L: float, rc: float, volume: float):
    """Scalar-loop mirror of compute_lj_potential_energy (f90:85-223)."""
    n = r.shape[0]
    rc2 = rc * rc
    inv_L = 1.0 / L
    epot = 0.0
    d_epot = 0.0
    dd_epot = 0.0
    acc = np.zeros((n, 3), dtype=np.float64)
    for i in range(n - 1):
        xi, yi, zi = r[i]
        for j in range(i + 1, n):
            dx = xi - r[j, 0]
            dy = yi - r[j, 1]
            dz = zi - r[j, 2]
            # dnint = round-half-away-from-zero; nearest-even differs only at
            # exact .5 which has measure zero for fluid configs
            dx -= L * np.round(dx * inv_L)
            dy -= L * np.round(dy * inv_L)
            dz -= L * np.round(dz * inv_L)
            r2 = dx * dx + dy * dy + dz * dz
            if r2 < rc2:
                inv_r2 = 1.0 / r2
                inv_r6 = inv_r2 * inv_r2 * inv_r2
                inv_r12 = inv_r6 * inv_r6
                epot += inv_r12 - inv_r6
                du = -2.0 * inv_r12 + inv_r6
                fx = -du * dx * inv_r2
                fy = -du * dy * inv_r2
                fz = -du * dz * inv_r2
                acc[i, 0] += fx
                acc[i, 1] += fy
                acc[i, 2] += fz
                acc[j, 0] -= fx
                acc[j, 1] -= fy
                acc[j, 2] -= fz
                d_epot += du
                dd_epot += 26.0 * inv_r12 - 7.0 * inv_r6
    epot *= 4.0
    acc *= 24.0
    d_epot *= 24.0
    dd_epot *= 24.0
    # tail corrections (f90:205-223)
    tail = 8.0 * math.pi * n * n / (volume * rc**3)
    epot += tail * ((1.0 / (3.0 * rc**6)) - 1.0) / 3.0
    d_epot += 2.0 * tail * (-2.0 / (3.0 * rc**6) + 1.0)
    dd_epot += 2.0 * tail * (26.0 / (3.0 * rc**6) - 7.0)
    return epot, d_epot, dd_epot, acc


def wrap(r: np.ndarray, L: float) -> np.ndarray:
    return r - L * np.floor(r / L)


def verlet_step(r, v, a, dt, L, rc, volume):
    """verlet.f90:41-97 in functional form."""
    r = wrap(r + v * dt + a * (0.5 * dt * dt), L)
    v = v + a * (0.5 * dt)
    epot, d_epot, dd_epot, a = lj_kernel(r, L, rc, volume)
    v = v + a * (0.5 * dt)
    ekin = 0.5 * float(np.sum(v * v))
    return r, v, a, epot, ekin, d_epot, dd_epot


def make_case(num_cells: int, L: float, rc_over_L: float, e_target: float,
              n_verlet: int, dt: float) -> dict:
    n = 4 * num_cells**3
    rc = rc_over_L * L
    volume = L**3
    r = fcc(num_cells, L)
    v = reference_initial_velocities(n, seed=-12345)
    v -= v.mean(axis=0, keepdims=True)

    epot0, d0, dd0, acc0 = lj_kernel(r, L, rc, volume)
    ekin_old = 0.5 * float(np.sum(v * v))
    ekin_new = e_target - epot0
    assert ekin_new > 0, "target energy too low for this lattice"
    v *= math.sqrt(ekin_new / ekin_old)

    rr, vv, aa = r.copy(), v.copy(), acc0.copy()
    traj = []
    for _ in range(n_verlet):
        rr, vv, aa, e, k, d, dd = verlet_step(rr, vv, aa, dt, L, rc, volume)
        traj.append({"epot": e, "ekin": k, "d_epot": d, "dd_epot": dd})

    return {
        "num_cells": num_cells,
        "box_length": L,
        "rc_over_box": rc_over_L,
        "target_total_energy": e_target,
        "dt": dt,
        "n": n,
        "lattice": {
            "epot": epot0,
            "d_epot": d0,
            "dd_epot": dd0,
            "force_abs_sum": float(np.sum(np.abs(acc0))),
            "forces_first3": acc0[:3].tolist(),
            "ekin_after_rescale": ekin_new,
            "v_first3": v[:3].tolist(),
            "v_abs_sum": float(np.sum(np.abs(v))),
        },
        "verlet": traj,
        "final_r_first3": rr[:3].tolist(),
        "final_r_abs_sum": float(np.sum(np.abs(rr))),
    }


# ----------------------------------------------------------------------
# Driver-level mirror: the full production-driver
# pipeline — sampling cadence, 11-observable streaming means/stds, centered
# ACF + normalization, block-averaged ACF, thermodynamic coefficients — in
# exact-order scalar/NumPy float64, written against the cited Fortran:
#   sampling (step > warmup) and (step % interval == 0)
#       md_simulation_program.f90:361
#   T = 2K/(3N), P = rho T + W/(3V), W = -d_epot
#       md_means.f90:221,227; md_simulation_program.f90:365-366
#   means/stds from Sum(x), Sum(x^2), std = sqrt(max(0, <x2>-<x>^2))
#       md_means.f90:192-366; stats_math.f90:56-61
#   centered ACF C(L) = (1/(n-L)) sum (A(k)-mu)(A(k+L)-mu)
#       stats_math.f90:127-149; normalize C/C(0) :168-190
#   block corr means: n_blocks equal blocks (remainder dropped), per-block
#   ACF averaged, both <C> and <C/C(0)>   md_correlations.f90:668-803
#   coefficient algebra (canonical module, f = 3N-3)
#       thermodynamic_coefs.f90:87-205
# ----------------------------------------------------------------------
def _acf_centered(a: np.ndarray, max_lag: int) -> np.ndarray:
    n = len(a)
    mu = a.mean()
    c = np.empty(max_lag + 1, dtype=np.float64)
    for lag in range(max_lag + 1):
        s = 0.0
        for k in range(n - lag):
            s += (a[k] - mu) * (a[k + lag] - mu)
        c[lag] = s / (n - lag)
    return c


def _norm_corr(c: np.ndarray) -> np.ndarray:
    return np.zeros_like(c) if abs(c[0]) < 1e-300 else c / c[0]


def _thermo(n, volume, ek, press, ekinv, du, ddu, du_kinv, du2_kinv) -> dict:
    f = 3.0 * n - 3.0
    aux1 = 1.0 - 2.0 / f
    aux2 = f / 2.0 - 1.0
    T = 2.0 * ek / f
    ca_v = 1.0 / (1.0 - aux1 * ek * ekinv)
    ce_v = ca_v / n
    gamma = 1.0 / ce_v + (aux2 / 3.0) * (du * ekinv - du_kinv)
    k_s_aux = (n * T * (1.0 + 2.0 * gamma - 1.0 / ce_v)) / volume + (
        ddu - 2.0 * du
    ) / (9.0 * volume)
    fluct = du2_kinv - 2.0 * du * du_kinv + du * du * ekinv
    k_s = k_s_aux - aux2 * fluct / (9.0 * volume * volume)
    k_t = k_s - (T * ca_v * gamma * gamma) / volume
    return {
        "temperature": T,
        "pressure": press,
        "Ca_v": ca_v,
        "Ce_v": ce_v,
        "Ca_p": ca_v * (k_s / k_t),
        "Ce_p": ca_v * (k_s / k_t) / n,
        "gamma": gamma,
        "K_S": k_s,
        "K_S_inv": 1.0 / k_s,
        "K_T": k_t,
        "K_T_inv": 1.0 / k_t,
        "alpha_E1": 1.0 / (press * volume / ca_v - gamma * T),
        "alpha_E2": 1.0 / ((1.0 / 3.0) * (aux1 * ek * du_kinv - du)),
        "alpha_S": -1.0 / (gamma * T),
        "alpha_P": (ca_v * gamma) / volume * (1.0 / k_t),
    }


def make_driver_case(num_cells, L, rc_over_L, e_target, dt,
                     total_steps, warmup_steps, interval,
                     max_lag, n_blocks_cap) -> dict:
    n = 4 * num_cells**3
    rc = rc_over_L * L
    volume = L**3
    rho = n / volume
    r = fcc(num_cells, L)
    v = reference_initial_velocities(n, seed=-12345)
    v -= v.mean(axis=0, keepdims=True)

    epot0, d0, dd0, acc0 = lj_kernel(r, L, rc, volume)
    ekin_old = 0.5 * float(np.sum(v * v))
    ekin_new = e_target - epot0
    assert ekin_new > 0
    v *= math.sqrt(ekin_new / ekin_old)

    rr, vv, aa = r.copy(), v.copy(), acc0.copy()
    obs_names = ["epot", "ekin", "etot", "temp", "press", "ekin_inv",
                 "d_epot", "dd_epot", "d_epot_ekin_inv",
                 "d_epot2_ekin_inv", "dd_epot_ekin_inv"]
    sums = np.zeros(11)
    sums2 = np.zeros(11)
    count = 0
    series = {k: [] for k in ("epot", "ekin", "etot", "temp", "press")}
    for step in range(1, total_steps + 1):
        rr, vv, aa, e, kin, du, ddu = verlet_step(rr, vv, aa, dt, L, rc, volume)
        if step > warmup_steps and step % interval == 0:
            temp = 2.0 * kin / (3.0 * n)          # md_means.f90:221 (3N!)
            w = -du                               # :365-366
            press = rho * temp + w / (3.0 * volume)
            kinv = 1.0 / kin
            x = np.array([e, kin, e + kin, temp, press, kinv, du, ddu,
                          du * kinv, du * du * kinv, ddu * kinv])
            sums += x
            sums2 += x * x
            count += 1
            for key, val in zip(series, (e, kin, e + kin, temp, press)):
                series[key].append(val)

    means = sums / count
    stds = np.sqrt(np.maximum(sums2 / count - means * means, 0.0))

    corr = {}
    corr_norm = {}
    corr_mean = {}
    corr_mean_norm = {}
    n_blocks = min(n_blocks_cap, count // (max_lag + 1))
    block_len = count // n_blocks
    for key, vals in series.items():
        a = np.asarray(vals)
        c = _acf_centered(a, max_lag)
        corr[key] = c.tolist()
        corr_norm[key] = _norm_corr(c).tolist()
        cb = np.zeros(max_lag + 1)
        cnb = np.zeros(max_lag + 1)
        for b in range(n_blocks):
            blk = a[b * block_len:(b + 1) * block_len]
            cblk = _acf_centered(blk, max_lag)
            cb += cblk
            cnb += _norm_corr(cblk)
        corr_mean[key] = (cb / n_blocks).tolist()
        corr_mean_norm[key] = (cnb / n_blocks).tolist()

    m = dict(zip(obs_names, means))
    thermo = _thermo(n, volume, m["ekin"], m["press"], m["ekin_inv"],
                     m["d_epot"], m["dd_epot"], m["d_epot_ekin_inv"],
                     m["d_epot2_ekin_inv"])

    return {
        "num_cells": num_cells,
        "box_length": L,
        "rc_over_box": rc_over_L,
        "target_total_energy": e_target,
        "dt": dt,
        "total_steps": total_steps,
        "warmup_steps": warmup_steps,
        "output_interval": interval,
        "corr_max_lag": max_lag,
        "corr_n_blocks": n_blocks,
        "n": n,
        "n_samples": count,
        "ekin_after_rescale": ekin_new,
        "observables": obs_names,
        "means": means.tolist(),
        "stds": stds.tolist(),
        "series": {k: list(map(float, v)) for k, v in series.items()},
        "corr": corr,
        "corr_norm": corr_norm,
        "corr_mean": corr_mean,
        "corr_mean_norm": corr_mean_norm,
        "thermo": thermo,
    }


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    driver = make_driver_case(
        num_cells=2, L=4.2, rc_over_L=0.45, e_target=-60.0, dt=0.002,
        total_steps=300, warmup_steps=10, interval=2,
        max_lag=20, n_blocks_cap=5,
    )
    path = os.path.join(here, "golden_driver_k2.json")
    with open(path, "w") as f:
        json.dump(driver, f, indent=1)
    print("wrote", path, "n_samples=", driver["n_samples"],
          "mean_etot=", driver["means"][2])
    cases = [
        # (num_cells, L, rc/L, E_target, n_verlet, dt)
        (2, 4.2, 0.45, -60.0, 5, 0.002),   # N=32, dense liquid-ish box
        (3, 6.0, 0.40, -280.0, 5, 0.002),   # N=108
    ]
    for num_cells, L, rcl, et, nv, dt in cases:
        case = make_case(num_cells, L, rcl, et, nv, dt)
        path = os.path.join(here, f"golden_k{num_cells}.json")
        with open(path, "w") as f:
            json.dump(case, f, indent=1)
        print("wrote", path, "epot_lattice=", case["lattice"]["epot"])


if __name__ == "__main__":
    main()
