"""Engine-level golden parity: our engines must
reproduce checked-in fixtures generated by a scalar-loop float64 mirror of
the reference engine (tests/golden/generate_golden.py — exact-order
arithmetic against ``lj_potential_energy.f90:109-223`` + ``verlet.f90:41-97``
with the reference's ran3 velocity stream), far inside the 1e-6 north-star
bound."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ljmd_tpu.config import SimConfig
from ljmd_tpu.models.engine import make_engine
from ljmd_tpu.models.lattice import fcc_lattice, remove_com_velocity
from ljmd_tpu.state import MDState
from ljmd_tpu.utils.ran3 import reference_initial_velocities

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _load(k):
    with open(os.path.join(GOLDEN_DIR, f"golden_k{k}.json")) as f:
        return json.load(f)


def _cfg(g) -> SimConfig:
    return SimConfig(
        num_cells=g["num_cells"],
        box_length=g["box_length"],
        rc_over_box=g["rc_over_box"],
        dt=g["dt"],
        total_steps=10,
        output_interval=1,
        warmup_steps=0,
        target_total_energy=g["target_total_energy"],
        dtype="float64",
    )


def _engine(cfg, backend):
    # The neighbor list needs rc + skin < L/2; the golden boxes leave ~0.2.
    if backend == "neighbor":
        cfg = cfg.replace(neighbor_skin=0.1)
    return make_engine(cfg, backend)


def _init_state(cfg, g) -> MDState:
    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=jnp.float64)
    v = remove_com_velocity(jnp.asarray(reference_initial_velocities(cfg.n)))
    scale = np.sqrt(g["lattice"]["ekin_after_rescale"] / (0.5 * float(jnp.sum(v * v))))
    v = v * scale
    return MDState(r=r, ru=r, v=v, a=jnp.zeros_like(r))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("backend", ["dense", "neighbor"])
def test_lattice_energies_forces_match_golden(k, backend):
    g = _load(k)
    cfg = _cfg(g)
    eng = _engine(cfg, backend)
    state = _init_state(cfg, g)
    carry, obs = eng.init(state)
    gl = g["lattice"]
    assert abs(float(obs.epot) - gl["epot"]) < 1e-9 * abs(gl["epot"])
    assert abs(float(obs.d_epot) - gl["d_epot"]) < 1e-9 * max(1.0, abs(gl["d_epot"]))
    assert abs(float(obs.dd_epot) - gl["dd_epot"]) < 1e-9 * abs(gl["dd_epot"])
    a = np.asarray(eng.get_state(carry).a)
    np.testing.assert_allclose(
        a[:3], np.asarray(gl["forces_first3"]), rtol=1e-9, atol=1e-9
    )
    # On a perfect FCC lattice forces vanish by symmetry, so the abs-sum is
    # pure rounding noise — compare absolutely (discriminating force parity
    # comes from the verlet-trajectory test below).
    assert abs(float(np.sum(np.abs(a))) - gl["force_abs_sum"]) < 1e-8


@pytest.mark.parametrize("k", [2, 3])
def test_initialize_ran3_matches_golden_end_to_end(k):
    """Full init-pipeline parity through the PUBLIC API:
    initialize(velocity_init="ran3") must reproduce the golden
    lattice + ran3-velocity + COM-removal + rescale state in one call
    (md_initial_config_program.f90:58-121 with seed -12345)."""
    from ljmd_tpu.models.simulation import initialize

    g = _load(k)
    cfg = _cfg(g).replace(seed=-12345, warmup_steps=0)
    state = initialize(cfg, backend="dense", velocity_init="ran3")
    gl = g["lattice"]
    # positions: the FCC lattice itself (no warmup steps taken)
    r = np.asarray(state.r)
    np.testing.assert_allclose(
        r, np.asarray(fcc_lattice(cfg.num_cells, cfg.box_length,
                                  dtype=jnp.float64)), rtol=0, atol=0
    )
    # velocities: the exact rescaled ran3 stream
    v = np.asarray(state.v)
    np.testing.assert_allclose(
        v[:3], np.asarray(gl["v_first3"]), rtol=1e-12, atol=1e-12
    )
    assert abs(float(np.sum(np.abs(v))) - gl["v_abs_sum"]) < 1e-9
    assert abs(0.5 * float(np.sum(v * v)) - gl["ekin_after_rescale"]) < 1e-9


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("backend", ["dense", "neighbor"])
def test_verlet_trajectory_matches_golden(k, backend):
    g = _load(k)
    cfg = _cfg(g)
    eng = _engine(cfg, backend)
    state = _init_state(cfg, g)
    carry, _ = eng.init(state)

    for step_golden in g["verlet"]:
        carry, obs = jax.jit(eng.step)(carry)
        for key in ("epot", "ekin", "d_epot", "dd_epot"):
            got = float(getattr(obs, key))
            want = step_golden[key]
            assert abs(got - want) < 1e-9 * max(1.0, abs(want)), (key, got, want)

    final = eng.get_state(carry)
    r = np.asarray(final.r)
    np.testing.assert_allclose(
        r[:3], np.asarray(g["final_r_first3"]), rtol=1e-9, atol=1e-9
    )
    assert abs(float(np.sum(np.abs(r))) - g["final_r_abs_sum"]) < 1e-8 * g["final_r_abs_sum"]


def test_production_driver_matches_golden_mirror():
    """Driver-level golden parity: run_production
    end-to-end — sampling cadence, 11-observable streaming means/stds,
    centered ACF + normalization, block-averaged ACF, and thermodynamic
    coefficients — against the scalar-f64 mirror of the reference driver
    (tests/golden/generate_golden.py::make_driver_case, written against
    md_simulation_program.f90:300-560 + md_means.f90 + md_correlations.f90 +
    thermodynamic_coefs.f90). Covers L3+L4+L5 JOINTLY (the stats stack was
    previously only NumPy-oracle tested in isolation)."""
    from ljmd_tpu.models.simulation import SERIES_OBSERVABLES, run_production
    from ljmd_tpu.stats.moments import OBSERVABLES

    with open(os.path.join(GOLDEN_DIR, "golden_driver_k2.json")) as f:
        g = json.load(f)

    cfg = SimConfig(
        num_cells=g["num_cells"],
        box_length=g["box_length"],
        rc_over_box=g["rc_over_box"],
        dt=g["dt"],
        total_steps=g["total_steps"],
        output_interval=g["output_interval"],
        warmup_steps=g["warmup_steps"],
        target_total_energy=g["target_total_energy"],
        dtype="float64",
        corr_max_lag_cap=g["corr_max_lag"],
        corr_max_blocks=g["corr_n_blocks"],
    )
    assert cfg.corr_max_lag == g["corr_max_lag"]
    state = _init_state(cfg, {"lattice": {"ekin_after_rescale":
                                          g["ekin_after_rescale"]}})
    out = run_production(cfg, state, backend="dense")

    # sampled series (cadence + per-sample T/P)
    series = np.asarray(out.series)
    assert series.shape == (5, g["n_samples"])
    for i, key in enumerate(SERIES_OBSERVABLES):
        np.testing.assert_allclose(
            series[i], np.asarray(g["series"][key]), rtol=1e-9, atol=1e-11,
            err_msg=f"series {key}",
        )

    # 11 means + stds (order = OBSERVABLES = the mirror's obs_names)
    assert list(OBSERVABLES) == g["observables"]
    np.testing.assert_allclose(
        np.asarray(out.means.means), np.asarray(g["means"]),
        rtol=1e-9, atol=1e-12, err_msg="means",
    )
    np.testing.assert_allclose(
        np.asarray(out.means.stds), np.asarray(g["stds"]),
        rtol=1e-7, atol=1e-9, err_msg="stds",
    )

    # full-series centered ACF + normalization, block-averaged ACF
    for i, key in enumerate(SERIES_OBSERVABLES):
        np.testing.assert_allclose(
            np.asarray(out.corr[i]), np.asarray(g["corr"][key]),
            rtol=1e-8, atol=1e-11, err_msg=f"corr {key}",
        )
        np.testing.assert_allclose(
            np.asarray(out.corr_norm[i]), np.asarray(g["corr_norm"][key]),
            rtol=1e-8, atol=1e-9, err_msg=f"corr_norm {key}",
        )
        np.testing.assert_allclose(
            np.asarray(out.corr_mean[i]), np.asarray(g["corr_mean"][key]),
            rtol=1e-8, atol=1e-11, err_msg=f"corr_mean {key}",
        )
        np.testing.assert_allclose(
            np.asarray(out.corr_mean_norm[i]),
            np.asarray(g["corr_mean_norm"][key]),
            rtol=1e-8, atol=1e-9, err_msg=f"corr_mean_norm {key}",
        )

    # thermodynamic coefficients (canonical algebra, f = 3N-3)
    thermo = out.thermo(cfg)
    for key, want in g["thermo"].items():
        got = float(getattr(thermo, key))
        assert got == pytest.approx(want, rel=1e-8), (key, got, want)
