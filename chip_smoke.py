"""On-card smoke run of the MD production path.

    python chip_smoke.py                # one GPU: the phases below
    python chip_smoke.py --crossover    # one GPU: neighbor vs pencil timing only
    python chip_smoke.py --four-cards   # four GPUs: the sharded paths only

Phases on one card, in one process, each through the entry points a user
calls (the CLI, ``initialize``/``run_production``, ``ensemble_simulate``):

- ``flagship``: ``examples/n4000_production.json`` (N=4000, f32) through
  ``simulate`` then ``analyze --no-plots``, then as one compiled
  ``run_production`` program, and the neighbor engine's forces against the
  float64 dense oracle (``ops/lj.py``) on the host CPU device.
- ``reference_default``: ``examples/reference_default.json`` (N=500,
  dt=1e-4, compensated f32) over 20k production steps; the energy-drift
  endpoint is held to the compensated bound.
- ``large``: ``examples/n62500_large.json`` (N=62500) through the pencil
  engine for a few hundred steps; forces and energies against a row-blocked
  ``lj_rect_partials`` sweep on the card.
- ``ensemble64``: ``examples/ensemble64.json``, 64 replicas vmapped on the
  card.
- ``autocorr``: the f32 autocorrelation on the card against float64 numpy.

Only the step counts are cut; every width (N, density, cutoff, dtype) is the
config's own. Each phase prints its wall and compile time, the compiled
program's ``memory_analysis()``, the device's ``peak_bytes_in_use`` and its
checks with their tolerances. Any failure makes the script fail. The last
line of stdout is ``{"ok": true, "device": {...}}``, printed only when every
phase passed; with no GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "examples")
OUT = os.path.join(HERE, "chiprun_out", "chip_smoke")

# Parity tolerances (printed beside each check). A dropped pair is an O(1)
# error in the forces of both partners and ~1/N_pairs in the energy.
EPOT_RTOL = 1e-5     # f32 sums of ~1e5-1e7 pair terms in another order
VIRIAL_RTOL = 1e-4   # d_epot/dd_epot: repulsive and attractive terms cancel
                     # to ~1/10 of their magnitude, so f32 rounding is ~10x
FORCE_RTOL = 1e-4    # max |da| over rms(a): f32 pair-force rounding
DRIFT_BOUND = 5e-4   # compensated f32 at dt=1e-4 over 20k steps
ACF_RTOL = 1e-5      # f32 dot of <=100 products; a TF32 dot errs ~5e-4/term


def log(*args) -> None:
    print(*args, flush=True)


def check(name: str, value: float, bound: float, why: str) -> None:
    ok = value <= bound
    log(f"  check {name}: {value:.3e} <= {bound:.1e} ({why}) -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} = {value:.3e} exceeds {bound:.1e}")


def compile_program(name: str, fn, *args):
    """AOT-compile ``jax.jit(fn)`` for ``args``; print compile time and the
    compiled program's memory analysis."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    mem = {k: getattr(ma, k, None) for k in (
        "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
        "alias_size_in_bytes", "generated_code_size_in_bytes")}
    log(f"  [{name}] compile_s={compile_s:.3f} memory_analysis={json.dumps(mem)}")
    return compiled


def run_program(name: str, compiled, *args, steps: int | None = None):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    wall = time.perf_counter() - t0
    per = f" per_step_us={wall / steps * 1e6:.3f}" if steps else ""
    log(f"  [{name}] wall_s={wall:.3f}{per}")
    return out


def peak_bytes(device) -> None:
    stats = device.memory_stats() or {}
    log(f"  peak_bytes_in_use={stats.get('peak_bytes_in_use')}")


def _example(name: str, **cut):
    from ljmd_tpu.config import load_config

    return load_config(os.path.join(EXAMPLES, name), **cut)


def _production(name: str, cfg, key_seed: int | None = None, backend: str = "auto"):
    """Compile + run initialize, then compile + run run_production on the
    post-warmup state (engine built from the concrete state, as the CLI's
    eager driver does). Returns (state, SimResult, engine name)."""
    import jax

    from ljmd_tpu.models.engine import auto_backend, make_engine
    from ljmd_tpu.models.simulation import initialize, run_production

    key = jax.random.PRNGKey(cfg.seed if key_seed is None else key_seed)
    init = compile_program(f"{name}/initialize", lambda k: initialize(cfg, k, backend=backend), key)
    state = run_program(f"{name}/initialize", init, key, steps=max(cfg.warmup_steps, 1))
    engine = make_engine(cfg, backend, state=state)
    prod = compile_program(
        f"{name}/run_production", lambda s: run_production(cfg, s, engine=engine), state
    )
    out = run_program(f"{name}/run_production", prod, state, steps=cfg.total_steps)
    chosen = auto_backend(cfg) if backend == "auto" else backend
    log(f"  [{name}] N={cfg.n} engine={chosen} samples={out.series.shape[1]}")
    return state, out, chosen


def _check_healthy(name: str, out) -> None:
    import numpy as np

    if not np.all(np.isfinite(np.asarray(out.series))):
        raise AssertionError(f"{name}: non-finite sampled series")
    for k, v in out.diagnostics.items():
        if bool(np.asarray(v)):
            raise AssertionError(f"{name}: diagnostic {k} is set")
    log(f"  [{name}] series finite, diagnostics clear: {sorted(out.diagnostics)}")


def _drift(out) -> tuple[float, float]:
    """(endpoint, window) relative drift of the sampled total energy: last
    sample vs first, and the mean of the last 10% of samples vs the first
    10% (the windowed form averages out the sharp cutoff's crossing noise)."""
    import numpy as np

    etot = np.asarray(out.series, dtype=np.float64)[2]
    w = max(1, len(etot) // 10)
    endpoint = abs(etot[-1] - etot[0]) / abs(etot[0])
    window = abs(etot[-w:].mean() - etot[:w].mean()) / abs(etot[:w].mean())
    return float(endpoint), float(window)


def _force_parity(name: str, a, obs, a_ref, ref_obs) -> None:
    import numpy as np

    a = np.asarray(a, np.float64)
    a_ref = np.asarray(a_ref, np.float64)
    rms = float(np.sqrt(np.mean(a_ref * a_ref)))
    check(f"{name} max|da|/rms(a)", float(np.max(np.abs(a - a_ref))) / rms, FORCE_RTOL,
          "f32 pair-force rounding; a missing pair is O(1)")
    for f, tol, why in (
        ("epot", EPOT_RTOL, "f32 sums in another order"),
        ("d_epot", VIRIAL_RTOL, "f32 sums of cancelling terms"),
        ("dd_epot", VIRIAL_RTOL, "f32 sums of cancelling terms"),
    ):
        got, want = float(getattr(obs, f)), float(getattr(ref_obs, f))
        check(f"{name} rel_err({f})", abs(got - want) / abs(want), tol, why)


def _lattice_state(cfg, jitter: float = 0.0):
    """FCC lattice (optionally jittered) with velocities scaled to T*=0.728,
    in f32: a start state that needs no warmup program."""
    import jax
    import jax.numpy as jnp

    from ljmd_tpu.models.lattice import fcc_lattice, random_velocities, remove_com_velocity
    from ljmd_tpu.ops.geometry import wrap_positions
    from ljmd_tpu.state import MDState

    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=jnp.float32)
    if jitter:
        r = wrap_positions(r + jitter * jax.random.normal(jax.random.PRNGKey(2), r.shape, r.dtype),
                           cfg.box_length)
    v = remove_com_velocity(random_velocities(jax.random.PRNGKey(1), cfg.n, jnp.float32))
    v = v * jnp.sqrt(0.728 / (jnp.sum(v * v) / (3 * cfg.n)))
    return MDState(r=r, ru=r, v=v, a=jnp.zeros_like(r))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------
def phase_flagship(cfg, device) -> "object":
    """CLI simulate + analyze, the compiled production program, and the
    neighbor engine against the float64 dense oracle on the host CPU."""
    import jax
    import numpy as np

    from ljmd_tpu import cli
    from ljmd_tpu.models.engine import make_engine
    from ljmd_tpu.ops.lj import lj_force_energy_dense

    run_dir = os.path.join(OUT, "flagship_run")
    os.makedirs(OUT, exist_ok=True)
    cfg_path = os.path.join(OUT, "flagship_config.json")
    with open(cfg_path, "w") as f:
        json.dump({k: getattr(cfg, k) for k in (
            "num_cells", "box_length", "rc_over_box", "dt", "total_steps",
            "output_interval", "warmup_steps", "target_total_energy", "dtype",
            "seed")}, f)
    t0 = time.perf_counter()
    if cli.main(["simulate", "--config", cfg_path, "--out-dir", run_dir]) != 0:
        raise AssertionError("simulate failed")
    t1 = time.perf_counter()
    if cli.main(["analyze", "--run-dir", run_dir, "--no-plots"]) != 0:
        raise AssertionError("analyze failed")
    t2 = time.perf_counter()
    with open(os.path.join(run_dir, "analysis_summary.json")) as f:
        summary = json.load(f)
    if not np.isfinite(summary["trajectory"]["D_einstein"]):
        raise AssertionError("analyze: non-finite diffusion coefficient")
    log(f"  [flagship/cli] simulate_wall_s={t1 - t0:.3f} analyze_wall_s={t2 - t1:.3f} "
        f"D_einstein={summary['trajectory']['D_einstein']:.6g}")

    state, out, engine_name = _production("flagship", cfg)
    _check_healthy("flagship", out)
    endpoint, window = _drift(out)
    log(f"  [flagship] etot drift endpoint={endpoint:.3e} window={window:.3e} "
        f"over {cfg.total_steps - cfg.warmup_steps} steps")
    peak_bytes(device)

    # parity: the production engine's forces on the final state (f32, card)
    # against the float64 dense oracle on the host CPU device
    final = out.final_state
    eng = make_engine(cfg, engine_name)
    carry, obs = jax.jit(eng.init)(final)
    a = eng.get_state(carry).a
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True):
        r64 = jax.device_put(np.asarray(final.r, np.float64), cpu)
        ref = jax.jit(lambda r: lj_force_energy_dense(
            r, cfg.box_length, cfg.rc_square, cfg.use_tail_corrections,
            cfg.volume, cfg.rc))(r64)
        ref = jax.device_get(ref)
    _force_parity(f"flagship {engine_name} vs f64 dense (cpu)", a, obs, ref.a, ref)
    return out


def phase_reference_default(cfg, device) -> None:
    from ljmd_tpu.models.engine import _compensated, _effective_dtype

    log(f"  [reference_default] effective dtype={_effective_dtype(cfg)} "
        f"compensated={_compensated(cfg)}")
    if not _compensated(cfg):
        raise AssertionError("reference default must integrate compensated")
    _, out, _ = _production("reference_default", cfg)
    _check_healthy("reference_default", out)
    endpoint, window = _drift(out)
    steps = cfg.total_steps - cfg.warmup_steps
    log(f"  [reference_default] etot drift over {steps} steps: endpoint={endpoint:.3e} "
        f"window={window:.3e}")
    for kind, value in (("endpoint", endpoint), ("windowed", window)):
        check(f"reference_default {kind} drift", value, DRIFT_BOUND,
              "compensated f32 at dt=1e-4 over 20k steps")
    peak_bytes(device)


def phase_large(cfg, device, block: int = 2500) -> None:
    import jax
    import jax.numpy as jnp

    from ljmd_tpu.models.engine import make_engine
    from ljmd_tpu.ops.lj import tail_corrections
    from ljmd_tpu.parallel.spatial import lj_rect_partials

    _, out, engine_name = _production("large", cfg)
    _check_healthy("large", out)
    peak_bytes(device)

    final = out.final_state
    eng = make_engine(cfg, engine_name, state=final)
    carry, obs = jax.jit(eng.init)(final)
    a = eng.get_state(carry).a
    n = cfg.n
    if n % block:
        raise ValueError(f"block {block} must divide N={n}")

    @jax.jit
    def row_blocked(r):
        def one(start):
            blk = jax.lax.dynamic_slice_in_dim(r, start, block)
            return lj_rect_partials(blk, r, start, cfg.box_length, cfg.rc_square)

        a_b, e, du, ddu = jax.lax.map(one, jnp.arange(0, n, block))
        return 24.0 * a_b.reshape(n, 3), 2.0 * e.sum(), 12.0 * du.sum(), 12.0 * ddu.sum()

    t0 = time.perf_counter()
    a_ref, e, du, ddu = jax.block_until_ready(row_blocked(final.r))
    log(f"  [large/reference] row-blocked sweep over all {n} particles wall_s="
        f"{time.perf_counter() - t0:.3f}")
    e_t, d_t, dd_t = tail_corrections(n, cfg.volume, cfg.rc)
    ref = SimpleNamespace(epot=float(e) + e_t, d_epot=float(du) + d_t,
                          dd_epot=float(ddu) + dd_t)
    _force_parity(f"large {engine_name} vs row-blocked lj_rect_partials (card)",
                  a, obs, a_ref, ref)


def phase_ensemble(cfg, device, n_replicas: int = 64):
    import jax
    import numpy as np

    from ljmd_tpu.parallel.ensemble import ensemble_simulate

    key = jax.random.PRNGKey(cfg.seed)
    prog = compile_program(
        "ensemble64", lambda k: ensemble_simulate(cfg, n_replicas, key=k, jit=False), key
    )
    agg = run_program("ensemble64", prog, key, steps=cfg.total_steps)
    n_ok = int(np.asarray(agg.n_ok))
    log(f"  [ensemble64] replicas={n_replicas} N={cfg.n} ok={n_ok} "
        f"<etot>={float(agg.mean_of_means[2]):.6g}")
    if n_ok != n_replicas or agg.replica_means.shape[0] != n_replicas:
        raise AssertionError("ensemble: not every replica finished finite")
    peak_bytes(device)
    return agg


def phase_autocorr(series) -> None:
    """The card's f32 autocorrelation (a vmapped dot per lag) against
    float64 numpy on the same f32 input."""
    import numpy as np

    from ljmd_tpu.stats.correlations import autocorr

    etot = np.asarray(series, np.float64)[2]
    x = (etot - etot.mean()).astype(np.float32)  # centred f32 input
    max_lag = len(x) // 2
    got = np.asarray(autocorr(x, max_lag, centered=False), np.float64)
    x64 = x.astype(np.float64)
    want = np.array([x64[: len(x) - L] @ x64[L:] / (len(x) - L) for L in range(max_lag + 1)])
    check("autocorr max|dC|/C(0)", float(np.max(np.abs(got - want)) / want[0]), ACF_RTOL,
          "f32 dot at HIGHEST precision")


def phase_crossover(device, sizes=(10, 12, 14, 16, 20), steps: int = 200) -> None:
    """Neighbor vs pencil engine per-step time at N=4k^3 (k in sizes), plus
    the neighbor build's memory analysis."""
    import jax

    from ljmd_tpu.config import config_from_density
    from ljmd_tpu.models.engine import make_engine
    from ljmd_tpu.ops.neighbor import build_neighbor_list_dense, estimate_capacity

    for k in sizes:
        cfg = config_from_density(num_cells=k, density=0.8442, dt=0.005, dtype="float32")
        state = _lattice_state(cfg)
        r = state.r
        r_list = cfg.rc + cfg.neighbor_skin
        cap = estimate_capacity(cfg.density, r_list)
        compile_program(f"crossover N={cfg.n}/neighbor_build",
                        lambda x: build_neighbor_list_dense(x, cfg.box_length, r_list**2, cap), r)
        for backend in ("neighbor", "cellpair"):
            # the pencil engine sizes its capacity from the state the
            # neighbor run melted, as production does
            eng = make_engine(cfg, backend, state=state if backend == "cellpair" else None)
            carry, _ = jax.jit(eng.init)(state)

            def loop(c, eng=eng):
                if eng.run_fast is not None:
                    return eng.run_fast(c, steps)
                return jax.lax.scan(lambda cc, _: (eng.step_fast(cc)[0], None),
                                    c, None, length=steps)[0]

            name = f"crossover N={cfg.n}/{backend}"
            prog = compile_program(name, loop, carry)
            carry = run_program(name + " (warm)", prog, carry, steps=steps)
            carry = run_program(name, prog, carry, steps=steps)
            state = eng.get_state(carry)
            del carry, prog
        peak_bytes(device)


def four_cards(devices, cfg_ens, cfg_ring, cfg_pencil, n_replicas: int = 64) -> None:
    """The sharded paths on four cards, each against its one-card run."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from ljmd_tpu.models.engine import make_engine
    from ljmd_tpu.models.simulation import initialize, run_production
    from ljmd_tpu.parallel.ensemble import ensemble_simulate
    from ljmd_tpu.parallel.mesh import PARTICLE_AXIS, make_mesh
    from ljmd_tpu.parallel.spatial import make_spatial_engine
    from ljmd_tpu.parallel.spatial_pencil import make_pencil_engine

    d = 4
    # 1. replica-sharded ensemble vs the same ensemble on one card
    log("phase four_cards/ensemble")
    t0 = time.perf_counter()
    one = ensemble_simulate(cfg_ens, n_replicas)
    t1 = time.perf_counter()
    four = ensemble_simulate(cfg_ens, n_replicas, mesh=make_mesh(replica=d, devices=devices[:d]))
    t2 = time.perf_counter()
    log(f"  [ensemble] one_card_wall_s={t1 - t0:.3f} four_card_wall_s={t2 - t1:.3f} "
        f"(first calls, compile included)")
    rel = np.max(np.abs(np.asarray(four.replica_means) - np.asarray(one.replica_means))
                 / np.maximum(np.abs(np.asarray(one.replica_means)), 1e-30))
    check("ensemble 4-card vs 1-card max rel |d means|", float(rel), 1e-4,
          "same per-replica program; f32 rounding grows chaotically over the run")

    # 2. half-ring spatial engine vs the one-card neighbor engine
    log("phase four_cards/half_ring")
    state = jax.jit(lambda k: initialize(cfg_ring, k))(jax.random.PRNGKey(cfg_ring.seed))
    mesh_p = Mesh(np.array(devices[:d]), (PARTICLE_AXIS,))
    ring = make_spatial_engine(cfg_ring, mesh_p, comm="half_ring")
    nbr = make_engine(cfg_ring, "neighbor")
    c4, o4 = jax.jit(ring.init)(state)
    c1, o1 = jax.jit(nbr.init)(state)
    _force_parity("half_ring 4-card vs neighbor 1-card", ring.get_state(c4).a, o4,
                  nbr.get_state(c1).a, o1)
    t0 = time.perf_counter()
    res4 = jax.block_until_ready(jax.jit(lambda s: run_production(cfg_ring, s, engine=ring))(state))
    t1 = time.perf_counter()
    res1 = jax.block_until_ready(jax.jit(lambda s: run_production(cfg_ring, s, engine=nbr))(state))
    t2 = time.perf_counter()
    log(f"  [half_ring] N={cfg_ring.n} steps={cfg_ring.total_steps} four_card_wall_s="
        f"{t1 - t0:.3f} one_card_wall_s={t2 - t1:.3f} (compile included)")
    e4, e1 = np.asarray(res4.series[2], np.float64), np.asarray(res1.series[2], np.float64)
    check("half_ring etot series max rel diff", float(np.max(np.abs(e4 - e1) / np.abs(e1))),
          1e-4, "f32 trajectories of two decompositions over a short run")

    # 3. sharded pencil engine (4-way particle mesh) vs the one-card pencil engine
    log("phase four_cards/pencil")
    # jittered lattice: on the perfect lattice the forces vanish by symmetry
    # and their comparison would measure rounding noise only
    st = _lattice_state(cfg_pencil, jitter=0.05)
    p4 = make_pencil_engine(cfg_pencil, mesh_p)
    p1 = make_pencil_engine(cfg_pencil)
    outs = {}
    for name, eng in (("four_card", p4), ("one_card", p1)):
        c, o = jax.jit(eng.init)(st)
        a0 = eng.get_state(c).a
        t0 = time.perf_counter()
        c = jax.block_until_ready(jax.jit(lambda cc, eng=eng: eng.run_fast(cc, 16))(c))
        c, o_end = jax.jit(eng.step)(c)
        log(f"  [pencil {name}] N={cfg_pencil.n} 17 steps wall_s={time.perf_counter() - t0:.3f} "
            f"(compile included) overflow={bool(c.overflow)}")
        if bool(c.overflow):
            raise AssertionError(f"pencil {name}: overflow flag set")
        outs[name] = (a0, o, eng.get_state(c), o_end)
    a4, o4, s4, e4 = outs["four_card"]
    a1, o1, s1, e1 = outs["one_card"]
    _force_parity("pencil 4-card vs 1-card (init)", a4, o4, a1, o1)
    dr = float(np.max(np.abs(np.asarray(s4.r, np.float64) - np.asarray(s1.r, np.float64))))
    check("pencil 4-card vs 1-card max |dr| after 17 steps", dr, 1e-4,
          "f32 positions of two sweep orders over a short run")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card phase (needs 4 GPUs)")
    p.add_argument("--crossover", action="store_true",
                   help="run only the neighbor-vs-pencil crossover timing")
    args = p.parse_args(argv)

    import jax

    from ljmd_tpu.cli import _enable_compile_cache
    from ljmd_tpu.utils.profiling import card_description, require_gpu

    devices = require_gpu()
    _enable_compile_cache(argparse.Namespace(compile_cache=None, no_compile_cache=False))
    card = card_description()
    log(f"devices: {len(devices)} x {devices[0].device_kind}")
    t_start = time.perf_counter()

    if args.four_cards:
        if len(devices) < 4:
            raise SystemExit(f"error: --four-cards needs 4 GPUs, found {len(devices)}")
        four_cards(
            devices,
            _example("ensemble64.json", total_steps=200, warmup_steps=20, output_interval=10),
            _example("n4000_production.json", total_steps=100, warmup_steps=50,
                     output_interval=10),
            _example("n4000_production.json", num_cells=21, box_length=35.27,
                     rc_over_box=2.5 / 35.27, neighbor_skin=0.4),
        )
        count = 4
    elif args.crossover:
        phase_crossover(devices[0])
        count = 1
    else:
        dev = devices[0]
        log("phase flagship")
        flag = phase_flagship(_example("n4000_production.json", total_steps=6000,
                                       warmup_steps=1000), dev)
        log("phase reference_default")
        phase_reference_default(_example("reference_default.json", total_steps=25000), dev)
        log("phase large")
        phase_large(_example("n62500_large.json", total_steps=400, warmup_steps=100), dev)
        log("phase ensemble64")
        phase_ensemble(_example("ensemble64.json", total_steps=2000, warmup_steps=200), dev)
        log("phase autocorr")
        phase_autocorr(flag.series)
        count = 1

    log(f"total_wall_s={time.perf_counter() - t_start:.3f}")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
