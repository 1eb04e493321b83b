"""Command-line interface: the rebuild of the reference's programs and run
scripts (``build/one_run/*.sh`` + the three Fortran programs + the Python
analysis CLI) behind one entry point:

  python -m ljmd_tpu init-config  --config <file> [--out rv_init.dat]
  python -m ljmd_tpu simulate     --config <file> --out-dir <dir>
                                  [--from-init rv_init.dat] [--backend auto]
                                  [--no-frames]
  python -m ljmd_tpu analyze      --run-dir <dir> [reference's flags]
  python -m ljmd_tpu ensemble     --config <file> --out-dir <dir>
                                  [--n-runs N] [--backend auto]
  python -m ljmd_tpu run-all      --config <file> --out-dir <dir>
                                  (compile->init->simulate->analyze pipeline,
                                   the run_all.sh equivalent)

Config files: the reference's block-text format or JSON (``config.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _load_cfg(args, **overrides):
    from ljmd_tpu.config import load_config

    if args.config:
        return load_config(args.config, **overrides)
    from ljmd_tpu.config import SimConfig

    return SimConfig(**overrides)


def cmd_init_config(args) -> int:
    import jax

    from ljmd_tpu.io.checkpoint import save_rv_init
    from ljmd_tpu.models.simulation import initialize

    cfg = _load_cfg(args)
    t0 = time.time()
    state = initialize(cfg, jax.random.PRNGKey(args.seed if args.seed is not None else cfg.seed),
                       backend=args.backend)
    _check_initialized(state, cfg)
    out = args.out or "outputs/rv_init.dat"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_rv_init(out, state)
    print(f"wrote {out} (N={cfg.n}, warmup={cfg.warmup_steps} steps, "
          f"{time.time()-t0:.1f}s)")
    return 0


def _check_initialized(state, cfg) -> None:
    """Fail fast on an unusable initial state (the reference stops inside
    rescale_velocities_to_target_energy when E_target < U,
    md_initial_config_program.f90:257; our pure-jnp init surfaces that as
    NaN velocities instead — catch it here before burning a full run)."""
    from ljmd_tpu.utils.debug import validate_state

    try:
        validate_state(state, cfg.box_length)
    except FloatingPointError as e:
        raise SystemExit(
            f"error: initial state is not finite ({e}). Most common cause: "
            f"target_total_energy={cfg.target_total_energy} is below the "
            "potential energy of the initial lattice, so the velocity "
            "rescale has no solution (reference aborts with 'target energy "
            "too low'). Raise target_total_energy."
        ) from e


def cmd_simulate(args) -> int:
    import jax
    import jax.numpy as jnp

    from ljmd_tpu.io.artifacts import write_run_artifacts
    from ljmd_tpu.io.checkpoint import load_rv_init
    from ljmd_tpu.models.simulation import initialize, run_production

    cfg = _load_cfg(args)
    t0 = time.time()
    if args.from_init:
        state = load_rv_init(args.from_init, cfg.n, dtype=jnp.dtype(cfg.dtype))
    else:
        state = initialize(cfg, jax.random.PRNGKey(cfg.seed), backend=args.backend)
    _check_initialized(state, cfg)
    record = not args.no_frames
    out_dir = args.out_dir or "outputs/one_run"
    if getattr(args, "stream", False):
        # chunked driver: incremental rva.dat + per-chunk checkpoints with
        # bit-exact resume (models/streaming.py)
        from ljmd_tpu.models.streaming import run_production_streaming

        out = run_production_streaming(
            cfg, state, out_dir, backend=args.backend,
            chunk_samples=args.chunk_samples, write_frames=record,
        )
        paths = write_run_artifacts(out_dir, cfg, out, write_frames=False)
    else:
        out = run_production(cfg, state, backend=args.backend, record_frames=record)
        paths = write_run_artifacts(out_dir, cfg, out, write_frames=record)
    elapsed = time.time() - t0
    for k, v in out.diagnostics.items():
        if bool(np.asarray(v)):
            print(f"WARNING: diagnostic flag {k} is set", file=sys.stderr)
    rate = cfg.n * cfg.total_steps / elapsed
    print(f"simulated N={cfg.n} x {cfg.total_steps} steps in {elapsed:.1f}s "
          f"({rate:.3e} particle-steps/s); artifacts in {out_dir}")
    print(json.dumps({k: float(out.means.mean(k)) for k in ("epot", "ekin", "etot", "temp", "press")}))
    return 0


def cmd_analyze(args) -> int:
    from ljmd_tpu.analysis.report import analyze_run

    if not args.no_plots:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise SystemExit(
                "error: analyze draws its plots with matplotlib, which is not "
                "installed; pass --no-plots to write the analysis without them"
            ) from e

    summary = analyze_run(
        args.run_dir,
        skip_rva=args.skip_rva,
        msd_fit_frac=args.msd_fit_frac,
        vacf_tmax_frac=args.vacf_tmax_frac,
        rva_max_lag=args.rva_max_lag,
        origin_stride=args.origin_stride,
        make_plots=not args.no_plots,
    )
    traj = summary.get("trajectory", {})
    if traj:
        print(f"D_einstein={traj['D_einstein']:.6g}  D_green_kubo={traj['D_green_kubo']:.6g}")
    print(f"analysis_summary.json written in {args.run_dir}")
    return 0


def cmd_ensemble(args) -> int:
    from ljmd_tpu.parallel.ensemble import ensemble_simulate, replica_result

    cfg = _load_cfg(args)
    n_runs = args.n_runs or cfg.n_runs
    t0 = time.time()
    per_run = getattr(args, "per_run_dirs", False)
    out_dir = args.out_dir or "outputs"
    os.makedirs(out_dir, exist_ok=True)
    if per_run:
        from ljmd_tpu.io.artifacts import write_run_artifacts

        out, results = ensemble_simulate(
            cfg, n_replicas=n_runs, backend=args.backend, keep_per_replica=True
        )
        # per-run directories + run listing (run_many_md parity:
        # outputs/run_XXXX + several_runs.txt, run_many_md.f90:59,74)
        run_dirs = []
        ok = np.asarray(out.replica_ok)
        for i in range(n_runs):
            d = os.path.join(out_dir, f"run_{i:04d}")
            if ok[i]:
                write_run_artifacts(d, cfg, replica_result(results, i), write_frames=False)
                run_dirs.append(d)
        with open(os.path.join(out_dir, "several_runs.txt"), "w") as f:
            f.write("\n".join(run_dirs) + ("\n" if run_dirs else ""))
    elif getattr(args, "stream", False):
        # Host-streamed series: config-4 at production lengths without
        # holding the (R, 5, n_samples) stack in device memory.
        from ljmd_tpu.parallel.ensemble import ensemble_simulate_streaming

        out = ensemble_simulate_streaming(
            cfg, n_replicas=n_runs, backend=args.backend,
            chunk_samples=getattr(args, "chunk_samples", 32) or 32,
        )
    else:
        out = ensemble_simulate(cfg, n_replicas=n_runs, backend=args.backend)

    write_ensemble_artifacts(out_dir, cfg, out, n_runs)
    print(f"{n_runs} replicas in {time.time()-t0:.1f}s; results in {out_dir}")
    return 0


def write_ensemble_artifacts(out_dir, cfg, out, n_runs) -> None:
    """Cross-run ensemble artifact set: means.txt, simulation_results.{txt,json},
    corrmean_runs_*.dat (the reference aggregator's output contract,
    simulation_results.f90 / run_many_md.f90:74-82)."""
    from ljmd_tpu.stats.moments import OBSERVABLES

    os.makedirs(out_dir, exist_ok=True)
    # Per-run means.dat-style records + cross-run simulation_results
    means = np.asarray(out.replica_means)
    lines = ["# run  " + "  ".join(OBSERVABLES)]
    for rmean in means:
        lines.append("  ".join(f"{v: .12e}" for v in rmean))
    with open(os.path.join(out_dir, "means.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    results = {
        "n_runs": int(n_runs),
        "cross_run": {
            name: {"mean": float(out.mean_of_means[i]), "std": float(out.std_of_means[i])}
            for i, name in enumerate(OBSERVABLES)
        },
        "thermo_per_run": {
            k: np.asarray(v).tolist() for k, v in out.thermo.as_dict().items()
        },
    }
    with open(os.path.join(out_dir, "simulation_results.json"), "w") as f:
        json.dump(results, f, indent=2)

    # cross-run-averaged correlation curves (ensemble ACF blocks)
    from ljmd_tpu.io.artifacts import CORR_OBS, write_corr_file

    cm = np.asarray(out.corr_mean_runs)
    cnm = np.asarray(out.corr_norm_mean_runs)
    for i, obs in enumerate(CORR_OBS):
        write_corr_file(
            os.path.join(out_dir, f"corrmean_runs_{obs}.dat"), cm[i], cnm[i],
            block_mean=True,
        )

    # human-readable simulation_results.txt (the reference aggregator's output)
    with open(os.path.join(out_dir, "simulation_results.txt"), "w") as f:
        f.write(f"# cross-run statistics over {n_runs} runs\n")
        for i, name in enumerate(OBSERVABLES):
            f.write(f"<{name}>: {out.mean_of_means[i]: .12e}  std: {out.std_of_means[i]: .12e}\n")
        for k, v in out.thermo.as_dict().items():
            arr = np.asarray(v)
            f.write(f"{k}: mean {arr.mean(): .12e}  std {arr.std(): .12e}\n")


def cmd_run_all(args) -> int:
    """compile -> init -> simulate -> analyze (run_all.sh:6-8 equivalent;
    'compile' is jit, so it happens inside)."""
    rc = cmd_simulate(args)
    if rc:
        return rc
    args.run_dir = args.out_dir or "outputs/one_run"
    args.skip_rva = False
    args.msd_fit_frac = 0.5
    args.vacf_tmax_frac = 1.0
    args.rva_max_lag = None
    args.origin_stride = None
    return cmd_analyze(args)


# Default cache directory: fixed and inside the checkout (the path is part
# of the cache key, so a moving directory never hits). Listed in .gitignore.
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _enable_compile_cache(args) -> None:
    """Persistent XLA compilation cache (on by default for every command).

    An MD run compiles many programs (init, warmup, sample chunk, rebin,
    correlations) that are bit-identical across invocations of one config.
    Caching keys on (HLO, compiler version, platform), so correctness is
    XLA's own contract. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
    reads it itself and the code sets no other directory; otherwise
    --compile-cache DIR, or ``DEFAULT_COMPILE_CACHE``. Disable with
    --no-compile-cache."""
    if getattr(args, "no_compile_cache", False):
        return
    cache_dir = None
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        cache_dir = getattr(args, "compile_cache", None) or DEFAULT_COMPILE_CACHE
    try:
        import jax

        if cache_dir is not None:
            jax.config.update("jax_compilation_cache_dir", cache_dir)
        # Default thresholds skip sub-second compiles; an MD run is MANY
        # small programs (init, rebin, chunk, corr) whose compiles add up.
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except (AttributeError, ValueError):  # pragma: no cover
        # older jax without these config flags: cache unavailable, not an
        # error worth failing a run over
        pass
    except Exception as e:  # pragma: no cover
        # a GENUINE failure (bad dir permissions, ...) must not be invisible
        print(f"warning: persistent compile cache disabled ({e})", file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ljmd_tpu", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--config", help="reference block-text or JSON config file")
        sp.add_argument("--backend", default="auto",
                        choices=["auto", "dense", "neighbor", "cellpair"])
        sp.add_argument("--compile-cache", metavar="DIR",
                        help="persistent XLA compilation cache directory "
                             "(default .jax_cache/ in the checkout; "
                             "JAX_COMPILATION_CACHE_DIR, when set, wins)")
        sp.add_argument("--no-compile-cache", action="store_true",
                        help="disable the persistent compilation cache")

    sp = sub.add_parser("init-config", help="build + warm up an initial configuration")
    common(sp)
    sp.add_argument("--out", help="rv_init.dat path (reference binary format)")
    sp.add_argument("--seed", type=int)
    sp.set_defaults(fn=cmd_init_config)

    sp = sub.add_parser("simulate", help="production run + artifacts")
    common(sp)
    sp.add_argument("--out-dir")
    sp.add_argument("--from-init", help="resume from an rv_init.dat snapshot")
    sp.add_argument("--no-frames", action="store_true", help="skip rva.dat frames")
    sp.add_argument("--stream", action="store_true",
                    help="chunked streaming driver: incremental trajectory + "
                         "mid-run checkpoints, resumable after a crash")
    sp.add_argument("--chunk-samples", type=int, default=64)
    sp.set_defaults(fn=cmd_simulate)

    sp = sub.add_parser("analyze", help="post-process a run directory")
    sp.add_argument("--run-dir", required=True)
    sp.add_argument("--skip-rva", action="store_true")
    sp.add_argument("--msd-fit-frac", type=float, default=0.5)
    sp.add_argument("--vacf-tmax-frac", type=float, default=1.0)
    sp.add_argument("--rva-max-lag", type=int)
    sp.add_argument("--origin-stride", type=int)
    sp.add_argument("--no-plots", action="store_true")
    sp.set_defaults(fn=cmd_analyze)

    sp = sub.add_parser("ensemble", help="vmapped replica runs + aggregation")
    common(sp)
    sp.add_argument("--out-dir")
    sp.add_argument("--n-runs", type=int)
    sp.add_argument(
        "--per-run-dirs", action="store_true",
        help="also write run_XXXX/ artifact directories per replica "
             "(run_many_md parity)",
    )
    sp.add_argument(
        "--stream", action="store_true",
        help="stream per-replica series to host per chunk (long runs / many "
             "replicas without holding all series in device memory)",
    )
    sp.add_argument("--chunk-samples", type=int, default=32)
    sp.set_defaults(fn=cmd_ensemble)

    sp = sub.add_parser("run-all", help="init + simulate + analyze pipeline")
    common(sp)
    sp.add_argument("--out-dir")
    sp.add_argument("--from-init")
    sp.add_argument("--no-frames", action="store_true")
    sp.add_argument("--no-plots", action="store_true")
    sp.set_defaults(fn=cmd_run_all)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _enable_compile_cache(args)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
