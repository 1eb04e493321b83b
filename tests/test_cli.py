"""CLI end-to-end: init-config -> simulate (from init) -> analyze -> ensemble
on a tiny config (the run_all.sh pipeline equivalent)."""

import json
import os

import numpy as np
import pytest

from ljmd_tpu.cli import main

CFG_JSON = {
    "num_cells": 2,
    "box_length": 3.8,
    "rc_over_box": 0.45,
    "total_steps": 120,
    "output_interval": 10,
    "warmup_steps": 20,
    "dt": 0.002,
    "dtype": "float64",
    "target_total_energy": -60.0,
    "n_runs": 3,
}


@pytest.fixture(scope="module")
def cfg_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    p = d / "cfg.json"
    p.write_text(json.dumps(CFG_JSON))
    return str(p)


def test_cli_pipeline(cfg_file, tmp_path):
    init_path = str(tmp_path / "rv_init.dat")
    rc = main(["init-config", "--config", cfg_file, "--out", init_path, "--backend", "dense"])
    assert rc == 0
    assert os.path.exists(init_path)

    run_dir = str(tmp_path / "one_run")
    rc = main([
        "simulate", "--config", cfg_file, "--out-dir", run_dir,
        "--from-init", init_path, "--backend", "dense",
    ])
    assert rc == 0
    for f in ("instantaneous_energies.dat", "corr_epot.dat", "corrmean_press.dat",
              "md_final_results.txt", "summary.json", "rva.dat"):
        assert os.path.exists(os.path.join(run_dir, f)), f

    rc = main(["analyze", "--run-dir", run_dir])
    assert rc == 0
    with open(os.path.join(run_dir, "analysis_summary.json")) as f:
        summary = json.load(f)
    assert summary["n_samples"] == 10
    assert "trajectory" in summary
    assert np.isfinite(summary["trajectory"]["D_einstein"])
    assert "tau_int" in summary["acf"]["epot"]
    # plots rendered
    plots = os.listdir(os.path.join(run_dir, "plots"))
    assert any(p.startswith("timeseries_") for p in plots)
    assert "rdf.png" in plots and "msd.png" in plots and "vacf.png" in plots


def test_cli_reads_reference_format_config(tmp_path):
    ref_cfg = tmp_path / "params.txt"
    ref_cfg.write_text(
        "# block 1\nk total_steps output_interval warmup_steps\n"
        "2 60 10 10\n"
        "# block 2\ndt L rc_over_L\n1.d-3 3.8 0.45d0\n"
        "# block 3\ntarget_total_energy\n-60.d0\n"
    )
    out_dir = str(tmp_path / "run")
    rc = main(["simulate", "--config", str(ref_cfg), "--out-dir", out_dir,
               "--backend", "dense", "--no-frames"])
    assert rc == 0
    assert os.path.exists(os.path.join(out_dir, "summary.json"))
    assert not os.path.exists(os.path.join(out_dir, "rva.dat"))


def test_cli_simulate_stream(cfg_file, tmp_path):
    run_dir = str(tmp_path / "stream_run")
    rc = main([
        "simulate", "--config", cfg_file, "--out-dir", run_dir,
        "--backend", "dense", "--stream", "--chunk-samples", "4",
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(run_dir, "rva.dat"))
    assert os.path.exists(os.path.join(run_dir, "summary.json"))
    # successful completion removes the mid-run checkpoint
    assert not os.path.exists(os.path.join(run_dir, "production_checkpoint.npz"))


def test_cli_ensemble_per_run_dirs(cfg_file, tmp_path):
    out_dir = str(tmp_path / "ens_dirs")
    rc = main(["ensemble", "--config", cfg_file, "--out-dir", out_dir,
               "--n-runs", "2", "--backend", "dense", "--per-run-dirs"])
    assert rc == 0
    listing = open(os.path.join(out_dir, "several_runs.txt")).read().split()
    assert len(listing) == 2
    for d in listing:
        assert os.path.exists(os.path.join(d, "summary.json"))
        assert os.path.exists(os.path.join(d, "corr_epot.dat"))
        assert os.path.exists(os.path.join(d, "md_final_results.txt"))


@pytest.mark.parametrize("case", ["env_set", "env_unset", "flag"])
def test_cli_compile_cache_plumbing(case, tmp_path, monkeypatch):
    """Compile-cache placement: a JAX_COMPILATION_CACHE_DIR in the
    environment is JAX's own setting and the CLI sets no other directory
    (not even with --compile-cache); without it, --compile-cache DIR or the
    fixed in-checkout default; --no-compile-cache leaves the config alone."""
    import argparse

    import jax

    from ljmd_tpu.cli import DEFAULT_COMPILE_CACHE, _enable_compile_cache

    prev = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "untouched")
    flag_dir = str(tmp_path / "flag_cache")
    try:
        jax.config.update("jax_compilation_cache_dir", sentinel)
        if case == "env_set":
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
            args = argparse.Namespace(compile_cache=flag_dir, no_compile_cache=False)
            want = sentinel
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            given = flag_dir if case == "flag" else None
            args = argparse.Namespace(compile_cache=given, no_compile_cache=False)
            want = given or DEFAULT_COMPILE_CACHE
        _enable_compile_cache(args)
        assert jax.config.jax_compilation_cache_dir == want

        # --no-compile-cache leaves the config untouched
        jax.config.update("jax_compilation_cache_dir", sentinel)
        _enable_compile_cache(
            argparse.Namespace(compile_cache=flag_dir, no_compile_cache=True)
        )
        assert jax.config.jax_compilation_cache_dir == sentinel
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)

    # the default lives inside the checkout, under a git-ignored name
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(DEFAULT_COMPILE_CACHE) == repo
    assert ".jax_cache/" in open(os.path.join(repo, ".gitignore")).read().split()


def test_cli_analyze_without_matplotlib_names_no_plots(cfg_file, tmp_path, monkeypatch):
    """Without matplotlib, analyze stops before any work with a message
    naming --no-plots; with --no-plots it runs."""
    import sys

    run_dir = str(tmp_path / "run")
    assert main(["simulate", "--config", cfg_file, "--out-dir", run_dir,
                 "--backend", "dense", "--no-frames"]) == 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="--no-plots"):
        main(["analyze", "--run-dir", run_dir])
    assert not os.path.exists(os.path.join(run_dir, "analysis_summary.json"))
    assert main(["analyze", "--run-dir", run_dir, "--no-plots"]) == 0
    assert os.path.exists(os.path.join(run_dir, "analysis_summary.json"))


def test_cli_ensemble(cfg_file, tmp_path):
    out_dir = str(tmp_path / "ens")
    rc = main(["ensemble", "--config", cfg_file, "--out-dir", out_dir,
               "--n-runs", "3", "--backend", "dense"])
    assert rc == 0
    with open(os.path.join(out_dir, "simulation_results.json")) as f:
        res = json.load(f)
    assert res["n_runs"] == 3
    assert "epot" in res["cross_run"]
    assert len(res["thermo_per_run"]["Ca_v"]) == 3
    means = np.loadtxt(os.path.join(out_dir, "means.txt"))
    assert means.shape == (3, 11)
    assert os.path.exists(os.path.join(out_dir, "simulation_results.txt"))
