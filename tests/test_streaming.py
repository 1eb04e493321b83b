"""Streaming driver: parity with the in-memory driver, mid-run resume,
incremental rva.dat, nan_guard + profiling utilities."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ljmd_tpu.config import config_from_density
from ljmd_tpu.io.fortran_records import read_rva
from ljmd_tpu.models.simulation import initialize, run_production
from ljmd_tpu.models.streaming import _checkpoint_path, run_production_streaming
from ljmd_tpu.utils.debug import nan_guard, validate_state
from ljmd_tpu.utils.profiling import Throughput, time_fn


def small_cfg(**kw):
    base = dict(
        total_steps=200, output_interval=10, warmup_steps=40, dt=0.002,
        dtype="float64", target_total_energy=-60.0, seed=5,
    )
    base.update(kw)
    return config_from_density(num_cells=2, density=0.6, **base)


def test_streaming_matches_in_memory(tmp_path):
    cfg = small_cfg()
    state = initialize(cfg, backend="dense")
    want = run_production(cfg, state, backend="dense", record_frames=True)
    got = run_production_streaming(
        cfg, state, str(tmp_path), backend="dense", chunk_samples=5
    )
    np.testing.assert_allclose(np.asarray(got.series), np.asarray(want.series), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(got.final_state.r), np.asarray(want.final_state.r), rtol=1e-12
    )
    np.testing.assert_allclose(np.asarray(got.corr), np.asarray(want.corr), rtol=1e-9)
    # incremental rva.dat matches the in-memory frames
    data = read_rva(str(tmp_path / "rva.dat"))
    assert data.n_snapshots == cfg.n_samples
    np.testing.assert_allclose(data.r, np.asarray(want.frames.r), rtol=1e-12)
    # checkpoint removed on success
    assert not os.path.exists(_checkpoint_path(str(tmp_path)))


def test_streaming_resume_bit_exact(tmp_path):
    cfg = small_cfg()
    state = initialize(cfg, backend="dense")
    full_dir = tmp_path / "full"
    want = run_production_streaming(cfg, state, str(full_dir), backend="dense", chunk_samples=4)

    # interrupted run: run only 2 chunks by raising from a tiny chunk count,
    # emulated by calling with a truncated loop via monkeypatched chunks
    part_dir = tmp_path / "part"
    part_dir.mkdir()
    # run the first 8 samples by temporarily shrinking total_steps so the
    # driver stops, leaving a checkpoint behind: emulate crash by manually
    # checkpointing mid-way instead — simplest: run with chunk_samples=4 but
    # kill after first chunk via a wrapper
    from ljmd_tpu.models import streaming as S

    calls = {"n": 0}
    orig_save = S._save

    def crash_after_two(*args, **kw):
        orig_save(*args, **kw)
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt

    S._save = crash_after_two
    try:
        with pytest.raises(KeyboardInterrupt):
            run_production_streaming(cfg, state, str(part_dir), backend="dense", chunk_samples=4)
    finally:
        S._save = orig_save
    assert os.path.exists(_checkpoint_path(str(part_dir)))

    got = run_production_streaming(
        cfg, state, str(part_dir), backend="dense", chunk_samples=4, resume=True
    )
    np.testing.assert_allclose(np.asarray(got.series), np.asarray(want.series), rtol=1e-12)
    data_part = read_rva(str(part_dir / "rva.dat"))
    data_full = read_rva(str(full_dir / "rva.dat"))
    assert data_part.n_snapshots == data_full.n_snapshots
    np.testing.assert_allclose(data_part.v, data_full.v, rtol=1e-12)


def test_streaming_resume_bit_exact_cellpair(tmp_path):
    """BINNED-engine resume must restore the engine CARRY verbatim: the
    mid-run rebin order is history-dependent (the unstable pencil sort keys
    on the previous slot index), so a state-based re-init yields a different
    within-pencil rank order and a different summation order (an N=62500
    kill-and-resume run's resumed means differed at ~5e-7); this pins EXACT
    equality with the uninterrupted run."""
    cfg = config_from_density(
        num_cells=5, density=0.66, dt=0.002, dtype="float64",
        neighbor_skin=0.4, total_steps=160, output_interval=10,
        warmup_steps=20, target_total_energy=-2000.0, seed=7,
    )
    state = initialize(cfg, backend="cellpair")
    full_dir = tmp_path / "full"
    want = run_production_streaming(
        cfg, state, str(full_dir), backend="cellpair", chunk_samples=4
    )

    from ljmd_tpu.models import streaming as S

    part_dir = tmp_path / "part"
    part_dir.mkdir()
    calls = {"n": 0}
    orig_save = S._save

    def crash_after_two(*args, **kw):
        orig_save(*args, **kw)
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt

    S._save = crash_after_two
    try:
        with pytest.raises(KeyboardInterrupt):
            run_production_streaming(
                cfg, state, str(part_dir), backend="cellpair", chunk_samples=4
            )
    finally:
        S._save = orig_save
    assert os.path.exists(_checkpoint_path(str(part_dir)))

    got = run_production_streaming(
        cfg, state, str(part_dir), backend="cellpair", chunk_samples=4,
        resume=True,
    )
    np.testing.assert_array_equal(np.asarray(got.series), np.asarray(want.series))
    np.testing.assert_array_equal(
        np.asarray(got.final_state.r), np.asarray(want.final_state.r)
    )
    data_part = read_rva(str(part_dir / "rva.dat"))
    data_full = read_rva(str(full_dir / "rva.dat"))
    assert data_part.n_snapshots == data_full.n_snapshots
    np.testing.assert_array_equal(data_part.v, data_full.v)


def test_validate_state_catches_problems():
    cfg = small_cfg()
    state = initialize(cfg, backend="dense")
    validate_state(state, cfg.box_length)  # healthy
    import dataclasses

    bad = dataclasses.replace(state, v=state.v.at[0, 0].set(jnp.nan))
    with pytest.raises(FloatingPointError):
        validate_state(bad, cfg.box_length)
    unwrapped = dataclasses.replace(state, r=state.r.at[0, 0].add(cfg.box_length))
    with pytest.raises(ValueError):
        validate_state(unwrapped, cfg.box_length)


def test_nan_guard_flags_divergence():
    import dataclasses

    from ljmd_tpu.models.engine import make_engine

    cfg = small_cfg()
    state = initialize(cfg, backend="dense")
    eng = nan_guard(make_engine(cfg, "dense"))
    carry, obs = eng.init(state)
    assert not bool(eng.diagnostics(carry)["nonfinite_observables"])

    # Two exactly overlapping particles: r = 0 pair -> inf * 0 -> NaN forces.
    broken = dataclasses.replace(state, r=state.r.at[1].set(state.r[0]))
    carry, obs = eng.init(broken)

    def run(c):
        def body(cc, _):
            return eng.step(cc)
        return jax.lax.scan(body, c, None, length=3)[0]

    carry = jax.jit(run)(carry)
    assert bool(eng.diagnostics(carry)["nonfinite_observables"])


def test_throughput_and_time_fn():
    t = Throughput(n_particles=100)
    t.start()
    t.stop(steps_done=50)
    rep = t.report()
    assert rep["steps"] == 50 and rep["particle_steps_per_sec"] > 0

    f = jax.jit(lambda x: x * 2)
    dt = time_fn(f, jnp.ones(8), iters=2)
    assert dt >= 0
