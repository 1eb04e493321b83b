"""Chunked streaming production driver with mid-run checkpoint/resume.

``run_production`` (models/simulation.py) keeps everything on device — ideal
for small/medium runs. This driver targets long trajectories and large N
(SURVEY §5.4: the reference has NO mid-production checkpointing — a crashed
500k-step run restarts from rv_init; and §5.7: frames must stream, not
accumulate): the sample loop is split into jitted chunks; after each chunk
the sampled series/frames are fetched to host, frames append to an rva.dat
via TrajectoryWriter, and a full checkpoint (state + the FLATTENED ENGINE
CARRY + means accumulator + series so far + sample index) lands on disk. A
restarted run picks up from the last checkpoint bit-exactly (same chunk
boundaries => identical scan structure; the carry restores verbatim, which
matters for binned engines whose mid-run rebin order is history-dependent —
see io/checkpoint.Checkpoint.carry_leaves).

Statistics finalization (correlations, block means, thermo) reuses the same
post-processing as the in-memory driver.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ljmd_tpu.config import SimConfig
from ljmd_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from ljmd_tpu.io.trajectory import AsyncTrajectoryWriter
from ljmd_tpu.models.engine import _effective_dtype, make_engine
from ljmd_tpu.models.simulation import SimResult, _advance, _cadence, sample_steps
from ljmd_tpu.state import MDState
from ljmd_tpu.stats.correlations import autocorr_all, block_corr_means
from ljmd_tpu.stats.moments import (
    MeansAccum,
    instantaneous_temp_press,
    means_finalize,
    means_init,
    means_update,
)

__all__ = ["run_production_streaming"]


def _checkpoint_path(out_dir: str) -> str:
    return os.path.join(out_dir, "production_checkpoint.npz")


def _save(out_dir, state: MDState, acc: MeansAccum, series_done: np.ndarray,
          sample_idx: int, ecarry=None):
    save_checkpoint(
        _checkpoint_path(out_dir), state, step=0, means=acc,
        series=series_done, sample_idx=sample_idx,
        carry_leaves=None if ecarry is None else jax.tree.leaves(ecarry),
    )


def _load(out_dir, dtype):
    path = _checkpoint_path(out_dir)
    if not os.path.exists(path):
        return None
    ck = load_checkpoint(path, dtype=dtype)
    return ck.state, ck.means, ck.series, ck.sample_idx, ck.carry_leaves


def _restore_carry(engine, state: MDState, carry_leaves):
    """Rebuild the engine carry for resume.

    With saved carry leaves (round-5 format) the carry is restored VERBATIM
    — bit-exact continuation for every engine, including the binned ones
    whose mid-run rebin order is history-dependent (the unstable pencil
    sort keys on the previous slot index, so ``engine.init`` from the
    particle-order MDState yields a different within-pencil rank order and
    a different f32 summation order), and including sticky diagnostic
    flags, which the state-based fallback silently resets. Falls back to
    ``engine.init(state)`` for pre-round-5 checkpoints."""
    template, _ = engine.init(state)
    if carry_leaves is None:
        return template
    t_leaves, treedef = jax.tree.flatten(template)
    if len(carry_leaves) != len(t_leaves) or any(
        tuple(c.shape) != tuple(np.shape(t)) for c, t in zip(carry_leaves, t_leaves)
    ):
        # config/engine mismatch (e.g. different backend than the writer):
        # the MDState fallback is still a correct, just not bit-exact, resume
        return template
    return jax.tree.unflatten(
        treedef,
        [
            jax.device_put(np.asarray(c, dtype=t.dtype), t.sharding)
            for c, t in zip(carry_leaves, t_leaves)
        ],
    )


def run_production_streaming(
    cfg: SimConfig,
    state: MDState,
    out_dir: str,
    backend: str = "auto",
    chunk_samples: int = 64,
    write_frames: bool = True,
    resume: bool = True,
    engine=None,
) -> SimResult:
    """Streaming production run. Artifacts land in ``out_dir`` incrementally:
    rva.dat grows per chunk, production_checkpoint.npz is refreshed per chunk
    (and removed on successful completion)."""
    os.makedirs(out_dir, exist_ok=True)
    # State-aware pencil capacity (make_engine docstring). Deterministic
    # across resume: the caller re-passes the same post-warmup state, so
    # the census — and hence the slot layout — is reproduced exactly.
    engine = engine or make_engine(cfg, backend, state=state)
    prologue, n_samples, epilogue = _cadence(cfg)
    if n_samples == 0:
        raise ValueError("no samples would be taken")
    dtype = _effective_dtype(cfg)

    resumed = _load(out_dir, dtype) if resume else None
    if resumed is not None:
        state, acc, series_done, start_sample, carry_leaves = resumed
        ecarry = _restore_carry(engine, state, carry_leaves)
    else:
        start_sample = 0
        acc = means_init(dtype=dtype)
        series_done = np.zeros((5, 0), dtype=np.float64)
        ecarry, _ = engine.init(state)
        if prologue:
            # jit: eager dispatch would run the prologue op by op.
            ecarry = jax.jit(lambda c: _advance(
                c, engine.step, prologue, dtype,
                fast_fn=engine.step_fast, want_obs=False, run_fast=engine.run_fast,
            )[0])(ecarry)

    @partial(jax.jit, static_argnames=("k",))
    def chunk(ec, acc, k: int):
        def sample_body(carry, _):
            ec_, acc_ = carry
            ec_, ob = _advance(
                ec_, engine.step, cfg.output_interval, dtype,
                fast_fn=engine.step_fast, run_fast=engine.run_fast,
            )
            acc_ = means_update(acc_, ob, cfg.n, cfg.volume)
            temp, press = instantaneous_temp_press(ob, cfg.n, cfg.volume)
            series = jnp.stack([ob.epot, ob.ekin, ob.epot + ob.ekin, temp, press])
            st = engine.get_state(ec_)
            return (ec_, acc_), (series, (st.r, st.ru, st.v, st.a))

        (ec, acc), (series_t, frames) = lax.scan(sample_body, (ec, acc), None, length=k)
        return ec, acc, series_t.T, frames

    writer = None
    if write_frames:
        # Native async writer (C++ worker thread): trajectory IO overlaps
        # the next chunk's compute; Python TrajectoryWriter fallback inside.
        if resumed is None or not os.path.exists(os.path.join(out_dir, "rva.dat")):
            writer = AsyncTrajectoryWriter(
                os.path.join(out_dir, "rva.dat"), cfg.n, cfg.box_length, cfg.dt,
                cfg.output_interval, n_samples,
            )
        else:
            writer = AsyncTrajectoryWriter.open_for_append(
                os.path.join(out_dir, "rva.dat"), cfg.n, cfg.box_length,
                cfg.dt, cfg.output_interval, start_sample,
            )

    sample_idx = start_sample
    try:
        while sample_idx < n_samples:
            k = min(chunk_samples, n_samples - sample_idx)
            ecarry, acc, series_block, frames = chunk(ecarry, acc, k)
            series_np = np.asarray(series_block, dtype=np.float64)
            series_done = np.concatenate([series_done, series_np], axis=1)
            if writer is not None:
                writer.append(*[np.asarray(f) for f in frames])
                # Crash-consistency fence BEFORE the checkpoint: the async
                # writer enqueues and returns, so without this a kill after
                # _save could leave rva.dat with fewer (or torn) frames than
                # the checkpoint's sample index — an unresumable file. With
                # the fence, disk frames >= checkpoint frames always, and
                # open_for_append truncates any post-checkpoint extras.
                writer.sync()
            sample_idx += k
            _save(out_dir, engine.get_state(ecarry), acc, series_done,
                  sample_idx, ecarry=ecarry)
    finally:
        if writer is not None:
            writer.close()

    if epilogue:
        ecarry = jax.jit(lambda c: _advance(
            c, engine.step, epilogue, dtype,
            fast_fn=engine.step_fast, want_obs=False, run_fast=engine.run_fast,
        )[0])(ecarry)
    final_state = engine.get_state(ecarry)
    diagnostics = engine.diagnostics(ecarry)

    # Finalize statistics exactly like the in-memory driver.
    series = jnp.asarray(series_done, dtype)
    report = means_finalize(acc)
    max_lag = cfg.corr_max_lag
    n_blocks = cfg.corr_n_blocks(n_samples)
    if max_lag >= 1:
        corr, corr_norm = autocorr_all(series, max_lag, centered=True)
    else:
        corr = jnp.zeros((5, 1), dtype)
        corr_norm = jnp.zeros((5, 1), dtype)
    if n_blocks >= 1 and max_lag >= 1:
        corr_mean, corr_mean_norm = jax.vmap(
            partial(block_corr_means, n_blocks=n_blocks, max_lag=max_lag, centered=True)
        )(series)
    else:
        corr_mean = jnp.zeros_like(corr)
        corr_mean_norm = jnp.zeros_like(corr_norm)

    steps = jnp.asarray(sample_steps(cfg), dtype)
    result = SimResult(
        final_state=final_state,
        times=steps * jnp.asarray(cfg.dt, dtype),
        series=series,
        means=report,
        corr=corr,
        corr_norm=corr_norm,
        corr_mean=corr_mean,
        corr_mean_norm=corr_mean_norm,
        frames=None,
        diagnostics=diagnostics,
    )
    # success: the checkpoint is no longer needed
    ckpt = _checkpoint_path(out_dir)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    return result
