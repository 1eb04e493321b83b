"""Checkpoint / resume.

The reference's only checkpoint is the init snapshot ``rv_init.dat`` at the
warmup->production boundary; a crashed 500k-step production run restarts from
scratch (SURVEY §5.4). The rebuild keeps that contract (``save_rv_init`` /
``load_rv_init`` below write the SAME binary format as the Fortran code, so
either implementation can resume from the other's init snapshot) and adds
full periodic production checkpoints: positions (wrapped + unwrapped),
velocities, accelerations, RNG key, step count, and the streaming means
accumulator — everything needed to resume mid-production bit-exactly.

Format: .npz (portable, no extra deps); orbax remains an option for
multi-host async checkpointing later.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ljmd_tpu.state import MDState
from ljmd_tpu.stats.moments import MeansAccum

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "save_rv_init",
    "load_rv_init",
    "Checkpoint",
]


@dataclasses.dataclass
class Checkpoint:
    state: MDState
    step: int
    key: Optional[jax.Array]
    means: Optional[MeansAccum]
    sample_count: int
    # Streaming-driver extras (models/streaming.py): the sampled series
    # fetched so far (host float64, shape (5, n_done)) and the resume point.
    series: Optional[np.ndarray] = None
    sample_idx: int = 0
    # Engine-carry leaves (ordered as jax.tree.leaves of the engine carry).
    # Needed for BIT-exact resume of binned engines: their mid-run rebin
    # order is history-dependent (the unstable pencil sort keys on the
    # previous slot index), so re-initializing from the particle-order
    # MDState produces a different within-pencil rank order and hence a
    # different f32 summation order (an N=62500 kill-and-resume run's
    # resumed means differed at ~5e-7).
    carry_leaves: Optional[list] = None


def save_checkpoint(
    path: str,
    state: MDState,
    step: int,
    key: Optional[jax.Array] = None,
    means: Optional[MeansAccum] = None,
    series: Optional[np.ndarray] = None,
    sample_idx: Optional[int] = None,
    carry_leaves: Optional[list] = None,
) -> None:
    """Single checkpoint codec for every driver (mid-production resume —
    absent in the reference, SURVEY §5.4). ``series``/``sample_idx`` are the
    streaming driver's chunk-resume extras; ``key`` the RNG state when the
    caller owns one; ``carry_leaves`` the flattened engine carry for
    bit-exact resume (loaders fall back to the MDState when absent)."""
    arrays = {
        "r": np.asarray(state.r),
        "ru": np.asarray(state.ru),
        "v": np.asarray(state.v),
        "a": np.asarray(state.a),
        "step": np.asarray(step, dtype=np.int64),
    }
    if key is not None:
        arrays["key"] = np.asarray(jax.random.key_data(key))
    if means is not None:
        arrays["means_count"] = np.asarray(means.count)
        arrays["means_moments"] = np.asarray(means.moments)
        arrays["means_shift"] = np.asarray(means.shift)
    if series is not None:
        arrays["series"] = np.asarray(series, dtype=np.float64)
    if sample_idx is not None:
        arrays["sample_idx"] = np.asarray(sample_idx, dtype=np.int64)
    if carry_leaves is not None:
        arrays["carry_n"] = np.asarray(len(carry_leaves), dtype=np.int64)
        for i, leaf in enumerate(carry_leaves):
            arrays[f"carry_{i}"] = np.asarray(leaf)
    np.savez(path, **arrays)


def load_checkpoint(path: str, dtype=None) -> Checkpoint:
    """Load a checkpoint; with ``dtype`` the state arrays are cast (the
    streaming driver resumes under the effective dtype policy)."""
    with np.load(path) as z:
        cast = (lambda a: jnp.asarray(a, dtype)) if dtype is not None else jnp.asarray
        state = MDState(
            r=cast(z["r"]),
            ru=cast(z["ru"]),
            v=cast(z["v"]),
            a=cast(z["a"]),
        )
        step = int(z["step"])
        key = None
        if "key" in z:
            key = jax.random.wrap_key_data(jnp.asarray(z["key"]))
        means = None
        count = 0
        if "means_moments" in z:
            moments = jnp.asarray(z["means_moments"])
            means = MeansAccum(
                count=jnp.asarray(z["means_count"]),
                moments=moments,
                # pre-round-4 checkpoints carry unshifted moments: shift=0
                # reproduces the old accumulator exactly
                shift=(jnp.asarray(z["means_shift"]) if "means_shift" in z
                       else jnp.zeros(moments.shape[1:], moments.dtype)),
            )
            count = int(z["means_count"])
        series = z["series"].copy() if "series" in z else None
        sample_idx = int(z["sample_idx"]) if "sample_idx" in z else 0
        carry_leaves = None
        if "carry_n" in z:
            carry_leaves = [z[f"carry_{i}"].copy() for i in range(int(z["carry_n"]))]
    return Checkpoint(
        state=state, step=step, key=key, means=means, sample_count=count,
        series=series, sample_idx=sample_idx, carry_leaves=carry_leaves,
    )


def save_rv_init(path: str, state: MDState) -> None:
    """Write the warmup->production snapshot in the REFERENCE binary format
    (positions record + velocities record, float64) so Fortran tooling can
    read it."""
    from ljmd_tpu.io.fortran_records import write_rv_init

    write_rv_init(path, np.asarray(state.r, dtype=np.float64), np.asarray(state.v, dtype=np.float64))


def load_rv_init(path: str, n: int, dtype=jnp.float32) -> MDState:
    """Read a Fortran (or ours) rv_init.dat into an MDState, with ru = r and
    zero accelerations — the caller must evaluate initial forces, as in the
    reference (md_simulation_program.f90:221-236)."""
    from ljmd_tpu.io.fortran_records import read_rv_init

    r, v = read_rv_init(path, n)
    r_j = jnp.asarray(r, dtype=dtype)
    return MDState(r=r_j, ru=r_j, v=jnp.asarray(v, dtype=dtype), a=jnp.zeros_like(r_j))
