"""Time-origin-averaged MSD and VACF, on device.

Rebuild of the reference's post-processing loops
(``scripts/md_one_run_analysis.py:404-489``):

  MSD(tau)  = < |ru(t0+tau) - ru(t0)|^2 >_{particles, origins}
  VACF(tau) = < v(t0+tau) . v(t0) >_{particles, origins}

with origins t0 = 0, stride, 2*stride, ... < n_snap-1, per-lag origin counts
(origins whose window is clipped by the end of the trajectory contribute only
their valid lags), and the per-origin average taken over particles first —
identical estimator, including the subtle normalization choices.

Design: instead of the reference's Python loop over origins with
NumPy slices, a ``lax.scan`` over origins whose body is one vectorized
(max_lag+1, N, 3) window operation (dynamic_slice into a zero-padded frame
buffer + validity mask), so the whole estimator is a single jitted program
over the HBM-resident frame stack.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["compute_msd", "compute_vacf"]


def _origin_scan(frames: jax.Array, max_lag: int, origin_stride: int, kind: str):
    """Shared origin-averaging machinery.

    frames: (n_snap, N, 3) — unwrapped positions (msd) or velocities (vacf).
    Returns (max_lag+1,) in float of frames.dtype with per-lag count
    normalization.
    """
    n_snap = frames.shape[0]
    dtype = frames.dtype
    if n_snap < 2:
        if kind == "msd":
            return jnp.zeros((1,), dtype)
        return jnp.mean(jnp.sum(frames[0] * frames[0], axis=-1))[None]

    max_lag = int(min(max_lag, n_snap - 1))
    origin_stride = max(1, int(origin_stride))
    origins = jnp.arange(0, n_snap - 1, origin_stride)

    window = max_lag + 1
    pad = jnp.zeros((max_lag,) + frames.shape[1:], dtype)
    padded = jnp.concatenate([frames, pad], axis=0)
    lags = jnp.arange(window)

    def body(carry, t0):
        acc, counts = carry
        w = lax.dynamic_slice_in_dim(padded, t0, window, axis=0)  # (window, N, 3)
        ref = frames[t0]  # gather one frame
        if kind == "msd":
            d = w - ref[None]
            per_lag = jnp.mean(jnp.sum(d * d, axis=-1), axis=-1)  # (window,)
        else:
            per_lag = jnp.mean(jnp.sum(w * ref[None], axis=-1), axis=-1)
        valid = lags <= (n_snap - 1 - t0)
        acc = acc + jnp.where(valid, per_lag, 0.0)
        counts = counts + valid.astype(counts.dtype)
        return (acc, counts), None

    acc0 = jnp.zeros((window,), dtype)
    cnt0 = jnp.zeros((window,), dtype)
    (acc, counts), _ = lax.scan(body, (acc0, cnt0), origins)
    return jnp.where(counts > 0, acc / jnp.maximum(counts, 1), 0.0)


@partial(jax.jit, static_argnames=("max_lag", "origin_stride"))
def compute_msd(ru_frames: jax.Array, max_lag: int | None = None, origin_stride: int = 1):
    """MSD(tau) from unwrapped positions (n_snap, N, 3) -> (max_lag+1,)."""
    if max_lag is None:
        max_lag = ru_frames.shape[0] - 1
    return _origin_scan(ru_frames, max_lag, origin_stride, "msd")


@partial(jax.jit, static_argnames=("max_lag", "origin_stride"))
def compute_vacf(v_frames: jax.Array, max_lag: int | None = None, origin_stride: int = 1):
    """VACF(tau) from velocities (n_snap, N, 3) -> (max_lag+1,)."""
    if max_lag is None:
        max_lag = v_frames.shape[0] - 1
    return _origin_scan(v_frames, max_lag, origin_stride, "vacf")


def default_origin_stride(n_snap: int) -> int:
    """The reference's heuristic (md_one_run_analysis.py:762-769):
    1 / 5 / 20 for n_snap <= 5000 / <= 20000 / larger."""
    if n_snap <= 5000:
        return 1
    if n_snap <= 20000:
        return 5
    return 20
