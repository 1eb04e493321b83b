"""Autocorrelation engines: full-series ACF, normalization, block-averaged
correlation means.

Rebuild of ``scripts/stats/stats_math.f90`` and the series/block machinery of
``scripts/stats/md_correlations.f90``:

- ``autocorr``: C(L) = (1/(n-L)) sum_{k=0}^{n-1-L} A(k) A(k+L) for
  L = 0..max_lag (stats_math.f90:85-103); ``centered=True`` subtracts the
  series mean first (autocovariance, stats_math.f90:127-149).
- ``normalize_corr``: C(L)/C(0) with a zero-C(0) guard
  (stats_math.f90:168-190).
- ``block_corr_means``: split the series into ``n_blocks`` contiguous equal
  blocks of length n//n_blocks (remainder dropped), compute the per-block
  ACF + normalized ACF (each block centered on its own mean when
  ``centered``), and average the curves over blocks — both <C> and <C/C(0)>
  (md_correlations.f90:668-803).

Design: the reference stores each observable's series in a
heap-allocated accumulator and loops lags with dot products; here a series is
just a ``(n,)`` array (sampled scalars are tiny — SURVEY §7 design mapping)
and the lag sweep is one vmapped dynamic-slice dot per lag, fully jittable
and vmappable over observables, blocks, and ensemble replicas.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["autocorr", "normalize_corr", "block_corr_means", "autocorr_all"]


def autocorr(series: jax.Array, max_lag: int, centered: bool = False) -> jax.Array:
    """(max_lag+1,) autocorrelation values C(0..max_lag).

    max_lag must be < len(series) (the reference enforces max_lag <= n-1,
    stats_math.f90:93-97).
    """
    n = series.shape[-1]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < series length {n}")
    dtype = series.dtype
    if centered:
        series = series - jnp.mean(series, axis=-1, keepdims=True)

    padded = jnp.concatenate([series, jnp.zeros((max_lag,), dtype)], axis=-1)
    lags = jnp.arange(max_lag + 1)

    def one_lag(lag):
        shifted = lax.dynamic_slice_in_dim(padded, lag, n, axis=-1)
        # zero padding makes products beyond n-1-L vanish, so the dot equals
        # sum_{k<=n-1-L} A(k) A(k+L). HIGHEST: the centered f32 Etot series
        # has a tiny variance that a reduced-precision (TF32) dot would erase.
        return jnp.dot(series, shifted, precision=lax.Precision.HIGHEST) / (
            n - lag
        ).astype(dtype)

    return jax.vmap(one_lag)(lags)


def normalize_corr(corr: jax.Array) -> jax.Array:
    """C(L)/C(0); returns zeros when |C(0)| is vanishingly small
    (stats_math.f90:168-190)."""
    c0 = corr[..., :1]
    safe = jnp.where(jnp.abs(c0) < 1e-300, 1.0, c0)
    return jnp.where(jnp.abs(c0) < 1e-300, jnp.zeros_like(corr), corr / safe)


def autocorr_all(series_matrix: jax.Array, max_lag: int, centered: bool = True):
    """ACF + normalized ACF for a stack of observables: (n_obs, n) ->
    ((n_obs, max_lag+1), (n_obs, max_lag+1)). This is the batched form of
    the reference's five per-observable md_corr_compute calls
    (md_correlations.f90:321-382)."""
    corr = jax.vmap(partial(autocorr, max_lag=max_lag, centered=centered))(series_matrix)
    return corr, normalize_corr(corr)


def block_corr_means(
    series: jax.Array,
    n_blocks: int,
    max_lag: int,
    centered: bool = True,
):
    """Block-averaged correlation curves: (mean_corr, mean_corrn), each
    (max_lag+1,).

    block_len = n // n_blocks; trailing remainder dropped
    (md_corr_cm_compute, md_correlations.f90:692). Requires
    max_lag < block_len (md_correlations.f90:694).
    """
    n = series.shape[-1]
    if n_blocks <= 0:
        raise ValueError("n_blocks must be >= 1")
    block_len = n // n_blocks
    if block_len <= 0:
        raise ValueError("block_len <= 0 (too many blocks)")
    if max_lag >= block_len:
        raise ValueError("max_lag must be < block_len")

    blocks = series[: n_blocks * block_len].reshape(n_blocks, block_len)
    corr_b = jax.vmap(partial(autocorr, max_lag=max_lag, centered=centered))(blocks)
    corrn_b = normalize_corr(corr_b)
    return jnp.mean(corr_b, axis=0), jnp.mean(corrn_b, axis=0)
