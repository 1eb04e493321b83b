"""Radial distribution function g(r), on device.

Rebuild of ``scripts/md_one_run_analysis.py:537-595``: MIC pair histogram of
wrapped positions over (optionally subsampled) snapshots and particles,
nbins=200, rmax=L/2 defaults, shell-volume + ideal-gas normalization:

  g(b) = hist(b) / (n_snap_used * n_eff * rho_eff * V_shell(b))

where hist counts ordered pairs (the reference adds 2 per i<j pair) and
rho_eff = n_eff / L^3 uses the subsampled particle count — semantics kept
exactly, including the evenly-spaced subsampling (<=200 snapshots, <=800
particles by default).

Design: a ``lax.scan`` over snapshots; each snapshot computes the
full (n_eff, n_eff) MIC distance matrix as per-component elementwise arrays
and bins it with a one-shot fixed-length ``bincount`` (scatter-add with a
static bin count), all inside one jit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ljmd_tpu.ops.geometry import minimum_image

__all__ = ["compute_rdf", "rdf_bin_centers"]


def rdf_bin_centers(box_length: float, nbins: int = 200, rmax: float | None = None):
    if rmax is None:
        rmax = 0.5 * box_length
    edges = np.linspace(0.0, rmax, nbins + 1)
    return 0.5 * (edges[:-1] + edges[1:])


def _subsample_indices(total: int, cap: int) -> np.ndarray:
    """Evenly spaced indices, the reference's np.linspace subsampling
    (md_one_run_analysis.py:556-561)."""
    if total > cap:
        return np.linspace(0, total - 1, cap, dtype=np.int64)
    return np.arange(total, dtype=np.int64)


@partial(jax.jit, static_argnames=("box_length", "nbins", "rmax", "max_snapshots", "max_particles"))
def compute_rdf(
    r_frames: jax.Array,
    box_length: float,
    nbins: int = 200,
    rmax: float | None = None,
    max_snapshots: int = 200,
    max_particles: int = 800,
):
    """g(r) from wrapped-position frames (n_snap, N, 3) -> (nbins,).

    Use ``rdf_bin_centers`` for the abscissa.
    """
    n_snap, n = r_frames.shape[0], r_frames.shape[1]
    if rmax is None:
        rmax = 0.5 * box_length
    dtype = r_frames.dtype

    snap_idx = jnp.asarray(_subsample_indices(n_snap, max_snapshots))
    part_idx = jnp.asarray(_subsample_indices(n, max_particles))
    n_eff = int(part_idx.shape[0])
    if n_eff < 2:
        raise ValueError("not enough particles for RDF after subsampling")

    frames = r_frames[snap_idx][:, part_idx, :]  # (S, n_eff, 3)
    inv_dr = nbins / rmax
    eye = jnp.eye(n_eff, dtype=bool)

    def one_snapshot(hist, snap):
        x, y, z = snap[:, 0], snap[:, 1], snap[:, 2]
        dx = minimum_image(x[:, None] - x[None, :], box_length)
        dy = minimum_image(y[:, None] - y[None, :], box_length)
        dz = minimum_image(z[:, None] - z[None, :], box_length)
        r = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        valid = jnp.logical_and(r < rmax, ~eye)
        bins = jnp.where(valid, (r * inv_dr).astype(jnp.int32), nbins)  # nbins = discard slot
        h = jnp.zeros((nbins + 1,), dtype).at[bins.reshape(-1)].add(1.0)
        return hist + h[:nbins], None

    hist0 = jnp.zeros((nbins,), dtype)
    hist, _ = lax.scan(one_snapshot, hist0, frames)

    edges = jnp.linspace(0.0, rmax, nbins + 1, dtype=dtype)
    shell_vol = (4.0 / 3.0) * jnp.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    rho_eff = n_eff / box_length**3
    norm = snap_idx.shape[0] * n_eff * rho_eff * shell_vol
    return jnp.where(norm > 0, hist / norm, 0.0)
