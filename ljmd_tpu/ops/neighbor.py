"""Verlet neighbor lists with skin + the O(N*K) LJ force path.

The reference has NO neighbor/cell lists — its force kernel is a pure O(N^2)
loop every step (``lj_potential_energy.f90:97`` flags this itself). This
module is the mid-N scaling answer (SURVEY §5.7): a fixed-capacity
neighbor list (static shapes for XLA) built from a cutoff rc + skin, rebuilt
only when some particle has moved more than skin/2 since the build, and a
gather-based force evaluation touching O(N*K) pairs per step instead of N^2.

Semantics are identical to the dense kernel (same energies/forces/virials,
EXCLUDING nothing inside rc as long as the skin criterion holds — verified
by parity tests); tail corrections are added the same way.

Design notes:
- The list stores, per particle, up to K neighbor indices within
  rc_list = rc + skin, padded with the sentinel index N (an extra phantom
  row appended to the gathered positions). Both directions of a pair are
  stored, so scalar sums are halved, matching the dense full-matrix sweep.
- The build is a dense O(N^2) sweep (simple; it runs only every ~10-40
  steps). Its N x N arrays bound the N it can serve; larger liquids go to
  the pencil engine (``parallel/spatial_pencil.py``).
- ``overflow`` flags particles with more than K in-range neighbors; the
  driver re-raises this to the user (capacity is config, like every other
  static knob).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ljmd_tpu.ops.geometry import minimum_image
from ljmd_tpu.ops.lj import LJResult, _pair_terms, tail_corrections

__all__ = [
    "NeighborList",
    "estimate_capacity",
    "build_neighbor_list_dense",
    "needs_rebuild",
    "lj_force_energy_neighbor",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NeighborList:
    """idx: (N, K) neighbor indices, sentinel N for empty slots;
    r_ref: positions at build time (for the displacement criterion);
    overflow: True if any particle exceeded capacity K (list is then
    incomplete and must be rebuilt with a larger K)."""

    idx: jax.Array
    r_ref: jax.Array
    overflow: jax.Array


def estimate_capacity(density: float, r_list: float, safety: float = 1.35) -> int:
    """Static neighbor capacity: ideal-gas count in the r_list sphere times a
    safety factor (liquid-state g(r) peaks push local density above the
    mean), rounded up to a multiple of 8."""
    mean_count = density * (4.0 / 3.0) * 3.141592653589793 * r_list**3
    k = int(mean_count * safety) + 8
    return ((k + 7) // 8) * 8


@partial(jax.jit, static_argnames=("box_length", "r_list_square", "capacity"))
def build_neighbor_list_dense(
    r: jax.Array,
    box_length: float,
    r_list_square: float,
    capacity: int,
) -> NeighborList:
    """O(N^2) build: full MIC distance matrix -> first-K in-range indices per
    row (ascending j; deterministic). Cost is one dense sweep, amortized over
    the rebuild interval."""
    n = r.shape[0]
    x, y, z = r[:, 0], r[:, 1], r[:, 2]
    dx = minimum_image(x[:, None] - x[None, :], box_length)
    dy = minimum_image(y[:, None] - y[None, :], box_length)
    dz = minimum_image(z[:, None] - z[None, :], box_length)
    r2 = dx * dx + dy * dy + dz * dz
    eye = jnp.eye(n, dtype=bool)
    mask = jnp.logical_and(r2 < jnp.asarray(r_list_square, r.dtype), ~eye)

    # Stable partition: in-range columns first (ascending j), sentinel after.
    cols = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (n, n))
    key = jnp.where(mask, cols, n + cols)  # in-range sort before out-of-range
    order = jnp.argsort(key, axis=1)
    idx = jnp.take_along_axis(key, order[:, :capacity], axis=1)
    idx = jnp.where(idx < n, idx, n).astype(jnp.int32)

    counts = jnp.sum(mask, axis=1)
    overflow = jnp.any(counts > capacity)
    return NeighborList(idx=idx, r_ref=r, overflow=overflow)


def needs_rebuild(nbrs: NeighborList, r: jax.Array, box_length: float, skin: float) -> jax.Array:
    """True when any particle moved more than skin/2 since the build (the
    standard Verlet-list safety criterion)."""
    d = minimum_image(r - nbrs.r_ref, box_length)
    max_d2 = jnp.max(jnp.sum(d * d, axis=-1))
    return max_d2 > (0.5 * skin) ** 2


@partial(
    jax.jit,
    static_argnames=("box_length", "rc_square", "use_tail_corrections", "volume", "rc"),
)
def lj_force_energy_neighbor(
    r: jax.Array,
    idx: jax.Array,
    box_length: float,
    rc_square: float,
    use_tail_corrections: bool = True,
    volume: float | None = None,
    rc: float | None = None,
) -> LJResult:
    """LJ forces/energy/virial from a neighbor list: O(N*K) gathers + VPU
    math. Identical results to the dense kernel when the list is valid."""
    n = r.shape[0]
    dtype = r.dtype

    # Phantom row for sentinel gathers; masked out via idx < n.
    r_pad = jnp.concatenate([r, jnp.zeros((1, 3), dtype)], axis=0)
    rj = r_pad[idx]  # (N, K, 3)
    valid = idx < n

    d = minimum_image(r[:, None, :] - rj, box_length)
    r2 = jnp.sum(d * d, axis=-1)  # (N, K)
    mask = jnp.logical_and(r2 < jnp.asarray(rc_square, dtype), valid)

    pair_e, du_r, pair_ddu, inv_r2 = _pair_terms(r2, mask, dtype)
    coef = (-du_r * inv_r2)[..., None]
    a = 24.0 * jnp.sum(coef * d, axis=1)

    # Each pair appears in both lists -> halve scalar sums; prefactors as in
    # the dense path (4 energy / 24 derivatives).
    epot = 2.0 * jnp.sum(pair_e)
    d_epot = 12.0 * jnp.sum(du_r)
    dd_epot = 12.0 * jnp.sum(pair_ddu)

    if use_tail_corrections:
        if volume is None or rc is None:
            raise ValueError("tail corrections require volume and rc")
        e_t, d_t, dd_t = tail_corrections(n, volume, rc)
        epot = epot + jnp.asarray(e_t, dtype)
        d_epot = d_epot + jnp.asarray(d_t, dtype)
        dd_epot = dd_epot + jnp.asarray(dd_t, dtype)

    return LJResult(a=a, epot=epot, d_epot=d_epot, dd_epot=dd_epot)
