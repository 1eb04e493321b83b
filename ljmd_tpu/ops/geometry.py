"""Periodic-boundary-condition geometry primitives.

Rebuild of ``scripts/physics/geometry_pbc.f90``:

- ``wrap_positions``: map coordinates into [0, L) via x - L*floor(x/L)
  (reference geometry_pbc.f90:53-57)
- ``minimum_image``: nearest-image displacement dx - L*nint(dx/L)
  (reference geometry_pbc.f90:80-88)

All are pure elementwise jnp functions that work on any shape and dtype and
broadcast over leading axes, so the same primitives serve the scalar-pair
case, (N, 3) state arrays, and (N, N) pair matrices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["wrap_positions", "wrap_positions_ext", "minimum_image"]


def wrap_positions(r: jax.Array, box_length, inv_box_length=None) -> jax.Array:
    """Wrap coordinates into [0, L): x -> x - L * floor(x / L).

    The naive formula can land exactly ON the boundaries in floating point
    (a tiny negative x rounds to w == L; the reciprocal-multiply can push
    floor off by one, giving w < 0 or w == L), so a correction pass enforces
    the half-open interval strictly — the rc < L/2 minimum-image guarantee
    depends on it."""
    if inv_box_length is None:
        inv_box_length = 1.0 / box_length
    w = r - box_length * jnp.floor(r * inv_box_length)
    w = jnp.where(w >= box_length, w - box_length, w)
    w = jnp.where(w < 0, w + box_length, w)
    # Denormal-distance edge: x + L == L exactly in floating point, so the
    # additive corrections can cycle (XLA may also reassociate (x+L)-L back
    # to x). Anything still outside is within one ulp of a boundary -> 0.
    return jnp.where((w < 0) | (w >= box_length), 0.0, w)


def minimum_image(dr: jax.Array, box_length, inv_box_length=None) -> jax.Array:
    """Minimum-image displacement: dx -> dx - L * nint(dx / L), mapping each
    component into [-L/2, L/2].

    ``jnp.round`` matches Fortran ``dnint`` (round-half-away-from-zero) for
    all MD-relevant inputs: exact .5 multiples of L never occur for particles
    in general position, and both conventions agree elsewhere.
    """
    if inv_box_length is None:
        inv_box_length = 1.0 / box_length
    return dr - box_length * jnp.round(dr * inv_box_length)


def wrap_positions_ext(hi: jax.Array, lo: jax.Array, box_length: float):
    """Wrap two-float positions (hi + lo) into [0, L) without losing the
    remainder: hi' = hi - k*L with the subtraction's rounding error folded
    into lo. k*L is exact for the small |k| (<= 2) that occur between wraps."""
    k = jnp.floor(hi * (1.0 / box_length))
    d = k * box_length
    s = hi - d
    big = jnp.abs(hi) >= jnp.abs(d)
    err = jnp.where(big, (hi - s) - d, (-d - s) + hi)
    return s, lo + err
