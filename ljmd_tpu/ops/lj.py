"""Lennard-Jones force / energy / virial kernels (dense reference path).

Rebuild of the reference's hot kernel ``compute_lj_potential_energy``
(``scripts/physics/lj_potential_energy.f90:46-225``): given wrapped positions
in a cubic periodic box, produce

  a        (N, 3) accelerations (= forces, m = 1)
  epot     total potential energy  U = 4 sum_{i<j} (r^-12 - r^-6)  [+ tail]
  d_epot   24 sum_{i<j} (-2 r^-12 + r^-6) = sum_{i<j} r dU/dr      [+ tail]
  dd_epot  24 sum_{i<j} (26 r^-12 - 7 r^-6) = sum r^2 d2U/dr2      [+ tail]

with minimum-image convention, sharp cutoff at rc, and optional mean-field
tail corrections assuming g(r) = 1 beyond rc
(``lj_potential_energy.f90:205-223``).

Design (vs. the reference's i<j scalar loop with Newton's-3rd-law scatter,
which does not vectorize): we sweep the FULL N x N pair matrix as
per-component (N, N) elementwise arrays, mask the
diagonal and the cutoff, and halve the symmetric scalar sums. Forces need no
halving: F_i = sum_j f_ij over the full row, and the antisymmetry that the
reference exploits via scatter is free here. This costs 2x the FLOPs of the
triangular loop but is the idiomatic data-parallel form (SURVEY §7 "Hard
parts"). This dense version is the correctness oracle and the small-N
path; the neighbor-list and pencil engines reuse ``_pair_terms``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ljmd_tpu.ops.geometry import minimum_image

__all__ = [
    "LJResult",
    "tail_corrections",
    "lj_force_energy_dense",
    "lj_potential_dense",
]

PI = 3.14159265358979323846


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LJResult:
    a: jax.Array        # (N, 3) accelerations
    epot: jax.Array     # scalar
    d_epot: jax.Array   # scalar
    dd_epot: jax.Array  # scalar


def tail_corrections(n: int, volume: float, rc: float) -> Tuple[float, float, float]:
    """Mean-field tail corrections for (epot, d_epot, dd_epot).

    Mirrors ``lj_potential_energy.f90:205-212``:
      tail_factor = 8 pi N^2 / (V rc^3)
      epot_tail   = tail_factor * (1/(3 rc^6) - 1) / 3
      d_tail      = 2 tail_factor * (-2/(3 rc^6) + 1)
      dd_tail     = 2 tail_factor * (26/(3 rc^6) - 7)

    Computed in Python floats (full f64 precision) since they are static.
    """
    rc3 = rc**3
    rc6 = rc3 * rc3
    tail_factor = 8.0 * PI * (n * n) / (volume * rc3)
    epot_tail = tail_factor * ((1.0 / (3.0 * rc6)) - 1.0) / 3.0
    d_tail = 2.0 * tail_factor * (-2.0 / (3.0 * rc6) + 1.0)
    dd_tail = 2.0 * tail_factor * (26.0 / (3.0 * rc6) - 7.0)
    return epot_tail, d_tail, dd_tail


def _pair_terms(r2, mask, dtype):
    """Shared per-pair LJ algebra on squared distances.

    Returns (pair_epot, dU_r, pair_ddU, inv_r2), each masked to zero outside
    the cutoff/off-diagonal mask. Prefactors (4 for energy, 24 for the rest)
    are NOT applied here, matching the reference's strategy of restoring them
    after the loop (lj_potential_energy.f90:105-107,188-193).
    """
    one = jnp.asarray(1.0, dtype)
    r2_safe = jnp.where(mask, r2, one)
    inv_r2 = jnp.where(mask, one / r2_safe, 0.0)
    inv_r6 = inv_r2 * inv_r2 * inv_r2
    inv_r12 = inv_r6 * inv_r6
    pair_epot = inv_r12 - inv_r6                  # U/4 per pair
    dU_r = -2.0 * inv_r12 + inv_r6                # (r dU/dr)/24 per pair
    pair_ddU = 26.0 * inv_r12 - 7.0 * inv_r6      # (r^2 d2U/dr2)/24 per pair
    return pair_epot, dU_r, pair_ddU, inv_r2


def lj_force_energy_dense(
    r: jax.Array,
    box_length,
    rc_square,
    use_tail_corrections: bool = True,
    volume: float | None = None,
    rc: float | None = None,
) -> LJResult:
    """Dense all-pairs LJ forces + energy + virial sums.

    Args:
      r: (N, 3) wrapped positions.
      box_length, rc_square: static floats (box edge L, cutoff squared).
      use_tail_corrections: add the analytic tail terms (requires volume, rc).
    """
    n = r.shape[-2]
    dtype = r.dtype
    inv_l = 1.0 / box_length

    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    dx = minimum_image(x[..., :, None] - x[..., None, :], box_length, inv_l)
    dy = minimum_image(y[..., :, None] - y[..., None, :], box_length, inv_l)
    dz = minimum_image(z[..., :, None] - z[..., None, :], box_length, inv_l)
    r2 = dx * dx + dy * dy + dz * dz

    eye = jnp.eye(n, dtype=bool)
    mask = jnp.logical_and(r2 < jnp.asarray(rc_square, dtype), ~eye)

    pair_epot, dU_r, pair_ddU, inv_r2 = _pair_terms(r2, mask, dtype)

    # Symmetric scalar sums: full-matrix sum double counts i<j -> halve, then
    # restore prefactors (4 energy, 24 derivatives; lj_potential_energy.f90:188-193).
    epot = 2.0 * jnp.sum(pair_epot)      # 4 * (1/2)
    d_epot = 12.0 * jnp.sum(dU_r)        # 24 * (1/2)
    dd_epot = 12.0 * jnp.sum(pair_ddU)   # 24 * (1/2)

    # Forces: f_ij = -(dU_r) * dr_vec * inv_r2 (prefactor 24 restored);
    # F_i = sum_j f_ij over the full row (no double counting for vectors).
    coef = -dU_r * inv_r2
    ax = jnp.sum(coef * dx, axis=-1)
    ay = jnp.sum(coef * dy, axis=-1)
    az = jnp.sum(coef * dz, axis=-1)
    a = 24.0 * jnp.stack([ax, ay, az], axis=-1)

    if use_tail_corrections:
        if volume is None or rc is None:
            raise ValueError("tail corrections require volume and rc")
        e_t, d_t, dd_t = tail_corrections(n, volume, rc)
        epot = epot + jnp.asarray(e_t, dtype)
        d_epot = d_epot + jnp.asarray(d_t, dtype)
        dd_epot = dd_epot + jnp.asarray(dd_t, dtype)

    return LJResult(a=a, epot=epot, d_epot=d_epot, dd_epot=dd_epot)


def lj_potential_dense(
    r: jax.Array,
    box_length,
    rc_square,
    use_tail_corrections: bool = True,
    volume: float | None = None,
    rc: float | None = None,
) -> jax.Array:
    """Potential energy only, differentiable: ``-grad(lj_potential_dense)``
    must equal the forces from ``lj_force_energy_dense`` (the force-is-minus-
    gradient oracle, SURVEY §4 test (d))."""
    n = r.shape[-2]
    dtype = r.dtype
    inv_l = 1.0 / box_length

    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    dx = minimum_image(x[..., :, None] - x[..., None, :], box_length, inv_l)
    dy = minimum_image(y[..., :, None] - y[..., None, :], box_length, inv_l)
    dz = minimum_image(z[..., :, None] - z[..., None, :], box_length, inv_l)
    r2 = dx * dx + dy * dy + dz * dz

    eye = jnp.eye(n, dtype=bool)
    mask = jnp.logical_and(r2 < jnp.asarray(rc_square, dtype), ~eye)
    pair_epot, _, _, _ = _pair_terms(r2, mask, dtype)
    epot = 2.0 * jnp.sum(pair_epot)

    if use_tail_corrections:
        if volume is None or rc is None:
            raise ValueError("tail corrections require volume and rc")
        e_t, _, _ = tail_corrections(n, volume, rc)
        epot = epot + jnp.asarray(e_t, dtype)
    return epot


def lj_from_config(r: jax.Array, cfg) -> LJResult:
    """Convenience wrapper taking a ``SimConfig``."""
    return lj_force_energy_dense(
        r,
        box_length=cfg.box_length,
        rc_square=cfg.rc_square,
        use_tail_corrections=cfg.use_tail_corrections,
        volume=cfg.volume,
        rc=cfg.rc,
    )
