"""Force-backend dispatch.

The framework has two stateless implementations of the same LJ
force/energy/virial contract (reference kernel ``lj_potential_energy.f90:46``):

- ``dense``    : all-pairs jnp sweep (``ops/lj.py``) — the correctness
                 oracle and the small-N path.
- ``neighbor`` : Verlet-list gather kernel (``ops/neighbor.py``), built per
                 call here; the production engine (``models/engine.py``)
                 keeps the list in its carry instead.
- ``auto``     : dense (the engines pick the neighbor list and the pencil
                 sweep by N, ``models/engine.auto_backend``).

Every backend returns an ``LJResult`` with identical semantics (including
tail corrections), so integrators, drivers, and tests are backend-agnostic.
"""

from __future__ import annotations

from typing import Callable

import jax

from ljmd_tpu.config import SimConfig
from ljmd_tpu.ops.lj import LJResult, lj_force_energy_dense

__all__ = ["make_force_fn", "FORCE_BACKENDS"]

FORCE_BACKENDS = ("auto", "dense", "neighbor")


def _dense_fn(cfg: SimConfig) -> Callable[[jax.Array], LJResult]:
    def force(r: jax.Array) -> LJResult:
        return lj_force_energy_dense(
            r,
            box_length=cfg.box_length,
            rc_square=cfg.rc_square,
            use_tail_corrections=cfg.use_tail_corrections,
            volume=cfg.volume,
            rc=cfg.rc,
        )

    return force


def make_force_fn(cfg: SimConfig, backend: str = "auto") -> Callable[[jax.Array], LJResult]:
    if backend not in FORCE_BACKENDS:
        raise ValueError(f"unknown force backend {backend!r}; expected one of {FORCE_BACKENDS}")

    if backend == "neighbor":
        # Build-per-call neighbor force: correct but wasteful (the production
        # path amortizes builds via the engine carry — models/engine.py).
        from ljmd_tpu.ops.neighbor import (
            build_neighbor_list_dense,
            estimate_capacity,
            lj_force_energy_neighbor,
        )

        r_list = cfg.rc + cfg.neighbor_skin
        capacity = cfg.neighbor_capacity or estimate_capacity(cfg.density, r_list)

        def neighbor_force(r: jax.Array) -> LJResult:
            nbrs = build_neighbor_list_dense(r, cfg.box_length, r_list * r_list, capacity)
            return lj_force_energy_neighbor(
                r,
                nbrs.idx,
                box_length=cfg.box_length,
                rc_square=cfg.rc_square,
                use_tail_corrections=cfg.use_tail_corrections,
                volume=cfg.volume,
                rc=cfg.rc,
            )

        return neighbor_force

    return _dense_fn(cfg)
