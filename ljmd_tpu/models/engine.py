"""Engine abstraction: a (carry, step) pair for the MD time loop.

The dense backend is a pure function of positions, so its scan carry is just
the MDState. The neighbor-list backend keeps a Verlet list in the carry and
rebuilds it (inside ``lax.cond``) whenever a particle has moved more than
skin/2 since the last build. The pencil backend (``parallel/spatial_pencil``)
keeps particles binned into cell columns. The drivers
(``models/simulation.py``) are written against this interface, so every
backend gets the same sampling cadence, statistics, and artifacts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ljmd_tpu.config import SimConfig
from ljmd_tpu.models.forces import make_force_fn
from ljmd_tpu.ops.geometry import minimum_image, wrap_positions
from ljmd_tpu.ops.neighbor import (
    build_neighbor_list_dense,
    estimate_capacity,
    lj_force_energy_neighbor,
    needs_rebuild,
)
from ljmd_tpu.state import MDState, StepObs, kinetic_energy

__all__ = ["Engine", "make_engine", "auto_backend", "PENCIL_MIN_N"]

# Smallest N that ``auto`` sends to the pencil engine instead of the neighbor
# list. The neighbor build materialises N x N arrays and sorts every row, so
# its memory grows as N^2; the pencil engine's grows as N. Set from the
# neighbor-vs-pencil measurement recorded in PERF.md (on an H100 the two tie
# at N=4000 and the pencil engine is 1.7x faster at N=6912).
PENCIL_MIN_N = 5000


class Engine(NamedTuple):
    """init(state) -> (carry, obs at t=0); step(carry) -> (carry, obs);
    get_state(carry) -> MDState; diagnostics(carry) -> dict of arrays.
    ``step_fast`` advances WITHOUT needing the energy/virial observables
    (its obs may be garbage) — drivers use it for the un-sampled steps
    between samples. ``run_fast(carry, n_steps)`` (n_steps static), when not
    None, advances n_steps observable-free steps in larger chunks; its
    trajectory is numerically equivalent to n_steps x step_fast but not
    necessarily bit-identical."""

    init: Callable[[MDState], tuple[Any, StepObs]]
    step: Callable[[Any], tuple[Any, StepObs]]
    get_state: Callable[[Any], MDState]
    diagnostics: Callable[[Any], dict]
    step_fast: Callable[[Any], tuple[Any, StepObs]] = None
    run_fast: Callable[[Any, int], Any] = None


def _effective_dtype(cfg: SimConfig) -> jnp.dtype:
    """The dtype arrays ACTUALLY get. A float64 config silently truncates to
    float32 when x64 is disabled — the precision policy (compensated
    summation) must follow the real dtype, not the requested one, or a
    dt=1e-4 "f64" run silently integrates in plain f32."""
    dt = jnp.dtype(cfg.dtype)
    if dt == jnp.float64 and not jax.config.jax_enable_x64:
        return jnp.dtype(jnp.float32)
    return dt


def _compensated(cfg: SimConfig) -> bool:
    """Precision policy shared by every engine: f32 at dt <= 1e-3 loses most
    of the velocity-increment bits per step, so positions and velocities
    get Neumaier-compensated updates there (or whenever the config asks).
    f64 increments do not underflow."""
    return (cfg.compensated_sum or cfg.dt <= 1.0e-3) and (
        _effective_dtype(cfg) == jnp.float32
    )


def _comp_add(x: jax.Array, c: jax.Array, delta: jax.Array):
    """Neumaier-compensated x += delta: returns (new_x, new_c) with c
    accumulating the rounding error, so x + c tracks the exact sum."""
    y = delta + c
    t = x + y
    # recovered low bits: (x - t) + y when |x| >= |y|; Neumaier's branchless
    # variant picks the larger-magnitude operand.
    big_x = jnp.abs(x) >= jnp.abs(y)
    c_new = jnp.where(big_x, (x - t) + y, (y - t) + x)
    return t, c_new


def _jnp_engine(cfg: SimConfig, backend: str) -> Engine:
    """Dense (``backend="dense"``) or Verlet-list (``"neighbor"``) engine.

    Carry: ``(state, nbrs, comp)`` — ``nbrs`` is the NeighborList (None for
    dense) and ``comp`` the (position, velocity) compensation terms (None
    unless the precision policy compensates)."""
    L = cfg.box_length
    dt = cfg.dt
    compensated = _compensated(cfg)

    if backend == "dense":
        force_fn = make_force_fn(cfg, "dense")

        def force(r, nbrs):
            return force_fn(r), None

        def maybe_rebuild(r, nbrs):
            return None
    else:
        skin = cfg.neighbor_skin
        r_list = cfg.rc + skin
        if not r_list < 0.5 * L:
            raise ValueError(
                f"rc + skin = {r_list} must stay below L/2 = {0.5 * L} for MIC "
                "(shrink neighbor_skin or use the dense backend)"
            )
        capacity = cfg.neighbor_capacity or estimate_capacity(cfg.density, r_list)

        def build(r):
            return build_neighbor_list_dense(r, L, r_list * r_list, capacity)

        def force(r, nbrs):
            nbrs = build(r) if nbrs is None else nbrs
            return lj_force_energy_neighbor(
                r, nbrs.idx, box_length=L, rc_square=cfg.rc_square,
                use_tail_corrections=cfg.use_tail_corrections,
                volume=cfg.volume, rc=cfg.rc,
            ), nbrs

        def maybe_rebuild(r, nbrs):
            new = lax.cond(needs_rebuild(nbrs, r, L, skin), build, lambda _: nbrs, r)
            # overflow is sticky: a list that ever overflowed taints the run
            return dataclasses.replace(new, overflow=new.overflow | nbrs.overflow)

    def init(state: MDState):
        res, nbrs = force(state.r, None)
        obs = StepObs(res.epot, kinetic_energy(state.v), res.d_epot, res.dd_epot)
        comp = (jnp.zeros_like(state.r), jnp.zeros_like(state.v)) if compensated else None
        return (MDState(state.r, state.ru, state.v, res.a), nbrs, comp), obs

    def step(carry):
        """Velocity Verlet (verlet.f90:58-95) plus the unwrap update
        (md_simulation_program.f90:339-353)."""
        state, nbrs, comp = carry
        drift = state.v * dt + state.a * (0.5 * dt * dt)
        kick = state.a * (0.5 * dt)
        if compensated:
            r_raw, rc = _comp_add(state.r, comp[0], drift)
            v_half, vc = _comp_add(state.v, comp[1], kick)
        else:
            r_raw, v_half = state.r + drift, state.v + kick
        r_new = wrap_positions(r_raw, L)
        if nbrs is not None:
            nbrs = maybe_rebuild(r_new, nbrs)
        res, nbrs = force(r_new, nbrs)
        if compensated:
            v_new, vc = _comp_add(v_half, vc, res.a * (0.5 * dt))
            ekin = kinetic_energy(v_new + vc)
            comp = (rc, vc)
        else:
            v_new = v_half + res.a * (0.5 * dt)
            ekin = kinetic_energy(v_new)
        ru_new = state.ru + minimum_image(r_new - state.r, L)
        new_state = MDState(r=r_new, ru=ru_new, v=v_new, a=res.a)
        return (new_state, nbrs, comp), StepObs(res.epot, ekin, res.d_epot, res.dd_epot)

    def get_state(carry) -> MDState:
        state, _, comp = carry
        if comp is None:
            return state
        return MDState(r=state.r, ru=state.ru, v=state.v + comp[1], a=state.a)

    def diagnostics(carry) -> dict:
        nbrs = carry[1]
        return {} if nbrs is None else {"neighbor_overflow": nbrs.overflow}

    return Engine(
        init=init, step=step, get_state=get_state,
        diagnostics=diagnostics, step_fast=step,
    )


def _pencil_viable(cfg: SimConfig) -> bool:
    """The pencil grid needs >= 3 columns of width rc + skin per side."""
    return cfg.box_length // (cfg.rc + cfg.neighbor_skin) >= 3


def auto_backend(cfg: SimConfig) -> str:
    """The engine ``auto`` picks: dense below 1024 particles or when the
    neighbor radius does not fit the box, the neighbor list up to
    ``PENCIL_MIN_N``, the pencil engine above it."""
    r_list = cfg.rc + cfg.neighbor_skin
    if cfg.n < 1024 or not r_list < 0.5 * cfg.box_length:
        return "dense"
    if cfg.n >= PENCIL_MIN_N and _pencil_viable(cfg):
        return "cellpair"
    # the list pays off only when the cutoff sphere is small next to the box
    if estimate_capacity(cfg.density, r_list) < cfg.n // 8:
        return "neighbor"
    return "dense"


def make_engine(cfg: SimConfig, backend: str = "auto", state=None) -> Engine:
    """Build the force/integration engine for ``cfg``.

    ``state`` (optional MDState): a representative configuration — e.g. the
    post-warmup state a production driver already holds. When the routing
    lands on the pencil engine and ``cfg.neighbor_capacity`` is unset, the
    pencil capacity is sized from this state's occupancy census
    (``capacity_from_state``) instead of the lattice-based bound, which
    must cover the FCC starting lattice's pencil aliasing. Occupancy drift
    past the census capacity trips the engine's sticky overflow diagnostic —
    detected, never silent.
    """
    if backend == "auto":
        backend = auto_backend(cfg)
    if backend in ("dense", "neighbor"):
        return _jnp_engine(cfg, backend)
    if backend != "cellpair":
        raise ValueError(
            f"unknown backend {backend!r}; expected auto, dense, neighbor or cellpair"
        )
    from ljmd_tpu.parallel.spatial_pencil import make_pencil_engine

    # The census needs CONCRETE positions: under a trace (e.g. the vmapped
    # ensemble calls run_production on tracer states) keep the lattice-based
    # default rather than crashing on np.asarray(tracer).
    if (
        state is not None
        and not cfg.neighbor_capacity
        and not isinstance(state.r, jax.core.Tracer)
    ):
        from ljmd_tpu.ops.cell_list import capacity_from_state

        cap = capacity_from_state(cfg.box_length, cfg.rc + cfg.neighbor_skin, state.r)
        cfg = dataclasses.replace(cfg, neighbor_capacity=cap)
    return make_pencil_engine(cfg)
