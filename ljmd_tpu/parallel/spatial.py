"""Particle-axis (spatial) sharding of the pair sweep over a device mesh.

Multi-device mode (SURVEY §5.7/§5.8): the i-axis of the N x N pair matrix
is sharded over the mesh's "particle" axis. Three comm strategies:

- ``half_ring`` (default): PAIR-ONCE force decomposition — triangular self
  block, floor((d-1)/2) rect-Newton ring hops (j blocks and their traveling
  reaction accumulators rotate via ``lax.ppermute``), a gated complementary-
  half hop for even d, and one final permute returning reactions to their
  owners. Exactly N^2/2 pair evaluations across the mesh (the ordered-pair
  ring did 2x that).
- ``ring``: ordered-pair j-block rotation (kept for comparison/fallback).
- ``all_gather``: replicate positions per device (tests/oracle).

Scalar energy/virial sums are ``psum``-reduced. This is the ring-attention-
shaped decomposition of pair interactions, expressed with XLA collectives
instead of hand-written NCCL (the reference has no distribution at all — its
ensemble is a serial do-loop, ``run_many_md_simuations/run_many_md.f90:57-82``).

All functions here are written for ``shard_map`` bodies: they see LOCAL
shards and use ``jax.lax`` collectives explicitly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ljmd_tpu.config import SimConfig
from ljmd_tpu.models.engine import _comp_add, _compensated, _effective_dtype
from ljmd_tpu.ops.geometry import minimum_image, wrap_positions
from ljmd_tpu.ops.lj import _pair_terms, tail_corrections
from ljmd_tpu.parallel.mesh import PARTICLE_AXIS
from ljmd_tpu.state import MDState, StepObs

__all__ = [
    "lj_rect_partials",
    "lj_rect_partials_newton",
    "make_spatial_engine",
    "make_spatial_step_fn",
    "shard_state",
    "spatial_state_specs",
]


def lj_rect_partials(
    r_local: jax.Array,
    r_all: jax.Array,
    gi_offset,
    box_length: float,
    rc_square: float,
    gj_offset=0,
):
    """Rectangular pair sweep: local i rows (ni, 3) against a j block
    (nj, 3) whose global indices start at ``gj_offset``.

    Returns (a_local (ni,3), e_sum, du_sum, ddu_sum) where the scalar sums
    run over ordered pairs (i local, j any, i != j) WITHOUT prefactors; the
    caller restores prefactors, halves the double count after psum, and adds
    tail corrections. Self-pairs are excluded by global index
    (gi = gi_offset + row).
    """
    ni = r_local.shape[0]
    nj = r_all.shape[0]
    dtype = r_local.dtype
    inv_l = 1.0 / box_length

    xi, yi, zi = (r_local[:, k][:, None] for k in range(3))
    xj, yj, zj = (r_all[:, k][None, :] for k in range(3))
    dx = minimum_image(xi - xj, box_length, inv_l)
    dy = minimum_image(yi - yj, box_length, inv_l)
    dz = minimum_image(zi - zj, box_length, inv_l)
    r2 = dx * dx + dy * dy + dz * dz

    gi = gi_offset + lax.broadcasted_iota(jnp.int32, (ni, nj), 0)
    gj = gj_offset + lax.broadcasted_iota(jnp.int32, (ni, nj), 1)
    mask = jnp.logical_and(r2 < jnp.asarray(rc_square, dtype), gi != gj)

    pair_e, du_r, pair_ddu, inv_r2 = _pair_terms(r2, mask, dtype)
    coef = -du_r * inv_r2
    a_local = jnp.stack(
        [jnp.sum(coef * dx, axis=1), jnp.sum(coef * dy, axis=1), jnp.sum(coef * dz, axis=1)],
        axis=-1,
    )
    return a_local, jnp.sum(pair_e), jnp.sum(du_r), jnp.sum(pair_ddu)


def lj_rect_partials_newton(
    r_local: jax.Array,
    r_j: jax.Array,
    gi_offset,
    gj_offset,
    box_length: float,
    rc_square: float,
    i_lo=0,
    j_hi=None,
    triangular: bool = False,
):
    """Pair-ONCE rect sweep with Newton's-3rd-law reactions: local i rows
    (ni, 3) against a j block (nj, 3), each pair in the active range
    [i_lo, ni) x [0, j_hi) evaluated once.

    Returns (a_i (ni,3), a_j (nj,3), e, du, ddu): i-side forces, j-side
    reaction forces (both WITHOUT the 24 prefactor), and pair-once scalar
    partials (totals restore with prefactors 4/24, NO halving).
    ``triangular=True`` additionally masks to gj > gi (the self-block cover).
    """
    ni = r_local.shape[0]
    nj = r_j.shape[0]
    dtype = r_local.dtype
    inv_l = 1.0 / box_length
    if j_hi is None:
        j_hi = nj

    xi, yi, zi = (r_local[:, k][:, None] for k in range(3))
    xj, yj, zj = (r_j[:, k][None, :] for k in range(3))
    dx = minimum_image(xi - xj, box_length, inv_l)
    dy = minimum_image(yi - yj, box_length, inv_l)
    dz = minimum_image(zi - zj, box_length, inv_l)
    r2 = dx * dx + dy * dy + dz * dz

    li = lax.broadcasted_iota(jnp.int32, (ni, nj), 0)
    lj_ = lax.broadcasted_iota(jnp.int32, (ni, nj), 1)
    gi = gi_offset + li
    gj = gj_offset + lj_
    mask = (
        (r2 < jnp.asarray(rc_square, dtype))
        & (gi != gj)
        & (li >= jnp.asarray(i_lo, jnp.int32))
        & (lj_ < jnp.asarray(j_hi, jnp.int32))
    )
    if triangular:
        mask = mask & (gj > gi)

    pair_e, du_r, pair_ddu, inv_r2 = _pair_terms(r2, mask, dtype)
    coef = -du_r * inv_r2
    fx, fy, fz = coef * dx, coef * dy, coef * dz
    a_i = jnp.stack(
        [jnp.sum(fx, axis=1), jnp.sum(fy, axis=1), jnp.sum(fz, axis=1)], axis=-1
    )
    a_j = -jnp.stack(
        [jnp.sum(fx, axis=0), jnp.sum(fy, axis=0), jnp.sum(fz, axis=0)], axis=-1
    )
    return a_i, a_j, jnp.sum(pair_e), jnp.sum(du_r), jnp.sum(pair_ddu)


def spatial_state_specs():
    """PartitionSpecs for an MDState sharded on the particle axis."""
    p = P(PARTICLE_AXIS, None)
    return MDState(r=p, ru=p, v=p, a=p)


def shard_state(state: MDState, mesh: Mesh) -> MDState:
    """Place a host/global MDState with particle-axis sharding."""
    spec = spatial_state_specs()
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, spec,
        is_leaf=lambda x: isinstance(x, P),
    )


def _ring_partials(
    r_local: jax.Array,
    axis: str,
    n_shards: int,
    box_length: float,
    rc_square: float,
):
    """Ring-pass j-block pair sweep (SURVEY §5.8/§7 design): instead of
    replicating all positions per device (``all_gather``, O(N) memory per
    chip), each device keeps an (N/d, 3) j block that rotates around the
    ring via ``lax.ppermute`` — after d-1 hops every i shard has seen every
    j block, with peak per-chip j storage O(N/d). This is the ring-attention
    communication pattern applied to pair interactions; XLA overlaps the
    permute with the local tile sweep.

    Returns (a_local_raw (ni,3) WITHOUT the 24 prefactor, e, du, ddu partial
    sums over ordered pairs (i local, j anywhere, i != j))."""
    ni = r_local.shape[0]
    dtype = r_local.dtype
    my = lax.axis_index(axis)
    gi0 = my * ni
    # ring: each device forwards its current j block to the next neighbor
    perm = [(s, (s + 1) % n_shards) for s in range(n_shards)]

    r_j = r_local
    a_loc = jnp.zeros((ni, 3), dtype)
    e = jnp.zeros((), dtype)
    du = jnp.zeros((), dtype)
    ddu = jnp.zeros((), dtype)
    for s in range(n_shards):
        gj0 = ((my - s) % n_shards) * ni
        a_b, e_b, du_b, ddu_b = lj_rect_partials(
            r_local, r_j, gi0, box_length, rc_square, gj_offset=gj0
        )
        a_loc = a_loc + a_b
        e = e + e_b
        du = du + du_b
        ddu = ddu + ddu_b
        if s + 1 < n_shards:
            r_j = lax.ppermute(r_j, axis, perm)
    return a_loc, e, du, ddu


def _half_ring_partials(
    r_local: jax.Array,
    axis: str,
    n_shards: int,
    box_length: float,
    rc_square: float,
):
    """PAIR-ONCE half-ring force decomposition (classic
    force-decomposition MD): the full ring computed every ordered
    pair — 2x the pair work. Here each unordered pair is evaluated once:

    - self block: triangular cover (gj > gi) with in-kernel Newton reactions;
    - hops h = 1..floor((d-1)/2): full rect Newton sweep against the visiting
      block (s - h) — block b is visited by i-shards b+1..b+H, so every
      cross-block pair at ring distance <= H is covered exactly once;
    - even d only, hop d/2: the block pair {s, s+d/2} is seen from BOTH ends,
      so the two devices sweep complementary halves keyed on the LOW block's
      particle index (low device: i rows >= ni/2; high device: j cols
      < ni/2) — each pair once, each device half the block work.

    The j-side reaction partials travel WITH the visiting block (the ppermute
    carries (pos_j, f_acc_j) together) and return to their owner shard in one
    final permute. Scalar sums are pair-once: callers restore prefactors
    4/24 with NO halving. Total pair work across the mesh is exactly N^2/2,
    balanced per device (self half-block + H full + possibly one half).

    Returns (a_local_raw (ni,3) WITHOUT the 24 prefactor, e, du, ddu)."""
    ni = r_local.shape[0]
    dtype = r_local.dtype
    d = n_shards
    my = lax.axis_index(axis)
    gi0 = my * ni
    h_full = (d - 1) // 2
    has_half = d % 2 == 0 and d > 1
    total_hops = h_full + (1 if has_half else 0)
    perm_fwd = [(s, (s + 1) % d) for s in range(d)]
    half = ni // 2

    def _hop_ranges(h):
        if has_half and h == total_hops:
            is_low = my < (d // 2)
            return (
                jnp.where(is_low, half, 0),
                jnp.where(is_low, ni, half),
            )
        return jnp.asarray(0, jnp.int32), jnp.asarray(ni, jnp.int32)

    a_i, a_j, e, du, ddu = lj_rect_partials_newton(
        r_local, r_local, gi0, gi0, box_length, rc_square, triangular=True
    )
    a_loc = a_i + a_j
    r_j = r_local
    facc = jnp.zeros((ni, 3), dtype)
    for h in range(1, total_hops + 1):
        r_j = lax.ppermute(r_j, axis, perm_fwd)
        facc = lax.ppermute(facc, axis, perm_fwd)
        gj0 = ((my - h) % d) * ni
        i_lo, j_hi = _hop_ranges(h)
        a_b, aj_b, e_b, du_b, ddu_b = lj_rect_partials_newton(
            r_local, r_j, gi0, gj0, box_length, rc_square, i_lo=i_lo, j_hi=j_hi
        )
        a_loc = a_loc + a_b
        facc = facc + aj_b
        e = e + e_b
        du = du + du_b
        ddu = ddu + ddu_b
    if total_hops:
        perm_back = [(s, (s - total_hops) % d) for s in range(d)]
        a_loc = a_loc + lax.ppermute(facc, axis, perm_back)
    return a_loc, e, du, ddu


def _make_local_step(
    cfg: SimConfig,
    axis: str,
    n_shards: int = 0,
    comm: str = "half_ring",
):
    """The shard-local velocity-Verlet step body (one particle shard).

    comm="ring": ppermute ring exchange of j blocks (O(N/d) per-chip memory);
    comm="all_gather": replicate positions per device (kept as
    the oracle for tests).

    Precision follows the single-device engines (``engine._compensated``):
    the policy keys on the EFFECTIVE dtype, and f32 at dt <= 1e-3 gets
    Neumaier-compensated updates. When compensated, ``step_local`` takes/returns
    ``(state, rc, vc)`` instead of a bare MDState; callers check the
    ``step_local.compensated`` attribute."""
    dtype = _effective_dtype(cfg)
    compensated = _compensated(cfg)
    dt = cfg.dt
    half_dt = 0.5 * cfg.dt
    half_dt_sq = 0.5 * cfg.dt * cfg.dt
    L = cfg.box_length

    e_t, d_t, dd_t = (
        tail_corrections(cfg.n, cfg.volume, cfg.rc)
        if cfg.use_tail_corrections
        else (0.0, 0.0, 0.0)
    )

    def local_force(r_local, want_obs: bool = True):
        pair_once = comm == "half_ring"
        if comm == "half_ring":
            a_raw, e, du, ddu = _half_ring_partials(
                r_local, axis, n_shards, L, cfg.rc_square,
            )
        elif comm == "ring":
            a_raw, e, du, ddu = _ring_partials(
                r_local, axis, n_shards, L, cfg.rc_square,
            )
        elif comm == "all_gather":
            r_all = lax.all_gather(r_local, axis, axis=0, tiled=True)
            gi0 = lax.axis_index(axis) * r_local.shape[0]
            a_raw, e, du, ddu = lj_rect_partials(r_local, r_all, gi0, L, cfg.rc_square)
        else:
            raise ValueError(f"unknown comm {comm!r}")
        if not want_obs:
            # fast path (run_fast chunk interiors): the psums and prefactor
            # math are dead.
            zero = jnp.zeros((), dtype)
            return 24.0 * a_raw, zero, zero, zero
        e = lax.psum(e, axis)
        du = lax.psum(du, axis)
        ddu = lax.psum(ddu, axis)
        if pair_once:
            epot = 4.0 * e + jnp.asarray(e_t, dtype)
            d_epot = 24.0 * du + jnp.asarray(d_t, dtype)
            dd_epot = 24.0 * ddu + jnp.asarray(dd_t, dtype)
        else:
            epot = 2.0 * e + jnp.asarray(e_t, dtype)      # 4 * (1/2) + tail
            d_epot = 12.0 * du + jnp.asarray(d_t, dtype)
            dd_epot = 12.0 * ddu + jnp.asarray(dd_t, dtype)
        return 24.0 * a_raw, epot, d_epot, dd_epot

    if compensated:
        def step_local(state: MDState, rc: jax.Array, vc: jax.Array):
            # Same update order and wrap handling as the single-device
            # engines' compensated step (models/engine.py) so sharded and
            # single-device compensated trajectories are comparable.
            r_raw, rc_new = _comp_add(state.r, rc, state.v * dt + state.a * half_dt_sq)
            r_new = wrap_positions(r_raw, L)
            v_half, vc_half = _comp_add(state.v, vc, state.a * half_dt)
            a_new, epot, d_epot, dd_epot = local_force(r_new)
            v_new, vc_new = _comp_add(v_half, vc_half, a_new * half_dt)
            v_eff = v_new + vc_new
            ekin = lax.psum(0.5 * jnp.sum(v_eff * v_eff), axis)
            ru_new = state.ru + minimum_image(r_new - state.r, L)
            new_state = MDState(r=r_new, ru=ru_new, v=v_new, a=a_new)
            return (new_state, rc_new, vc_new), StepObs(
                epot=epot, ekin=ekin, d_epot=d_epot, dd_epot=dd_epot
            )

        def init_local(state: MDState, rc: jax.Array, vc: jax.Array):
            a_new, epot, d_epot, dd_epot = local_force(state.r)
            ekin = lax.psum(0.5 * jnp.sum(state.v * state.v), axis)
            new_state = MDState(r=state.r, ru=state.ru, v=state.v, a=a_new)
            return (new_state, rc, vc), StepObs(
                epot=epot, ekin=ekin, d_epot=d_epot, dd_epot=dd_epot
            )

        def fast_local(state: MDState, rc: jax.Array, vc: jax.Array):
            """Obs-free step for run_fast chunk interiors: identical
            trajectory (the fast/obs coefficient bit-identity contract,
            tests/test_pair_terms.py), no ekin psum, no obs rows."""
            r_raw, rc_new = _comp_add(state.r, rc, state.v * dt + state.a * half_dt_sq)
            r_new = wrap_positions(r_raw, L)
            v_half, vc_half = _comp_add(state.v, vc, state.a * half_dt)
            a_new, _e, _du, _ddu = local_force(r_new, want_obs=False)
            v_new, vc_new = _comp_add(v_half, vc_half, a_new * half_dt)
            ru_new = state.ru + minimum_image(r_new - state.r, L)
            return (MDState(r=r_new, ru=ru_new, v=v_new, a=a_new), rc_new, vc_new)
    else:
        def step_local(state: MDState):
            r_new = wrap_positions(state.r + state.v * dt + state.a * half_dt_sq, L)
            v_half = state.v + state.a * half_dt
            a_new, epot, d_epot, dd_epot = local_force(r_new)
            v_new = v_half + a_new * half_dt
            ekin = lax.psum(0.5 * jnp.sum(v_new * v_new), axis)
            ru_new = state.ru + minimum_image(r_new - state.r, L)
            new_state = MDState(r=r_new, ru=ru_new, v=v_new, a=a_new)
            return new_state, StepObs(epot=epot, ekin=ekin, d_epot=d_epot, dd_epot=dd_epot)

        def init_local(state: MDState):
            """t=0 force evaluation on the shard (the reference drivers'
            initial force call, md_simulation_program.f90:236)."""
            a_new, epot, d_epot, dd_epot = local_force(state.r)
            ekin = lax.psum(0.5 * jnp.sum(state.v * state.v), axis)
            new_state = MDState(r=state.r, ru=state.ru, v=state.v, a=a_new)
            return new_state, StepObs(epot=epot, ekin=ekin, d_epot=d_epot, dd_epot=dd_epot)

        def fast_local(state: MDState):
            """Obs-free step for run_fast chunk interiors (same trajectory,
            no obs rows in the kernels, no ekin psum)."""
            r_new = wrap_positions(state.r + state.v * dt + state.a * half_dt_sq, L)
            v_half = state.v + state.a * half_dt
            a_new, _e, _du, _ddu = local_force(r_new, want_obs=False)
            v_new = v_half + a_new * half_dt
            ru_new = state.ru + minimum_image(r_new - state.r, L)
            return MDState(r=r_new, ru=ru_new, v=v_new, a=a_new)

    step_local.init_local = init_local
    step_local.fast_local = fast_local
    step_local.compensated = compensated
    return step_local


def make_spatial_step_fn(
    cfg: SimConfig,
    mesh: Mesh,
    axis: str = PARTICLE_AXIS,
    comm: str = "half_ring",
):
    """A velocity-Verlet step over particle shards via shard_map.

    State arrays are sharded (N/d, 3) per device; the force evaluation
    ring-passes j blocks between devices (``comm="ring"``, default; O(N/d) per-chip
    memory) or all-gathers positions (``comm="all_gather"``), and psums the
    scalar observables, which come back replicated. cfg.n must be divisible
    by the axis size.
    """
    n_shards = mesh.shape[axis]
    if cfg.n % n_shards != 0:
        raise ValueError(f"N={cfg.n} not divisible by particle-axis size {n_shards}")

    step_local = _make_local_step(cfg, axis, n_shards, comm=comm)
    spec = spatial_state_specs()
    p = P(PARTICLE_AXIS, None)
    if step_local.compensated:
        in_specs = (spec, p, p)
        out_specs = ((spec, p, p), StepObs(P(), P(), P(), P()))
    else:
        in_specs = (spec,)
        out_specs = (spec, StepObs(P(), P(), P(), P()))
    fn = shard_map(
        step_local,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    fn.compensated = step_local.compensated
    return fn


def make_ensemble_spatial_step_fn(
    cfg: SimConfig,
    mesh: Mesh,
    axis: str = PARTICLE_AXIS,
    comm: str = "half_ring",
):
    """Combined replica x particle sharding: batched MDState arrays
    (R, N, 3) sharded P(replica, particle, None); one velocity-Verlet step
    for every replica. Observables come back per replica, shape (R,).

    This is the full multi-chip production step: ensemble data-parallelism
    over the replica axis, spatial parallelism over the particle axis, all
    collectives (ppermute ring or all_gather, plus psum) riding the mesh.
    """
    from ljmd_tpu.parallel.mesh import REPLICA_AXIS

    n_shards = mesh.shape[axis]
    if cfg.n % n_shards != 0:
        raise ValueError(f"N={cfg.n} not divisible by particle-axis size {n_shards}")

    single_step = _make_local_step(cfg, axis, n_shards, comm=comm)

    spec = MDState(*(P(REPLICA_AXIS, axis, None),) * 4)
    p = P(REPLICA_AXIS, axis, None)
    obs_spec = StepObs(*(P(REPLICA_AXIS),) * 4)
    if single_step.compensated:
        def step_local(state: MDState, rc: jax.Array, vc: jax.Array):
            return jax.vmap(single_step)(state, rc, vc)

        in_specs = (spec, p, p)
        out_specs = ((spec, p, p), obs_spec)
    else:
        def step_local(state: MDState):
            return jax.vmap(single_step)(state)

        in_specs = (spec,)
        out_specs = (spec, obs_spec)
    fn = shard_map(
        step_local,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    fn.compensated = single_step.compensated
    return fn


def make_spatial_engine(
    cfg: SimConfig,
    mesh: Mesh,
    axis: str = PARTICLE_AXIS,
    comm: str = "half_ring",
):
    """Engine-interface wrapper for the particle-sharded step, so the
    standard drivers (run_production / streaming / artifacts) run the
    multi-chip path with the same sampling cadence, means accumulation, and
    file contract as the single-device engines.

    The carry is a particle-sharded MDState; get_state returns it as-is
    (arrays are global jax.Arrays with shardings — fully addressable on a
    single host mesh).
    """
    from ljmd_tpu.models.engine import Engine

    n_shards = mesh.shape[axis]
    if cfg.n % n_shards != 0:
        raise ValueError(f"N={cfg.n} not divisible by particle-axis size {n_shards}")

    step_local = _make_local_step(cfg, axis, n_shards, comm=comm)
    spec = spatial_state_specs()
    obs_spec = StepObs(P(), P(), P(), P())
    p = P(PARTICLE_AXIS, None)

    # Fused multi-step chunks: the whole k-step
    # loop runs INSIDE one shard_map — per-step ring/all_gather exchange and
    # local sweep compile into a single program per device, so the per-step
    # launch + collective dispatch glue does not return at N devices. The
    # rect path has no spatial bins, hence no rebin cadence: one shard_map
    # per run_fast call, lax.scan over the steps inside.
    chunk_fns: dict[int, object] = {}

    def _make_chunk_fn(k: int):
        if step_local.compensated:
            def chunk_local(carry):
                def body(c, _):
                    return step_local.fast_local(*c), None

                c, _ = lax.scan(body, carry, None, length=k)
                return c

            return shard_map(
                chunk_local, mesh=mesh, in_specs=(((spec, p, p)),),
                out_specs=(spec, p, p), check_vma=False,
            )

        def chunk_local(state):
            def body(st, _):
                return step_local.fast_local(st), None

            st, _ = lax.scan(body, state, None, length=k)
            return st

        return shard_map(
            chunk_local, mesh=mesh, in_specs=(spec,), out_specs=spec,
            check_vma=False,
        )

    def run_fast(carry, n_steps: int):
        if n_steps not in chunk_fns:
            chunk_fns[n_steps] = _make_chunk_fn(n_steps)
        return chunk_fns[n_steps](carry)

    if step_local.compensated:
        # Carry = (MDState, rc, vc): the compensated multi-chip step (a
        # dt=1e-4 f32 run must not drift, as on one device).
        in_specs = ((spec, p, p),)
        out_specs = ((spec, p, p), obs_spec)
        step = shard_map(
            lambda c: step_local(*c), mesh=mesh, in_specs=in_specs,
            out_specs=out_specs, check_vma=False,
        )
        init_sharded = shard_map(
            lambda c: step_local.init_local(*c), mesh=mesh, in_specs=in_specs,
            out_specs=out_specs, check_vma=False,
        )

        def init(state: MDState):
            s = shard_state(state, mesh)
            zero = jax.tree.map(jnp.zeros_like, s.r)
            return init_sharded((s, zero, zero))

        def get_state(c):
            state, _rc, vc = c
            return MDState(r=state.r, ru=state.ru, v=state.v + vc, a=state.a)

        return Engine(
            init=init,
            step=step,
            get_state=get_state,
            diagnostics=lambda c: {},
            step_fast=step,
            run_fast=run_fast,
        )

    step = shard_map(
        step_local, mesh=mesh, in_specs=(spec,), out_specs=(spec, obs_spec),
        check_vma=False,
    )
    init_sharded = shard_map(
        step_local.init_local, mesh=mesh, in_specs=(spec,), out_specs=(spec, obs_spec),
        check_vma=False,
    )

    def init(state: MDState):
        return init_sharded(shard_state(state, mesh))

    return Engine(
        init=init,
        step=step,
        get_state=lambda c: c,
        diagnostics=lambda c: {},
        step_fast=step,
        run_fast=run_fast,
    )
