"""Pencil (cell-column) engine: the large-N path, on one device or sharded
over a mesh's particle axis.

- Particles are binned into fixed-capacity pencils — z-columns whose xy
  cross-section is at least rc + skin wide (``ops/cell_list.py``). The slot
  array (8, n_slots) is laid out x-major (pencil p = ix * m + iy, slots
  p*cap..); rows 0..2 hold x/y/z, and in ``r`` row 3 is slot validity and
  row 4 the particle id.
- The sweep is pair-once over a half shell: each pencil against itself
  (rank-ordered pairs) and against its 4 upper xy-neighbors (offsets (0,1),
  (1,-1), (1,0), (1,1)); the reactions on the neighbor pencils are
  scatter-added. Pair work is O(N * 4.5 * capacity) with no neighbor list.
- On a mesh, the slot axis splits into ``d`` strips of m/d x-columns. The
  half shell reaches only the +x column, so each device ``ppermute``-receives
  ONE halo strip (the next device's first x-column), sweeps its own pencils,
  and ``ppermute``s the halo reactions back; scalar observables are
  ``psum``-reduced. Without a mesh the halo is the device's own first column
  (the torus closes on itself) and the collectives are identities — one
  sweep serves the single-device and the sharded engine.
- Rebinning (a packed sort + two gathers, ``ops/cell_list.rebin_gather_parts``)
  runs on the global arrays when a particle has drifted in xy past half the
  geometric slack (pencil width - rc), inside ``lax.cond`` per step or once
  per ``inner_chunk`` steps in ``run_fast``. Capacity overflow and drift past
  the slack between checks set a sticky ``overflow`` flag.

Precision: follows the effective-dtype policy with Neumaier compensation at
f32 dt <= 1e-3, like every engine. Compensated rebins use the two-float wrap
and permute the position compensation rows with the slots.

Reference anchor: the reference's force loop is O(N^2) with no spatial
structure (``lj_potential_energy.f90:97``); this decomposition is new.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ljmd_tpu.config import SimConfig
from ljmd_tpu.models.engine import Engine, _comp_add, _compensated, _effective_dtype
from ljmd_tpu.ops.cell_list import (
    bin_to_slots,
    make_pencil_grid,
    rebin_gather_parts,
)
from ljmd_tpu.ops.geometry import minimum_image, wrap_positions, wrap_positions_ext
from ljmd_tpu.ops.lj import _pair_terms, tail_corrections
from ljmd_tpu.parallel.mesh import PARTICLE_AXIS
from ljmd_tpu.state import MDState, StepObs

__all__ = ["PencilCarry", "make_pencil_engine"]

_HALF_SHELL = ((0, 1), (1, -1), (1, 0), (1, 1))
_PREDICT_SAFETY = 1.25


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PencilCarry:
    """Slot-layout carry, every array (8, n_slots) (sharded on the slot axis
    on a mesh). ``r_ref``: positions at the last rebin (displacement
    criterion); ``rc``/``vc``: Neumaier compensation terms (zeros when off);
    ``counts``: per-pencil occupancy; ``overflow``: sticky capacity /
    displacement diagnostic."""

    r: jax.Array
    ru: jax.Array
    v: jax.Array
    a: jax.Array
    r_ref: jax.Array
    rc: jax.Array
    vc: jax.Array
    counts: jax.Array
    overflow: jax.Array


def _local_half_shell_table(m: int, m_xl: int) -> np.ndarray:
    """(P_loc, 4) int32 neighbor ids in the LOCAL augmented pencil space:
    local pencils 0..P_loc-1 (p = lx * m + iy), halo column pencils
    P_loc..P_loc+m-1 (the next strip's first x-column). Identical on every
    device — the x-major strip layout is translation invariant."""
    p_loc = m_xl * m
    tbl = np.empty((p_loc, 4), dtype=np.int32)
    for lx in range(m_xl):
        for iy in range(m):
            p = lx * m + iy
            for k, (dx, dy) in enumerate(_HALF_SHELL):
                gy = (iy + dy) % m
                gx = lx + dx
                tbl[p, k] = gx * m + gy if gx < m_xl else p_loc + gy
    return tbl


def make_pencil_engine(
    cfg: SimConfig,
    mesh: Mesh | None = None,
    axis: str = PARTICLE_AXIS,
    compensated: bool | None = None,
    inner_chunk: int = 8,
    rebin_trigger: str | None = None,
) -> Engine:
    """Pencil engine for ``cfg``; with ``mesh``, the sweep is sharded over
    ``mesh``'s ``axis``, which must divide the pencil grid's x-column count.

    ``run_fast`` runs ``inner_chunk`` steps per rebin check. ``rebin_trigger``
    picks the per-chunk rebin: "always" (default in plain f32: a branchless
    rebin every chunk), "predictive" (default when compensated: rebin only
    when a particle could cross the slack during the coming chunk), or
    "never" (no rebin; drift past the slack still sets ``overflow``).
    ``compensated`` overrides the precision policy (tests)."""
    d = 1 if mesh is None else mesh.shape[axis]
    L = cfg.box_length
    r_list = cfg.rc + cfg.neighbor_skin
    grid = make_pencil_grid(cfg.n, L, r_list, cfg.density, cfg.neighbor_capacity)
    m = grid.m_xy
    if m % d != 0:
        raise ValueError(
            f"pencil grid {m}x{m} does not split over {d} devices "
            "(m_xy % d != 0); choose a divisor axis size"
        )
    m_xl = m // d
    p_loc = m_xl * m
    p_aug = p_loc + m
    cap = grid.capacity
    ns = grid.n_slots
    n = cfg.n
    dtype = _effective_dtype(cfg)
    if compensated is None:
        compensated = _compensated(cfg)
    if rebin_trigger is None:
        rebin_trigger = "predictive" if compensated else "always"
    if rebin_trigger not in ("always", "predictive", "never"):
        raise ValueError(f"unknown rebin trigger {rebin_trigger!r}")
    tbl = jnp.asarray(_local_half_shell_table(m, m_xl))

    e_t, d_t, dd_t = (
        tail_corrections(n, cfg.volume, cfg.rc)
        if cfg.use_tail_corrections
        else (0.0, 0.0, 0.0)
    )
    xyz_mask = jnp.zeros((8, 1), dtype).at[0:3].set(1.0)
    rc_sq = jnp.asarray(cfg.rc_square, dtype)
    slot_spec = P(None, axis)
    pencil_spec = P(axis)
    perm_fwd = [(s, (s - 1) % d) for s in range(d)]   # first strip -> prev dev
    perm_back = [(s, (s + 1) % d) for s in range(d)]  # halo reactions return

    if mesh is None:
        def ppermute(x, perm):
            return x

        def psum(x):
            return x

        def sharded(fn, in_specs, out_specs):
            return fn

        def place(x, spec):
            return x
    else:
        def ppermute(x, perm):
            return lax.ppermute(x, axis, perm)

        def psum(x):
            return lax.psum(x, axis)

        def sharded(fn, in_specs, out_specs):
            return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)

        def place(x, spec):
            return jax.device_put(x, NamedSharding(mesh, spec))

    # ------------------------------------------------------------------
    # Local force sweep: returns (f_rows WITHOUT the 24 prefactor on rows
    # 0..2, e, du, ddu partial scalars over the local pair-once pairs).
    # ------------------------------------------------------------------
    def _pair_block(ri, vi, rj, vj, tri: bool, want_obs: bool):
        """Pair-once partials between (P, cap, 3) blocks."""
        dxyz = minimum_image(ri[:, :, None, :] - rj[:, None, :, :], L)
        r2 = jnp.sum(dxyz * dxyz, axis=-1)
        mask = (r2 < rc_sq) & (vi[:, :, None] > 0.5) & (vj[:, None, :] > 0.5)
        if tri:
            rank = jnp.arange(cap)
            mask = mask & (rank[None, :, None] < rank[None, None, :])
        pair_e, du_r, pair_ddu, inv_r2 = _pair_terms(r2, mask, dtype)
        f_pairs = (-du_r * inv_r2)[..., None] * dxyz
        f_i = jnp.sum(f_pairs, axis=2)
        f_j = -jnp.sum(f_pairs, axis=1)
        if want_obs:
            return f_i, f_j, jnp.sum(pair_e), jnp.sum(du_r), jnp.sum(pair_ddu)
        z = jnp.zeros((), dtype)
        return f_i, f_j, z, z, z

    def _sweep(r_aug, want_obs: bool):
        """Half-shell sweep over the augmented strip (local pencils + halo
        column). Returns (8, p_aug*cap) force rows + scalar partials."""
        pos = r_aug[0:3].T.reshape(p_aug, cap, 3)
        valid = r_aug[3].reshape(p_aug, cap)
        ri, vi = pos[:p_loc], valid[:p_loc]

        f_i, f_j, e, du, ddu = _pair_block(ri, vi, ri, vi, True, want_obs)
        f_aug = jnp.zeros((p_aug, cap, 3), dtype).at[:p_loc].add(f_i + f_j)
        for k in range(4):
            nbr = tbl[:, k]
            f_i, f_j, e_b, du_b, ddu_b = _pair_block(
                ri, vi, pos[nbr], valid[nbr], False, want_obs
            )
            f_aug = f_aug.at[:p_loc].add(f_i).at[nbr].add(f_j)
            e, du, ddu = e + e_b, du + du_b, ddu + ddu_b

        f_rows = jnp.zeros((8, p_aug * cap), dtype)
        f_rows = f_rows.at[0:3].set(f_aug.reshape(p_aug * cap, 3).T)
        return f_rows, e, du, ddu

    def _local_force(r_loc, want_obs: bool):
        """One halo exchange + local sweep + reaction return."""
        halo = ppermute(r_loc[:, : m * cap], perm_fwd)
        out_aug, e, du, ddu = _sweep(jnp.concatenate([r_loc, halo], axis=1), want_obs)
        f_back = ppermute(out_aug[:, p_loc * cap:], perm_back)
        out_loc = out_aug[:, : p_loc * cap].at[:, : m * cap].add(f_back)
        return out_loc, e, du, ddu

    def _sweep_local(r_loc, want_obs: bool):
        f_rows, e, du, ddu = _local_force(r_loc, want_obs)
        return f_rows, psum(e), psum(du), psum(ddu)

    sweep = {
        wo: sharded(partial(_sweep_local, want_obs=wo), (slot_spec,),
                    (slot_spec, P(), P(), P()))
        for wo in (False, True)
    }

    def _force_obs(r8, want_obs: bool):
        f_rows, e, du, ddu = sweep[want_obs](r8)
        obs_part = (
            4.0 * e + jnp.asarray(e_t, dtype),
            24.0 * du + jnp.asarray(d_t, dtype),
            24.0 * ddu + jnp.asarray(dd_t, dtype),
        )
        return 24.0 * f_rows, obs_part

    def _scatter_rows(arr_particles, slot):
        out = jnp.zeros((8, ns + 1), dtype)
        out = out.at[0:3, slot].set(arr_particles.T.astype(dtype))
        return out[:, :ns]

    def _counts_from_valid(valid):
        return valid.reshape(grid.n_pencils, cap).sum(axis=1).astype(jnp.int32)

    def init(state: MDState):
        slot, overflow = bin_to_slots(state.r, grid)
        r8 = _scatter_rows(state.r, slot)
        valid = jnp.zeros((ns + 1,), dtype).at[slot].set(1.0)[:ns]
        ids = jnp.zeros((ns + 1,), dtype).at[slot].set(jnp.arange(n, dtype=dtype))[:ns]
        r8 = r8.at[3, :].set(valid).at[4, :].set(ids)
        r8 = place(r8, slot_spec)
        ru8 = place(_scatter_rows(state.ru, slot), slot_spec)
        v8 = place(_scatter_rows(state.v, slot), slot_spec)
        counts = place(_counts_from_valid(valid), pencil_spec)
        a8, (epot, d_epot, dd_epot) = _force_obs(r8, True)
        ekin = 0.5 * jnp.sum(v8 * v8)
        zero = jnp.zeros_like(r8)
        carry = PencilCarry(
            r=r8, ru=ru8, v=v8, a=a8, r_ref=r8, rc=zero, vc=zero,
            counts=counts, overflow=overflow,
        )
        return carry, StepObs(epot=epot, ekin=ekin, d_epot=d_epot, dd_epot=dd_epot)

    dt = cfg.dt
    half_dt = 0.5 * cfg.dt
    half_dt_sq = 0.5 * cfg.dt * cfg.dt
    # Coverage of the 9-pencil xy neighborhood needs rc + 2*delta_xy <=
    # pencil_width, i.e. per-particle XY drift below (width - rc)/2 since the
    # last rebin; z is unrestricted (the sweeps cover whole z columns).
    half_slack = 0.5 * (grid.pencil_width - cfg.rc)
    rebuild_thresh = half_slack**2

    def _xy_drift2(c_r, r_ref):
        dsp = minimum_image(c_r[0:2] - r_ref[0:2], L)
        return jnp.sum(dsp * dsp, axis=0) * c_r[3]

    def _rebin(args):
        """Gather-form global rebin. Compensated mode: two-float wrap, rc
        permutes with the slots."""
        r8, ru8, v8, a8, rc8, vc8 = args
        if compensated:
            rhi, rlo = wrap_positions_ext(r8[0:3], rc8[0:3], L)
            r8 = r8.at[0:3].set(rhi)
            rc8 = rc8.at[0:3].set(rlo)
        else:
            r8 = r8.at[0:3].set(wrap_positions(r8[0:3], L))
        order, src, valid_new, overflow = rebin_gather_parts(r8, r8[3, :], grid)
        vmask = valid_new.astype(dtype)
        parts = [r8[0:3], r8[4:5], ru8[0:3], v8[0:3], a8[0:3]] + (
            [rc8[0:3], vc8[0:3]] if compensated else []
        )
        # double gather (see rebin_gather_parts): cheaper than composing
        # old_of_new = order[src] first
        stacked = jnp.concatenate(parts, axis=0)[:, order][:, src] * vmask[None, :]
        pad3 = jnp.zeros((3, ns), dtype)
        pad5 = jnp.zeros((5, ns), dtype)
        r8p = jnp.concatenate([stacked[0:3], vmask[None, :], stacked[3:4], pad3], axis=0)

        def emb(i):
            return jnp.concatenate([stacked[4 + 3 * i:7 + 3 * i], pad5], axis=0)

        rc8p = emb(3) if compensated else jnp.zeros_like(r8p)
        vc8p = emb(4) if compensated else vc8
        return r8p, emb(0), emb(1), emb(2), rc8p, vc8p, _counts_from_valid(vmask), overflow

    def _rebin_carry(c: PencilCarry) -> PencilCarry:
        r8p, ru8p, v8p, a8p, rc8p, vc8p, counts_p, ovf = _rebin(
            (c.r, c.ru, c.v, c.a, c.rc, c.vc)
        )
        return dataclasses.replace(
            c, r=r8p, ru=ru8p, v=v8p, a=a8p, rc=rc8p, vc=vc8p,
            r_ref=r8p, counts=counts_p, overflow=c.overflow | ovf,
        )

    def _maybe_rebin(c: PencilCarry, k: int) -> PencilCarry:
        moved2 = _xy_drift2(c.r, c.r_ref)
        c = dataclasses.replace(
            c, overflow=c.overflow | (jnp.max(moved2) > rebuild_thresh)
        )
        if rebin_trigger == "never":
            return c
        if rebin_trigger == "always":
            return _rebin_carry(c)
        speed = jnp.sqrt(jnp.sum(c.v[0:2] * c.v[0:2], axis=0))
        predicted = jnp.sqrt(moved2) + speed * (k * dt * _PREDICT_SAFETY)
        will_exceed = jnp.max(predicted * c.r[3]) > half_slack
        return lax.cond(will_exceed, _rebin_carry, lambda cc: cc, c)

    # ------------------------------------------------------------------
    # Per-step path (sampled steps; displacement-cond'd rebin). Positions
    # are not wrapped between rebins: the sweep's minimum image handles
    # coordinates slightly outside [0, L).
    # ------------------------------------------------------------------
    def _step(c: PencilCarry, want_obs: bool):
        delta = (c.v * dt + c.a * half_dt_sq) * xyz_mask
        if compensated:
            r_new, rc_new = _comp_add(c.r, c.rc, delta)
            v_half, vc_half = _comp_add(c.v, c.vc, c.a * half_dt)
        else:
            r_new = c.r + delta
            rc_new = c.rc
            v_half, vc_half = c.v + c.a * half_dt, c.vc
        ru_new = c.ru + delta
        moved = jnp.max(_xy_drift2(r_new, c.r_ref)) > rebuild_thresh

        def do(args):
            r8p, ru8p, v8p, a8p, rc8p, vc8p, counts_p, ovf = _rebin(args)
            return r8p, ru8p, v8p, a8p, rc8p, vc8p, r8p, counts_p, ovf

        def dont(args):
            r8, ru8, v8, a8, rc8, vc8 = args
            return (r8, ru8, v8, a8, rc8, vc8, c.r_ref, c.counts,
                    jnp.asarray(False))

        (r_new, ru_new, v_half, _a, rc_new, vc_half, r_ref, counts,
         ovf) = lax.cond(
            moved, do, dont, (r_new, ru_new, v_half, c.a, rc_new, vc_half),
        )

        a_new, (epot, d_epot, dd_epot) = _force_obs(r_new, want_obs)
        if compensated:
            v_new, vc_new = _comp_add(v_half, vc_half, a_new * half_dt)
            v_eff = v_new + vc_new
        else:
            v_new, vc_new = v_half + a_new * half_dt, vc_half
            v_eff = v_new
        ekin = 0.5 * jnp.sum(v_eff * v_eff)
        carry = PencilCarry(
            r=r_new, ru=ru_new, v=v_new, a=a_new, r_ref=r_ref,
            rc=rc_new, vc=vc_new, counts=counts, overflow=c.overflow | ovf,
        )
        return carry, StepObs(epot=epot, ekin=ekin, d_epot=d_epot, dd_epot=dd_epot)

    # ------------------------------------------------------------------
    # Chunk path (run_fast): k steps of halo exchange + local sweep inside
    # one (shard-mapped) loop; the global rebin check runs once per chunk.
    # ------------------------------------------------------------------
    def _make_chunk_fn(k: int):
        def chunk_local(r, ru, v, a, rc_, vc_):
            def body(carry, _):
                r, ru, v, a, rc_, vc_ = carry
                delta = (v * dt + a * half_dt_sq) * xyz_mask
                if compensated:
                    r, rc_ = _comp_add(r, rc_, delta)
                    v, vc_ = _comp_add(v, vc_, a * half_dt)
                else:
                    r = r + delta
                    v = v + a * half_dt
                ru = ru + delta
                f_rows, _e, _du, _ddu = _local_force(r, False)
                a = 24.0 * f_rows
                if compensated:
                    v, vc_ = _comp_add(v, vc_, a * half_dt)
                else:
                    v = v + a * half_dt
                return (r, ru, v, a, rc_, vc_), None

            out, _ = lax.scan(body, (r, ru, v, a, rc_, vc_), None, length=k)
            return out

        return sharded(chunk_local, (slot_spec,) * 6, (slot_spec,) * 6)

    chunk_fns: dict[int, object] = {}

    def _chunk(c: PencilCarry, k: int) -> PencilCarry:
        c = _maybe_rebin(c, k)
        if k not in chunk_fns:
            chunk_fns[k] = _make_chunk_fn(k)
        r, ru, v, a, rc_, vc_ = chunk_fns[k](c.r, c.ru, c.v, c.a, c.rc, c.vc)
        return dataclasses.replace(c, r=r, ru=ru, v=v, a=a, rc=rc_, vc=vc_)

    def run_fast(c: PencilCarry, n_steps: int) -> PencilCarry:
        full, rem = divmod(n_steps, inner_chunk)
        if full > 0:
            c, _ = lax.scan(
                lambda cc, _: (_chunk(cc, inner_chunk), None),
                c, None, length=full,
            )
        if rem:
            c = _chunk(c, rem)
        return c

    def get_state(c: PencilCarry) -> MDState:
        """Slot layout -> particle order via the id row (positions wrapped
        back into [0, L))."""
        valid = c.r[3, :] > 0.5
        ids = jnp.where(valid, c.r[4, :].astype(jnp.int32), n)

        def gather(arr):
            out = jnp.zeros((n + 1, 3), dtype)
            out = out.at[ids].set(arr[0:3, :].T)
            return out[:n]

        v8 = c.v + c.vc if compensated else c.v
        return MDState(
            r=wrap_positions(gather(c.r), L),
            ru=gather(c.ru),
            v=gather(v8),
            a=gather(c.a),
        )

    return Engine(
        init=init,
        step=lambda c: _step(c, True),
        get_state=get_state,
        diagnostics=lambda c: {"pencil_overflow": c.overflow},
        step_fast=lambda c: _step(c, False),
        run_fast=run_fast,
    )
