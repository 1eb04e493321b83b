"""Pencil (cell-column) spatial binning for the structured large-N kernel.

The reference has no spatial data structures at all (pure O(N^2) loop,
SURVEY §5.7). The large-N path re-ARRANGES particles into fixed-capacity
"pencils" — z-columns of cross-section >= rc + skin — and sweeps each pencil
only against its xy-neighbor pencils (``parallel/spatial_pencil.py``). Its
memory is O(N), where the neighbor-list build's is O(N^2); the only dynamic
permutation happens at rebuild time.

Geometry: Mxy = floor(L / (rc + skin)) pencils per side (must be >= 3, else
fall back to the dense kernel); pencil id p = ix * Mxy + iy; each pencil owns
``capacity`` slots (a multiple of 128). A particle in pencil p with rank k
occupies global slot p * capacity + k. Interactions beyond the 9-pencil
xy-neighborhood are geometrically impossible within rc + skin; z stays
unrestricted (the MIC cutoff mask handles it), which costs extra masked
pairs but keeps every memory access block-structured.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "PencilGrid",
    "make_pencil_grid",
    "pencil_capacity",
    "bin_to_slots",
    "rebin_slots",
    "rebin_gather",
    "rebin_gather_parts",
]


@dataclasses.dataclass(frozen=True)
class PencilGrid:
    """Static pencil geometry (host-side constants)."""

    m_xy: int           # pencils per box side
    capacity: int       # slots per pencil (multiple of 128)
    box_length: float

    @property
    def n_pencils(self) -> int:
        return self.m_xy * self.m_xy

    @property
    def n_slots(self) -> int:
        return self.n_pencils * self.capacity

    @property
    def pencil_width(self) -> float:
        return self.box_length / self.m_xy


def pencil_capacity(n: int, density: float, box_length: float, m_xy: int,
                    safety: float = 1.4) -> int:
    """Static per-pencil slot capacity, rounded up to a multiple of 128.

    The margin above mean occupancy is fluctuation-driven: grand-canonical
    particle-number fluctuations in a cell scale like sqrt(S(0) * mean) with
    S(0) << 1 in a dense liquid, so even a Poisson-scale margin
    (~sqrt(mean)) is generous. Margins are
    max(0.15 * mean + 8, 3.5 * sqrt(mean)) — relatively tight for big pencils,
    wide for small ones where Poisson statistics dominate. Capacity overflow
    at (re)binning sets the engine's sticky overflow flag, so a violated
    bound is detected, never silent."""
    mean = n / (m_xy * m_xy)
    margin = max(0.15 * mean + 8.0, 3.5 * mean**0.5) * (safety / 1.4)
    cap = int(mean + margin)
    # The FCC starting lattice aliases the pencil grid (atom columns bunch
    # into pencils), exceeding any fluid-fluctuation bound — e.g. at N=62500
    # the fluid needs <384 slots but the lattice needs more. Binning the
    # lattice is a real input (initialize() starts there), so the default
    # capacity covers it; equilibrated production runs may override with
    # cfg.neighbor_capacity for a tighter j sweep (overflow stays detected
    # via the sticky flag).
    if n >= 32:
        k = round((n / 4) ** (1 / 3))
        if 4 * k**3 == n:
            cap = max(cap, _fcc_max_pencil_occupancy(k, box_length, m_xy) + 8)
    return ((cap + 127) // 128) * 128


def capacity_from_state(box_length: float, r_list: float, r) -> int:
    """128-granular pencil capacity sized from an ACTUAL configuration
    (e.g. the post-warmup state), instead of the lattice-safe worst case.

    The default ``pencil_capacity`` must cover the FCC starting lattice,
    whose pencil aliasing needs far more slots than the equilibrated fluid
    (N=62500: lattice 512 vs fluid 384; N=131072: 640 vs 512) — and the
    sweeps used to pay for that padding on every step. Production drivers
    that already hold an equilibrated state can size capacity from its
    occupancy census: smallest 128-multiple >= occ_max + 16 (the round-up
    slack adds 0..111 more headroom on top). Occupancy drift past the
    capacity during the run is caught by the engines' sticky overflow
    diagnostic (overflow victims are dropped deterministically, never
    silent), and ``cfg.neighbor_capacity`` stays available as an explicit
    override either way.
    """
    m_xy = int(np.floor(box_length / r_list))
    if m_xy < 3:
        raise ValueError("box too small for a pencil grid")
    pos = np.asarray(r)
    inv_w = m_xy / box_length
    ix = np.clip((pos[:, 0] * inv_w).astype(np.int64), 0, m_xy - 1)
    iy = np.clip((pos[:, 1] * inv_w).astype(np.int64), 0, m_xy - 1)
    occ = np.bincount(ix * m_xy + iy, minlength=m_xy * m_xy)
    # Fluctuation floor: one snapshot's occ_max can sit just under a 128
    # boundary while the run's extreme-value tail crosses it — keep at
    # least the Poisson-scale fluid bound over the MEAN as headroom for
    # long production runs (overflow stays detected via the sticky flag
    # either way).
    mean = pos.shape[0] / (m_xy * m_xy)
    need = max(int(occ.max()) + 16, int(mean + 3.5 * mean**0.5) + 1)
    return max(128, -(-need // 128) * 128)


def _fcc_max_pencil_occupancy(num_cells: int, box_length: float, m_xy: int) -> int:
    """Exact max per-pencil occupancy of the FCC starting lattice
    (md_initial_config_program.f90:132-187 geometry): project the 4-atom
    basis onto xy and histogram the columns into the pencil grid."""
    a = box_length / num_cells
    cells = np.arange(num_cells) * a
    cols_x = []
    cols_y = []
    counts_per_col = num_cells  # one atom per xy column per z cell
    for bx, by in ((0.0, 0.0), (0.0, 0.5), (0.5, 0.0), (0.5, 0.5)):
        x = (cells + bx * a) % box_length
        y = (cells + by * a) % box_length
        gx, gy = np.meshgrid(x, y, indexing="ij")
        cols_x.append(gx.ravel())
        cols_y.append(gy.ravel())
    x = np.concatenate(cols_x)
    y = np.concatenate(cols_y)
    inv_w = m_xy / box_length
    ix = np.clip((x * inv_w).astype(np.int64), 0, m_xy - 1)
    iy = np.clip((y * inv_w).astype(np.int64), 0, m_xy - 1)
    pid = ix * m_xy + iy
    occ = np.bincount(pid, minlength=m_xy * m_xy) * counts_per_col
    return int(occ.max())


def make_pencil_grid(n: int, box_length: float, r_list: float,
                     density: float, capacity: int = 0) -> PencilGrid:
    m_xy = int(np.floor(box_length / r_list))
    if m_xy < 3:
        raise ValueError(
            f"box holds only {m_xy} pencils of width >= {r_list}; "
            "use the dense kernel for small boxes"
        )
    cap = capacity or pencil_capacity(n, density, box_length, m_xy)
    return PencilGrid(m_xy=m_xy, capacity=cap, box_length=box_length)


def _pencil_ids(x: jax.Array, y: jax.Array, grid: PencilGrid) -> jax.Array:
    inv_w = grid.m_xy / grid.box_length
    ix = jnp.clip((x * inv_w).astype(jnp.int32), 0, grid.m_xy - 1)
    iy = jnp.clip((y * inv_w).astype(jnp.int32), 0, grid.m_xy - 1)
    return ix * grid.m_xy + iy


def _run_starts(sorted_key: jax.Array) -> jax.Array:
    """For a SORTED key vector, the index of the first element of each
    element's run: an O(n) cummax (``jnp.searchsorted(x, x)`` computes the
    same thing with a binary search per element)."""
    n = sorted_key.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    changed = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_key[1:] != sorted_key[:-1]]
    )
    return jax.lax.cummax(jnp.where(changed, idx, 0))


@partial(jax.jit, static_argnames=("grid",))
def bin_to_slots(r: jax.Array, grid: PencilGrid):
    """Bin (N, 3) wrapped positions into pencil slots.

    Returns (slot_of_particle (N,), overflow flag). Particles are ranked
    within a pencil by ascending z, ties broken by particle index (stable
    sort).
    """
    n = r.shape[0]
    pid = _pencil_ids(r[:, 0], r[:, 1], grid)
    # Lexicographic (pencil-major, z-minor) stable sort: exact on any dtype,
    # where a composite float key would lose bits in f32.
    order = jnp.lexsort((r[:, 2], pid))
    sorted_pid = pid[order]
    ranks_sorted = jnp.arange(n) - _run_starts(sorted_pid)
    ranks = jnp.zeros((n,), jnp.int32).at[order].set(ranks_sorted.astype(jnp.int32))
    overflow = jnp.any(ranks >= grid.capacity)
    slot = pid * grid.capacity + jnp.minimum(ranks, grid.capacity - 1)
    return slot, overflow


def _packed_pencil_order(pid_key: jax.Array, grid: PencilGrid) -> jax.Array:
    """Slot indices sorted by pencil key. Packs (pid << ceil_log2(ns)) | slot
    into ONE int32 and sorts it UNSTABLY: the low slot-index bits make the
    order deterministic by construction, and an unstable single-operand
    sort is the cheapest sort XLA offers. Falls back to an unstable
    2-operand sort when the packed key would overflow int31
    (n_pencils * n_slots >= 2^31, N >> 1e6). Within a pencil, ranks follow
    the previous slot order — any order is valid for the sweep."""
    ns = grid.n_slots
    bits = max(1, (ns - 1).bit_length())
    if (grid.n_pencils << bits) < 2**31:
        packed = (pid_key << bits) | jnp.arange(ns, dtype=jnp.int32)
        packed = jax.lax.sort(packed, is_stable=False)
        return packed & ((1 << bits) - 1)
    _, order = jax.lax.sort_key_val(  # pragma: no cover - needs N >> 1e6
        pid_key, jnp.arange(ns, dtype=jnp.int32), is_stable=False
    )
    return order


@partial(jax.jit, static_argnames=("grid",))
def rebin_slots(rows_r: jax.Array, valid: jax.Array, grid: PencilGrid):
    """Scatter form of the rebin: the new slot OF each old slot.

    rows_r: (8, n_slots) slot-layout positions (rows 0..2 = x,y,z);
    valid: (n_slots,) 1.0/0.0 slot validity.
    Returns (new_slot_for_old_slot (n_slots,), overflow): invalid old slots
    map to the sentinel n_slots (dropped by the scatter). The engines use
    the gather form (``rebin_gather_parts``); tests hold it to this layout.
    """
    ns = grid.n_slots
    pid = _pencil_ids(rows_r[0], rows_r[1], grid)
    is_valid = valid > 0.5
    # Invalid slots pushed to the end.
    pid_key = jnp.where(is_valid, pid, grid.n_pencils)
    order = _packed_pencil_order(pid_key, grid)
    sorted_pid = pid_key[order]
    ranks_sorted = (jnp.arange(ns) - _run_starts(sorted_pid)).astype(jnp.int32)
    ranks = jnp.zeros((ns,), jnp.int32).at[order].set(ranks_sorted)
    overflow = jnp.any(is_valid & (ranks >= grid.capacity))
    new_slot = jnp.where(
        is_valid,
        pid * grid.capacity + jnp.minimum(ranks, grid.capacity - 1),
        ns,  # sentinel: dropped
    )
    return new_slot, overflow


def _pencil_counts(pid_key: jax.Array, grid: PencilGrid) -> jax.Array:
    """Per-pencil population from (clipped-to-n_pencils) pencil keys, as a
    broadcast compare-reduce ``sum(pid == arange(P))`` (fused, nothing
    materialized) instead of a scatter-add. The compare form scales as
    O(ns * n_pencils), so fall back to the scatter when that product gets
    huge (P ~ N^(2/3): far above any supported N)."""
    ns = pid_key.shape[0]
    P = grid.n_pencils
    if ns * P <= (1 << 33):
        return jnp.sum(
            (pid_key[None, :] == jnp.arange(P, dtype=jnp.int32)[:, None])
            .astype(jnp.int32),
            axis=1,
        )
    return jnp.zeros((P,), jnp.int32).at[  # pragma: no cover - N >> 1e6
        jnp.minimum(pid_key, P - 1)
    ].add((pid_key < P).astype(jnp.int32))


def rebin_gather_parts(rows_r: jax.Array, valid: jax.Array, grid: PencilGrid):
    """Gather form of the rebin, as split indices: returns ``(order, src,
    valid_new, overflow)`` with ``old_of_new = order[src]``.

    Target slots are STRUCTURED (t = pid * capacity + j), so no inverse
    scatter is needed: per-pencil counts come from ``_pencil_counts``, run
    starts from their exclusive cumsum, and ``src[t] = starts[pid] + j``.
    Callers that permute data apply the TWO gathers in sequence —
    ``data[:, order][:, src]`` — instead of materializing ``old_of_new``:
    the second gather is near-sequential.

    ``new_layout[:, t] = old_layout[:, old_of_new[t]] where valid_new[t]``.
    Overflow victims (rank >= capacity) are dropped deterministically and
    flagged; the layout is IDENTICAL to the scatter form's
    (``rebin_slots``) for the same sort key.
    """
    ns = grid.n_slots
    cap = grid.capacity
    pid = _pencil_ids(rows_r[0], rows_r[1], grid)
    pid_key = jnp.where(valid > 0.5, pid, grid.n_pencils)
    order = _packed_pencil_order(pid_key, grid)
    counts = _pencil_counts(pid_key, grid)
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)]
    )
    overflow = jnp.any(counts > cap)
    j = jnp.arange(cap, dtype=jnp.int32)
    src = jnp.clip(
        (starts[:, None] + j[None, :]).reshape(ns), 0, ns - 1
    )
    valid_new = (j[None, :] < jnp.minimum(counts, cap)[:, None]).reshape(ns)
    return order, src, valid_new, overflow


def rebin_gather(rows_r: jax.Array, valid: jax.Array, grid: PencilGrid):
    """Gather-form rebin with the composed permutation: returns
    ``(old_of_new (ns,) int32, valid_new (ns,) bool, overflow)`` (see
    ``rebin_gather_parts``)."""
    order, src, valid_new, overflow = rebin_gather_parts(rows_r, valid, grid)
    return order[src], valid_new, overflow
