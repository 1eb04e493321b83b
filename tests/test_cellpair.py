"""Pencil binning + the pencil (cellpair) engine: binning invariants, force
parity with the dense kernel, trajectory parity with rebinning, and the
``auto`` routing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.engine import auto_backend, make_engine
from ljmd_tpu.models.simulation import initialize, run_production
from ljmd_tpu.ops.cell_list import bin_to_slots, make_pencil_grid, pencil_capacity
from ljmd_tpu.ops.lj import lj_force_energy_dense
from ljmd_tpu.parallel.spatial_pencil import make_pencil_engine


def big_cfg(**kw):
    # N=500, L=~9.1: 3x3 pencils of width >= 2.9
    base = dict(
        density=0.66, dt=0.002, dtype="float64", neighbor_skin=0.4,
        total_steps=60, output_interval=10, warmup_steps=10,
        target_total_energy=-2000.0,
    )
    base.update(kw)
    return config_from_density(num_cells=5, **base)


def test_pencil_grid_geometry():
    grid = make_pencil_grid(n=500, box_length=9.1, r_list=2.9, density=0.66)
    assert grid.m_xy == 3
    assert grid.capacity % 128 == 0

    # the sweep's half shell, with its mirror and the pencil itself, covers
    # each pencil's 9-pencil xy neighborhood exactly once (one device: halo
    # ids p_loc + iy alias the first x-column, pencil iy)
    from ljmd_tpu.parallel.spatial_pencil import _local_half_shell_table

    m = 4
    tbl = _local_half_shell_table(m, m) % (m * m)
    assert tbl.shape == (m * m, 4)
    for p in range(m * m):
        ix, iy = divmod(p, m)
        want = {((ix + dx) % m) * m + (iy + dy) % m for dx in (-1, 0, 1) for dy in (-1, 0, 1)}
        got = [p, *tbl[p].tolist(), *(q for q in range(m * m) if p in tbl[q])]
        assert sorted(got) == sorted(want)


def test_pencil_grid_rejects_small_box():
    with pytest.raises(ValueError):
        make_pencil_grid(n=32, box_length=5.0, r_list=2.9, density=0.5)


def test_bin_to_slots_invariants():
    cfg = big_cfg()
    grid = make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin, cfg.density)
    rng = np.random.default_rng(0)
    r = jnp.asarray(rng.uniform(0, cfg.box_length, (cfg.n, 3)))
    slot, overflow = bin_to_slots(r, grid)
    assert not bool(overflow)
    slots = np.asarray(slot)
    assert len(np.unique(slots)) == cfg.n  # injective
    # every particle is in the pencil containing its (x, y)
    w = grid.pencil_width
    for i in range(0, cfg.n, 37):
        p = slots[i] // grid.capacity
        ix, iy = p // grid.m_xy, p % grid.m_xy
        assert ix == min(int(r[i, 0] / w), grid.m_xy - 1)
        assert iy == min(int(r[i, 1] / w), grid.m_xy - 1)


def test_rebin_slots_packed_matches_stable():
    """The rebin uses an unstable packed single-key sort; it must assign
    every particle to the same PENCIL as the stable (pencil, z) binning of
    ``bin_to_slots`` and produce distinct in-range slots (any within-pencil
    rank order is contractually acceptable)."""
    from ljmd_tpu.ops.cell_list import rebin_slots

    cfg = big_cfg()
    grid = make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin,
                            cfg.density)
    rng = np.random.default_rng(3)
    r = jnp.asarray(rng.uniform(0, cfg.box_length, (cfg.n, 3)))
    slot, overflow = bin_to_slots(r, grid)
    assert not bool(overflow)
    ns = grid.n_slots
    rows = jnp.zeros((8, ns))
    rows = rows.at[0:3, slot].set(r.T)
    rows = rows.at[3, slot].set(1.0)

    new_p, ovf_p = rebin_slots(rows, rows[3], grid)
    assert not bool(ovf_p)
    valid = np.asarray(rows[3]) > 0.5
    # each valid old slot IS the stable binning's slot of its particle
    nz, np_ = np.nonzero(valid)[0], np.asarray(new_p)[valid]
    # same pencil assignment, distinct in-range slots, invalid -> sentinel
    assert np.array_equal(nz // grid.capacity, np_ // grid.capacity)
    assert len(np.unique(np_)) == cfg.n
    assert np_.max() < ns
    assert np.all(np.asarray(new_p)[~valid] == ns)


def test_rebin_gather_matches_scatter_layout():
    """The engine's gather-form rebin must produce EXACTLY the layout the
    scatter form produces from the same sort key."""
    from ljmd_tpu.ops.cell_list import rebin_gather, rebin_slots

    cfg = big_cfg()
    grid = make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin,
                            cfg.density)
    rng = np.random.default_rng(7)
    r = jnp.asarray(rng.uniform(0, cfg.box_length, (cfg.n, 3)))
    slot, overflow = bin_to_slots(r, grid)
    assert not bool(overflow)
    ns = grid.n_slots
    rows = jnp.zeros((8, ns))
    rows = rows.at[0:3, slot].set(r.T)
    rows = rows.at[3, slot].set(1.0)
    rows = rows.at[4, slot].set(jnp.arange(cfg.n, dtype=rows.dtype))

    new_slot, ovf_s = rebin_slots(rows, rows[3], grid)
    old_of_new, valid_new, ovf_g = rebin_gather(rows, rows[3], grid)
    assert bool(ovf_s) == bool(ovf_g) == False  # noqa: E712
    # scatter-form layout
    want = np.zeros((8, ns + 1))
    want[:, np.asarray(new_slot)] = np.asarray(rows)
    want = want[:, :ns]
    # gather-form layout
    got = np.asarray(rows)[:, np.asarray(old_of_new)]
    got *= np.asarray(valid_new)[None, :]
    np.testing.assert_array_equal(got, want)


def test_cellpair_init_force_parity():
    cfg = big_cfg()
    state = initialize(cfg, backend="dense")
    eng = make_pencil_engine(cfg)
    carry, obs = eng.init(state)
    want = lj_force_energy_dense(
        state.r, cfg.box_length, cfg.rc_square, True, cfg.volume, cfg.rc
    )
    assert float(obs.epot) == pytest.approx(float(want.epot), rel=1e-10)
    assert float(obs.d_epot) == pytest.approx(float(want.d_epot), rel=1e-10)
    assert float(obs.dd_epot) == pytest.approx(float(want.dd_epot), rel=1e-10)
    got = eng.get_state(carry)
    np.testing.assert_allclose(np.asarray(got.r), np.asarray(state.r), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(got.a), np.asarray(want.a), rtol=1e-9, atol=1e-9)
    assert not bool(eng.diagnostics(carry)["pencil_overflow"])


def test_cellpair_trajectory_matches_dense():
    cfg = big_cfg(neighbor_skin=0.2, total_steps=20)  # small skin -> several rebins
    state = initialize(cfg, backend="dense")
    out_d = run_production(cfg, state, backend="dense")
    out_c = run_production(cfg, state, backend="cellpair", record_frames=True)
    assert not bool(out_c.diagnostics["pencil_overflow"])
    np.testing.assert_allclose(
        np.asarray(out_c.series), np.asarray(out_d.series), rtol=1e-9, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out_c.final_state.r), np.asarray(out_d.final_state.r),
        rtol=1e-9, atol=1e-10,
    )
    # frames preserve particle identity across rebins
    np.testing.assert_allclose(
        np.asarray(out_c.frames.ru[-1]), np.asarray(out_c.final_state.ru), rtol=1e-12
    )


def test_pencil_capacity_alignment():
    cap = pencil_capacity(65536, 0.8442, 42.66, 14)
    assert cap % 128 == 0
    assert cap >= 65536 / 196


def test_auto_backend_selects_cellpair_for_large_n(monkeypatch):
    """Past PENCIL_MIN_N auto routes to the pencil engine on a GPU host
    (the neighbor build's N x N arrays stop fitting the card)."""
    from ljmd_tpu.models import engine as E

    cfg = config_from_density(num_cells=20, density=0.8442)  # N=32000
    monkeypatch.setattr(
        E.jax, "devices", lambda: [type("D", (), {"platform": "gpu"})()]
    )
    assert cfg.n >= E.PENCIL_MIN_N
    eng = E.make_engine(cfg, "auto")

    class FakeCarry:
        overflow = jnp.asarray(False)

    # pencil engines expose the pencil_overflow diagnostic
    assert "pencil_overflow" in eng.diagnostics(FakeCarry())


EXAMPLE_ROUTES = {
    "n256_rho0.8.json": "dense",
    "ensemble64.json": "dense",
    "n864_liquid.json": "dense",
    "reference_default.json": "dense",
    "n4000_production.json": "neighbor",
    "n62500_large.json": "cellpair",
}


@pytest.mark.parametrize("name", sorted(EXAMPLE_ROUTES))
def test_auto_routing_table_for_examples_on_gpu(name, monkeypatch):
    """The GPU ``auto`` routing of every example config: dense below 1024
    particles, the neighbor list up to PENCIL_MIN_N, pencils above. The
    routing consults no platform, so a GPU platform changes nothing."""
    import os

    from ljmd_tpu.config import load_config
    from ljmd_tpu.models import engine as E

    monkeypatch.setattr(
        E.jax, "devices", lambda: [type("D", (), {"platform": "gpu"})()]
    )
    path = os.path.join(os.path.dirname(__file__), "..", "examples", name)
    assert auto_backend(load_config(path)) == EXAMPLE_ROUTES[name]


def test_compensated_rebin_preserves_parity_across_triggers():
    """The two-float-wrap rebin: compensated pencil trajectories must agree
    between the cond'd predictive trigger and the branchless always-rebin
    (which rebins 4-8x more often) to f64-roundoff — the rebin neither
    loses compensation bits nor perturbs the physics."""
    cfg = big_cfg(neighbor_skin=0.3)
    state = initialize(cfg, backend="dense")
    outs = []
    for trig in ("predictive", "always"):
        eng = make_pencil_engine(cfg, compensated=True, rebin_trigger=trig)
        c, _ = eng.init(state)
        c = jax.jit(lambda cc, eng=eng: eng.run_fast(cc, 48))(c)
        assert not bool(jax.device_get(c.overflow))
        outs.append(eng.get_state(c))
    np.testing.assert_allclose(
        np.asarray(outs[0].r), np.asarray(outs[1].r), rtol=1e-9, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(outs[0].v), np.asarray(outs[1].v), rtol=1e-9, atol=1e-10
    )


def test_cellpair_rejects_unknown_rebin_trigger():
    with pytest.raises(ValueError, match="rebin trigger"):
        make_pencil_engine(big_cfg(), rebin_trigger="sometimes")


def test_unfused_run_fast_matches_per_step():
    """The chunked driver (rebin once per chunk, cond-free steps in
    between) must reproduce the per-step cond'd trajectory through several
    rebins."""
    cfg = big_cfg(neighbor_skin=0.3)
    state = initialize(cfg, backend="dense")
    eng = make_pencil_engine(cfg)
    assert eng.run_fast is not None

    c0, _ = eng.init(state)
    c_fast = jax.jit(lambda c: eng.run_fast(c, 24))(c0)

    def body(c, _):
        c2, _ob = eng.step_fast(c)
        return c2, None

    c_step = jax.jit(lambda c: jax.lax.scan(body, c, None, length=24)[0])(c0)
    assert not bool(jax.device_get(c_fast.overflow))
    s_f, s_s = eng.get_state(c_fast), eng.get_state(c_step)
    for field in ("r", "ru", "v"):
        np.testing.assert_allclose(
            np.asarray(getattr(s_f, field)), np.asarray(getattr(s_s, field)),
            rtol=1e-9, atol=1e-10, err_msg=field,
        )


def test_capacity_from_state_census():
    from ljmd_tpu.ops.cell_list import capacity_from_state

    rng = np.random.default_rng(11)
    L, r_list = 12.0, 3.0  # 4x4 pencils
    r = rng.uniform(0, L, size=(600, 3))
    cap = capacity_from_state(L, r_list, r)
    # reference census
    ix = np.clip((r[:, 0] * 4 / L).astype(int), 0, 3)
    iy = np.clip((r[:, 1] * 4 / L).astype(int), 0, 3)
    occ_max = np.bincount(ix * 4 + iy, minlength=16).max()
    want = max(128, int(-(-(occ_max + 16) // 128) * 128))
    assert cap == want
    # piling everything into one pencil grows the capacity accordingly
    r1 = np.full((600, 3), 0.5)
    assert capacity_from_state(L, r_list, r1) == 640  # 616 -> 640


def test_make_engine_state_aware_capacity():
    """make_engine(state=...) sizes the pencil capacity from the state's
    census (not the lattice-safe default) and the tuned engine matches the
    default-capacity engine's trajectory (capacity is pure layout)."""
    cfg = big_cfg()
    state = initialize(cfg, jax.random.PRNGKey(2))

    # The equilibrated fluid at N=500 / 3x3 pencils has occ ~56 +- fluct,
    # so the census gives the 128 floor; the lattice-safe default is >= it.
    eng_t = make_engine(cfg, "cellpair", state=state)
    eng_d = make_pencil_engine(cfg)

    ct, _ = eng_t.init(state)
    cd, _ = eng_d.init(state)
    assert ct.r.shape[1] == 9 * 128  # census capacity applied
    step_t = jax.jit(lambda c: eng_t.step_fast(c)[0])
    step_d = jax.jit(lambda c: eng_d.step_fast(c)[0])
    for _ in range(3):
        ct = step_t(ct)
        cd = step_d(cd)
    st, sd = eng_t.get_state(ct), eng_d.get_state(cd)
    assert not bool(ct.overflow)
    for name in ("r", "v"):
        d = float(jnp.max(jnp.abs(getattr(st, name) - getattr(sd, name))))
        assert d < 1e-9, f"{name}: {d}"

    # explicit neighbor_capacity still wins over the census
    import dataclasses as dc

    cfg_o = dc.replace(cfg, neighbor_capacity=256)
    eng_o = make_engine(cfg_o, "cellpair", state=state)
    co, _ = eng_o.init(state)
    assert co.r.shape[1] == 9 * 256


def test_ensemble_vmap_cellpair_state_capacity():
    """The vmapped ensemble calls run_production on TRACER states; the
    state-aware capacity census must fall back to the lattice default
    instead of crashing on np.asarray(tracer) (regression)."""
    from ljmd_tpu.parallel.ensemble import ensemble_simulate

    cfg = big_cfg(total_steps=5, warmup_steps=2, output_interval=5)
    agg = ensemble_simulate(cfg, n_replicas=2, backend="cellpair", jit=False)
    assert np.all(np.isfinite(np.asarray(agg.mean_of_means)))
