"""Neighbor-list backend: build correctness, force parity with the dense
kernel, rebuild criterion, engine-level trajectory parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.engine import make_engine
from ljmd_tpu.models.simulation import initialize, run_production, simulate
from ljmd_tpu.ops.lj import lj_force_energy_dense
from ljmd_tpu.ops.neighbor import (
    build_neighbor_list_dense,
    estimate_capacity,
    lj_force_energy_neighbor,
    needs_rebuild,
)


def fluid_positions(n, L, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(0, L, size=(n, 3)))


def test_build_finds_exactly_inrange_neighbors():
    L, r_list = 10.0, 2.0
    r = fluid_positions(50, L, seed=1)
    nbrs = build_neighbor_list_dense(r, L, r_list**2, capacity=32)
    assert not bool(nbrs.overflow)
    rn = np.asarray(r)
    for i in range(50):
        d = rn - rn[i]
        d -= L * np.round(d / L)
        r2 = (d * d).sum(-1)
        want = sorted(j for j in range(50) if j != i and r2[j] < r_list**2)
        got = sorted(int(j) for j in np.asarray(nbrs.idx[i]) if j < 50)
        assert got == want, i


def test_build_overflow_flag():
    L = 4.0
    r = fluid_positions(40, L, seed=2)
    nbrs = build_neighbor_list_dense(r, L, (1.9) ** 2, capacity=4)
    assert bool(nbrs.overflow)


def test_estimate_capacity_reasonable():
    k = estimate_capacity(density=0.8442, r_list=2.9)
    # mean neighbors ~ 86; safety margin above, multiple of 8
    assert 96 <= k <= 160
    assert k % 8 == 0


def test_neighbor_force_matches_dense():
    cfg = config_from_density(num_cells=3, density=0.8, dtype="float64")
    r = fluid_positions(cfg.n, cfg.box_length, seed=3)
    r_list = cfg.rc + cfg.neighbor_skin
    nbrs = build_neighbor_list_dense(
        r, cfg.box_length, r_list**2, estimate_capacity(cfg.density, r_list)
    )
    assert not bool(nbrs.overflow)
    got = lj_force_energy_neighbor(
        r, nbrs.idx, cfg.box_length, cfg.rc_square, True, cfg.volume, cfg.rc
    )
    want = lj_force_energy_dense(
        r, cfg.box_length, cfg.rc_square, True, cfg.volume, cfg.rc
    )
    assert float(got.epot) == pytest.approx(float(want.epot), rel=1e-10)
    assert float(got.d_epot) == pytest.approx(float(want.d_epot), rel=1e-10)
    assert float(got.dd_epot) == pytest.approx(float(want.dd_epot), rel=1e-10)
    np.testing.assert_allclose(np.asarray(got.a), np.asarray(want.a), rtol=1e-9, atol=1e-9)


def test_needs_rebuild_criterion():
    L = 8.0
    r = fluid_positions(20, L, seed=4)
    nbrs = build_neighbor_list_dense(r, L, 4.0, capacity=24)
    skin = 0.4
    assert not bool(needs_rebuild(nbrs, r, L, skin))
    moved = r.at[3, 0].add(0.19)  # just under skin/2
    assert not bool(needs_rebuild(nbrs, moved, L, skin))
    moved = r.at[3, 0].add(0.21)  # just over skin/2
    assert bool(needs_rebuild(nbrs, moved, L, skin))
    # displacement across the periodic boundary counts via MIC
    moved = r.at[5, 1].set((r[5, 1] + L - 0.3) % L)  # true move 0.3
    assert bool(needs_rebuild(nbrs, moved, L, skin))


def test_neighbor_engine_matches_dense_trajectory():
    """Full production parity: neighbor engine vs dense engine, same init."""
    cfg = config_from_density(
        num_cells=4,           # N=256, L=6.84: rc+skin=2.8 < L/2=3.42
        density=0.8,
        total_steps=150,
        output_interval=10,
        warmup_steps=30,
        dt=0.002,
        dtype="float64",
        target_total_energy=-500.0,
        neighbor_skin=0.3,
    )
    state = initialize(cfg, backend="dense")
    out_d = run_production(cfg, state, backend="dense")
    out_n = run_production(cfg, state, backend="neighbor")
    assert not bool(out_n.diagnostics["neighbor_overflow"])
    np.testing.assert_allclose(
        np.asarray(out_n.series), np.asarray(out_d.series), rtol=1e-9, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out_n.final_state.r), np.asarray(out_d.final_state.r),
        rtol=1e-9, atol=1e-10,
    )


def test_auto_backend_picks_neighbor_for_large_small_cutoff():
    from ljmd_tpu.models.engine import auto_backend

    big = config_from_density(num_cells=7, density=0.8442)  # N=1372, rc=2.5
    assert auto_backend(big) == "neighbor"
    small = config_from_density(num_cells=2, density=0.5)
    assert auto_backend(small) == "dense"
    # reference default: rc = 0.49 L -> no room for skin under L/2
    ref = config_from_density(num_cells=7, density=0.5).replace(rc_over_box=0.49)
    assert auto_backend(ref) == "dense"


def test_simulate_with_neighbor_backend_end_to_end():
    cfg = config_from_density(
        num_cells=4, density=0.8, total_steps=100, output_interval=10,
        warmup_steps=20, dt=0.002, dtype="float64", target_total_energy=-1200.0,
        neighbor_skin=0.3,
    )
    out = simulate(cfg, backend="neighbor")
    assert out.series.shape[1] == cfg.n_samples
    assert bool(jnp.isfinite(out.series).all())
    assert not bool(out.diagnostics["neighbor_overflow"])
