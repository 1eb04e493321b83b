"""Multi-device tests on the 8-way virtual CPU mesh: particle-axis sharding
parity with the single-device path, ensemble vmap bit-identity with
sequential runs, mesh-sharded ensembles (SURVEY §4 oracle (j))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.forces import make_force_fn
from ljmd_tpu.models.integrators import init_forces, make_step_fn
from ljmd_tpu.models.simulation import initialize, run_production
from ljmd_tpu.parallel.ensemble import ensemble_simulate
from ljmd_tpu.parallel.mesh import make_mesh
from ljmd_tpu.parallel.spatial import make_spatial_step_fn, shard_state
from ljmd_tpu.stats.moments import OBSERVABLES


def small_cfg(**kw):
    base = dict(
        total_steps=120,
        output_interval=10,
        warmup_steps=20,
        dt=0.002,
        dtype="float64",
        target_total_energy=-60.0,
        seed=3,
        n_runs=4,
    )
    base.update(kw)
    return config_from_density(num_cells=2, density=0.6, **base)


def test_devices_available():
    assert len(jax.devices()) == 8


def test_spatial_step_matches_single_device():
    cfg = small_cfg()
    state = initialize(cfg, backend="dense")

    # single-device trajectory
    force_fn = make_force_fn(cfg, "dense")
    step = make_step_fn(force_fn, cfg.dt, cfg.box_length)
    s_ref = state
    for _ in range(5):
        s_ref, obs_ref = step(s_ref)

    # 4-way particle-sharded trajectory (N=32 divisible by 4)
    mesh = make_mesh(replica=1, particle=4)
    sstep = make_spatial_step_fn(cfg, mesh)
    s_sh = shard_state(state, mesh)
    run = jax.jit(lambda s: jax.lax.scan(lambda c, _: sstep(c), s, None, length=5))
    s_out, obs_hist = run(s_sh)

    np.testing.assert_allclose(np.asarray(s_out.r), np.asarray(s_ref.r), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(s_out.v), np.asarray(s_ref.v), rtol=1e-12, atol=1e-12)
    assert float(obs_hist.epot[-1]) == pytest.approx(float(obs_ref.epot), rel=1e-12)
    assert float(obs_hist.ekin[-1]) == pytest.approx(float(obs_ref.ekin), rel=1e-12)
    assert float(obs_hist.d_epot[-1]) == pytest.approx(float(obs_ref.d_epot), rel=1e-12)
    assert float(obs_hist.dd_epot[-1]) == pytest.approx(float(obs_ref.dd_epot), rel=1e-12)


def test_ensemble_matches_sequential_runs():
    cfg = small_cfg()
    out = ensemble_simulate(cfg, n_replicas=3, backend="dense")
    assert out.replica_means.shape == (3, len(OBSERVABLES))

    # sequential per-replica oracle with the same key split
    key = jax.random.PRNGKey(cfg.seed)
    keys = jax.random.split(key, 3)
    for i in range(3):
        state = initialize(cfg, keys[i], backend="dense")
        res = run_production(cfg, state, backend="dense")
        np.testing.assert_allclose(
            np.asarray(out.replica_means[i]), np.asarray(res.means.means),
            rtol=1e-12, atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(out.series[i]), np.asarray(res.series), rtol=1e-12, atol=1e-12
        )

    np.testing.assert_allclose(
        np.asarray(out.mean_of_means), np.asarray(out.replica_means.mean(axis=0)), rtol=1e-12
    )
    # per-replica thermo coefficients are finite and batched
    assert out.thermo.temperature.shape == (3,)
    assert bool(jnp.isfinite(out.thermo.Ca_v).all())
    # cross-run ACF average equals the mean of per-replica ACFs
    per_replica_corr = []
    for i in range(3):
        state = initialize(cfg, keys[i], backend="dense")
        res = run_production(cfg, state, backend="dense")
        per_replica_corr.append(np.asarray(res.corr))
    np.testing.assert_allclose(
        np.asarray(out.corr_mean_runs), np.mean(per_replica_corr, axis=0),
        rtol=1e-10, atol=1e-12,
    )


def test_ensemble_on_mesh_matches_unsharded():
    cfg = small_cfg(total_steps=60, warmup_steps=10)
    mesh = make_mesh(replica=8, particle=1)
    sharded = ensemble_simulate(cfg, n_replicas=8, mesh=mesh, backend="dense")
    local = ensemble_simulate(cfg, n_replicas=8, backend="dense")
    np.testing.assert_allclose(
        np.asarray(sharded.replica_means), np.asarray(local.replica_means),
        rtol=1e-12, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(sharded.mean_of_means), np.asarray(local.mean_of_means), rtol=1e-12
    )


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(replica=16, particle=1)
    cfg = small_cfg()
    mesh = make_mesh(replica=1, particle=3)  # 32 % 3 != 0
    with pytest.raises(ValueError):
        make_spatial_step_fn(cfg, mesh)


def test_ring_matches_all_gather_and_pallas():
    """ppermute ring exchange == all_gather path on a 4-way particle axis."""
    cfg = small_cfg()
    state = initialize(cfg, backend="dense")
    mesh = make_mesh(replica=1, particle=4)

    outs = {}
    for name, kw in {
        "ring": dict(comm="ring"),
        "gather": dict(comm="all_gather"),
    }.items():
        sstep = make_spatial_step_fn(cfg, mesh, **kw)
        s = shard_state(state, mesh)
        run = jax.jit(
            lambda s, f=sstep: jax.lax.scan(lambda c, _: f(c), s, None, length=5)
        )
        outs[name] = run(s)

    ref_state, ref_obs = outs["gather"]
    for name in ("ring",):
        st, obs = outs[name]
        np.testing.assert_allclose(
            np.asarray(st.r), np.asarray(ref_state.r), rtol=1e-11, atol=1e-12,
            err_msg=name,
        )
        np.testing.assert_allclose(
            np.asarray(st.v), np.asarray(ref_state.v), rtol=1e-10, atol=1e-12,
            err_msg=name,
        )
        assert float(obs.epot[-1]) == pytest.approx(float(ref_obs.epot[-1]), rel=1e-10)
        assert float(obs.d_epot[-1]) == pytest.approx(float(ref_obs.d_epot[-1]), rel=1e-10)


def test_half_ring_matches_all_gather():
    """Pair-once half-ring force decomposition (the default comm)
    == the ordered-pair all_gather oracle across shard
    counts: d=2 (gated shared hop only), d=3 (odd: full hops only), d=4
    (full + gated hop), d=8."""
    for num_cells, d in [(2, 2), (3, 3), (2, 4), (2, 8)]:
        cfg = small_cfg() if num_cells == 2 else config_from_density(
            num_cells=3, density=0.6, total_steps=120, output_interval=10,
            warmup_steps=20, dt=0.002, dtype="float64",
            target_total_energy=-200.0, seed=3,
        )
        assert cfg.n % d == 0
        state = initialize(cfg, backend="dense")
        mesh = make_mesh(replica=1, particle=d)

        ref_step = make_spatial_step_fn(cfg, mesh, comm="all_gather")
        hr_step = make_spatial_step_fn(cfg, mesh, comm="half_ring")
        s0 = shard_state(state, mesh)
        run_ref = jax.jit(
            lambda s: jax.lax.scan(lambda c, _: ref_step(c), s, None, length=5))
        run_hr = jax.jit(
            lambda s: jax.lax.scan(lambda c, _: hr_step(c), s, None, length=5))
        want_state, want_obs = run_ref(s0)
        got_state, got_obs = run_hr(s0)

        tag = f"d={d}"
        np.testing.assert_allclose(
            np.asarray(got_state.r), np.asarray(want_state.r),
            rtol=1e-11, atol=1e-12, err_msg=tag,
        )
        np.testing.assert_allclose(
            np.asarray(got_state.v), np.asarray(want_state.v),
            rtol=1e-10, atol=1e-12, err_msg=tag,
        )
        for f in ("epot", "ekin", "d_epot", "dd_epot"):
            assert float(getattr(got_obs, f)[-1]) == pytest.approx(
                float(getattr(want_obs, f)[-1]), rel=1e-10), (tag, f)


@pytest.mark.slow
def test_spatial_engine_production_matches_single_device():
    """The sharded engine runs through the standard production driver
    (sampling cadence + means + correlations) and matches the single-device
    dense backend."""
    from ljmd_tpu.parallel.spatial import make_spatial_engine

    cfg = config_from_density(
        num_cells=4, density=0.7, total_steps=40, output_interval=10,
        warmup_steps=5, dt=0.002, dtype="float64",
        target_total_energy=-1200.0,
    )
    state = initialize(cfg, backend="dense")
    want = run_production(cfg, state, backend="dense")

    mesh = make_mesh(replica=1, particle=4)
    eng = make_spatial_engine(cfg, mesh)
    got = run_production(cfg, state, engine=eng)
    np.testing.assert_allclose(
        np.asarray(got.series), np.asarray(want.series), rtol=1e-9, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(got.means.means), np.asarray(want.means.means),
        rtol=1e-9, atol=1e-11,
    )


@pytest.mark.slow
def test_ring_8way_larger_n_forces():
    """8-way particle sharding at N=2048: ring forces equal the single-device
    dense kernel (meaningful shard sizes)."""
    cfg = config_from_density(
        num_cells=8, density=0.75, total_steps=10, warmup_steps=0,
        dt=0.002, dtype="float64", target_total_energy=-10000.0,
    )
    from ljmd_tpu.models.lattice import fcc_lattice, random_velocities, remove_com_velocity
    from ljmd_tpu.state import MDState

    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=jnp.float64)
    v = remove_com_velocity(
        random_velocities(jax.random.PRNGKey(1), cfg.n, dtype=jnp.float64)
    )
    state = MDState(r=r, ru=r, v=v, a=jnp.zeros_like(r))

    force_fn = make_force_fn(cfg, "dense")
    s_ref, obs_ref = init_forces(state, force_fn)

    mesh = make_mesh(replica=1, particle=8)
    from ljmd_tpu.parallel.spatial import make_spatial_engine

    eng = make_spatial_engine(cfg, mesh, comm="ring")
    carry, obs = eng.init(state)
    np.testing.assert_allclose(
        np.asarray(eng.get_state(carry).a), np.asarray(s_ref.a),
        rtol=1e-10, atol=1e-10,
    )
    assert float(obs.epot) == pytest.approx(float(obs_ref.epot), rel=1e-11)


def test_streaming_ensemble_matches_in_memory():
    """Host-streamed ensemble series == fully materialized ensemble;
    series lives on host as numpy."""
    from ljmd_tpu.parallel.ensemble import ensemble_simulate_streaming

    from ljmd_tpu.parallel.ensemble import HostSeries

    cfg = small_cfg()
    want = ensemble_simulate(cfg, n_replicas=3, backend="dense")
    got = ensemble_simulate_streaming(cfg, n_replicas=3, backend="dense",
                                      chunk_samples=4)
    assert isinstance(got.series, HostSeries)
    assert isinstance(got.series.array, np.ndarray)
    np.testing.assert_allclose(np.asarray(got.series), np.asarray(want.series),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.replica_means),
                               np.asarray(want.replica_means), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(got.corr_mean_runs),
                               np.asarray(want.corr_mean_runs),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.mean_of_means),
                               np.asarray(want.mean_of_means), rtol=1e-12)


def test_tree_map_over_ensemble_result_both_paths():
    """jax.tree.map over an EnsembleResult must be safe on both the batched
    (device series) and streaming (HostSeries) paths — the streamed host
    series is pytree-inert, so a tree.map cannot device-put it."""
    from ljmd_tpu.parallel.ensemble import HostSeries, ensemble_simulate_streaming

    cfg = small_cfg()
    dev = ensemble_simulate(cfg, n_replicas=2, backend="dense")
    host = ensemble_simulate_streaming(cfg, n_replicas=2, backend="dense",
                                       chunk_samples=4)

    mapped_dev = jax.tree.map(lambda x: x * 1, dev)
    np.testing.assert_array_equal(np.asarray(mapped_dev.series),
                                  np.asarray(dev.series))

    mapped_host = jax.tree.map(lambda x: x * 1, host)
    # the HostSeries leaf-less node passes through UNTOUCHED (same object,
    # never visited by the map fn, never device-put)
    assert mapped_host.series is host.series
    assert isinstance(mapped_host.series, HostSeries)
    leaves = jax.tree.leaves(host.series)
    assert leaves == []


def test_simulate_pipeline_traces_once():
    """Repeated simulate() calls with the same (cfg, backend, record_frames)
    must reuse one traced pipeline (the single-run
    API gets the same cache the ensemble paths have)."""
    from ljmd_tpu.models.simulation import (
        _pipeline_trace_counts,
        _simulate_fn,
        simulate,
    )

    cfg = small_cfg()
    _simulate_fn.cache_clear()
    _pipeline_trace_counts.clear()
    a = simulate(cfg, backend="dense")
    b = simulate(cfg, backend="dense")
    key = (cfg, "dense", False)
    assert _pipeline_trace_counts.get(key) == 1
    np.testing.assert_array_equal(np.asarray(a.series), np.asarray(b.series))


@pytest.mark.slow
def test_streaming_ensemble_8_replicas_end_to_end(tmp_path):
    """Config-4-at-scale streaming shape on CPU:
    8 replicas through ensemble_simulate_streaming, all replicas healthy,
    per-replica drift bounded, full artifact set written via the shared
    CLI writer (run_many_md.f90:57-82 output contract)."""
    from ljmd_tpu.cli import write_ensemble_artifacts
    from ljmd_tpu.parallel.ensemble import ensemble_simulate_streaming

    cfg = small_cfg(total_steps=400, warmup_steps=40, n_runs=8)
    out = ensemble_simulate_streaming(cfg, n_replicas=8, chunk_samples=16)

    assert isinstance(np.asarray(out.series), np.ndarray)
    assert out.series.shape[0] == 8
    assert int(np.asarray(out.n_ok)) == 8
    etot = np.asarray(out.series)[:, 2, :]
    drift = np.abs((etot[:, -1] - etot[:, 0]) / etot[:, 0])
    # at N=32 the unshifted-truncation crossing noise dominates (~1/N per
    # crossing); this guards against divergence, not integrator precision
    assert drift.max() < 0.05

    d = tmp_path / "ens"
    write_ensemble_artifacts(str(d), cfg, out, 8)
    for name in ("means.txt", "simulation_results.json",
                 "simulation_results.txt", "corrmean_runs_epot.dat"):
        assert (d / name).exists()
    means = np.loadtxt(d / "means.txt", skiprows=1)
    assert means.shape[0] == 8


# ---------------------------------------------------------------------------
# Sharded STRUCTURED engine (pencil strips + ppermute halo exchange) and the
# multi-device precision policy.
# ---------------------------------------------------------------------------


def _melted_state(cfg, temp=1.0, seed=0, dtype=jnp.float64):
    from ljmd_tpu.models.lattice import (
        fcc_lattice,
        random_velocities,
        remove_com_velocity,
    )
    from ljmd_tpu.state import MDState

    n = cfg.n
    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=dtype)
    v = remove_com_velocity(
        random_velocities(jax.random.PRNGKey(seed), n, dtype=dtype)
    )
    v = v * jnp.sqrt(temp / (jnp.sum(v * v) / (3 * n)))
    return MDState(r=r, ru=r, v=v, a=jnp.zeros_like(r))


@pytest.mark.slow
def test_sharded_pencil_matches_single_device_cellpair():
    """Pencil-strip sharding (ppermute halo of the +x column) over 5 devices
    == the single-device cellpair engine, through melt steps that include a
    displacement-triggered global rebin. N=4000: the BASELINE-config-5-shaped
    structured path composing with the mesh (O(N/d + halo) pair work)."""
    from jax.sharding import Mesh

    from ljmd_tpu.parallel.mesh import PARTICLE_AXIS
    from ljmd_tpu.parallel.spatial_pencil import make_pencil_engine

    cfg = config_from_density(
        num_cells=10, density=0.8442, dt=0.004, dtype="float64",
        neighbor_skin=0.49,
    )
    st = _melted_state(cfg, temp=1.2)
    mesh = Mesh(np.array(jax.devices()[:5]), (PARTICLE_AXIS,))
    es = make_pencil_engine(cfg, mesh)
    ec = make_pencil_engine(cfg)

    cs, obs_s = es.init(st)
    cc, obs_c = ec.init(st)
    assert float(obs_s.epot) == pytest.approx(float(obs_c.epot), rel=1e-12)
    assert float(obs_s.d_epot) == pytest.approx(float(obs_c.d_epot), rel=1e-12)

    step_s = jax.jit(es.step)
    step_c = jax.jit(ec.step)
    for _ in range(12):
        cs, os_ = step_s(cs)
        cc, oc_ = step_c(cc)
    ss, sc = es.get_state(cs), ec.get_state(cc)
    for f in ("r", "ru", "v"):
        np.testing.assert_allclose(
            np.asarray(getattr(ss, f)), np.asarray(getattr(sc, f)),
            rtol=0, atol=1e-12, err_msg=f,
        )
    np.testing.assert_allclose(np.asarray(ss.a), np.asarray(sc.a),
                               rtol=0, atol=1e-10)
    assert float(os_.epot) == pytest.approx(float(oc_.epot), rel=1e-12)
    assert not bool(jax.device_get(cs.overflow))


def test_sharded_pencil_rejects_non_divisor_axis():
    from jax.sharding import Mesh

    from ljmd_tpu.parallel.mesh import PARTICLE_AXIS
    from ljmd_tpu.parallel.spatial_pencil import make_pencil_engine

    cfg = config_from_density(
        num_cells=10, density=0.8442, dt=0.004, dtype="float64",
        neighbor_skin=0.49,
    )  # 5x5 pencil grid
    mesh = Mesh(np.array(jax.devices()[:4]), (PARTICLE_AXIS,))
    with pytest.raises(ValueError, match="does not split"):
        make_pencil_engine(cfg, mesh)


@pytest.mark.slow
def test_spatial_engine_compensated_carry_and_policy():
    """dt <= 1e-3 f32 multi-chip: the spatial engine must carry compensation
    terms (item 3a — the single-chip effective-dtype invariant extends to the
    mesh) and still reproduce finite, sane observables."""
    from ljmd_tpu.parallel.spatial import make_spatial_engine

    cfg = small_cfg(dt=1e-4, dtype="float32", total_steps=20,
                    warmup_steps=0, output_interval=5)
    mesh = make_mesh(particle=4, devices=jax.devices()[:4])
    eng = make_spatial_engine(cfg, mesh, comm="ring")
    state = initialize(cfg, backend="dense")
    carry, obs0 = eng.init(state)
    assert isinstance(carry, tuple) and len(carry) == 3
    stepj = jax.jit(eng.step)
    for _ in range(5):
        carry, obs = stepj(carry)
    e0 = float(obs0.epot + obs0.ekin)
    e1 = float(obs.epot + obs.ekin)
    assert np.isfinite(e1)
    assert abs(e1 - e0) < 1e-3 * abs(e0)


@pytest.mark.slow
def test_sharded_pencil_compensated_dt1em4_tracks_f64_oracle():
    """Compensated multi-chip integration at the reference's own dt=1e-4 in
    f32 (item 3 acceptance), measured the same way as the single-chip
    compensation tests (tests/test_compensated.py): against the f64 oracle
    trajectory of the SAME engine. An energy-drift assertion is the wrong
    metric here — the unshifted truncated potential's rc-crossing bookkeeping
    fluctuates at the 1e-3 level regardless of integrator precision
    (CLAUDE.md: 1.86e-4 std in pure f64 at N=500)."""
    from jax import lax
    from jax.sharding import Mesh

    from ljmd_tpu.parallel.mesh import PARTICLE_AXIS
    from ljmd_tpu.parallel.spatial_pencil import make_pencil_engine

    base = dict(num_cells=6, density=0.8442, dt=1e-4, neighbor_skin=0.49)
    cfg64 = config_from_density(dtype="float64", **base)  # N=864, 3x3 grid
    cfg32 = config_from_density(dtype="float32", **base)
    st64 = _melted_state(cfg64, temp=0.9, dtype=jnp.float64)
    st32 = jax.tree.map(lambda x: x.astype(jnp.float32), st64)
    mesh = Mesh(np.array(jax.devices()[:3]), (PARTICLE_AXIS,))

    def run(cfg, st, compensated, n_steps=400):
        eng = make_pencil_engine(cfg, mesh, compensated=compensated)
        c0, _ = eng.init(st)

        @jax.jit
        def go(c):
            def body(cc, _):
                cc2, _o = eng.step_fast(cc)
                return cc2, None
            c, _ = lax.scan(body, c, None, length=n_steps)
            return c

        return eng.get_state(go(c0))

    s64 = run(cfg64, st64, compensated=False)
    s_comp = run(cfg32, st32, compensated=True)
    s_plain = run(cfg32, st32, compensated=False)

    ref_v = np.asarray(s64.v)
    err_comp = np.abs(np.asarray(s_comp.v, dtype=np.float64) - ref_v).max()
    err_plain = np.abs(np.asarray(s_plain.v, dtype=np.float64) - ref_v).max()
    # dt=1e-4 velocity increments underflow plain f32 addition; the
    # compensated sharded path must recover a significantly better
    # trajectory (the single-chip engines' bar, test_compensated.py:55).
    assert err_comp < err_plain * 0.5, (err_comp, err_plain)


def test_spatial_engine_run_fast_matches_per_step():
    """Fused multi-chip chunks: the k-step loop
    inside ONE shard_map must reproduce k per-step shard_map calls exactly
    (same step body, same collectives — only the dispatch granularity
    changes)."""
    from jax.sharding import Mesh

    from ljmd_tpu.parallel.mesh import PARTICLE_AXIS
    from ljmd_tpu.parallel.spatial import make_spatial_engine

    cfg = small_cfg()
    state = initialize(cfg, backend="dense")
    # 4 devices (N=32 must divide the shard count) keeps the multi-hop
    # ring incl. the gated half hop (comm defaults to half_ring — the
    # production path); 3 steps bound the 1-core host's rendezvous bill
    mesh = Mesh(np.array(jax.devices()[:4]), (PARTICLE_AXIS,))
    eng = make_spatial_engine(cfg, mesh)

    c1, _ = eng.init(state)
    c2, _ = eng.init(state)
    c1 = jax.jit(lambda c: eng.run_fast(c, 3))(c1)
    stepj = jax.jit(eng.step)
    for _ in range(3):
        c2, _ = stepj(c2)
    s1, s2 = eng.get_state(c1), eng.get_state(c2)
    for f in ("r", "ru", "v", "a"):
        np.testing.assert_allclose(
            np.asarray(getattr(s1, f)), np.asarray(getattr(s2, f)),
            rtol=0, atol=1e-12, err_msg=f,
        )


@pytest.mark.slow
def test_sharded_pencil_run_fast_matches_per_step():
    """Chunked sharded-pencil advance (per-chunk global rebin + k unrolled
    steps of halo-ppermute + local sweep inside one shard_map) == k per-step
    calls of the same engine."""
    from jax.sharding import Mesh

    from ljmd_tpu.parallel.mesh import PARTICLE_AXIS
    from ljmd_tpu.parallel.spatial_pencil import make_pencil_engine

    cfg = config_from_density(
        num_cells=6, density=0.8442, dt=0.004, dtype="float64",
        neighbor_skin=0.49,
    )
    st = _melted_state(cfg, temp=1.2)
    mesh = Mesh(np.array(jax.devices()[:3]), (PARTICLE_AXIS,))
    eng = make_pencil_engine(cfg, mesh)

    c1, _ = eng.init(st)
    c2, _ = eng.init(st)
    c1 = jax.jit(lambda c: eng.run_fast(c, 16))(c1)
    stepj = jax.jit(eng.step_fast)
    for _ in range(16):
        c2, _ = stepj(c2)
    s1, s2 = eng.get_state(c1), eng.get_state(c2)
    # The chunked path rebins once per 8-step chunk while the per-step path
    # rebins on the displacement cond — identical physics, different
    # reduction orders after a rebin; f64 keeps them within 1e-9.
    for f in ("r", "ru", "v"):
        np.testing.assert_allclose(
            np.asarray(getattr(s1, f)), np.asarray(getattr(s2, f)),
            rtol=0, atol=1e-9, err_msg=f,
        )
    assert not bool(jax.device_get(c1.overflow))
