"""The jnp half-shell pencil sweep against the dense oracle (``ops/lj.py``)
across state points and dtypes, its sticky overflow flag, and the sharded
sweep on a virtual-device mesh against the single-device sweep."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.lattice import fcc_lattice, random_velocities, remove_com_velocity
from ljmd_tpu.ops.geometry import wrap_positions
from ljmd_tpu.ops.lj import lj_force_energy_dense
from ljmd_tpu.parallel.mesh import PARTICLE_AXIS
from ljmd_tpu.parallel.spatial_pencil import make_pencil_engine
from ljmd_tpu.state import MDState


def _jittered_state(cfg, dtype, sigma=0.08, seed=0):
    """FCC lattice with random displacements (on the perfect lattice the
    forces vanish by symmetry and a force comparison measures nothing)."""
    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=dtype)
    key_r, key_v = jax.random.split(jax.random.PRNGKey(seed))
    r = wrap_positions(r + sigma * jax.random.normal(key_r, r.shape, dtype), cfg.box_length)
    v = remove_com_velocity(random_velocities(key_v, cfg.n, dtype=dtype))
    return MDState(r=r, ru=r, v=v, a=jnp.zeros_like(r))


# (num_cells, density, rc): N from 500 to 2048, dilute to dense liquid, short
# to long cutoffs; every case leaves a pencil grid of >= 3 columns per side.
STATE_POINTS = [
    (5, 0.5, 2.5),
    (6, 0.8442, 2.5),
    (8, 0.8442, 2.5),
    (6, 0.6, 2.0),
    (7, 0.8442, 1.5),
    (5, 0.3, 3.0),
]
# f32 tolerances: rounding of ~1e4-1e5 pair terms; a missing pair is O(1)
TOL = {"float32": (2e-5, 1e-4), "float64": (1e-10, 1e-9)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("num_cells,density,rc", STATE_POINTS)
def test_pencil_sweep_matches_dense_oracle(num_cells, density, rc, dtype):
    cfg = config_from_density(num_cells=num_cells, density=density, rc=rc, dtype=dtype)
    state = _jittered_state(cfg, jnp.dtype(dtype))
    eng = make_pencil_engine(cfg)
    carry, obs = jax.jit(eng.init)(state)
    got = eng.get_state(carry)
    want = lj_force_energy_dense(
        state.r, cfg.box_length, cfg.rc_square, True, cfg.volume, cfg.rc
    )
    e_tol, f_tol = TOL[dtype]
    for f in ("epot", "d_epot", "dd_epot"):
        g, w = float(getattr(obs, f)), float(getattr(want, f))
        assert abs(g - w) <= e_tol * max(abs(w), 1.0), (f, g, w)
    rms = float(jnp.sqrt(jnp.mean(want.a * want.a)))
    assert float(jnp.max(jnp.abs(got.a - want.a))) <= f_tol * rms
    # identity survives the slot layout
    np.testing.assert_array_equal(np.asarray(got.r), np.asarray(state.r))
    assert not bool(carry.overflow)


def test_pencil_capacity_overflow_is_sticky():
    """Squeezing the capacity below the occupancy drops particles at the
    binning; the flag says so and stays set through later steps."""
    cfg = config_from_density(num_cells=6, density=0.8442, dtype="float64")
    state = _jittered_state(cfg, jnp.float64)
    eng = make_pencil_engine(cfg.replace(neighbor_capacity=64))  # mean occ 96
    carry, _ = eng.init(state)
    assert bool(carry.overflow)
    step = jax.jit(lambda c: eng.step(c)[0])
    for _ in range(2):
        carry = step(carry)
    assert bool(carry.overflow)


def test_pencil_drift_past_slack_without_rebin_sets_overflow():
    """With rebinning off, a particle that drifts past half the geometric
    slack between checks sets the flag (its pairs may be missed)."""
    cfg = config_from_density(num_cells=6, density=0.8442, dtype="float64", dt=0.005)
    state = _jittered_state(cfg, jnp.float64)
    # a Galilean boost: the whole fluid flows at 10 sigma/tau along x, so
    # every particle leaves the slack while the forces stay the fluid's
    boost = jnp.asarray([10.0, 0.0, 0.0], jnp.float64)
    state = MDState(r=state.r, ru=state.ru, v=state.v + boost, a=state.a)
    eng = make_pencil_engine(cfg, rebin_trigger="never")
    carry, _ = eng.init(state)
    assert not bool(carry.overflow)
    carry = jax.jit(lambda c: eng.run_fast(c, 16))(carry)
    carry = jax.jit(lambda c: eng.run_fast(c, 8))(carry)  # check sees the drift
    assert bool(carry.overflow)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_pencil_matches_single_device(d):
    """Halo-exchanged strips over d virtual devices == the single-device
    sweep (N=2048, 4x4 pencil grid), through a chunked advance."""
    cfg = config_from_density(num_cells=8, density=0.8442, dtype="float64", dt=0.004)
    state = _jittered_state(cfg, jnp.float64, seed=1)
    mesh = Mesh(np.array(jax.devices()[:d]), (PARTICLE_AXIS,))
    es, e1 = make_pencil_engine(cfg, mesh), make_pencil_engine(cfg)
    cs, os_ = es.init(state)
    c1, o1 = e1.init(state)
    for f in ("epot", "d_epot", "dd_epot"):
        assert float(getattr(os_, f)) == pytest.approx(float(getattr(o1, f)), rel=1e-12)
    cs = jax.jit(lambda c: es.run_fast(c, 8))(cs)
    c1 = jax.jit(lambda c: e1.run_fast(c, 8))(c1)
    ss, s1 = es.get_state(cs), e1.get_state(c1)
    for f in ("r", "ru", "v", "a"):
        np.testing.assert_allclose(
            np.asarray(getattr(ss, f)), np.asarray(getattr(s1, f)), rtol=0, atol=1e-10,
            err_msg=f,
        )
    assert not bool(cs.overflow)
