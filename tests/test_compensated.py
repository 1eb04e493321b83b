"""Neumaier-compensated f32 integration: closer to the f64 oracle than plain
f32 at small dt (the f32-roundoff-floor regime), in every engine that
carries the precision policy."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models import engine as E
from ljmd_tpu.models.engine import make_engine
from ljmd_tpu.models.simulation import initialize


def run_engine(eng, state, n_steps):
    carry, _ = eng.init(state)

    def body(c, _):
        return eng.step(c)

    carry, obs = jax.jit(
        lambda c: jax.lax.scan(body, c, None, length=n_steps)
    )(carry)
    return eng.get_state(carry), obs


@pytest.mark.parametrize("backend", ["dense", "neighbor"])
def test_compensation_reduces_f32_error(backend, monkeypatch):
    # N=256 at rho=0.7: L=7.15 leaves room for the neighbor list's rc + skin
    base = dict(
        num_cells=4, density=0.7, dt=1e-4, total_steps=10,
        warmup_steps=0, target_total_energy=-1000.0, seed=3,
    )
    cfg64 = config_from_density(dtype="float64", **base)
    state64 = initialize(cfg64, backend="dense")
    state32 = jax.tree.map(lambda x: x.astype(jnp.float32), state64)

    n_steps = 400
    # f64 oracle
    s64, _ = run_engine(make_engine(cfg64, backend), state64, n_steps)

    cfg32 = config_from_density(dtype="float32", **base)
    assert E._compensated(cfg32)  # dt=1e-4 f32: the policy compensates
    s_comp, _ = run_engine(make_engine(cfg32, backend), state32, n_steps)
    monkeypatch.setattr(E, "_compensated", lambda cfg: False)
    s_plain, _ = run_engine(make_engine(cfg32, backend), state32, n_steps)

    ref_v = np.asarray(s64.v)
    err_plain = np.abs(np.asarray(s_plain.v, dtype=np.float64) - ref_v).max()
    err_comp = np.abs(np.asarray(s_comp.v, dtype=np.float64) - ref_v).max()
    # At dt=1e-4 the per-step velocity increment underflows f32 addition;
    # compensation must recover a significantly more accurate trajectory.
    assert err_comp < err_plain * 0.5, (err_comp, err_plain)


@pytest.mark.slow
def test_cellpair_compensation_reduces_f32_error():
    """Same oracle comparison for the pencil engine (its own Kahan path)."""
    from ljmd_tpu.parallel.spatial_pencil import make_pencil_engine

    base = dict(
        num_cells=5, density=0.66, dt=1e-4, total_steps=10,
        warmup_steps=0, target_total_energy=-2000.0, seed=4,
        neighbor_skin=0.4,
    )
    cfg64 = config_from_density(dtype="float64", **base)
    state64 = initialize(cfg64, backend="dense")
    state32 = jax.tree.map(lambda x: x.astype(jnp.float32), state64)

    n_steps = 300
    s64, _ = run_engine(make_engine(cfg64, "dense"), state64, n_steps)

    cfg32 = config_from_density(dtype="float32", **base)
    s_cell, _ = run_engine(make_pencil_engine(cfg32), state32, n_steps)
    s_plain, _ = run_engine(
        make_pencil_engine(cfg32, compensated=False), state32, n_steps
    )
    ref_v = np.asarray(s64.v)
    err_cell = np.abs(np.asarray(s_cell.v, dtype=np.float64) - ref_v).max()
    err_plain = np.abs(np.asarray(s_plain.v, dtype=np.float64) - ref_v).max()
    assert err_cell < err_plain * 0.5, (err_cell, err_plain)


def test_compensated_config_flag_roundtrip():
    cfg = config_from_density(num_cells=2, density=0.7, compensated_sum=True)
    assert cfg.compensated_sum
    assert cfg.replace(dt=0.001).compensated_sum


def test_effective_dtype_follows_x64():
    """A float64 config must be treated as float32 by the precision policy
    when x64 is disabled: arrays silently truncate there, and compensation
    gated on the REQUESTED dtype would leave the reference-default dt=1e-4
    config integrating in plain f32."""
    cfg = config_from_density(num_cells=2, density=0.5, dt=1e-4,
                              dtype="float64")
    assert E._effective_dtype(cfg) == jnp.float64  # x64 on (tests force it)
    assert not E._compensated(cfg)
    try:
        jax.config.update("jax_enable_x64", False)
        assert E._effective_dtype(cfg) == jnp.float32
        assert E._compensated(cfg)
    finally:
        jax.config.update("jax_enable_x64", True)
    cfg32 = config_from_density(num_cells=2, density=0.5, dt=1e-4,
                                dtype="float32")
    assert E._effective_dtype(cfg32) == jnp.float32
