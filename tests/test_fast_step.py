"""step_fast must produce EXACTLY the same dynamics as step — it may only
skip observable accumulation."""

import jax
import numpy as np
import pytest

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.engine import make_engine
from ljmd_tpu.models.simulation import initialize


def run_steps(eng, carry, step_fn, n):
    def body(c, _):
        c2, _ob = step_fn(c)
        return c2, None

    return jax.jit(lambda c: jax.lax.scan(body, c, None, length=n)[0])(carry)


@pytest.mark.parametrize("engine_name", ["dense", "cellpair", "neighbor"])
def test_fast_step_trajectory_identical(engine_name):
    if engine_name == "cellpair":
        cfg = config_from_density(
            num_cells=5, density=0.66, dt=0.002, dtype="float64",
            total_steps=10, warmup_steps=0, target_total_energy=-2000.0,
            neighbor_skin=0.4,
        )
        eng = make_engine(cfg, "cellpair")
    elif engine_name == "dense":
        cfg = config_from_density(
            num_cells=2, density=0.7, dt=0.002, dtype="float64",
            total_steps=10, warmup_steps=0, target_total_energy=-70.0,
        )
        eng = make_engine(cfg, "dense")
    else:
        cfg = config_from_density(
            num_cells=4, density=0.8, dt=0.002, dtype="float64",
            total_steps=10, warmup_steps=0, target_total_energy=-1200.0,
            neighbor_skin=0.3,
        )
        eng = make_engine(cfg, "neighbor")

    state = initialize(cfg, backend="dense")
    c0, _ = eng.init(state)
    n_steps = 12
    c_obs = run_steps(eng, c0, eng.step, n_steps)
    c_fast = run_steps(eng, c0, eng.step_fast, n_steps)
    s_obs = eng.get_state(c_obs)
    s_fast = eng.get_state(c_fast)
    for field in ("r", "ru", "v", "a"):
        np.testing.assert_array_equal(
            np.asarray(getattr(s_fast, field)),
            np.asarray(getattr(s_obs, field)),
            err_msg=f"{engine_name}: {field} diverged between fast and obs steps",
        )
    # and a subsequent obs step from the fast trajectory yields finite obs
    _, ob = eng.step(c_fast)
    assert np.isfinite(float(ob.epot)) and np.isfinite(float(ob.ekin))


@pytest.mark.slow
def test_streaming_with_cellpair_backend(tmp_path):
    from ljmd_tpu.models.simulation import run_production
    from ljmd_tpu.models.streaming import run_production_streaming

    cfg = config_from_density(
        num_cells=5, density=0.66, dt=0.002, dtype="float64",
        total_steps=80, output_interval=10, warmup_steps=20,
        target_total_energy=-2000.0, neighbor_skin=0.4,
    )
    state = initialize(cfg, backend="dense")
    want = run_production(cfg, state, backend="cellpair")
    got = run_production_streaming(
        cfg, state, str(tmp_path), backend="cellpair", chunk_samples=3,
        write_frames=False,
    )
    np.testing.assert_allclose(
        np.asarray(got.series), np.asarray(want.series), rtol=1e-12
    )
    assert not bool(got.diagnostics["pencil_overflow"])
