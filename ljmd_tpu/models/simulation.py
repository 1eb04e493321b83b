"""End-to-end simulation drivers: initialization and production run.

Rebuild of the reference's two Fortran programs:

- ``initialize``  <-> ``scripts/md_initial_config_program.f90`` (:58-121):
  FCC lattice -> random velocities -> COM removal -> initial forces ->
  velocity rescale to target E -> warmup equilibration; returns the state
  the reference would serialize to ``outputs/rv_init.dat``.
- ``run_production`` / ``simulate`` <-> ``scripts/md_simulation_program.f90``
  (:196-560): velocity-Verlet production loop with unwrap tracking, sampling
  at ``(step > warmup) and (step % interval == 0)``, streaming means,
  instantaneous series, trajectory frames, full-series + block-averaged
  autocorrelations, and thermodynamic coefficients.

Design: the whole production run is ONE jitted computation — a
``lax.scan`` over samples whose body is an inner ``lax.scan`` over the
``output_interval`` un-sampled steps, with the means accumulator carried on
device (SURVEY §7 design mapping). Sampling cadence is reproduced exactly for
any (total, warmup, interval) via a static prologue/epilogue step split, so
sampled step indices match the reference's ``mod(step, interval) == 0`` rule
even when ``warmup % interval != 0``. Trajectory frames are optional scan
outputs (device-resident); large-N runs should instead use the chunked streaming
driver in ``ljmd_tpu/io/trajectory.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ljmd_tpu.config import SimConfig
from ljmd_tpu.models.engine import _effective_dtype, make_engine
from ljmd_tpu.models.lattice import (
    fcc_lattice,
    random_velocities,
    remove_com_velocity,
    rescale_to_target_energy,
)
from ljmd_tpu.state import MDState, StepObs
from ljmd_tpu.stats.correlations import autocorr_all, block_corr_means
from ljmd_tpu.stats.moments import (
    MeansReport,
    instantaneous_temp_press,
    means_finalize,
    means_init,
    means_update,
)
from ljmd_tpu.stats.thermo import ThermoCoefs, thermo_coefs_from_report

__all__ = [
    "SERIES_OBSERVABLES",
    "Frames",
    "SimResult",
    "sample_steps",
    "initialize",
    "run_production",
    "simulate",
]

# Order of the sampled scalar series, matching the columns of the reference's
# instantaneous_energies.dat ("time epot ekin etot T P",
# md_simulation_program.f90:294) and its five corr_*.dat observables.
SERIES_OBSERVABLES = ("epot", "ekin", "etot", "temp", "press")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Frames:
    """Sampled trajectory frames, each (n_samples, N, 3) — the in-memory
    equivalent of the reference's rva.dat records (r, ru, v, a per snapshot,
    md_simulation_program.f90:384-387)."""

    r: jax.Array
    ru: jax.Array
    v: jax.Array
    a: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SimResult:
    """Everything the reference's production driver emits, on device."""

    final_state: MDState
    times: jax.Array        # (n_samples,) sample times step*dt
    series: jax.Array       # (5, n_samples) rows ordered as SERIES_OBSERVABLES
    means: MeansReport      # 11 means + stds
    corr: jax.Array         # (5, max_lag+1) centered ACF
    corr_norm: jax.Array    # (5, max_lag+1) ACF normalized by C(0)
    corr_mean: jax.Array    # (5, max_lag+1) block-averaged ACF
    corr_mean_norm: jax.Array
    frames: Optional[Frames]
    diagnostics: dict       # backend health flags (e.g. neighbor_overflow)

    def thermo(self, cfg: SimConfig) -> ThermoCoefs:
        return thermo_coefs_from_report(cfg.n, cfg.volume, self.means)

    def series_dict(self) -> dict:
        return {k: self.series[i] for i, k in enumerate(SERIES_OBSERVABLES)}


# ----------------------------------------------------------------------
# Sampling-cadence arithmetic (static, mirrors the reference loop exactly)
# ----------------------------------------------------------------------
def sample_steps(cfg: SimConfig) -> np.ndarray:
    """Absolute step indices at which the reference samples:
    multiples of output_interval in (warmup, total]."""
    first = (cfg.warmup_steps // cfg.output_interval + 1) * cfg.output_interval
    last = (cfg.total_steps // cfg.output_interval) * cfg.output_interval
    if first > last:
        return np.zeros((0,), dtype=np.int64)
    return np.arange(first, last + 1, cfg.output_interval, dtype=np.int64)


def _cadence(cfg: SimConfig):
    """(prologue, n_samples, epilogue): un-sampled steps before the first
    sample, number of interval-sized sampled chunks, and trailing un-sampled
    steps after the last sample. prologue includes warmup."""
    steps = sample_steps(cfg)
    n_samples = len(steps)
    if n_samples == 0:
        return cfg.total_steps, 0, 0
    prologue = int(steps[0]) - cfg.output_interval
    epilogue = cfg.total_steps - int(steps[-1])
    return prologue, n_samples, epilogue


# ----------------------------------------------------------------------
# Core scans
# ----------------------------------------------------------------------
def _advance(carry, step_fn, n_steps: int, dtype, fast_fn=None, want_obs=True,
             run_fast=None):
    """Advance n_steps (static), returning the final carry and the
    observables of the LAST step (carried, not materialized per step).

    When the engine provides an observable-free fast step, the first
    n_steps-1 steps use it (the reference only consumes observables at the
    sampling step, md_simulation_program.f90:361); pass want_obs=False for
    fully-unsampled stretches (prologue/epilogue/warmup). When the engine
    provides ``run_fast``, the un-sampled stretch runs in its multi-step
    chunks instead of a per-step scan."""
    dummy = StepObs(*(jnp.zeros((), dtype),) * 4)
    if n_steps == 0:
        return carry, dummy
    fast = fast_fn or step_fn

    def fast_body(c, _):
        c2, _ob = fast(c)
        return c2, None

    n_fast = n_steps if not want_obs else n_steps - 1
    if n_fast > 0:
        if run_fast is not None:
            carry = run_fast(carry, n_fast)
        else:
            carry, _ = lax.scan(fast_body, carry, None, length=n_fast)
    if not want_obs:
        return carry, dummy
    return step_fn(carry)


def initialize(
    cfg: SimConfig,
    key: Optional[jax.Array] = None,
    backend: str = "auto",
    velocity_init: str = "threefry",
) -> MDState:
    """Initial-configuration pipeline (md_initial_config_program.f90:58-121).

    Returns the post-warmup state (the rv_init.dat contract): positions on a
    perturbed-equilibrated fluid, velocities rescaled so E_tot == target at
    the rescale point, accelerations consistent with positions.

    ``velocity_init``: "threefry" (default; splittable JAX keys, the
    production choice) or "ran3" — the reference's exact subtractive-RNG
    velocity stream seeded with ``cfg.seed``
    (md_initial_config_program.f90:82-83,196-209; bit-exact port in
    utils/ran3.py). ran3 runs on the host, so it cannot be used under
    jit/vmap — it exists to make full init-pipeline parity with the Fortran
    program one function call.
    """
    dtype = _effective_dtype(cfg)
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)

    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=dtype)
    if velocity_init == "ran3":
        from ljmd_tpu.utils.ran3 import reference_initial_velocities

        v = jnp.asarray(reference_initial_velocities(cfg.n, seed=cfg.seed),
                        dtype=dtype)
    elif velocity_init == "threefry":
        v = random_velocities(key, cfg.n, dtype=dtype)
    else:
        raise ValueError(f"unknown velocity_init {velocity_init!r}")
    v = remove_com_velocity(v)

    engine = make_engine(cfg, backend)
    state = MDState(r=r, ru=r, v=v, a=jnp.zeros_like(r))
    carry, obs = engine.init(state)
    state = engine.get_state(carry)

    v = rescale_to_target_energy(state.v, obs.epot, cfg.target_total_energy)
    state = MDState(r=state.r, ru=state.ru, v=v, a=state.a)

    if cfg.warmup_steps > 0:
        carry, _ = engine.init(state)
        # The warmup advance runs under jit even when initialize() is
        # called eagerly: eager dispatch would run the scan's steps op by
        # op. Nested jit is free when the caller is already jitted.
        warm = jax.jit(lambda c: _advance(
            c, engine.step, cfg.warmup_steps, dtype,
            fast_fn=engine.step_fast, want_obs=False, run_fast=engine.run_fast,
        )[0])
        carry = warm(carry)
        state = engine.get_state(carry)
    # Reset unwrapped coordinates: production starts its own MSD clock with
    # ru(0) = r(0) (md_simulation_program.f90:229-231).
    return MDState(r=state.r, ru=state.r, v=state.v, a=state.a)


def run_production(
    cfg: SimConfig,
    state: MDState,
    backend: str = "auto",
    record_frames: bool = False,
    engine=None,
) -> SimResult:
    """Production run (md_simulation_program.f90:300-391 + finalization).

    One jitted scan; all statistics accumulate on device. Pass ``engine`` to
    supply a pre-built Engine (e.g. the particle-sharded multi-chip engine
    from ``parallel.spatial.make_spatial_engine``) instead of ``backend``.
    """
    # State-aware pencil capacity: the post-warmup state sizes the slot
    # layout (make_engine docstring) — lattice-safe padding is for init.
    engine = engine or make_engine(cfg, backend, state=state)
    prologue, n_samples, epilogue = _cadence(cfg)
    if n_samples == 0:
        raise ValueError(
            "no samples would be taken (check warmup_steps/output_interval/"
            "total_steps) — the reference aborts too (md_simulation_program.f90:399)"
        )
    dtype = _effective_dtype(cfg)

    # t=0 forces (md_simulation_program.f90:236)
    ecarry, _ = engine.init(state)

    # Un-sampled steps up to the first sampling point.
    if prologue:
        ecarry, _ = _advance(
            ecarry, engine.step, prologue, dtype,
            fast_fn=engine.step_fast, want_obs=False, run_fast=engine.run_fast,
        )

    means0 = means_init(dtype=dtype)

    def sample_body(carry, _):
        ec, acc = carry
        ec, ob = _advance(
            ec, engine.step, cfg.output_interval, dtype,
            fast_fn=engine.step_fast, run_fast=engine.run_fast,
        )
        acc = means_update(acc, ob, cfg.n, cfg.volume)
        temp, press = instantaneous_temp_press(ob, cfg.n, cfg.volume)
        series = jnp.stack([ob.epot, ob.ekin, ob.epot + ob.ekin, temp, press])
        if record_frames:
            # get_state only when frames are recorded: the pencil engine's
            # is an (n+1,3) scatter per array, and eager callers would
            # execute it per sample for nothing.
            st = engine.get_state(ec)
            ys = (series, (st.r, st.ru, st.v, st.a))
        else:
            ys = (series, None)
        return (ec, acc), ys

    (ecarry, acc), (series_t, frame_arrays) = lax.scan(
        sample_body, (ecarry, means0), None, length=n_samples
    )

    if epilogue:
        ecarry, _ = _advance(
            ecarry, engine.step, epilogue, dtype,
            fast_fn=engine.step_fast, want_obs=False, run_fast=engine.run_fast,
        )
    state = engine.get_state(ecarry)
    diagnostics = engine.diagnostics(ecarry)

    series = series_t.T  # (5, n_samples)
    report = means_finalize(acc)

    max_lag = cfg.corr_max_lag
    n_blocks = cfg.corr_n_blocks(n_samples)
    if max_lag >= 1:
        corr, corr_norm = autocorr_all(series, max_lag, centered=True)
    else:
        corr = jnp.zeros((5, 1), dtype)
        corr_norm = jnp.zeros((5, 1), dtype)
    if n_blocks >= 1 and max_lag >= 1:
        cm = jax.vmap(
            partial(block_corr_means, n_blocks=n_blocks, max_lag=max_lag, centered=True)
        )(series)
        corr_mean, corr_mean_norm = cm
    else:
        corr_mean = jnp.zeros_like(corr)
        corr_mean_norm = jnp.zeros_like(corr_norm)

    steps = jnp.asarray(sample_steps(cfg), dtype)
    times = steps * jnp.asarray(cfg.dt, dtype)

    frames = Frames(*frame_arrays) if record_frames else None
    return SimResult(
        final_state=state,
        times=times,
        series=series,
        means=report,
        corr=corr,
        corr_norm=corr_norm,
        corr_mean=corr_mean,
        corr_mean_norm=corr_mean_norm,
        frames=frames,
        diagnostics=diagnostics,
    )


# Per-(cfg, backend, record_frames) count of pipeline TRACES (not calls):
# the body below only executes while jax traces it, so tests can assert the
# cache really makes repeat simulate() calls trace-free.
_pipeline_trace_counts: dict = {}


@functools.lru_cache(maxsize=8)
def _simulate_fn(cfg: SimConfig, backend: str, record_frames: bool):
    """Cached jitted init+production pipeline, keyed like the ensemble paths'
    ``_batched_ensemble_fn``/``_streaming_programs`` caches: a fresh
    ``jax.jit`` closure per ``simulate()`` call re-TRACES the whole pipeline
    every invocation."""
    key = (cfg, backend, record_frames)

    def pipeline(k):
        _pipeline_trace_counts[key] = _pipeline_trace_counts.get(key, 0) + 1
        state = initialize(cfg, k, backend=backend)
        return run_production(cfg, state, backend=backend, record_frames=record_frames)

    return jax.jit(pipeline)


def simulate(
    cfg: SimConfig,
    key: Optional[jax.Array] = None,
    backend: str = "auto",
    record_frames: bool = False,
    jit: bool = True,
) -> SimResult:
    """Full pipeline: initialize + production (the run_all.sh equivalent).

    The jitted pipeline is cached on (cfg, backend, record_frames), so
    repeated calls with the same configuration trace and compile once."""
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    if jit:
        return _simulate_fn(cfg, backend, record_frames)(key)

    def pipeline(k):
        state = initialize(cfg, k, backend=backend)
        return run_production(cfg, state, backend=backend, record_frames=record_frames)

    return pipeline(key)
