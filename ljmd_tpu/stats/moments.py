"""Streaming time-average accumulator for the 11 scalar observables.

Rebuild of ``scripts/stats/md_means.f90`` (type ``md_means_accum``, 67-114;
``md_means_add_sample`` 192-275; ``md_means_get`` 284-366): streaming sums
Sum(x) and Sum(x^2) of

  U, K, E, T, P, 1/K, dU, ddU, dU/K, dU^2/K, ddU/K

without storing the series, where per sample

  T = 2 K / (3 N)            (md_means.f90:221 — note 3N here, vs 3N-3 in
                              the coefficient module; documented reference
                              quirk, SURVEY §2.3.4)
  P = rho T + W / (3 V)      (md_means.f90:227), with W = -d_epot
                              (md_simulation_program.f90:365-366)

Design: instead of 22 named scalar fields, the accumulator is one
``(2, 11)`` array (row 0 = sums, row 1 = sums of squares) living in the
``lax.scan`` carry, so a sample update is two fused vector ops. Observable
order is fixed by ``OBSERVABLES``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ljmd_tpu.state import StepObs

__all__ = [
    "OBSERVABLES",
    "MeansAccum",
    "MeansReport",
    "means_init",
    "means_update",
    "means_finalize",
    "instantaneous_temp_press",
]

# Index order of accumulated observables (means/stds are reported in this
# order). Names follow the reference's md_means_get argument names.
OBSERVABLES = (
    "epot",              # U
    "ekin",              # K
    "etot",              # E = U + K
    "temp",              # T = 2K/(3N)
    "press",             # P = rho T + W/(3V)
    "ekin_inv",          # 1/K
    "d_epot",            # dU   = sum r dU/dr
    "dd_epot",           # ddU  = sum r^2 d2U/dr2
    "d_epot_ekin_inv",   # dU/K
    "d_epot2_ekin_inv",  # dU^2/K
    "dd_epot_ekin_inv",  # ddU/K
)
NUM_OBSERVABLES = len(OBSERVABLES)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeansAccum:
    """count: number of samples; moments: (2, 11) [sums; sums of squares] of
    the SHIFTED samples x - shift, with shift captured from the first sample.
    Shifting is algebraically free (var(x) == var(x - c)) and necessary in
    f32: <Etot^2> - <Etot>^2 on raw values loses ALL of Etot's tiny NVE
    variance to cancellation (reported std 3.6 vs true 0.025 on the
    reference-default run in f32)."""

    count: jax.Array
    moments: jax.Array
    shift: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeansReport:
    """Means and stds over samples, each shape (11,) ordered as OBSERVABLES."""

    count: jax.Array
    means: jax.Array
    stds: jax.Array

    def _idx(self, name: str) -> int:
        return OBSERVABLES.index(name)

    def mean(self, name: str) -> jax.Array:
        return self.means[..., self._idx(name)]

    def std(self, name: str) -> jax.Array:
        return self.stds[..., self._idx(name)]

    def as_dict(self) -> dict:
        return {
            name: (self.means[..., i], self.stds[..., i])
            for i, name in enumerate(OBSERVABLES)
        }


def means_init(dtype=jnp.float32) -> MeansAccum:
    return MeansAccum(
        count=jnp.zeros((), dtype=dtype),
        moments=jnp.zeros((2, NUM_OBSERVABLES), dtype=dtype),
        shift=jnp.zeros((NUM_OBSERVABLES,), dtype=dtype),
    )


def instantaneous_temp_press(obs: StepObs, n: int, volume: float):
    """Per-sample T and P from instantaneous observables (md_means.f90:221,227)."""
    dtype = obs.ekin.dtype
    npd = jnp.asarray(float(n), dtype)
    rho = jnp.asarray(n / volume, dtype)
    temp = 2.0 * obs.ekin / (3.0 * npd)
    virial = -obs.d_epot  # W = -d_epot (md_simulation_program.f90:365-366)
    press = rho * temp + virial / jnp.asarray(3.0 * volume, dtype)
    return temp, press


def _sample_vector(obs: StepObs, n: int, volume: float) -> jax.Array:
    temp, press = instantaneous_temp_press(obs, n, volume)
    ekin_inv = 1.0 / obs.ekin  # reference aborts on K <= 0 (md_means.f90:244);
    # here K <= 0 yields inf, surfaced by driver-level NaN/inf checks.
    du = obs.d_epot
    ddu = obs.dd_epot
    return jnp.stack(
        [
            obs.epot,
            obs.ekin,
            obs.epot + obs.ekin,
            temp,
            press,
            ekin_inv,
            du,
            ddu,
            du * ekin_inv,
            du * du * ekin_inv,
            ddu * ekin_inv,
        ]
    )


def means_update(acc: MeansAccum, obs: StepObs, n: int, volume: float) -> MeansAccum:
    """Add one sample (md_means_add_sample). All 11 observables in two fused
    vector ops."""
    x = _sample_vector(obs, n, volume).astype(acc.moments.dtype)
    shift = jnp.where(acc.count == 0, x, acc.shift)
    dx = x - shift
    moments = acc.moments + jnp.stack([dx, dx * dx])
    return MeansAccum(count=acc.count + 1, moments=moments, shift=shift)


def means_finalize(acc: MeansAccum) -> MeansReport:
    """Means and stds; std = sqrt(max(0, <x^2> - <x>^2))
    (stats_math.f90:56-61)."""
    inv_n = 1.0 / acc.count
    dmean = acc.moments[0] * inv_n
    second = acc.moments[1] * inv_n
    var = jnp.maximum(second - dmean * dmean, 0.0)
    return MeansReport(count=acc.count, means=acc.shift + dmean,
                       stds=jnp.sqrt(var))
