"""Simulation state pytrees.

Rebuild of the reference's ``sim_state`` struct-of-arrays container
(``scripts/base/md_types.f90:56-60,175-230``) plus the unwrapped-coordinate
tracking arrays the reference driver allocates separately
(``scripts/md_simulation_program.f90:199-231``).

Design: the state is a single immutable pytree of ``(N, 3)``
arrays resident in HBM for the whole ``lax.scan`` trajectory, carried
functionally through the step function instead of mutated in place. The RNG
key and step counter live in the pytree too so checkpoints capture a full
resumable state (SURVEY §5.4).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

__all__ = ["MDState", "StepObs", "zero_state", "kinetic_energy"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MDState:
    """Full microscopic state at one instant.

    Fields (all ``(N, 3)`` arrays, reduced units):
      r   wrapped positions in [0, L)
      ru  unwrapped positions (continuous across PBC; for MSD/diffusion)
      v   velocities
      a   accelerations (= forces, since m = 1)
    """

    r: jax.Array
    ru: jax.Array
    v: jax.Array
    a: jax.Array

    @property
    def n(self) -> int:
        return self.r.shape[-2]

    @property
    def dtype(self):
        return self.r.dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StepObs:
    """Instantaneous observables returned by one integrator step, evaluated
    at the new time t+dt (contract of ``verlet_step``, reference
    ``verlet.f90:41-97`` and SURVEY §3.3).

      epot     total LJ potential energy U (tail-corrected)
      ekin     kinetic energy K = 1/2 sum v^2
      d_epot   sum_{i<j} r_ij dU/dr_ij  (virial sum; W = -d_epot)
      dd_epot  sum_{i<j} r_ij^2 d2U/dr_ij^2 (response-function sum)
    """

    epot: jax.Array
    ekin: jax.Array
    d_epot: jax.Array
    dd_epot: jax.Array

    @property
    def etot(self) -> jax.Array:
        return self.epot + self.ekin


def zero_state(n: int, dtype=jnp.float32) -> MDState:
    """Allocate an all-zero state (reference ``zero_state``,
    md_types.f90:204-219)."""
    z = jnp.zeros((n, 3), dtype=dtype)
    return MDState(r=z, ru=z, v=z, a=z)


def kinetic_energy(v: jax.Array) -> jax.Array:
    """K = 1/2 sum_i |v_i|^2 (reference verlet.f90:93-95). Accumulates in the
    array dtype; callers on the f32 path that need tighter sums should cast."""
    return 0.5 * jnp.sum(v * v)
