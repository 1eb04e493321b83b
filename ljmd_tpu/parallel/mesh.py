"""Device-mesh helpers.

The reference is single-process (SURVEY §5.8): its only "distribution" is a
serial loop over runs. The equivalents built on this mesh:

- ensemble replicas  -> mesh axis "replica" (data-parallel analogue; collectives
  only for final cross-run reductions) — ``ljmd_tpu/parallel/ensemble.py``
- large-N particle sharding -> mesh axis "particle" (sequence-parallel
  analogue; i-tiles sharded, j blocks passed around a ring) —
  ``ljmd_tpu/parallel/spatial.py``
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "REPLICA_AXIS", "PARTICLE_AXIS"]

REPLICA_AXIS = "replica"
PARTICLE_AXIS = "particle"


def make_mesh(
    replica: int = 1,
    particle: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (replica, particle) mesh. With defaults (1,1) uses one device.

    Axis sizes must multiply to the device count used.
    """
    if devices is None:
        devices = jax.devices()
    n = replica * particle
    if n > len(devices):
        raise ValueError(
            f"mesh needs {n} devices ({replica} replica x {particle} particle), "
            f"only {len(devices)} available"
        )
    dev_array = np.asarray(devices[:n]).reshape(replica, particle)
    return Mesh(dev_array, (REPLICA_AXIS, PARTICLE_AXIS))
