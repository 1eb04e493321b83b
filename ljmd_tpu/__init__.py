"""ljmd_tpu — a JAX molecular dynamics framework for the 3-D
monoatomic Lennard-Jones fluid in the NVE ensemble, in reduced LJ units.

Ground-up rebuild of the capabilities of the Fortran reference
``Ledicia/Molecular-Dynamics-Simulation---Lennard-Jones-monoatomic-fluid``,
designed JAX/XLA-first: pure-function physics kernels under ``jit``,
``lax.scan`` time loops with on-device statistics, neighbor-list and
cell-column pair sweeps for the force evaluation, and ``vmap``/``shard_map``
ensemble replicas over a device mesh.

Package layout:
  config    frozen SimConfig + reference input-file parser
  state     MDState / StepObs pytrees
  ops       geometry (PBC/MIC), dense LJ kernel, neighbor lists, pencil binning
  models    FCC/velocity init, velocity-Verlet, force dispatch, simulation drivers
  stats     streaming moments, autocorrelations + block means, thermo coefficients
  analysis  MSD, VACF, RDF, diffusion estimators, ACF timescales, plots
  io        trajectory/checkpoint IO, Fortran-format compat readers
  parallel  device mesh + ensemble sharding
  utils     ran3-parity RNG, profiling helpers
"""

__version__ = "0.1.0"

from ljmd_tpu.config import SimConfig, load_config, parse_reference_input  # noqa: F401
from ljmd_tpu.state import MDState, StepObs  # noqa: F401
