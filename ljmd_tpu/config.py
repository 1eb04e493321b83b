"""Simulation configuration for the JAX Lennard-Jones MD engine.

This is the rebuild of the reference's parameter layer:

- ``sim_params`` container + derived-parameter computation
  (reference: ``scripts/base/md_types.f90:27-50,105-169``)
- block-text input-file parsing
  (reference: ``scripts/base/read_input_files.f90:27-171``)

Unlike the reference's mutable derived fields, the config here is a frozen,
hashable dataclass: every derived quantity is computed once in a validated
constructor, and the object is static under ``jax.jit`` (closed over or passed
as a static argument), so XLA sees only compile-time constants.

All quantities are in reduced LJ units (sigma = epsilon = m = k_B = 1),
matching the reference (``README.md:75-84``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["SimConfig", "parse_reference_input", "load_config"]

_ALLOWED_DTYPES = ("float32", "float64")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters (hashable; safe to close over under jit).

    Core inputs mirror the reference input file
    (``inputs/input_simulation_parameters.txt``):

    - ``num_cells`` (k): FCC cells per box edge; N = 4 k**3
      (reference ``read_input_files.f90:167-168``)
    - ``total_steps`` / ``output_interval`` / ``warmup_steps``: MD loop control
    - ``dt``: integration time step
    - ``box_length`` (L): cubic box edge
    - ``rc_over_box``: cutoff radius as a fraction of L (must be in (0, 0.5))
    - ``target_total_energy``: total-energy target used by the velocity
      rescaling at initialization (``md_initial_config_program.f90:244-266``)

    Rebuild-specific fields (promoted from values hardcoded in the reference,
    per SURVEY §5.6):

    - ``dtype``: "float32" (production) or "float64" (parity/testing)
    - ``seed``: PRNG seed for velocity init (reference hardcodes -12345)
    - ``use_tail_corrections``: compile-time flag in the reference
      (``lj_potential_energy.f90:36``)
    - ``corr_max_lag_cap`` / ``corr_max_blocks``: caps on autocorrelation lag
      and block count (reference ``md_simulation_program.f90:281,476``)
    - ``n_runs``: ensemble replica count (reference ``run_many_md.f90:26``)
    """

    # --- core inputs (reference input file) ---
    num_cells: int = 5
    total_steps: int = 500_000
    output_interval: int = 100
    warmup_steps: int = 5_000
    dt: float = 1.0e-4
    box_length: float = 10.0
    rc_over_box: float = 0.49
    target_total_energy: float = -555.0

    # --- rebuild-specific ---
    dtype: str = "float32"
    seed: int = 12345
    use_tail_corrections: bool = True
    corr_max_lag_cap: int = 1000
    corr_max_blocks: int = 5
    n_runs: int = 10
    # Verlet neighbor lists (absent in the reference — SURVEY §5.7):
    # skin beyond rc for the list radius; capacity 0 = auto-estimate.
    neighbor_skin: float = 0.4
    neighbor_capacity: int = 0
    # Kahan/Neumaier-compensated position & velocity updates: removes the
    # f32 roundoff drift floor at small dt (reference runs use dt=1e-4) at
    # ~zero cost relative to the force kernel. Ignored for float64.
    compensated_sum: bool = False

    # --- derived (filled in __post_init__; do not pass) ---
    n: int = dataclasses.field(init=False, default=0)
    rc: float = dataclasses.field(init=False, default=0.0)
    rc_square: float = dataclasses.field(init=False, default=0.0)
    volume: float = dataclasses.field(init=False, default=0.0)
    density: float = dataclasses.field(init=False, default=0.0)
    inv_box_length: float = dataclasses.field(init=False, default=0.0)

    def __post_init__(self) -> None:
        # Validation mirrors read_input_files.f90:105-141 and
        # md_types.f90:132-169 (including the hard rc < L/2 MIC constraint).
        if self.num_cells <= 0:
            raise ValueError("num_cells (k) must be > 0")
        if self.total_steps <= 0:
            raise ValueError("total_steps must be > 0")
        if self.output_interval <= 0:
            raise ValueError("output_interval must be > 0")
        if self.warmup_steps < 0:
            raise ValueError("warmup_steps must be >= 0")
        if self.dt <= 0.0:
            raise ValueError("dt must be > 0")
        if self.box_length <= 0.0:
            raise ValueError("box_length must be > 0")
        if not (0.0 < self.rc_over_box <= 0.5):
            raise ValueError("rc_over_box must be in (0, 0.5]")
        if self.dtype not in _ALLOWED_DTYPES:
            raise ValueError(f"dtype must be one of {_ALLOWED_DTYPES}")
        if self.corr_max_lag_cap < 0 or self.corr_max_blocks < 0:
            raise ValueError("correlation caps must be >= 0")
        if self.n_runs <= 0:
            raise ValueError("n_runs must be > 0")
        if self.neighbor_skin < 0.0:
            raise ValueError("neighbor_skin must be >= 0")
        if self.neighbor_capacity < 0:
            raise ValueError("neighbor_capacity must be >= 0")

        n = 4 * self.num_cells**3  # N = 4 k^3 (read_input_files.f90:167-168)
        rc = self.rc_over_box * self.box_length
        if not (rc < 0.5 * self.box_length):
            # compute_derived_params enforces rc < L/2 strictly
            # (md_types.f90:152-154): minimum-image distances are only
            # unambiguous below half the box.
            raise ValueError("rc must be strictly less than box_length / 2")
        volume = self.box_length**3

        object.__setattr__(self, "n", n)
        object.__setattr__(self, "rc", rc)
        object.__setattr__(self, "rc_square", rc * rc)
        object.__setattr__(self, "volume", volume)
        object.__setattr__(self, "density", n / volume)
        object.__setattr__(self, "inv_box_length", 1.0 / self.box_length)

    # ------------------------------------------------------------------
    # Conveniences
    # ------------------------------------------------------------------
    @property
    def half_dt(self) -> float:
        return 0.5 * self.dt

    @property
    def half_dt_sq(self) -> float:
        return 0.5 * self.dt * self.dt

    @property
    def lattice_constant(self) -> float:
        """FCC lattice constant a = L / k (md_initial_config_program.f90:73)."""
        return self.box_length / self.num_cells

    @property
    def n_samples(self) -> int:
        """Number of production samples, matching the sampling condition
        ``(step > warmup) and (step % interval == 0)``
        (md_simulation_program.f90:254,277,361)."""
        n = self.total_steps // self.output_interval - self.warmup_steps // self.output_interval
        return max(n, 0)

    @property
    def corr_max_lag(self) -> int:
        """max_lag = min(cap, n_samples-1, n_samples//2)
        (md_simulation_program.f90:281-282); 0 when fewer than 2 samples."""
        ns = self.n_samples
        if ns < 2:
            return 0
        return min(self.corr_max_lag_cap, ns - 1, ns // 2)

    def corr_n_blocks(self, num_samples: Optional[int] = None) -> int:
        """n_blocks = min(cap, num_samples // (max_lag+1))
        (md_simulation_program.f90:475-476)."""
        ns = self.n_samples if num_samples is None else num_samples
        lag = self.corr_max_lag
        return min(self.corr_max_blocks, ns // (lag + 1))

    def replace(self, **kwargs) -> "SimConfig":
        """Return a new config with the given fields replaced (derived fields
        recomputed)."""
        base = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.init
        }
        base.update(kwargs)
        return SimConfig(**base)

    def summary(self) -> dict:
        return {
            "n": self.n,
            "num_cells": self.num_cells,
            "box_length": self.box_length,
            "density": self.density,
            "rc": self.rc,
            "dt": self.dt,
            "total_steps": self.total_steps,
            "warmup_steps": self.warmup_steps,
            "output_interval": self.output_interval,
            "n_samples": self.n_samples,
            "target_total_energy": self.target_total_energy,
            "dtype": self.dtype,
            "use_tail_corrections": self.use_tail_corrections,
        }


def parse_reference_input(text: str, **overrides) -> SimConfig:
    """Parse the reference's block-structured text config into a SimConfig.

    Format (reference ``read_input_files.f90:85-157`` and
    ``inputs/input_simulation_parameters.txt``): lines starting with ``#`` and
    blank lines are skipped; the remaining data lines are, in order:

    1. ``k total_steps output_interval warmup_steps``  (4 integers)
    2. ``dt L rc_over_L``                              (3 reals)
    3. ``target_total_energy``                          (1 real)

    Each block also has a bare label line ("k total_steps ...") which the
    reference reads-and-discards; we keep only lines whose first token is
    numeric. Fortran ``D``-exponents (``1.0D-4``, ``-555.d00``) are accepted.
    """

    def _is_numeric(tok: str) -> bool:
        try:
            float(tok.replace("D", "e").replace("d", "e"))
            return True
        except ValueError:
            return False

    data_lines = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if not _is_numeric(line.split()[0]):
            continue  # label line
        data_lines.append(line)
    if len(data_lines) < 3:
        raise ValueError(
            f"expected 3 data blocks in reference input, got {len(data_lines)} lines"
        )

    def _f(tok: str) -> float:
        return float(tok.replace("D", "e").replace("d", "e"))

    b1 = data_lines[0].split()
    if len(b1) < 4:
        raise ValueError("block 1 must have 4 integers: k steps interval warmup")
    k, total_steps, output_interval, warmup_steps = (int(_f(t)) for t in b1[:4])

    b2 = data_lines[1].split()
    if len(b2) < 3:
        raise ValueError("block 2 must have 3 reals: dt L rc_over_L")
    dt, box_length, rc_over_box = (_f(t) for t in b2[:3])

    b3 = data_lines[2].split()
    target_total_energy = _f(b3[0])

    kwargs = dict(
        num_cells=k,
        total_steps=total_steps,
        output_interval=output_interval,
        warmup_steps=warmup_steps,
        dt=dt,
        box_length=box_length,
        rc_over_box=rc_over_box,
        target_total_energy=target_total_energy,
    )
    kwargs.update(overrides)
    return SimConfig(**kwargs)


def load_config(path: str, **overrides) -> SimConfig:
    """Load a SimConfig from a file: reference block-text format (``.txt``)
    or JSON (``.json``, keys = SimConfig init fields).

    JSON configs may alternatively give the state point as ``density``
    (+ optional ``rc``) instead of ``box_length``/``rc_over_box`` —
    L = (4 k^3 / rho*)^(1/3) is derived like ``config_from_density``
    (the BASELINE state points are specified as (N, rho*), and deriving
    L by hand loses digits)."""
    with open(path, "r") as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{"):
        import json

        kwargs = json.loads(text)
        kwargs.update(overrides)
        if "density" in kwargs:
            if "box_length" in kwargs or "rc_over_box" in kwargs:
                raise ValueError(
                    "give either density(+rc) or box_length/rc_over_box, "
                    "not both"
                )
            density = kwargs.pop("density")
            rc = kwargs.pop("rc", None)
            return config_from_density(density=density, rc=rc, **kwargs)
        return SimConfig(**kwargs)
    return parse_reference_input(text, **overrides)


# Density helper used by standard-state-point constructors (BASELINE.json
# configs use (N, rho*) rather than (k, L)).
def config_from_density(
    num_cells: int,
    density: float,
    rc: float | None = None,
    **kwargs,
) -> SimConfig:
    """Build a config from (k, rho*): L = (N/rho)^(1/3), rc defaults to
    min(2.5, 0.49 L). Used for the BASELINE.json state points."""
    n = 4 * num_cells**3
    box_length = (n / density) ** (1.0 / 3.0)
    if rc is None:
        rc = min(2.5, 0.49 * box_length)
    if not rc < 0.5 * box_length:
        raise ValueError("requested rc does not satisfy rc < L/2")
    return SimConfig(
        num_cells=num_cells,
        box_length=box_length,
        rc_over_box=rc / box_length,
        **kwargs,
    )
