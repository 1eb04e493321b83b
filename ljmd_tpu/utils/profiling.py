"""Tracing / profiling helpers (SURVEY §5.1 — absent in the reference;
JAX-native here).

- ``trace``: context manager capturing a jax.profiler trace (TensorBoard
  format) around a region, e.g. the production scan.
- ``Throughput``: wall-clock throughput meter reporting steps/s and
  particle-steps/s (the BASELINE metric).
- ``time_fn``: best-of-n wall time of a jitted function, each call ended
  by ``jax.block_until_ready`` (dispatch is asynchronous).
- ``require_gpu`` / ``card_description``: what every on-card measurement
  checks first and prints beside its numbers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time
from typing import Callable, Optional

import jax

__all__ = ["trace", "Throughput", "time_fn", "require_gpu", "card_description"]


@contextlib.contextmanager
def trace(log_dir: str, host_profiling: bool = False):
    """Capture a profiler trace of the enclosed region into ``log_dir``
    (viewable in TensorBoard / Perfetto)."""
    jax.profiler.start_trace(log_dir, create_perfetto_trace=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class Throughput:
    """Step-throughput meter: accumulate (steps, particles) batches and
    report rates."""

    n_particles: int
    steps: int = 0
    elapsed: float = 0.0
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, steps_done: int) -> None:
        if self._t0 is None:
            raise RuntimeError("Throughput.stop() without start()")
        self.elapsed += time.perf_counter() - self._t0
        self.steps += steps_done
        self._t0 = None

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.elapsed if self.elapsed else 0.0

    @property
    def particle_steps_per_sec(self) -> float:
        return self.steps_per_sec * self.n_particles

    def report(self) -> dict:
        return {
            "steps": self.steps,
            "elapsed_s": self.elapsed,
            "steps_per_sec": self.steps_per_sec,
            "particle_steps_per_sec": self.particle_steps_per_sec,
        }


def time_fn(fn: Callable, *args, iters: int = 3) -> float:
    """Best-of-``iters`` wall time of ``fn(*args)`` after one warm-up call
    (which compiles); each call is timed to ``jax.block_until_ready``."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def require_gpu() -> list:
    """JAX's devices, or SystemExit when the first is not a GPU: an on-card
    measurement never falls back to another platform."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"error: needs a GPU, but JAX found {devices[0].platform!r} devices"
        )
    return devices


def card_description() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them, read
    by a child process that stays off JAX. A card set below its maximum
    power runs slower under load, so every number is kept beside this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
