"""Benchmark: particle-steps/s for the flagship N=4000 LJ fluid on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", "card", ...}.

Measures the ``auto`` engine's observable-free step (what the production
driver runs between samples) in a jitted ``lax.scan``, timed on the host
clock to ``jax.block_until_ready``; the value is the median of the timed
repeats. Exits non-zero, printing no result, when JAX finds no GPU.

Run: ``python bench.py``
"""

from __future__ import annotations

import json
import statistics
import time

N_STEPS = 2000
REPEATS = 5


def main() -> None:
    import jax
    import jax.numpy as jnp

    from ljmd_tpu.config import config_from_density
    from ljmd_tpu.models.engine import auto_backend, make_engine
    from ljmd_tpu.models.lattice import (
        fcc_lattice,
        random_velocities,
        remove_com_velocity,
    )
    from ljmd_tpu.state import MDState
    from ljmd_tpu.utils.profiling import card_description, require_gpu

    devices = require_gpu()
    card = card_description()
    cfg = config_from_density(num_cells=10, density=0.8442, dt=0.005, dtype="float32")

    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=jnp.float32)
    v = remove_com_velocity(random_velocities(jax.random.PRNGKey(0), cfg.n, dtype=jnp.float32))
    # scale to T* ~ 0.728 (the classic liquid point)
    v = v * jnp.sqrt(0.728 / (jnp.sum(v * v) / (3 * cfg.n)))
    engine = make_engine(cfg, "auto")
    carry, _ = engine.init(MDState(r=r, ru=r, v=v, a=jnp.zeros_like(r)))

    @jax.jit
    def run(c):
        if engine.run_fast is not None:
            return engine.run_fast(c, N_STEPS)
        return jax.lax.scan(lambda cc, _: (engine.step_fast(cc)[0], None),
                            c, None, length=N_STEPS)[0]

    t0 = time.perf_counter()
    carry = jax.block_until_ready(run(carry))  # compile + equilibrate
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        carry = jax.block_until_ready(run(carry))
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times) / N_STEPS

    _, obs = jax.jit(engine.step)(carry)
    print(json.dumps({
        "metric": f"particle-steps/s (LJ NVE, N={cfg.n}, rho*=0.8442, rc=2.5, f32, "
                  f"{auto_backend(cfg)} engine)",
        "value": cfg.n / step_s,
        "unit": "particle-steps/s",
        "step_us": step_s * 1e6,
        "step_us_runs": [t / N_STEPS * 1e6 for t in times],
        "first_call_s": compile_s,
        "device": {"platform": devices[0].platform, "kind": devices[0].device_kind,
                   "count": len(devices)},
        "card": card,
        "etot_per_particle": (float(obs.epot) + float(obs.ekin)) / cfg.n,
    }))


if __name__ == "__main__":
    main()
