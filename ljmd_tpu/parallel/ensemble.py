"""Ensemble mode: vmapped independent replicas, optionally sharded over a
device mesh, with cross-run aggregation.

Rebuild of the reference's WIP run-many subsystem
(``scripts/run_many_md_simuations/``): the serial do-loop over runs
(run_many_md.f90:57-82) becomes ``vmap`` over a replica axis with split
threefry keys (fixing the reference's global RNG stream, SURVEY §2.3.7); the
disconnected ``simulation_results`` aggregator (which read a means.txt no
component produced — pipeline gap, SURVEY §3.4) becomes an in-memory
reduction over the replica axis, closed by construction. Per-replica
coefficient algebra uses the CANONICAL formulas, not the WIP's drifted ones
(SURVEY §2.3.3).

On a mesh, replica keys are placed with a ``replica``-axis sharding and XLA
partitions the embarrassingly-parallel batch; the final cross-run mean/std is
the only collective (SURVEY §5.8).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ljmd_tpu.config import SimConfig
from ljmd_tpu.models.simulation import SimResult, initialize, run_production
from ljmd_tpu.parallel.mesh import REPLICA_AXIS
from ljmd_tpu.stats.moments import OBSERVABLES
from ljmd_tpu.stats.thermo import ThermoCoefs, thermo_coefs_from_report

__all__ = [
    "EnsembleResult",
    "HostSeries",
    "ReplicaStats",
    "ensemble_simulate",
    "ensemble_aggregate",
]


class HostSeries:
    """Host-resident (R, 5, n_samples) sampled series.

    The streaming ensemble keeps the series on host by design (that is its
    memory guarantee) — but ``EnsembleResult`` is a pytree-registered
    dataclass, and a bare numpy array in a data field would be treated as a
    leaf: ``jax.tree.map`` over the result would device-put it (or trip on
    it under jit), silently defeating the host/device split. This wrapper is registered as a pytree node with NO children,
    so tree transformations pass it through untouched, while ``np.asarray``
    / ``.shape`` / indexing keep working for consumers.
    """

    __slots__ = ("array",)

    def __init__(self, array):
        import numpy as _np

        self.array = _np.asarray(array)

    def __array__(self, dtype=None, copy=None):
        import numpy as _np

        if dtype is None and not copy:
            return self.array
        return _np.asarray(self.array, dtype=dtype)

    @property
    def shape(self):
        return self.array.shape

    @property
    def dtype(self):
        return self.array.dtype

    def __getitem__(self, idx):
        return self.array[idx]

    def __len__(self):
        return len(self.array)

    def __repr__(self):
        return f"HostSeries(shape={self.array.shape}, dtype={self.array.dtype})"


# No children: tree.map / flatten leave the host array alone (aux data uses
# object identity for eq/hash, so treedef comparison stays well-defined).
jax.tree_util.register_pytree_node(
    HostSeries, lambda hs: ((), hs), lambda hs, _children: hs
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EnsembleResult:
    """Batched per-replica results + cross-run aggregates.

    replica_means / replica_stds: (R, 11) per-replica time-average means/stds
    (ordered as stats.moments.OBSERVABLES). mean_of_means / std_of_means:
    (11,) cross-run statistics (the simulation_results.txt content). thermo:
    ThermoCoefs with (R,)-shaped fields (per replica).
    """

    replica_means: jax.Array
    replica_stds: jax.Array
    mean_of_means: jax.Array
    std_of_means: jax.Array
    thermo: ThermoCoefs
    series: jax.Array  # (R, 5, n_samples)
    replica_ok: jax.Array  # (R,) bool: replica produced finite means
    # Cross-run-averaged correlation curves (5, max_lag+1): the ensemble
    # analogue of the reference's block-averaged ACFs — every replica is an
    # independent block, so <C(lag)>_runs / <C_norm(lag)>_runs are the
    # highest-quality correlation estimates the framework produces.
    corr_mean_runs: jax.Array
    corr_norm_mean_runs: jax.Array

    def named_cross_run(self) -> dict:
        return {
            name: (self.mean_of_means[i], self.std_of_means[i])
            for i, name in enumerate(OBSERVABLES)
        }

    @property
    def n_ok(self) -> jax.Array:
        return jnp.sum(self.replica_ok)


@dataclasses.dataclass(frozen=True)
class ReplicaStats:
    """The minimal batched per-replica statistics ``ensemble_aggregate``
    needs — what the streaming ensemble produces instead of a full
    ``SimResult`` (no final states, times, block means, or frames; the
    series lives on HOST so the (R, 5, n_samples) stack never sits in HBM).
    """

    means: object        # batched MeansReport, fields shaped (R, 11)
    corr: jax.Array      # (R, 5, max_lag+1)
    corr_norm: jax.Array  # (R, 5, max_lag+1)
    series: object       # (R, 5, n_samples): HostSeries in the streaming path


def ensemble_simulate(
    cfg: SimConfig,
    n_replicas: Optional[int] = None,
    key: Optional[jax.Array] = None,
    mesh: Optional[Mesh] = None,
    backend: str = "auto",
    jit: bool = True,
    keep_per_replica: bool = False,
):
    """Run ``n_replicas`` independent simulations (default cfg.n_runs) and
    aggregate. Each replica gets its own threefry key; results are
    bit-identical to running replicas sequentially (vmap semantics).

    With ``keep_per_replica=True`` returns
    ``(EnsembleResult, batched SimResult)`` so callers can emit per-run
    artifacts (the reference's run_XXXX directories)."""
    r = cfg.n_runs if n_replicas is None else n_replicas
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    keys = jax.random.split(key, r)

    if mesh is not None:
        keys = jax.device_put(keys, NamedSharding(mesh, P(REPLICA_AXIS, None)))
        agg, results = _batched_ensemble_fn(cfg, backend)(keys)
    elif jit:
        agg, results = _batched_ensemble_fn(cfg, backend)(keys)
    else:
        agg, results = _make_batched(cfg, backend)(keys)
    return (agg, results) if keep_per_replica else agg


def _make_batched(cfg: SimConfig, backend: str):
    def one(k) -> SimResult:
        state = initialize(cfg, k, backend=backend)
        return run_production(cfg, state, backend=backend, record_frames=False)

    def batched(ks):
        results = jax.vmap(one)(ks)
        return ensemble_aggregate(cfg, results), results

    return batched


@functools.lru_cache(maxsize=8)
def _batched_ensemble_fn(cfg: SimConfig, backend: str):
    """Cached jitted ensemble pipeline. SimConfig is hashable by design; a
    fresh closure per call would re-TRACE the whole vmapped pipeline every
    invocation, even with the XLA compile cached."""
    return jax.jit(_make_batched(cfg, backend))


def replica_result(results: SimResult, i: int) -> SimResult:
    """Slice replica ``i`` out of a vmapped SimResult."""
    return jax.tree.map(lambda x: x[i], results)


def ensemble_aggregate(
    cfg: SimConfig, results: "SimResult | ReplicaStats"
) -> EnsembleResult:
    """Cross-run reduction over the leading replica axis of a vmapped
    SimResult — or a ReplicaStats from the streaming path — (the
    simulation_results aggregation as one collective)."""
    means = results.means.means  # (R, 11)
    stds = results.means.stds
    # Per-replica divergence masks (SURVEY §5.3): a replica whose means went
    # non-finite (NVE blow-up, overlapping particles, ...) invalidates only
    # itself — it is excluded from the cross-run statistics, exactly like the
    # reference's skip-failed-runs aggregation (run_many_md.f90:76-80).
    ok = jnp.isfinite(means).all(axis=1) & jnp.isfinite(stds).all(axis=1)
    w = ok.astype(means.dtype)[:, None]
    n_ok = jnp.maximum(jnp.sum(w), 1.0)
    safe = jnp.where(jnp.isfinite(means), means, 0.0)
    mean_of_means = jnp.sum(safe * w, axis=0) / n_ok
    var = jnp.sum(((safe - mean_of_means) ** 2) * w, axis=0) / n_ok
    # Per-replica thermodynamic coefficients: the algebra is elementwise, so
    # it maps over the batched MeansReport directly.
    thermo = thermo_coefs_from_report(cfg.n, cfg.volume, results.means)
    # Cross-run ACF averages over valid replicas (each replica = one block).
    wc = w[:, :, None]
    corr_safe = jnp.where(jnp.isfinite(results.corr), results.corr, 0.0)
    corrn_safe = jnp.where(jnp.isfinite(results.corr_norm), results.corr_norm, 0.0)
    corr_mean_runs = jnp.sum(corr_safe * wc, axis=0) / n_ok
    corr_norm_mean_runs = jnp.sum(corrn_safe * wc, axis=0) / n_ok
    return EnsembleResult(
        replica_means=means,
        replica_stds=stds,
        mean_of_means=mean_of_means,
        std_of_means=jnp.sqrt(var),
        thermo=thermo,
        series=results.series,
        replica_ok=ok,
        corr_mean_runs=corr_mean_runs,
        corr_norm_mean_runs=corr_norm_mean_runs,
    )


@functools.lru_cache(maxsize=8)
def _streaming_programs(cfg: SimConfig, backend: str):
    """Jitted (init_all, chunk, corr_fn) for the streaming ensemble, cached
    on (config, backend) like ``_batched_ensemble_fn``: fresh ``jax.jit``
    wrappers per call would re-TRACE the vmapped scan programs every
    invocation — XLA compilation is content-cached process-wide, but
    tracing the R-batched sample cycle is not. The cache makes repeat
    streaming calls trace-free."""
    from functools import partial

    from jax import lax

    from ljmd_tpu.models.engine import _effective_dtype, make_engine
    from ljmd_tpu.models.simulation import _advance, _cadence
    from ljmd_tpu.stats.correlations import autocorr_all
    from ljmd_tpu.stats.moments import (
        instantaneous_temp_press,
        means_init,
        means_update,
    )

    engine = make_engine(cfg, backend)
    prologue, _n_samples, _ = _cadence(cfg)
    dtype = _effective_dtype(cfg)

    @jax.jit
    def init_all(ks):
        def one(k):
            state = initialize(cfg, k, backend=backend)
            ec, _ = engine.init(state)
            if prologue:
                ec, _ = _advance(
                    ec, engine.step, prologue, dtype,
                    fast_fn=engine.step_fast, want_obs=False,
                    run_fast=engine.run_fast,
                )
            return ec, means_init(dtype=dtype)
        return jax.vmap(one)(ks)

    @partial(jax.jit, static_argnames=("k",))
    def chunk(ec, acc, k: int):
        def one(ec, acc):
            def body(carry, _):
                ec_, acc_ = carry
                ec_, ob = _advance(
                    ec_, engine.step, cfg.output_interval, dtype,
                    fast_fn=engine.step_fast, run_fast=engine.run_fast,
                )
                acc_ = means_update(acc_, ob, cfg.n, cfg.volume)
                temp, press = instantaneous_temp_press(ob, cfg.n, cfg.volume)
                series = jnp.stack([ob.epot, ob.ekin, ob.epot + ob.ekin, temp, press])
                return (ec_, acc_), series
            (ec, acc), s = lax.scan(body, (ec, acc), None, length=k)
            return ec, acc, s.T  # (5, k)
        return jax.vmap(one)(ec, acc)

    if cfg.corr_max_lag >= 1:
        corr_fn = jax.jit(
            jax.vmap(lambda s: autocorr_all(s, cfg.corr_max_lag, centered=True))
        )
    else:
        corr_fn = None
    return init_all, chunk, corr_fn, dtype


def ensemble_simulate_streaming(
    cfg: SimConfig,
    n_replicas: Optional[int] = None,
    key: Optional[jax.Array] = None,
    backend: str = "auto",
    chunk_samples: int = 32,
):
    """Ensemble run with HOST-streamed per-replica series: the sampled (R, 5, k) series blocks are fetched to host after
    every ``chunk_samples`` samples, so a config-4-at-scale run (many
    replicas x reference-length sampling) never materializes the full
    (R, 5, n_samples) series DURING the run — only the means accumulators
    and the engine carries stay on device while stepping.

    The correlation stage afterwards IS batched: one vmapped program over
    the full (R, 5, n_samples) host stack (a host loop of per-replica jit
    calls costs one dispatch per replica). At config-4 scale that stack is ~6 MB; for R*n_samples far
    beyond that, chunk the ``corr_fn`` call over replica groups.

    Returns an EnsembleResult numerically identical to ``ensemble_simulate``
    (same per-sample op sequence; scan chunking does not change the math),
    with ``series`` wrapped in :class:`HostSeries` (host numpy, pytree-inert).
    """
    import numpy as np

    from ljmd_tpu.models.simulation import _cadence
    from ljmd_tpu.stats.moments import means_finalize

    r = cfg.n_runs if n_replicas is None else n_replicas
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    keys = jax.random.split(key, r)

    _, n_samples, epilogue = _cadence(cfg)
    if n_samples == 0:
        raise ValueError("no samples would be taken")
    init_all, chunk, corr_fn, dtype = _streaming_programs(cfg, backend)

    ec, acc = init_all(keys)
    blocks = []
    done = 0
    while done < n_samples:
        k = min(chunk_samples, n_samples - done)
        ec, acc, block = chunk(ec, acc, k)
        blocks.append(np.asarray(block, dtype=np.float64))  # (R, 5, k) to host
        done += k
    series_host = np.concatenate(blocks, axis=2)  # (R, 5, n_samples)

    report = jax.vmap(lambda a: means_finalize(a))(acc)

    # Per-replica correlation curves, batched over replicas in ONE vmapped
    # program instead of a host loop of r jit calls; the full
    # (R, 5, n_samples) f32 stack is only ~6 MB at config-4 scale.
    if corr_fn is not None:
        c, cn = corr_fn(jnp.asarray(series_host, dtype))
        corr = jnp.asarray(np.asarray(c))
        corr_norm = jnp.asarray(np.asarray(cn))
    else:
        corr = jnp.zeros((r, 5, 1), dtype)
        corr_norm = jnp.zeros((r, 5, 1), dtype)

    # series stays a HOST numpy array (the whole point: the (R,5,n) stack
    # never persists in HBM); ensemble_aggregate only reduces means/corr.
    return ensemble_aggregate(
        cfg,
        ReplicaStats(means=report, corr=corr, corr_norm=corr_norm,
                     series=HostSeries(series_host)),
    )
