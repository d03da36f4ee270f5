"""repro_torch — the PyTorch/CUDA port of GUST (graph edge-coloring SpMV).

The JAX package ``repro`` is the reference; this package mirrors its
module layout and names, imports neither ``jax`` nor ``repro``, and runs
its hot path through CUDA kernels written for Hopper (``kernels/csrc``).
Public API, exported lazily so that ``import repro_torch`` stays cheap:

    >>> import repro_torch
    >>> p = repro_torch.plan(matrix, repro_torch.PlanConfig(l=256))  # device="cuda"
    >>> y = p.spmv(v)
    >>> C = p.spgemm(B)                        # sparse x sparse -> COOMatrix
    >>> repro_torch.triangle_count(A)          # graph analytics (repro_torch.graph)
    >>> layer = repro_torch.GustLinear(w, density=0.1)   # y = layer(x)
    >>> p = repro_torch.plan(M, store=repro_torch.PlanStore(path))  # warm loads
    >>> repro_torch.verify(leaves, meta)       # GUST-Pxx findings of an artifact
    >>> lm = repro_torch.build_model(repro_torch.get_arch("yi_6b"))  # dense LM
    >>> loop = repro_torch.ServeLoop(lm, lm.init(gen), repro_torch.ServeConfig(
    ...     batch=4, seq_len=512, gust=repro_torch.GustServeConfig()))  # GUST decode
"""

from typing import TYPE_CHECKING

_EXPORTS = {
    "plan": "repro_torch.core.plan",
    "PlanConfig": "repro_torch.core.plan",
    "GustPlan": "repro_torch.core.plan",
    "PlanCost": "repro_torch.core.plan",
    "TuneResult": "repro_torch.core.plan",
    "reschedule": "repro_torch.core.plan",
    "RescheduleResult": "repro_torch.core.plan",
    "PlanStore": "repro_torch.core.plan_store",
    # the module path, not the package: ``repro_torch.analysis.verify`` is
    # both a submodule and a lazy export, so the package's attribute turns
    # with import order; this one is always the function
    "verify": "repro_torch.analysis.verify",
    "Finding": "repro_torch.analysis.verify",
    "GustLinear": "repro_torch.core.gust_linear",
    "prune_by_magnitude": "repro_torch.core.gust_linear",
    "FaultPlan": "repro_torch.resilience.faults",
    "FaultSpec": "repro_torch.resilience.faults",
    "RequestResult": "repro_torch.resilience.lifecycle",
    "RequestStatus": "repro_torch.resilience.lifecycle",
    "expected_colors_bound": "repro_torch.core.bounds",
    "expected_execution_cycles": "repro_torch.core.bounds",
    "expected_utilization": "repro_torch.core.bounds",
    "spmv": "repro_torch.core.spmv",
    "spmv_scheduled": "repro_torch.core.spmv",
    "spmm_scheduled": "repro_torch.core.spmv",
    "spmm_ragged": "repro_torch.core.spmv",
    "distributed_spmv": "repro_torch.core.spmv",
    "gust_spmm": "repro_torch.kernels.ops",
    "gust_spmm_auto": "repro_torch.kernels.ops",
    "ScheduleCache": "repro_torch.core.packing",
    "clear_cache": "repro_torch.core.packing",
    "PackedSchedule": "repro_torch.core.packing",
    "RaggedSchedule": "repro_torch.core.packing",
    "GustSchedule": "repro_torch.core.formats",
    "coo_from_dense": "repro_torch.core.formats",
    "dense_from_coo": "repro_torch.core.formats",
    "schedule": "repro_torch.core.scheduler",
    "COOMatrix": "repro_torch.core.formats",
    "spgemm": "repro_torch.core.spgemm",
    "SpgemmCost": "repro_torch.core.spgemm",
    "pagerank": "repro_torch.graph.analytics",
    "triangle_count": "repro_torch.graph.analytics",
    "feature_propagation": "repro_torch.graph.analytics",
    "PageRankResult": "repro_torch.graph.analytics",
    "TriangleCountResult": "repro_torch.graph.analytics",
    "ArchConfig": "repro_torch.configs.base",
    "get_arch": "repro_torch.configs.base",
    "LM": "repro_torch.models.model_zoo",
    "build_model": "repro_torch.models.model_zoo",
    "from_reference_params": "repro_torch.core.convert",
    "CachePolicy": "repro_torch.serving.kv_cache",
    "cache_bytes": "repro_torch.serving.kv_cache",
    "cache_specs": "repro_torch.serving.kv_cache",
    "cache_shardings": "repro_torch.serving.kv_cache",
    "GustServeConfig": "repro_torch.serving.gust_serve",
    "gustify": "repro_torch.serving.gust_serve",
    "decode_step_gust": "repro_torch.serving.gust_serve",
    "dryrun_specs": "repro_torch.serving.gust_serve",
    "ServeConfig": "repro_torch.serving.serve_loop",
    "ServeLoop": "repro_torch.serving.serve_loop",
    "make_sampler": "repro_torch.serving.serve_loop",
    "make_serve_fns": "repro_torch.serving.serve_loop",
    "run_serving": "repro_torch.launch.serve",
}
#: Subpackages, imported on first access.
_SUBMODULES = ("configs", "graph", "launch", "models", "resilience", "serving")

__all__ = sorted([*_EXPORTS, *_SUBMODULES])


def __getattr__(name):
    import importlib

    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
    elif name in _SUBMODULES:
        value = importlib.import_module(f"repro_torch.{name}")
    else:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))


if TYPE_CHECKING:  # pragma: no cover
    from repro_torch import configs, graph, launch, models, resilience, serving
    from repro_torch.analysis.verify import Finding, verify
    from repro_torch.configs.base import ArchConfig, get_arch
    from repro_torch.core.convert import from_reference_params
    from repro_torch.launch.serve import run_serving
    from repro_torch.models.model_zoo import LM, build_model
    from repro_torch.serving.gust_serve import (
        GustServeConfig,
        decode_step_gust,
        dryrun_specs,
        gustify,
    )
    from repro_torch.serving.kv_cache import (
        CachePolicy,
        cache_bytes,
        cache_shardings,
        cache_specs,
    )
    from repro_torch.serving.serve_loop import (
        ServeConfig,
        ServeLoop,
        make_sampler,
        make_serve_fns,
    )
    from repro_torch.core.bounds import (
        expected_colors_bound,
        expected_execution_cycles,
        expected_utilization,
    )
    from repro_torch.core.formats import (
        COOMatrix,
        GustSchedule,
        coo_from_dense,
        dense_from_coo,
    )
    from repro_torch.core.gust_linear import GustLinear, prune_by_magnitude
    from repro_torch.core.packing import (
        PackedSchedule,
        RaggedSchedule,
        ScheduleCache,
        clear_cache,
    )
    from repro_torch.core.plan import (
        GustPlan,
        PlanConfig,
        PlanCost,
        RescheduleResult,
        TuneResult,
        plan,
        reschedule,
    )
    from repro_torch.core.plan_store import PlanStore
    from repro_torch.core.scheduler import schedule
    from repro_torch.core.spmv import (
        distributed_spmv,
        spmm_ragged,
        spmm_scheduled,
        spmv,
        spmv_scheduled,
    )
    from repro_torch.kernels.ops import gust_spmm, gust_spmm_auto
    from repro_torch.resilience.faults import FaultPlan, FaultSpec
    from repro_torch.resilience.lifecycle import RequestResult, RequestStatus
    from repro_torch.core.spgemm import SpgemmCost, spgemm
    from repro_torch.graph.analytics import (
        PageRankResult,
        TriangleCountResult,
        feature_propagation,
        pagerank,
        triangle_count,
    )
