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
"""

from typing import TYPE_CHECKING

_EXPORTS = {
    "plan": "repro_torch.core.plan",
    "PlanConfig": "repro_torch.core.plan",
    "COOMatrix": "repro_torch.core.formats",
    "spgemm": "repro_torch.core.spgemm",
    "SpgemmCost": "repro_torch.core.spgemm",
    "pagerank": "repro_torch.graph.analytics",
    "triangle_count": "repro_torch.graph.analytics",
    "feature_propagation": "repro_torch.graph.analytics",
    "PageRankResult": "repro_torch.graph.analytics",
    "TriangleCountResult": "repro_torch.graph.analytics",
}
#: Subpackages, imported on first access.
_SUBMODULES = ("graph",)

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
    from repro_torch import graph
    from repro_torch.core.formats import COOMatrix
    from repro_torch.core.plan import PlanConfig, plan
    from repro_torch.core.spgemm import SpgemmCost, spgemm
    from repro_torch.graph.analytics import (
        PageRankResult,
        TriangleCountResult,
        feature_propagation,
        pagerank,
        triangle_count,
    )
