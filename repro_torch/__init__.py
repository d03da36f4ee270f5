"""repro_torch — the PyTorch/CUDA port of GUST (graph edge-coloring SpMV).

The JAX package ``repro`` is the reference; this package mirrors its
module layout and names, imports neither ``jax`` nor ``repro``, and runs
its hot path through CUDA kernels written for Hopper (``kernels/csrc``).
Public API, exported lazily so that ``import repro_torch`` stays cheap:

    >>> import repro_torch
    >>> p = repro_torch.plan(matrix, repro_torch.PlanConfig(
    ...     gather="resident", pipeline="single"))          # device="cuda"
    >>> y = p.spmv(v)
"""

from typing import TYPE_CHECKING

_EXPORTS = {
    "plan": "repro_torch.core.plan",
    "PlanConfig": "repro_torch.core.plan",
    "COOMatrix": "repro_torch.core.formats",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.formats import COOMatrix
    from repro_torch.core.plan import PlanConfig, plan
