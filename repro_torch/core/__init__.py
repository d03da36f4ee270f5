"""Host side of the port: formats, scheduler, packing, plan, SpGEMM.

Counterpart of ``repro.core``, with the names of its ``__all__`` (but
``SparsityConfig``, which the port does not have) exported lazily (PEP
562), so that importing a torch-free host module (``formats``,
``scheduler``, ``load_balance``, ``bounds``, ``baselines``,
``hardware_model``) through this package loads no torch.

Two of those names, ``plan`` and ``spmv``, are also submodules, and here
they are the submodules in every import order: ``import
repro_torch.core.spmv as m`` and ``from repro_torch.core import spmv``
both read the package's attribute, which the import system sets to the
submodule once it is loaded.  The functions are ``repro_torch.plan`` and
``repro_torch.spmv`` (and ``repro_torch.core.plan.plan``, ``.spmv.spmv``).
"""

from typing import TYPE_CHECKING

_EXPORTS = {
    "COOMatrix": "repro_torch.core.formats",
    "GustSchedule": "repro_torch.core.formats",
    "coo_from_dense": "repro_torch.core.formats",
    "dense_from_coo": "repro_torch.core.formats",
    "schedule": "repro_torch.core.scheduler",
    "GustPlan": "repro_torch.core.plan",
    "PlanConfig": "repro_torch.core.plan",
    "PlanCost": "repro_torch.core.plan",
    "TuneResult": "repro_torch.core.plan",
    "PackedSchedule": "repro_torch.core.packing",
    "RaggedSchedule": "repro_torch.core.packing",
    "ScheduleCache": "repro_torch.core.packing",
    "pack_auto": "repro_torch.core.packing",
    "pack_ragged": "repro_torch.core.packing",
    "pack_schedule": "repro_torch.core.packing",
    "packed_spec": "repro_torch.core.packing",
    "ragged_waste_ratio": "repro_torch.core.packing",
    "schedule_packed": "repro_torch.core.packing",
    "spmv_scheduled": "repro_torch.core.spmv",
    "spmm_scheduled": "repro_torch.core.spmv",
    "spmm_ragged": "repro_torch.core.spmv",
    "distributed_spmv": "repro_torch.core.spmv",
    "expected_colors_bound": "repro_torch.core.bounds",
    "expected_execution_cycles": "repro_torch.core.bounds",
    "expected_utilization": "repro_torch.core.bounds",
    "GustLinear": "repro_torch.core.gust_linear",
    "prune_by_magnitude": "repro_torch.core.gust_linear",
}
#: Names of the reference's ``__all__`` that are submodules here.
_SUBMODULES = ("plan", "spmv")

__all__ = sorted([*_EXPORTS, *_SUBMODULES])


def __getattr__(name: str):
    import importlib

    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
    elif name in _SUBMODULES:
        value = importlib.import_module(f"repro_torch.core.{name}")
    else:
        raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))


if TYPE_CHECKING:  # static analyzers see the real symbols
    from repro_torch.core import plan, spmv  # noqa: F401
    from repro_torch.core.bounds import (  # noqa: F401
        expected_colors_bound,
        expected_execution_cycles,
        expected_utilization,
    )
    from repro_torch.core.formats import (  # noqa: F401
        COOMatrix,
        GustSchedule,
        coo_from_dense,
        dense_from_coo,
    )
    from repro_torch.core.gust_linear import GustLinear, prune_by_magnitude  # noqa: F401
    from repro_torch.core.packing import (  # noqa: F401
        PackedSchedule,
        RaggedSchedule,
        ScheduleCache,
        pack_auto,
        pack_ragged,
        pack_schedule,
        packed_spec,
        ragged_waste_ratio,
        schedule_packed,
    )
    from repro_torch.core.plan import GustPlan, PlanConfig, PlanCost, TuneResult  # noqa: F401
    from repro_torch.core.scheduler import schedule  # noqa: F401
    from repro_torch.core.spmv import (  # noqa: F401
        distributed_spmv,
        spmm_ragged,
        spmm_scheduled,
        spmv_scheduled,
    )
