"""GUST SpMV from the raw schedule, and the legacy entry shims.

Counterpart of ``repro.core.spmv``.  The scheduled format turns SpMV into
three dense streaming steps — the paper's three hardware levels:

  1. multiply   : ``P = M_sch * v[Col_sch]``          (the l multipliers)
  2. route      : partial product (c, j) goes to adder ``Row_sch[c, j]``
                  of its window                        (the crossbar)
  3. accumulate : adders integrate per window, dump at window end.

:func:`spmv_scheduled` computes them in plain PyTorch from the unpacked
schedule: the oracle the packed paths are checked against.  The other
entry points (``spmv``, ``spmm_scheduled``, ``spmm_ragged``) are legacy
shims that build a :class:`~repro_torch.core.plan.GustPlan` and delegate;
new code calls ``repro_torch.plan(matrix, config).spmv(v)`` / ``.spmm(x)``.
Every entry point runs on the card unless ``device="cpu"`` is asked for
(``spmm_ragged`` runs on its artifact's device).  ``distributed_spmv``
is the §5.5 scale-out shim over :meth:`GustPlan.shard`.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict

import numpy as np
import torch

from .formats import COOMatrix, GustSchedule
from .packing import RaggedSchedule, resolve_device, window_ids

__all__ = [
    "spmv_dense_ref",
    "spmv_scheduled",
    "spmv",
    "spmm_scheduled",
    "spmm_ragged",
    "distributed_spmv",
]


def spmv_dense_ref(dense: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Oracle: plain dense matvec."""
    return dense @ v


def spmv_scheduled(sched: GustSchedule, v, *, device="cuda") -> torch.Tensor:
    """SpMV from the raw (unpacked) scheduled format on ``device``, in
    float32.  Padding slots (``sched.valid`` false) add nothing, whatever
    x holds at their column."""
    device = resolve_device(device)
    v = torch.as_tensor(v, device=device)
    m, n = sched.shape
    if tuple(v.shape) != (n,):
        raise ValueError(f"vector shape {tuple(v.shape)} != ({n},)")
    l, W = sched.l, sched.num_windows

    def leaf(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    # Level 1: the multipliers.  Buffer Filler == gather by Col_sch.
    col = leaf(sched.col_sch, torch.int64).clamp_(0, max(n - 1, 0))
    partial = leaf(sched.m_sch, torch.float32) * v.to(torch.float32)[col]
    partial = torch.where(leaf(sched.valid), partial, torch.zeros_like(partial))
    # Levels 2+3: route to adder window*l + row and accumulate.
    adder = leaf(window_ids(sched), torch.int64)[:, None] * l + leaf(
        sched.row_sch, torch.int64)
    y_sorted = torch.zeros(W * l, dtype=torch.float32, device=device)
    y_sorted.index_add_(0, adder.reshape(-1), partial.reshape(-1))
    # Undo the load-balancing row sort: scheduled row s is original row
    # row_perm[s].
    y = torch.zeros(m, dtype=torch.float32, device=device)
    y[leaf(sched.row_perm, torch.int64)] = y_sorted[:m]
    return y


#: Identity-keyed LRU of shim plans: repeated ``spmm_scheduled`` calls on
#: one schedule object (and device) reuse one plan and its pack without
#: the cache's O(nnz) content hash.  Entries hold the schedule, so an id
#: cannot be recycled while its entry lives; the identity re-check makes a
#: stale hit impossible.
_SHIM_PLANS: "OrderedDict[tuple, object]" = OrderedDict()
_SHIM_PLANS_MAX = 64


def spmm_scheduled(sched: GustSchedule, x, *, device="cuda") -> torch.Tensor:
    """Legacy shim: multi-vector SpMV, ``x (n, B) -> (m, B)``, through a
    padded-layout plan on ``device``; prefer
    ``repro_torch.plan(sched).spmm(x)``."""
    from .plan import PlanConfig, plan

    device = resolve_device(device)
    key = (id(sched), str(device))
    p = _SHIM_PLANS.get(key)
    if p is None or p.sched is not sched:
        p = plan(sched, PlanConfig(l=sched.l, layout="padded"), cache=None,
                 device=device)
        _SHIM_PLANS[key] = p
        while len(_SHIM_PLANS) > _SHIM_PLANS_MAX:
            _SHIM_PLANS.popitem(last=False)
    else:
        _SHIM_PLANS.move_to_end(key)
    return p.spmm(x)


def spmm_ragged(ragged: RaggedSchedule, x) -> torch.Tensor:
    """Legacy shim: multi-vector SpMV from the ragged block stream,
    ``x (n, B) -> (m, B)``, on the stream's device."""
    from .plan import GustPlan

    return GustPlan.from_artifact(ragged).spmm(x)


def spmv(
    coo: COOMatrix,
    v,
    l: int = 256,
    *,
    load_balance: bool = True,
    method: str = "fast",
    device="cuda",
) -> torch.Tensor:
    """Deprecated convenience shim: schedule + execute in one call.  Use
    ``repro_torch.plan(coo, PlanConfig(l=..., colorer=...)).spmv(v)``."""
    warnings.warn(
        "spmv(coo, v, l=..., method=...) is deprecated; use "
        "repro_torch.plan(coo, PlanConfig(l=..., colorer=..., "
        "load_balance=...)).spmv(v) ('method' is spelled 'colorer', 'l' "
        "stays 'l')",
        DeprecationWarning,
        stacklevel=2,
    )
    from .plan import PlanConfig, plan

    return plan(
        coo, PlanConfig(l=l, colorer=method, load_balance=load_balance),
        device=device,
    ).spmv(v)


def distributed_spmv(
    sched: GustSchedule,
    v,
    mesh,
    axis: str = "data",
    *,
    c_blk: int = 1,
    cache="default",
    device="cuda",
) -> torch.Tensor:
    """Legacy shim for the paper's §5.5 "k parallel length-l GUSTs": the
    row windows split over ``mesh``'s ``axis`` dim (contiguous ranges
    balanced by ragged-stream block count; the schedule is untouched),
    each rank running its range on ``device``, the outputs gathered over
    the dim.  Every rank of the dim calls it with the same ``sched`` and
    ``v``.  Routes through ``repro_torch.plan(sched, ...).shard(mesh,
    axis).spmv(v)``; ``cache="default"`` uses the process-wide
    :class:`~repro_torch.core.packing.ScheduleCache`, ``None`` re-packs
    every call."""
    from .packing import default_cache
    from .plan import PlanConfig, plan

    if cache == "default":
        cache = default_cache
    p = plan(
        sched,
        PlanConfig(l=sched.l, layout="ragged", c_blk=c_blk, mesh_axis=axis),
        cache=cache,
        device=device,
    )
    return p.shard(mesh, axis).spmv(v)
