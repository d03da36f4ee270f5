"""Executor of the GUST scheduled format: ``y = M @ x`` from either packed
layout (padded :class:`PackedSchedule` or ragged :class:`RaggedSchedule`).

Counterpart of ``repro.kernels.ops.execute_spmm``.  The device of the
artifact decides the path: on a CUDA artifact the hand-written kernels
run, chosen by layout, gather and pipeline as the reference chooses its
Pallas kernels; on a CPU artifact their plain PyTorch versions.  There
is no fallback from one to the other.  The resilience fault sites
``kernel.execute`` (tagged ``"cuda"`` or ``"plain"``) and ``gather.local``
(when the resolved gather is segment-local) fire on every call; an
injected fault reaches the caller as a failed kernel would.
"""

from __future__ import annotations

import warnings
from typing import Tuple, Union

import torch

from ..core.formats import GustSchedule
from ..core.packing import (
    PackedSchedule,
    RaggedSchedule,
    default_cache,
    pack_schedule,
    packed_spec,
    resolve_gather,
)
from ..resilience import faults

from .gust_spmv import gust_spmv, gust_spmv_db, gust_spmv_local, gust_spmv_local_db
from .gust_spmv_ragged import (
    gust_spmv_ragged,
    gust_spmv_ragged_db,
    gust_spmv_ragged_local,
    gust_spmv_ragged_local_db,
)

__all__ = [
    "PackedSchedule",
    "RaggedSchedule",
    "pack_schedule",
    "packed_spec",
    "execute_spmm",
    "gust_spmm",
    "gust_spmm_auto",
    "normalize_choice",
    "EXECUTE_CHOICES",
]

#: Legal values of every string knob the executor (and PlanConfig)
#: accepts — the one place rejection messages are defined.
EXECUTE_CHOICES = {
    "gather": ("resident", "local", "auto"),
    "layout": ("padded", "ragged", "auto"),
    "pipeline": ("single", "double", "auto"),
}


def normalize_choice(name: str, value: str, allowed: Tuple[str, ...] = None):
    """Validate a string knob against its allowed values, raising the one
    normalized rejection message every caller shares::

        unknown <name> 'x'; expected one of: 'a', 'b'

    Returns the value unchanged so call sites can validate inline."""
    if allowed is None:
        allowed = EXECUTE_CHOICES[name]
    if value not in allowed:
        raise ValueError(
            f"unknown {name} {value!r}; expected one of: "
            + ", ".join(repr(a) for a in allowed)
        )
    return value


def _prep_x(x: torch.Tensor, n: int, l: int) -> torch.Tensor:
    """Zero-pad x (n, B) to the (S*l, B) float32 layout the kernels and
    plain versions gather from (padding slots hold in-range lane columns,
    so every gather stays in bounds)."""
    seg_count = -(-n // l)
    xp = torch.zeros(seg_count * l, x.shape[1], dtype=torch.float32, device=x.device)
    xp[:n] = x
    return xp


def execute_spmm(
    packed: Union[PackedSchedule, RaggedSchedule],
    x: torch.Tensor,
    *,
    c_blk: int = 8,
    transpose_io: bool = False,
    gather: str = "auto",
    pipeline: str = "auto",
    layout: str = "auto",
) -> torch.Tensor:
    """``y = M @ x`` from either packed layout; x (n, B) -> y (m, B), in
    x's dtype (accumulation is f32).

    ``x`` must lie on the artifact's device.  ``c_blk`` applies only to
    the padded layout's unquantized resident path (a ragged stream's block
    height is fixed at pack time; an override on a quantized or local
    padded stream raises).  ``transpose_io=True`` takes and returns
    batch-major arrays: x (B, n) -> y (B, m).  An x with no column
    (B = 0) gives the empty ``(m, 0)`` (or ``(0, m)``) result and launches
    nothing, as the reference's kernel path does.

    ``gather`` and ``pipeline`` are the reference's knobs, routed as the
    reference routes its kernels: on the card, ``pipeline="double"`` (and
    ``"auto"``, which means double-buffered there) runs the double-buffered
    kernel of the layout and the resolved gather, ``pipeline="single"``
    its single-buffered kernel.  The plain path has no tile pipeline and
    ignores ``pipeline``, as the reference's jnp path does.  ``layout``
    is an assertion: naming the wrong one raises.
    """
    normalize_choice("gather", gather)
    normalize_choice("pipeline", pipeline)
    normalize_choice("layout", layout)
    if faults.enabled():
        faults.trip("kernel.execute",
                    tag="cuda" if packed.device.type == "cuda" else "plain")
        eff_gather = gather
        if eff_gather == "auto":
            eff_gather = resolve_gather(packed.s_blk, packed.seg_count)
        if eff_gather == "local":
            faults.trip("gather.local")
    ragged = isinstance(packed, RaggedSchedule)
    actual_layout = "ragged" if ragged else "padded"
    if layout not in ("auto", actual_layout):
        raise ValueError(
            f"layout={layout!r} requested but the packed artifact is "
            f"{actual_layout} (the layout is decided at pack time)"
        )
    m, n = packed.shape
    if transpose_io:
        if x.dim() != 2 or x.shape[1] != n:
            raise ValueError(
                f"expected batch-major x of shape (B, {n}) with "
                f"transpose_io=True, got {tuple(x.shape)}"
            )
        x = x.T
    elif x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"expected x of shape ({n}, B), got {tuple(x.shape)}")
    if x.device != packed.device:
        raise ValueError(
            f"x is on {x.device} but the packed artifact is on {packed.device}"
        )
    l, W = packed.l, packed.num_windows
    quant = packed.scale_blk is not None
    if gather == "auto":
        gather = resolve_gather(packed.s_blk, packed.seg_count)
    if not ragged and c_blk != packed.c_blk:
        if gather == "local":
            raise ValueError(
                f"c_blk={c_blk} override on the padded local path is not "
                f"executable: the pack-time gather tables were built at "
                f"c_blk={packed.c_blk} (re-pack at the desired block "
                f"height, or use gather='resident')"
            )
        if quant:
            raise ValueError(
                f"c_blk={c_blk} override on a quantized stream is not "
                f"executable: the per-block scales are aligned to the "
                f"pack-time c_blk={packed.c_blk} blocks (re-pack at the "
                f"desired block height)"
            )
    local = gather == "local"
    double = pipeline != "single"
    if x.shape[1] == 0:  # an empty batch: nothing to launch
        y = torch.zeros(m, 0, dtype=x.dtype, device=x.device)
        return y.T if transpose_io else y

    xp = _prep_x(x, n, l)
    # the execute-time c_blk applies only to the padded resident unquantized
    # stream; a padded local one equals the pack-time c_blk (checked above)
    kw = dict(num_windows=W, l=l, scale_blk=packed.scale_blk,
              c_blk=packed.c_blk if ragged or quant else c_blk)
    if ragged:
        blocks = (packed.block_window, packed.block_starts)
        if local:
            fn = gust_spmv_ragged_local_db if double else gust_spmv_ragged_local
            y_win = fn(
                packed.m_blk, packed.col_loc, packed.row_blk, packed.seg_blk,
                *blocks, xp, **kw,
            )
        else:
            fn = gust_spmv_ragged_db if double else gust_spmv_ragged
            y_win = fn(packed.m_blk, packed.col_blk, packed.row_blk, *blocks, xp, **kw)
    elif local:
        fn = gust_spmv_local_db if double else gust_spmv_local
        y_win = fn(
            packed.m_blk, packed.col_loc, packed.row_blk, packed.seg_blk, xp, **kw
        )
    else:
        fn = gust_spmv_db if double else gust_spmv
        y_win = fn(packed.m_blk, packed.col_blk, packed.row_blk, xp, **kw)
    b = xp.shape[1]
    y_sorted = y_win.reshape(W * l, b)
    if packed.identity_perm:
        # the scheduled row order is the output order: skip the scatter
        y = y_sorted[:m]
    else:
        out = torch.zeros(max(m, W * l), b, dtype=torch.float32, device=xp.device)
        out[packed.row_perm.long()] = y_sorted
        y = out[:m]
    y = y.to(x.dtype)
    return y.T if transpose_io else y


def gust_spmm(
    packed: Union[PackedSchedule, RaggedSchedule],
    x: torch.Tensor,
    *,
    c_blk: int = 8,
) -> torch.Tensor:
    """Legacy packed-entry shim: ``y = M @ x``, x (n, B) -> y (m, B), on
    the artifact's device.  Routes through
    :meth:`~repro_torch.core.plan.GustPlan.from_artifact`; prefer
    ``repro_torch.plan(matrix, ...).spmm(x)``."""
    from ..core.plan import GustPlan

    return GustPlan.from_artifact(packed, c_blk=c_blk).spmm(x)


def gust_spmm_auto(
    sched: GustSchedule,
    x: torch.Tensor,
    *,
    c_blk: int = 8,
    waste_threshold: float = None,
    cache=default_cache,
    device="cuda",
) -> torch.Tensor:
    """Deprecated schedule-level shim: pick ragged or padded by the
    measured waste, pack through the content-keyed cache on ``device``,
    execute.  Use ``repro_torch.plan(sched, PlanConfig(layout="auto",
    ...)).spmm(x)``."""
    warnings.warn(
        "gust_spmm_auto(sched, x, ...) is deprecated; use "
        "repro_torch.plan(sched, PlanConfig(layout='auto', c_blk=...), "
        "device=...).spmm(x)",
        DeprecationWarning,
        stacklevel=2,
    )
    from ..core.plan import PlanConfig, plan

    p = plan(
        sched,
        PlanConfig(l=sched.l, layout="auto", c_blk=c_blk,
                   waste_threshold=waste_threshold),
        cache=cache,
        device=device,
    )
    return p.spmm(x)
