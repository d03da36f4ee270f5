"""Executor of the GUST scheduled format: ``y = M @ x`` from either packed
layout (padded :class:`PackedSchedule` or ragged :class:`RaggedSchedule`).

Counterpart of ``repro.kernels.ops.execute_spmm``.  The device of the
artifact decides the path: on a CUDA artifact the hand-written kernels
run (``gust_spmv`` / ``gust_spmv_ragged``), on a CPU artifact their
plain PyTorch versions.  There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..core.packing import PackedSchedule, RaggedSchedule, resolve_gather

from .gust_spmv import gust_spmv
from .gust_spmv_ragged import gust_spmv_ragged

__all__ = ["execute_spmm", "normalize_choice", "EXECUTE_CHOICES"]

#: Legal values of every string knob the executor (and PlanConfig)
#: accepts — the one place rejection messages are defined.
EXECUTE_CHOICES = {
    "gather": ("resident", "local", "auto"),
    "layout": ("padded", "ragged", "auto"),
    "pipeline": ("single", "double", "auto"),
}

#: Where the port's missing execution modes are queued.
_ROADMAP = {
    "local": "ROADMAP §2 items 3-4 (segment-local gather kernels)",
    "double": "ROADMAP §2 items 5-8 (double-buffered kernels)",
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
    batch-major arrays: x (B, n) -> y (B, m).

    ``gather`` and ``pipeline`` are the reference's knobs.  This slice
    runs the resident gather with the single-buffered kernels; a resolved
    ``gather="local"``, or ``pipeline="double"`` on the card (``"auto"``
    means double there, as in the reference), raises
    ``NotImplementedError`` naming the ROADMAP item.  The plain path has
    no tile pipeline and ignores ``pipeline``, as the reference's jnp
    path does.  ``layout`` is an assertion: naming the wrong one raises.
    """
    normalize_choice("gather", gather)
    normalize_choice("pipeline", pipeline)
    normalize_choice("layout", layout)
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
    if gather == "local":
        raise NotImplementedError(
            f"gather='local' is not ported yet: {_ROADMAP['local']}; "
            "use gather='resident'"
        )
    if packed.device.type == "cuda" and pipeline != "single":
        raise NotImplementedError(
            f"pipeline={pipeline!r} resolves to the double-buffered kernels, "
            f"which are not ported yet: {_ROADMAP['double']}; use "
            "pipeline='single'"
        )

    xp = _prep_x(x, n, l)
    if ragged:
        y_win = gust_spmv_ragged(
            packed.m_blk, packed.col_blk, packed.row_blk,
            packed.block_window, packed.block_starts, xp,
            num_windows=W, l=l, c_blk=packed.c_blk, scale_blk=packed.scale_blk,
        )
    else:
        y_win = gust_spmv(
            packed.m_blk, packed.col_blk, packed.row_blk, xp,
            num_windows=W, l=l, c_blk=packed.c_blk if quant else c_blk,
            scale_blk=packed.scale_blk,
        )
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
