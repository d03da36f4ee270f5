"""Packed GUST scheduled format, holding torch tensors.

Counterpart of ``repro.core.packing``.  The host work (the scatter of
schedule rows into color blocks, the segment-local gather tables, the
int8 quantization) is the reference's numpy code; only the leaves become
torch tensors, on the device the caller names.  Every leaf is bitwise
equal to the reference's ``packed_leaves`` / ``ragged_leaves`` for the
same schedule and dtypes.

Two layouts share the packed-format invariants (padding slots have value
0, column equal to the slot's lane, and row 0):

* :func:`pack_schedule` (*padded*) pads every window to a common
  ``C_pad`` (max window colors rounded up to ``c_blk``): ``(W * C_pad, l)``.
* :func:`pack_ragged` (*ragged*) keeps each window's
  ``max(ceil(C_w / c_blk), 1)`` blocks in one ``(T_blk * c_blk, l)``
  stream; window ``w`` owns blocks ``block_starts[w]:block_starts[w+1]``.

Scheduling and packing are cached on matrix / schedule content
(:class:`ScheduleCache`), so two plans over one matrix schedule once.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .formats import COOMatrix, GustSchedule
from .scheduler import schedule

__all__ = [
    "PackedSchedule",
    "RaggedSchedule",
    "pack_blocks",
    "pack_schedule",
    "pack_ragged",
    "DEFAULT_WASTE_THRESHOLD",
    "DEFAULT_LOCALITY_RATIO",
    "DEFAULT_LOCAL_MIN_SEGS",
    "resolve_device",
    "resolve_layout",
    "resolve_gather",
    "ragged_waste_ratio",
    "packed_leaves",
    "packed_meta",
    "packed_from_leaves",
    "ragged_leaves",
    "ragged_meta",
    "ragged_from_leaves",
    "ScheduleCache",
    "DEFAULT_SCHEDULE_CACHE_SIZE",
    "default_cache",
]

#: Leaf dtypes the port packs and executes, by the names ``PlanConfig``
#: uses (the reference's ``jnp.dtype(...).name`` spellings).
VALUE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}
INDEX_DTYPES = {"int32": torch.int32, "int16": torch.int16}


def dtype_name(dtype) -> str:
    """Canonical name of a dtype given as a string, a torch dtype or a
    numpy dtype (``torch.float32`` -> ``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def _lookup(table: Dict[str, torch.dtype], dtype, kind: str) -> torch.dtype:
    name = dtype_name(dtype)
    if name not in table:
        raise ValueError(
            f"unsupported {kind} dtype {name!r}; expected one of: "
            + ", ".join(repr(k) for k in table)
        )
    return table[name]


def resolve_device(device) -> torch.device:
    """The port's device rule: a CUDA device must exist when one is named
    (the default everywhere), and nothing quietly runs on the CPU instead.
    ``device="cpu"`` selects the plain PyTorch path."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return device


def _leaf(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy -> torch leaf.  The dtype conversion runs on the host, where
    f32 -> bf16 rounds to nearest-even as ``jnp.asarray`` does and
    integer narrowing wraps as numpy's does."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
    return t.to(device)


@dataclasses.dataclass
class PackedSchedule:
    """Fixed-shape GUST scheduled format (padded layout).

    Tensors (leaves):
      m_blk:   (W * C_pad, l) values; 0 in padding slots.  float32,
               bfloat16, or int8 (then ``scale_blk`` is present).
      col_blk: (W * C_pad, l) int32/int16 original column index; padding
               slots hold the slot's own lane.
      row_blk: (W * C_pad, l) int32/int16 adder index; 0 in padding slots.
      row_perm:(W * l,) int32 — original row of each scheduled row position
               (identity-extended past m).
      seg_blk: (T_blk, S_blk) int32 — per-(c_blk, l)-block distinct column
               segments (sorted; padded with segment 0).
      col_loc: (W * C_pad, l) col_blk remapped to block-local segment ids.
      scale_blk: (T_blk,) f32 per-block dequantization scales, or ``None``:
               the value of slot ``(r, j)`` is
               ``float32(m[r, j]) * scale_blk[r // c_blk]``.

    Static: l, num_windows, c_pad, shape=(m, n), fusable, c_blk, s_blk,
    identity_perm (row_perm is the identity — the executor skips the
    output scatter).
    """

    m_blk: torch.Tensor
    col_blk: torch.Tensor
    row_blk: torch.Tensor
    row_perm: torch.Tensor
    seg_blk: torch.Tensor
    col_loc: torch.Tensor
    l: int
    num_windows: int
    c_pad: int
    shape: Tuple[int, int]
    fusable: bool
    c_blk: int
    s_blk: int
    identity_perm: bool
    scale_blk: Optional[torch.Tensor] = None

    @property
    def seg_count(self) -> int:
        return -(-self.shape[1] // self.l)

    @property
    def quantized(self) -> bool:
        return self.scale_blk is not None

    @property
    def device(self) -> torch.device:
        return self.m_blk.device

    @property
    def streamed_slots(self) -> int:
        """(cycle, lane) slots the execution path streams."""
        return self.m_blk.numel()

    @property
    def stream_bytes(self) -> int:
        """Device bytes of the scheduled stream (value + col + row leaves at
        their actual dtypes) plus the per-block scales when quantized."""
        extra = (self.scale_blk,) if self.scale_blk is not None else ()
        return sum(
            a.numel() * a.element_size()
            for a in (self.m_blk, self.col_blk, self.row_blk) + extra
        )


@dataclasses.dataclass
class RaggedSchedule:
    """Ragged color-block stream of the GUST scheduled format.

    Tensors (leaves): as :class:`PackedSchedule` over ``T_blk * c_blk``
    stream rows, plus
      block_window: (T_blk,) int32 — window id of each stream block
                    (sorted; blocks of one window are contiguous).
      block_starts: (W + 1,) int32 — window ``w`` owns stream blocks
                    ``block_starts[w]:block_starts[w+1]`` (at least one).

    Static: l, num_windows, c_blk, num_blocks (= T_blk), shape, fusable,
    s_blk, identity_perm.
    """

    m_blk: torch.Tensor
    col_blk: torch.Tensor
    row_blk: torch.Tensor
    row_perm: torch.Tensor
    seg_blk: torch.Tensor
    col_loc: torch.Tensor
    block_window: torch.Tensor
    block_starts: torch.Tensor
    l: int
    num_windows: int
    c_blk: int
    num_blocks: int
    shape: Tuple[int, int]
    fusable: bool
    s_blk: int
    identity_perm: bool
    scale_blk: Optional[torch.Tensor] = None

    @property
    def seg_count(self) -> int:
        return -(-self.shape[1] // self.l)

    @property
    def quantized(self) -> bool:
        return self.scale_blk is not None

    @property
    def device(self) -> torch.device:
        return self.m_blk.device

    @property
    def streamed_slots(self) -> int:
        """(cycle, lane) slots the execution path streams."""
        return self.num_blocks * self.c_blk * self.l

    @property
    def stream_bytes(self) -> int:
        """Device bytes of the scheduled stream plus the scalar block
        metadata and the per-block scales when quantized."""
        extra = (self.scale_blk,) if self.scale_blk is not None else ()
        return sum(
            a.numel() * a.element_size()
            for a in (self.m_blk, self.col_blk, self.row_blk,
                      self.block_window, self.block_starts) + extra
        )


def pack_blocks(
    sched: GustSchedule, c_blk: int = 8
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, bool]:
    """Vectorized core of the ragged→padded conversion (host numpy).

    Returns ``(m_b, c_b, r_b, c_pad, fusable)`` with the three blocks of
    shape ``(W * c_pad, l)``.  Each real cycle row scatters to global
    destination ``window * C_pad + local_cycle`` in one fancy-indexed
    assignment.
    """
    l, W = sched.l, sched.num_windows
    ws = np.asarray(sched.window_starts)
    cpw = np.diff(ws)
    c_max = int(cpw.max()) if W else 1
    c_pad = max(-(-c_max // c_blk) * c_blk, c_blk)
    c_total = int(ws[-1]) if W else 0

    lane = np.arange(l, dtype=np.int32)
    # One backing allocation for all three blocks (f32 and i32 share the
    # itemsize, so the value plane is a reinterpreting view).
    buf = np.zeros((3, W * c_pad, l), dtype=np.int32)
    m_b = buf[0].view(np.float32)
    r_b = buf[1]
    c_b = buf[2]
    c_b[:] = lane  # padding slots gather x[lane] (packed-format invariant)
    if c_total:
        wid = np.repeat(np.arange(W, dtype=np.int64), cpw)
        dest = wid * c_pad + (np.arange(c_total, dtype=np.int64) - ws[wid])
        m_b[dest] = sched.m_sch[:c_total]
        r_b[dest] = sched.row_sch[:c_total]
        c_b[dest] = sched.col_sch[:c_total]

    return m_b, c_b, r_b, c_pad, _fusable(sched)


def _fusable(sched: GustSchedule) -> bool:
    """The lane structure the reference's fused gather relies on: every
    slot's column offset is its lane or the reversed lane.  The port's
    direct gather does not need it; the flag is kept for leaf parity."""
    l = sched.l
    lane = np.arange(l, dtype=np.int32)
    src = sched.col_sch
    off = (src & (l - 1)) if (l & (l - 1)) == 0 else (src % l)
    return bool(np.all((off == lane[None, :]) | (off == (l - 1 - lane)[None, :])))


def _quantize_stream(
    m_b: np.ndarray, c_blk: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-block symmetric int8 quantization of a packed value stream.

    For each ``(c_blk, l)`` block: ``scale = absmax / 127`` (1.0 for
    all-zero blocks) and ``q = clip(rint(v / scale), -127, 127)`` int8.
    Exact zeros — every padding slot — quantize to exactly 0.  Dequant is
    ``float32(q) * scale`` everywhere (kernel and plain version alike).

    Returns ``(q (rows, l) int8, scale (rows // c_blk,) f32)``.
    """
    m_b = np.ascontiguousarray(m_b, np.float32)
    rows, l = m_b.shape
    if rows % c_blk:
        raise ValueError(f"stream rows {rows} not a multiple of c_blk {c_blk}")
    blocks = m_b.reshape(rows // c_blk, c_blk * l)
    absmax = np.abs(blocks).max(axis=1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(
        np.rint(blocks / scale[:, None].astype(np.float32)), -127, 127
    ).astype(np.int8)
    return q.reshape(rows, l), scale


def _local_gather_tables(
    col: np.ndarray, l: int, c_blk: int, s_min: int = 1
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Segment-local gather tables of a packed column stream.

    For each ``(c_blk, l)`` block of ``col``, the distinct column segments
    (``col // l``) it references, sorted ascending, padded with segment 0
    to ``S_blk = max(max distinct per block, s_min)`` — plus the columns
    remapped to block-local segment ids: ``col_loc = local_seg * l +
    col % l``.  Returns ``(seg_blk (T, S_blk) int32, col_loc (rows, l)
    int32, S_blk)``.
    """
    col = np.asarray(col, np.int64)
    rows = col.shape[0]
    if rows % c_blk:  # virtually pad to a block multiple with lane rows
        lane_rows = np.broadcast_to(
            np.arange(l, dtype=np.int64), (c_blk - rows % c_blk, l)
        )
        col = np.concatenate([col, lane_rows], axis=0)
    t_blk = col.shape[0] // c_blk
    segs = (col // l).reshape(t_blk, c_blk * l)
    order = np.argsort(segs, axis=1, kind="stable")
    srt = np.take_along_axis(segs, order, axis=1)
    first = np.ones_like(srt, dtype=bool)
    if srt.shape[1] > 1:
        first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    loc_sorted = np.cumsum(first, axis=1) - 1  # local id per sorted slot
    loc = np.empty_like(loc_sorted)
    np.put_along_axis(loc, order, loc_sorted, axis=1)
    counts = first.sum(axis=1)
    s_blk = int(max(counts.max() if t_blk else 1, s_min, 1))
    seg_blk = np.zeros((t_blk, s_blk), np.int32)
    r_idx = np.nonzero(first)[0]
    seg_blk[r_idx, loc_sorted[first]] = srt[first]
    col_loc = (
        loc.reshape(col.shape[0], l) * l + (col - (col // l) * l)
    ).astype(np.int32)[:rows]
    return seg_blk, col_loc, s_blk


def _extended_row_perm(sched: GustSchedule) -> np.ndarray:
    """row_perm identity-extended to the full W*l scheduled row positions
    (shared by both layouts)."""
    row_perm = np.arange(sched.num_windows * sched.l, dtype=np.int32)
    row_perm[: sched.row_perm.shape[0]] = sched.row_perm
    return row_perm


def _stream_leaves(m_b, c_b, l, c_blk, value_dtype, index_dtype, device):
    """Leaves shared by both layouts: values (quantized when int8), column
    and row streams' gather tables, and the per-block scales."""
    vdt = _lookup(VALUE_DTYPES, value_dtype, "value")
    idt = _lookup(INDEX_DTYPES, index_dtype, "index")
    seg_blk, col_loc, s_blk = _local_gather_tables(c_b, l, c_blk)
    scale = None
    if vdt == torch.int8:
        m_b, scale = _quantize_stream(m_b, c_blk)
        scale = _leaf(scale, torch.float32, device)
    return (
        _leaf(m_b, vdt, device),
        _leaf(c_b, idt, device),
        _leaf(seg_blk, torch.int32, device),
        _leaf(col_loc, idt, device),
        s_blk,
        scale,
        idt,
    )


def pack_schedule(
    sched: GustSchedule, c_blk: int = 8, value_dtype="float32",
    index_dtype="int32", *, device="cuda",
) -> PackedSchedule:
    """Pad the ragged per-window schedule to (W, C_pad, l) blocks on
    ``device``.  C_pad = max window colors, rounded up to ``c_blk``."""
    device = resolve_device(device)
    l, W = sched.l, sched.num_windows
    m_b, c_b, r_b, c_pad, fusable = pack_blocks(sched, c_blk)
    row_perm = _extended_row_perm(sched)
    m_t, c_t, seg_t, loc_t, s_blk, scale, idt = _stream_leaves(
        m_b, c_b, l, c_blk, value_dtype, index_dtype, device
    )
    return PackedSchedule(
        m_blk=m_t,
        col_blk=c_t,
        row_blk=_leaf(r_b, idt, device),
        row_perm=_leaf(row_perm, torch.int32, device),
        seg_blk=seg_t,
        col_loc=loc_t,
        l=l,
        num_windows=W,
        c_pad=c_pad,
        shape=tuple(sched.shape),
        fusable=fusable,
        c_blk=c_blk,
        s_blk=s_blk,
        identity_perm=bool(
            np.array_equal(row_perm, np.arange(W * l, dtype=np.int32))
        ),
        scale_blk=scale,
    )


def _ragged_block_layout(
    sched: GustSchedule, c_blk: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """(blocks_per_window, block_starts, num_blocks) of the ragged stream.
    Every window keeps ``ceil(C_w / c_blk)`` blocks, floored at one so an
    empty window still owns a block (its output tile is written once)."""
    cpw = np.diff(np.asarray(sched.window_starts))
    bpw = np.maximum(-(-cpw // c_blk), 1).astype(np.int64)
    block_starts = np.zeros(sched.num_windows + 1, dtype=np.int64)
    np.cumsum(bpw, out=block_starts[1:])
    return bpw, block_starts, int(block_starts[-1])


def ragged_waste_ratio(sched: GustSchedule, c_blk: int = 8) -> float:
    """Padding waste of the padded layout relative to the ragged stream:
    ``(W * C_pad) / (T_blk * c_blk)``."""
    W = sched.num_windows
    cpw = np.diff(np.asarray(sched.window_starts))
    c_max = int(cpw.max()) if W else 1
    c_pad = max(-(-c_max // c_blk) * c_blk, c_blk)
    _, _, t_blk = _ragged_block_layout(sched, c_blk)
    return (W * c_pad) / float(max(t_blk * c_blk, 1))


def pack_ragged(
    sched: GustSchedule, c_blk: int = 8, value_dtype="float32",
    index_dtype="int32", *, device="cuda",
) -> RaggedSchedule:
    """Flatten the ragged per-window schedule into a (T_blk * c_blk, l)
    block stream on ``device``, holding only each window's real cycle
    blocks (plus its final partial-block padding)."""
    device = resolve_device(device)
    l, W = sched.l, sched.num_windows
    ws = np.asarray(sched.window_starts)
    cpw = np.diff(ws)
    c_total = int(ws[-1]) if W else 0
    bpw, block_starts, t_blk = _ragged_block_layout(sched, c_blk)

    lane = np.arange(l, dtype=np.int32)
    buf = np.zeros((3, t_blk * c_blk, l), dtype=np.int32)
    m_b = buf[0].view(np.float32)
    r_b = buf[1]
    c_b = buf[2]
    c_b[:] = lane  # padding slots gather x[lane] (packed-format invariant)
    if c_total:
        wid = np.repeat(np.arange(W, dtype=np.int64), cpw)
        dest = block_starts[wid] * c_blk + (
            np.arange(c_total, dtype=np.int64) - ws[wid]
        )
        m_b[dest] = sched.m_sch[:c_total]
        r_b[dest] = sched.row_sch[:c_total]
        c_b[dest] = sched.col_sch[:c_total]

    block_window = np.repeat(np.arange(W, dtype=np.int32), bpw)
    row_perm = _extended_row_perm(sched)
    m_t, c_t, seg_t, loc_t, s_blk, scale, idt = _stream_leaves(
        m_b, c_b, l, c_blk, value_dtype, index_dtype, device
    )
    return RaggedSchedule(
        m_blk=m_t,
        col_blk=c_t,
        row_blk=_leaf(r_b, idt, device),
        row_perm=_leaf(row_perm, torch.int32, device),
        seg_blk=seg_t,
        col_loc=loc_t,
        block_window=_leaf(block_window, torch.int32, device),
        block_starts=_leaf(block_starts, torch.int32, device),
        l=l,
        num_windows=W,
        c_blk=c_blk,
        num_blocks=t_blk,
        shape=tuple(sched.shape),
        fusable=_fusable(sched),
        s_blk=s_blk,
        identity_perm=bool(
            np.array_equal(row_perm, np.arange(W * l, dtype=np.int32))
        ),
        scale_blk=scale,
    )


#: Padded-stream waste (``W * C_pad`` over ``T_blk * c_blk``) above which
#: the ragged layout is chosen — consumed only through
#: :func:`resolve_layout`.  The reference's value, measured on a TPU; it
#: is re-measured on the H100 in a later slice.
DEFAULT_WASTE_THRESHOLD = 2.0


def resolve_layout(
    sched: GustSchedule, c_blk: int = 8, waste_threshold: float = None
) -> str:
    """The one layout='auto' decision point: ``"ragged"`` when the padded
    layout would stream ``>= waste_threshold`` times more slots than the
    ragged stream, else ``"padded"``."""
    if waste_threshold is None:
        waste_threshold = DEFAULT_WASTE_THRESHOLD
    return (
        "ragged"
        if ragged_waste_ratio(sched, c_blk) >= waste_threshold
        else "padded"
    )


#: ``S_blk / seg_count`` ratio below which ``gather="auto"`` picks the
#: segment-local path (the reference's TPU-measured default).
DEFAULT_LOCALITY_RATIO = 0.5

#: Minimum segment count before ``gather="auto"`` considers the local
#: path at all (the reference's TPU-measured default).
DEFAULT_LOCAL_MIN_SEGS = 128


def resolve_gather(
    s_blk: int, seg_count: int, locality_ratio: float = None,
    min_segs: int = None,
) -> str:
    """The one ``gather="auto"`` decision point: ``"local"`` when the
    matrix is wide enough (``seg_count >= min_segs``) and the per-block
    segment working set is small (``S_blk <= locality_ratio *
    seg_count``); else ``"resident"``."""
    if locality_ratio is None:
        locality_ratio = DEFAULT_LOCALITY_RATIO
    if min_segs is None:
        min_segs = DEFAULT_LOCAL_MIN_SEGS
    if seg_count < max(min_segs, 2):
        return "resident"
    return "local" if s_blk <= locality_ratio * seg_count else "resident"


# ---------------------------------------------------------------------------
# Leaves/meta codec — the reference's wire format, with torch leaves.
# ---------------------------------------------------------------------------


def packed_leaves(p: PackedSchedule) -> Dict[str, torch.Tensor]:
    """Tensor leaves of a padded pack; ``scale_blk`` present exactly when
    the pack is quantized."""
    leaves = {
        "m_blk": p.m_blk,
        "col_blk": p.col_blk,
        "row_blk": p.row_blk,
        "row_perm": p.row_perm,
        "seg_blk": p.seg_blk,
        "col_loc": p.col_loc,
    }
    if p.scale_blk is not None:
        leaves["scale_blk"] = p.scale_blk
    return leaves


def packed_meta(p: PackedSchedule) -> Tuple:
    """Static part: ``(l, num_windows, c_pad, shape, fusable, c_blk,
    s_blk, identity_perm)``."""
    return (p.l, p.num_windows, p.c_pad, p.shape, p.fusable, p.c_blk,
            p.s_blk, p.identity_perm)


def packed_from_leaves(leaves: Dict, meta: Tuple) -> PackedSchedule:
    """Inverse of the codec: rebuild a PackedSchedule from leaves + meta."""
    l, w, c_pad, shape, fusable, c_blk, s_blk, identity_perm = meta
    return PackedSchedule(
        m_blk=leaves["m_blk"],
        col_blk=leaves["col_blk"],
        row_blk=leaves["row_blk"],
        row_perm=leaves["row_perm"],
        seg_blk=leaves["seg_blk"],
        col_loc=leaves["col_loc"],
        l=l, num_windows=w, c_pad=c_pad, shape=tuple(shape), fusable=fusable,
        c_blk=c_blk, s_blk=s_blk, identity_perm=identity_perm,
        scale_blk=leaves.get("scale_blk"),
    )


def ragged_leaves(r: RaggedSchedule) -> Dict[str, torch.Tensor]:
    """Tensor leaves of a ragged stream (see :func:`packed_leaves`)."""
    leaves = {
        "m_blk": r.m_blk,
        "col_blk": r.col_blk,
        "row_blk": r.row_blk,
        "row_perm": r.row_perm,
        "seg_blk": r.seg_blk,
        "col_loc": r.col_loc,
        "block_window": r.block_window,
        "block_starts": r.block_starts,
    }
    if r.scale_blk is not None:
        leaves["scale_blk"] = r.scale_blk
    return leaves


def ragged_meta(r: RaggedSchedule) -> Tuple:
    """Static part: ``("ragged", l, num_windows, c_blk, num_blocks, shape,
    fusable, s_blk, identity_perm)``."""
    return ("ragged", r.l, r.num_windows, r.c_blk, r.num_blocks, r.shape,
            r.fusable, r.s_blk, r.identity_perm)


def ragged_from_leaves(leaves: Dict, meta: Tuple) -> RaggedSchedule:
    """Inverse of the ragged codec."""
    tag, l, w, c_blk, t_blk, shape, fusable, s_blk, identity_perm = meta
    if tag != "ragged":
        raise ValueError(f"not a ragged meta tuple: {meta!r}")
    return RaggedSchedule(
        m_blk=leaves["m_blk"],
        col_blk=leaves["col_blk"],
        row_blk=leaves["row_blk"],
        row_perm=leaves["row_perm"],
        seg_blk=leaves["seg_blk"],
        col_loc=leaves["col_loc"],
        block_window=leaves["block_window"],
        block_starts=leaves["block_starts"],
        l=l, num_windows=w, c_blk=c_blk, num_blocks=t_blk, shape=tuple(shape),
        fusable=fusable, s_blk=s_blk, identity_perm=identity_perm,
        scale_blk=leaves.get("scale_blk"),
    )


# ---------------------------------------------------------------------------
# Content-keyed schedule cache.
# ---------------------------------------------------------------------------


class ScheduleCache:
    """LRU cache of ``schedule(...)`` and pack results, keyed by matrix
    *content* (sha1 of shape + COO triples) or schedule content, and the
    scheduling/packing parameters — the reference's keys, plus the device
    a pack's tensors live on."""

    def __init__(self, maxsize: Optional[int] = None):
        if maxsize is None:
            env = os.environ.get("REPRO_SCHEDULE_CACHE_SIZE", "").strip()
            maxsize = int(env) if env else DEFAULT_SCHEDULE_CACHE_SIZE
        if maxsize < 1:
            raise ValueError(f"ScheduleCache maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._store: "OrderedDict[Tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def matrix_key(coo: COOMatrix) -> str:
        h = hashlib.sha1()
        h.update(repr(tuple(int(s) for s in coo.shape)).encode())
        for a in (coo.rows, coo.cols, coo.vals):
            arr = np.ascontiguousarray(a)
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
        return h.hexdigest()

    @staticmethod
    def schedule_key(sched: GustSchedule) -> str:
        """Content key of an already-built schedule."""
        h = hashlib.sha1()
        h.update(repr((sched.l, sched.shape, sched.nnz)).encode())
        for a in (sched.m_sch, sched.row_sch, sched.col_sch,
                  sched.window_starts, sched.row_perm):
            arr = np.ascontiguousarray(a)
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
        return h.hexdigest()

    def _get(self, key: Tuple, build):
        if key in self._store:
            self.hits += 1
            self._store.move_to_end(key)
            return self._store[key]
        self.misses += 1
        val = build()
        self._store[key] = val
        while len(self._store) > self.maxsize:
            self._store.popitem(last=False)
            self.evictions += 1
        return val

    def schedule(
        self, coo: COOMatrix, l: int, *, load_balance: bool = True,
        method: str = "fast", workers: Optional[int] = None,
    ) -> GustSchedule:
        # ``workers`` is not part of the key: the schedule is bit-identical
        # for every worker count.
        key = ("sched", self.matrix_key(coo), l, load_balance, method)
        return self._get(
            key,
            lambda: schedule(
                coo, l, load_balance=load_balance, method=method,
                workers=workers,
            ),
        )

    def _pack(self, tag, fn, sched, c_blk, value_dtype, index_dtype, device):
        device = resolve_device(device)
        key = (tag, self.schedule_key(sched), c_blk, dtype_name(value_dtype),
               dtype_name(index_dtype), str(device))
        return self._get(
            key,
            lambda: fn(sched, c_blk, value_dtype, index_dtype, device=device),
        )

    def pack_for(
        self, sched: GustSchedule, *, c_blk: int = 8, value_dtype="float32",
        index_dtype="int32", device="cuda",
    ) -> PackedSchedule:
        """Memoized :func:`pack_schedule` keyed on schedule content."""
        return self._pack("pack_for", pack_schedule, sched, c_blk,
                          value_dtype, index_dtype, device)

    def ragged_for(
        self, sched: GustSchedule, *, c_blk: int = 8, value_dtype="float32",
        index_dtype="int32", device="cuda",
    ) -> RaggedSchedule:
        """Memoized :func:`pack_ragged` keyed on schedule content."""
        return self._pack("ragged_for", pack_ragged, sched, c_blk,
                          value_dtype, index_dtype, device)

    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "entries": len(self._store),
        }

    def clear(self):
        self._store.clear()
        self.hits = self.misses = self.evictions = 0


#: Default LRU capacity of :class:`ScheduleCache` (the reference's value;
#: ``REPRO_SCHEDULE_CACHE_SIZE`` overrides it per process).
DEFAULT_SCHEDULE_CACHE_SIZE = 256

default_cache = ScheduleCache()

