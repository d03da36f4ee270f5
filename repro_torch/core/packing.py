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

Repads (``repad_to``, ``repad_to_blocks``, ``repad_seg_to``) and the
incremental splice (:func:`splice_ragged_blocks`) are torch ops on the
artifact's own device; they keep every leaf dtype and recompute the
gather tables there (:func:`_gather_tables`), bit for bit the host
tables.  Shape-only specs (:func:`packed_spec`, :func:`ragged_spec`,
:func:`stacked_leaf_specs`) hold tensors on ``torch.device("meta")``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

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
    "pack_auto",
    "packed_spec",
    "ragged_spec",
    "stacked_leaf_specs",
    "splice_ragged_blocks",
    "window_ids",
    "resolve_tuning",
    "DEFAULT_TUNE_IMPROVEMENT",
    "clear_cache",
    "schedule_packed",
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
    if device.type == "cuda" and (device.index or 0) >= torch.cuda.device_count():
        raise RuntimeError(f"device {str(device)!r} requested but only "
                           f"{torch.cuda.device_count()} CUDA device(s) exist")
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

    def repad_to(self, c_pad: int) -> "PackedSchedule":
        """Grow the per-window color padding to ``c_pad`` slots, on the
        artifact's device.  Keeps every leaf dtype and the packed-format
        invariants (new value slots 0, new column slots the slot's lane,
        new row slots 0); the gather tables are recomputed on the grown
        stream and never narrow.  Equalizes C_pad across stacked layers."""
        if c_pad == self.c_pad:
            return self
        if c_pad < self.c_pad:
            raise ValueError(
                f"cannot shrink c_pad {self.c_pad} -> {c_pad} (real colors "
                "may live in the dropped slots)"
            )
        W, l, extra = self.num_windows, self.l, c_pad - self.c_pad
        lane = torch.arange(l, device=self.device)

        def grow(a, pad_row):
            a3 = a.reshape(W, self.c_pad, l)
            pad = pad_row.to(a.dtype)[None, None, :].expand(W, extra, l)
            return torch.cat([a3, pad], dim=1).reshape(W * c_pad, l)

        col_grown = grow(self.col_blk, lane)
        seg_blk, col_loc, s_blk = _gather_tables(
            col_grown, l, self.c_blk, s_min=self.s_blk
        )
        col_loc = _index_leaf(col_loc, self.col_loc.dtype, self.shape[1])
        scale = self.scale_blk
        if scale is not None:
            # scales are per (c_blk, l) block: the grown padding must land on
            # whole new blocks for the old blocks' scales to stay put
            if c_pad % self.c_blk or self.c_pad % self.c_blk:
                raise ValueError(
                    f"quantized repad_to requires c_pad multiples of c_blk="
                    f"{self.c_blk}, got {self.c_pad} -> {c_pad}"
                )
            old_bpw, new_bpw = self.c_pad // self.c_blk, c_pad // self.c_blk
            ones = torch.ones(W, new_bpw - old_bpw, dtype=scale.dtype,
                              device=scale.device)  # all-zero blocks
            scale = torch.cat([scale.reshape(W, old_bpw), ones], dim=1).reshape(-1)
        return dataclasses.replace(
            self,
            m_blk=grow(self.m_blk, torch.zeros(l, device=self.device)),
            col_blk=col_grown,
            row_blk=grow(self.row_blk, torch.zeros(l, device=self.device)),
            seg_blk=seg_blk,
            col_loc=col_loc,
            c_pad=c_pad,
            s_blk=s_blk,
            scale_blk=scale,
        )

    def repad_seg_to(self, s_blk: int) -> "PackedSchedule":
        """Widen the per-block segment table to ``s_blk`` slots (padding
        with segment 0, which no ``col_loc`` entry references).  Equalizes
        ``S_blk`` across stacked layers."""
        return _repad_seg(self, s_blk)


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

    def repad_to_blocks(self, num_blocks: int) -> "RaggedSchedule":
        """Grow the stream to ``num_blocks`` blocks with all-padding
        trailing blocks (attributed to the last window, whose accumulator
        they extend by zero), on the artifact's device.  Keeps every leaf
        dtype and the padding invariants; equalizes stream lengths across
        stacked layers."""
        if num_blocks == self.num_blocks:
            return self
        if num_blocks < self.num_blocks:
            raise ValueError(
                f"cannot shrink num_blocks {self.num_blocks} -> {num_blocks}"
                " (real cycles may live in the dropped blocks)"
            )
        l, extra, dev = self.l, num_blocks - self.num_blocks, self.device
        rows = extra * self.c_blk

        def grow(a, pad_row):
            return torch.cat([a, pad_row.to(a.dtype)[None, :].expand(rows, l)])

        last_w = max(self.num_windows - 1, 0)
        bw = torch.cat([
            self.block_window,
            torch.full((extra,), last_w, dtype=self.block_window.dtype, device=dev),
        ])
        bs = self.block_starts.clone()
        bs[-1] = num_blocks
        col_grown = grow(self.col_blk, torch.arange(l, device=dev))
        seg_blk, col_loc, s_blk = _gather_tables(
            col_grown, l, self.c_blk, s_min=self.s_blk
        )
        scale = self.scale_blk
        if scale is not None:  # appended blocks are all padding: scale 1.0
            scale = torch.cat([scale, torch.ones(extra, dtype=scale.dtype, device=dev)])
        return dataclasses.replace(
            self,
            m_blk=grow(self.m_blk, torch.zeros(l, device=dev)),
            col_blk=col_grown,
            row_blk=grow(self.row_blk, torch.zeros(l, device=dev)),
            seg_blk=seg_blk,
            col_loc=_index_leaf(col_loc, self.col_loc.dtype, self.shape[1]),
            block_window=bw,
            block_starts=bs,
            num_blocks=num_blocks,
            s_blk=s_blk,
            scale_blk=scale,
        )

    def repad_seg_to(self, s_blk: int) -> "RaggedSchedule":
        """Widen the per-block segment table to ``s_blk`` slots (padding
        with segment 0): the ragged twin of
        :meth:`PackedSchedule.repad_seg_to`."""
        return _repad_seg(self, s_blk)


def _repad_seg(packed, s_blk: int):
    """Shared ``repad_seg_to``: pad ``seg_blk`` columns with segment 0.
    No ``col_loc`` entry maps to the new slots; the local kernels read
    only a row's strictly increasing prefix as tiles, and a slot past it
    reads x directly."""
    if s_blk == packed.s_blk:
        return packed
    if s_blk < packed.s_blk:
        raise ValueError(
            f"cannot shrink s_blk {packed.s_blk} -> {s_blk} (real segment "
            "ids may live in the dropped table slots)"
        )
    seg = packed.seg_blk
    pad = torch.zeros(seg.shape[0], s_blk - packed.s_blk, dtype=seg.dtype,
                      device=seg.device)
    return dataclasses.replace(
        packed, seg_blk=torch.cat([seg, pad], dim=1), s_blk=s_blk
    )


def window_ids(sched: GustSchedule) -> np.ndarray:
    """Window id of each global schedule cycle, shape (max(C_total, 1),)."""
    wid = np.zeros(max(sched.total_colors, 1), dtype=np.int32)
    ids = np.repeat(
        np.arange(sched.num_windows, dtype=np.int32), sched.colors_per_window
    )
    wid[: ids.shape[0]] = ids
    return wid


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
    """Host form of :func:`_gather_tables` (numpy in and out, ``col_loc``
    int32): the tables the packers write."""
    seg_blk, col_loc, s_blk = _gather_tables(
        torch.from_numpy(np.asarray(col, np.int64)), l, c_blk, s_min
    )
    return seg_blk.numpy(), col_loc.to(torch.int32).numpy(), s_blk


def _gather_tables(
    col: torch.Tensor, l: int, c_blk: int, s_min: int = 1
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Segment-local gather tables of a packed column stream, as torch ops
    on ``col``'s device (the packers run them on the host, repads and
    splices on the artifact's device).

    For each ``(c_blk, l)`` block of ``col``, the distinct column segments
    (``col // l``) it references, sorted ascending, padded with segment 0
    to ``S_blk = max(max distinct per block, s_min)`` — plus the columns
    remapped to block-local segment ids: ``col_loc = local_seg * l +
    col % l``.  Bit for bit the reference's tables (a stable sort orders
    equal segments as numpy's stable argsort does).  Returns ``(seg_blk
    (T, S_blk) int32, col_loc (rows, l) int64, S_blk)``; the caller casts
    ``col_loc``.
    """
    col = col.long()
    rows = col.shape[0]
    if rows % c_blk:  # virtually pad to a block multiple with lane rows
        lane_rows = torch.arange(l, device=col.device).expand(c_blk - rows % c_blk, l)
        col = torch.cat([col, lane_rows])
    t_blk = col.shape[0] // c_blk
    segs = torch.div(col, l, rounding_mode="floor").reshape(t_blk, c_blk * l)
    srt, order = torch.sort(segs, dim=1, stable=True)
    first = torch.ones_like(srt, dtype=torch.bool)
    if srt.shape[1] > 1:
        first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    loc_sorted = first.long().cumsum(dim=1) - 1  # local id per sorted slot
    loc = torch.empty_like(loc_sorted).scatter_(1, order, loc_sorted)
    counts = first.sum(dim=1)
    s_blk = int(max(int(counts.max()) if t_blk else 1, s_min, 1))
    seg_blk = torch.zeros(t_blk, s_blk, dtype=torch.int32, device=col.device)
    r_idx = first.nonzero(as_tuple=True)[0]
    seg_blk[r_idx, loc_sorted[first]] = srt[first].int()
    col_loc = (loc.reshape(col.shape[0], l) * l + (col - segs.reshape(-1, l) * l))[:rows]
    return seg_blk, col_loc, s_blk


def _index_leaf(col_loc: torch.Tensor, idt: torch.dtype, n_cols: int) -> torch.Tensor:
    """``col_loc`` cast to the index dtype, after the int16 range check
    the packers make (:func:`_check_index_range`)."""
    largest = int(col_loc.max()) if col_loc.numel() else 0
    _check_index_range(idt, n_cols, largest)
    return col_loc.to(idt)


def _extended_row_perm(sched: GustSchedule) -> np.ndarray:
    """row_perm identity-extended to the full W*l scheduled row positions
    (shared by both layouts)."""
    row_perm = np.arange(sched.num_windows * sched.l, dtype=np.int32)
    row_perm[: sched.row_perm.shape[0]] = sched.row_perm
    return row_perm


def _check_index_range(idt: torch.dtype, n_cols: int, largest_loc: int) -> None:
    """Raise when an int16 index leaf cannot hold the largest column
    (``n_cols - 1``) or the largest block-local column ``largest_loc``:
    the cast would wrap, and a kernel would then read outside x.  The
    reference's packer wraps without a word; the port refuses at pack
    time, and so do its repads and splices."""
    if idt != torch.int16:
        return
    top = torch.iinfo(torch.int16).max
    for what, largest in (("column", n_cols - 1), ("col_loc", largest_loc)):
        if largest > top:
            raise ValueError(
                f"index_dtype='int16' cannot hold the largest {what} {largest} "
                f"(int16 stops at {top}): pack with index_dtype='int32'"
            )


def _stream_leaves(m_b, c_b, l, c_blk, value_dtype, index_dtype, device, n_cols):
    """Leaves shared by both layouts: values (quantized when int8), column
    and row streams' gather tables, and the per-block scales.  Raises
    before any leaf is made when the index dtype cannot hold a column of
    the ``n_cols``-column matrix."""
    vdt = _lookup(VALUE_DTYPES, value_dtype, "value")
    idt = _lookup(INDEX_DTYPES, index_dtype, "index")
    seg_blk, col_loc, s_blk = _local_gather_tables(c_b, l, c_blk)
    _check_index_range(idt, n_cols, int(col_loc.max()) if col_loc.size else 0)
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
        m_b, c_b, l, c_blk, value_dtype, index_dtype, device, sched.shape[1]
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
        m_b, c_b, l, c_blk, value_dtype, index_dtype, device, sched.shape[1]
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


def splice_ragged_blocks(
    old: RaggedSchedule,
    sched: GustSchedule,
    dirty: Sequence[int],
    *,
    value_dtype="float32",
    index_dtype="int32",
) -> RaggedSchedule:
    """Incremental ragged repack on ``old``'s device: windows listed in
    ``dirty`` are packed fresh (through a compact dirty-only
    sub-schedule), every other window's stream blocks and int8 scales are
    copied from ``old``.  Bit for bit ``pack_ragged(sched, old.c_blk,
    ...)``: stream blocks are window-local, scales block-local, and the
    gather tables a pure function of the spliced column stream.

    ``old`` must be an un-repadded pack of a schedule that agrees with
    ``sched`` on every clean window (the :func:`~repro_torch.core.scheduler.
    incremental_schedule` contract) and on geometry and dtypes; anything
    else raises."""
    from .scheduler import _ranges

    l, W, cb = sched.l, sched.num_windows, old.c_blk
    if old.l != l or old.num_windows != W or tuple(old.shape) != tuple(sched.shape):
        raise ValueError("splice: schedule/artifact geometry mismatch")
    vdt = _lookup(VALUE_DTYPES, value_dtype, "value")
    idt = _lookup(INDEX_DTYPES, index_dtype, "index")
    quant = vdt == torch.int8
    if quant != old.quantized:
        raise ValueError("splice: quantization mismatch with the old artifact")
    if idt != old.col_blk.dtype:
        raise ValueError("splice: index dtype mismatch with the old artifact")
    if vdt != old.m_blk.dtype:
        raise ValueError("splice: value dtype mismatch with the old artifact")
    dev = old.device

    dirty = np.asarray(dirty, dtype=np.int64)
    dirty_mask = np.zeros(W, dtype=bool)
    dirty_mask[dirty] = True
    clean = np.nonzero(~dirty_mask)[0]

    bpw_new, bs_new, t_new = _ragged_block_layout(sched, cb)
    bs_old = old.block_starts.cpu().numpy().astype(np.int64)
    bpw_old = np.diff(bs_old)
    if clean.size and not np.array_equal(bpw_old[clean], bpw_new[clean]):
        raise ValueError("splice: clean windows changed block counts")

    def at(idx):
        return torch.from_numpy(idx).to(dev)

    m_new = torch.zeros(t_new * cb, l, dtype=old.m_blk.dtype, device=dev)
    c_new = torch.arange(l, device=dev).to(idt).repeat(t_new * cb, 1)  # col == lane
    r_new = torch.zeros(t_new * cb, l, dtype=old.row_blk.dtype, device=dev)
    scale_new = torch.ones(t_new, dtype=torch.float32, device=dev) if quant else None

    if clean.size:
        src = at(_ranges(bs_old[clean] * cb, bpw_old[clean] * cb))
        dst = at(_ranges(bs_new[clean] * cb, bpw_new[clean] * cb))
        m_new[dst] = old.m_blk[src]
        c_new[dst] = old.col_blk[src]
        r_new[dst] = old.row_blk[src]
        if quant:
            sb = at(_ranges(bs_old[clean], bpw_old[clean]))
            scale_new[at(_ranges(bs_new[clean], bpw_new[clean]))] = old.scale_blk[sb]

    if dirty.size:
        # Pack only the dirty windows: their schedule rows lifted into a
        # compact sub-schedule (sub window i == dirty[i]); a window's block
        # content depends only on its own rows, so the sub-pack's blocks
        # equal the fresh global pack's.
        ws = np.asarray(sched.window_starts)
        sub_cpw = np.diff(ws)[dirty]
        sub_ws = np.zeros(dirty.size + 1, dtype=np.int64)
        np.cumsum(sub_cpw, out=sub_ws[1:])
        rows_src = _ranges(ws[dirty], sub_cpw)
        sub_c = int(sub_ws[-1])
        rows = max(sub_c, 1)
        sub_m = np.zeros((rows, l), dtype=np.asarray(sched.m_sch).dtype)
        sub_r = np.zeros((rows, l), dtype=np.int32)
        sub_col = np.tile(np.arange(l, dtype=np.int32), (rows, 1))
        sub_valid = np.zeros((rows, l), dtype=bool)
        if sub_c:
            sub_m[:sub_c] = np.asarray(sched.m_sch)[rows_src]
            sub_r[:sub_c] = np.asarray(sched.row_sch)[rows_src]
            sub_col[:sub_c] = np.asarray(sched.col_sch)[rows_src]
            sub_valid[:sub_c] = np.asarray(sched.valid)[rows_src]
        sub_sched = GustSchedule(
            l=l,
            shape=(int(dirty.size) * l, sched.shape[1]),
            nnz=int(sub_valid.sum()),
            m_sch=sub_m,
            row_sch=sub_r,
            col_sch=sub_col,
            window_starts=sub_ws,
            row_perm=np.arange(int(dirty.size) * l, dtype=np.int64),
            valid=sub_valid,
        )
        sub = pack_ragged(sub_sched, cb, value_dtype, index_dtype, device=dev)
        # sub windows come in dirty order: the sub stream maps onto the
        # dirty destinations row for row
        dst = at(_ranges(bs_new[dirty] * cb, bpw_new[dirty] * cb))
        m_new[dst] = sub.m_blk
        c_new[dst] = sub.col_blk
        r_new[dst] = sub.row_blk
        if quant:
            scale_new[at(_ranges(bs_new[dirty], bpw_new[dirty]))] = sub.scale_blk

    seg_blk, col_loc, s_blk = _gather_tables(c_new, l, cb)
    row_perm = _extended_row_perm(sched)
    return RaggedSchedule(
        m_blk=m_new,
        col_blk=c_new,
        row_blk=r_new,
        row_perm=_leaf(row_perm, torch.int32, dev),
        seg_blk=seg_blk,
        col_loc=_index_leaf(col_loc, idt, sched.shape[1]),
        block_window=_leaf(np.repeat(np.arange(W, dtype=np.int32), bpw_new),
                           torch.int32, dev),
        block_starts=_leaf(bs_new, torch.int32, dev),
        l=l,
        num_windows=W,
        c_blk=cb,
        num_blocks=t_new,
        shape=tuple(sched.shape),
        fusable=_fusable(sched),
        s_blk=s_blk,
        identity_perm=bool(
            np.array_equal(row_perm, np.arange(W * l, dtype=np.int32))
        ),
        scale_blk=scale_new,
    )


#: A measured tune winner must beat the static-default baseline by this
#: wall-clock factor to displace it — consumed only through
#: :func:`resolve_tuning` (the reference's value; the margin absorbs
#: timer noise so ``GustPlan.tune`` is never slower than the defaults).
DEFAULT_TUNE_IMPROVEMENT = 1.05


def resolve_tuning(
    measurements: Dict, baseline, min_improvement: float = None,
):
    """The one measured-tuning decision point: the key of the fastest
    candidate in ``measurements`` (``{candidate_key: seconds}``), unless
    it fails to beat ``baseline``'s own measurement by
    ``min_improvement`` — then ``baseline``.  ``None`` means
    :data:`DEFAULT_TUNE_IMPROVEMENT`."""
    if min_improvement is None:
        min_improvement = DEFAULT_TUNE_IMPROVEMENT
    if baseline not in measurements:
        raise ValueError(
            f"baseline {baseline!r} missing from measurements "
            f"({sorted(map(repr, measurements))})"
        )
    if not all(t > 0 for t in measurements.values()):
        raise ValueError("measurements must be positive wall-clock seconds")
    best = min(measurements, key=measurements.get)
    if measurements[baseline] / measurements[best] >= min_improvement:
        return best
    return baseline


def pack_auto(
    sched: GustSchedule, c_blk: int = 8, *, waste_threshold: float = None,
    value_dtype="float32", index_dtype="int32", device="cuda",
):
    """Pick the layout by measured padding waste (:func:`resolve_layout`)
    and pack only that one, on ``device``."""
    fn = (
        pack_ragged
        if resolve_layout(sched, c_blk, waste_threshold) == "ragged"
        else pack_schedule
    )
    return fn(sched, c_blk, value_dtype, index_dtype, device=device)


def _default_spec_s_blk(n: int, l: int, c_blk: int) -> int:
    """Worst-case table width for shape-only specs: a block of c_blk*l
    slots references at most that many distinct segments, capped at the
    matrix's segment count."""
    return max(min(-(-n // l), c_blk * l), 1)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def packed_spec(
    m: int,
    n: int,
    l: int,
    c_pad: int,
    value_dtype="float32",
    index_dtype="int32",
    c_blk: int = 8,
    s_blk: int = None,
) -> PackedSchedule:
    """Shape-only :class:`PackedSchedule` (leaves on the meta device, the
    exact dtypes, no allocation).  ``c_pad`` is typically sized from the
    Eq. 9 bound; ``s_blk=None`` sizes the gather table at the worst case."""
    vdt = _lookup(VALUE_DTYPES, value_dtype, "value")
    idt = _lookup(INDEX_DTYPES, index_dtype, "index")
    W = max(-(-m // l), 1)
    if s_blk is None:
        s_blk = _default_spec_s_blk(n, l, c_blk)
    t_blk = -(-(W * c_pad) // c_blk)
    return PackedSchedule(
        m_blk=_meta((W * c_pad, l), vdt),
        col_blk=_meta((W * c_pad, l), idt),
        row_blk=_meta((W * c_pad, l), idt),
        row_perm=_meta((W * l,), torch.int32),
        seg_blk=_meta((t_blk, s_blk), torch.int32),
        col_loc=_meta((W * c_pad, l), idt),
        l=l,
        num_windows=W,
        c_pad=c_pad,
        shape=(m, n),
        fusable=True,
        c_blk=c_blk,
        s_blk=s_blk,
        identity_perm=False,
        scale_blk=_meta((t_blk,), torch.float32) if vdt == torch.int8 else None,
    )


def ragged_spec(
    m: int,
    n: int,
    l: int,
    num_blocks: int,
    c_blk: int = 8,
    value_dtype="float32",
    index_dtype="int32",
    s_blk: int = None,
) -> RaggedSchedule:
    """Shape-only :class:`RaggedSchedule`, the ragged twin of
    :func:`packed_spec`.  ``num_blocks`` is typically
    ``W * ceil(expected_colors_bound / c_blk)``."""
    vdt = _lookup(VALUE_DTYPES, value_dtype, "value")
    idt = _lookup(INDEX_DTYPES, index_dtype, "index")
    W = max(-(-m // l), 1)
    if s_blk is None:
        s_blk = _default_spec_s_blk(n, l, c_blk)
    rows = num_blocks * c_blk
    return RaggedSchedule(
        m_blk=_meta((rows, l), vdt),
        col_blk=_meta((rows, l), idt),
        row_blk=_meta((rows, l), idt),
        row_perm=_meta((W * l,), torch.int32),
        seg_blk=_meta((num_blocks, s_blk), torch.int32),
        col_loc=_meta((rows, l), idt),
        block_window=_meta((num_blocks,), torch.int32),
        block_starts=_meta((W + 1,), torch.int32),
        l=l,
        num_windows=W,
        c_blk=c_blk,
        num_blocks=num_blocks,
        shape=(m, n),
        fusable=True,
        s_blk=s_blk,
        identity_perm=False,
        scale_blk=_meta((num_blocks,), torch.float32) if vdt == torch.int8 else None,
    )


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


def stacked_leaf_specs(proto, reps: int) -> Dict[str, torch.Tensor]:
    """Meta-device leaves of ``reps`` layer packs stacked on axis 0, for
    a packed or ragged prototype, real or shape-only (only ``.shape`` and
    ``.dtype`` are read)."""
    leaves = (
        ragged_leaves(proto)
        if isinstance(proto, RaggedSchedule)
        else packed_leaves(proto)
    )
    return {k: _meta((reps, *v.shape), v.dtype) for k, v in leaves.items()}


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

    def _schedule_for_key(self, mk: str, coo: COOMatrix, l: int,
                          load_balance: bool, method: str,
                          workers: Optional[int] = None) -> GustSchedule:
        # ``workers`` is not part of the key: the schedule is bit-identical
        # for every worker count.
        key = ("sched", mk, l, load_balance, method)
        return self._get(
            key,
            lambda: schedule(
                coo, l, load_balance=load_balance, method=method,
                workers=workers,
            ),
        )

    def schedule(
        self, coo: COOMatrix, l: int, *, load_balance: bool = True,
        method: str = "fast", workers: Optional[int] = None,
    ) -> GustSchedule:
        return self._schedule_for_key(
            self.matrix_key(coo), coo, l, load_balance, method, workers
        )

    def _matrix_pack(self, tag, fn, coo, l, load_balance, method, c_blk,
                     value_dtype, index_dtype, device):
        device = resolve_device(device)
        mk = self.matrix_key(coo)  # O(nnz) hash, once per call
        sched = self._schedule_for_key(mk, coo, l, load_balance, method)
        key = (tag, mk, l, load_balance, method, c_blk, dtype_name(value_dtype),
               dtype_name(index_dtype), str(device))
        return sched, self._get(
            key,
            lambda: fn(sched, c_blk, value_dtype, index_dtype, device=device),
        )

    def packed(
        self, coo: COOMatrix, l: int, *, load_balance: bool = True,
        method: str = "fast", c_blk: int = 8, value_dtype="float32",
        index_dtype="int32", device="cuda",
    ) -> Tuple[GustSchedule, PackedSchedule]:
        """Schedule + padded pack of ``coo``, both keyed on matrix content."""
        return self._matrix_pack("packed", pack_schedule, coo, l, load_balance,
                                 method, c_blk, value_dtype, index_dtype, device)

    def ragged_packed(
        self, coo: COOMatrix, l: int, *, load_balance: bool = True,
        method: str = "fast", c_blk: int = 8, value_dtype="float32",
        index_dtype="int32", device="cuda",
    ) -> Tuple[GustSchedule, RaggedSchedule]:
        """Ragged twin of :meth:`packed`."""
        return self._matrix_pack("ragged", pack_ragged, coo, l, load_balance,
                                 method, c_blk, value_dtype, index_dtype, device)

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

    def auto_for(
        self, sched: GustSchedule, *, c_blk: int = 8,
        waste_threshold: float = None, value_dtype="float32",
        index_dtype="int32", device="cuda",
    ):
        """Cached twin of :func:`pack_auto`: the :func:`resolve_layout`
        decision, memoized through :meth:`ragged_for` / :meth:`pack_for`."""
        route = (
            self.ragged_for
            if resolve_layout(sched, c_blk, waste_threshold) == "ragged"
            else self.pack_for
        )
        return route(sched, c_blk=c_blk, value_dtype=value_dtype,
                     index_dtype=index_dtype, device=device)

    def memo(self, key: Tuple, build):
        """LRU memoization for results derived from cached entries (a
        ``GustPlan.tune`` sweep).  ``key`` must lead with a tag distinct
        from the built-in routes."""
        return self._get(key, build)

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


def clear_cache() -> None:
    """Drop every entry of the module-level cache and the ``core.spmv``
    shims' identity-keyed plans.  Entries hold device tensors for the
    process lifetime; call this after a one-shot conversion."""
    from . import spmv

    default_cache.clear()
    spmv._SHIM_PLANS.clear()


def schedule_packed(
    coo: COOMatrix, l: int, *, load_balance: bool = True, method: str = "fast",
    c_blk: int = 8, value_dtype="float32", index_dtype="int32",
    cache: Optional[ScheduleCache] = default_cache, device="cuda",
) -> Tuple[GustSchedule, PackedSchedule]:
    """Schedule + padded pack in one call, served from ``cache``
    (content-keyed; ``cache=None`` bypasses it)."""
    if cache is None:
        device = resolve_device(device)
        sched = schedule(coo, l, load_balance=load_balance, method=method)
        return sched, pack_schedule(sched, c_blk, value_dtype, index_dtype,
                                    device=device)
    return cache.packed(
        coo, l, load_balance=load_balance, method=method, c_blk=c_blk,
        value_dtype=value_dtype, index_dtype=index_dtype, device=device,
    )
