"""Plain PyTorch versions of the GUST SpMV kernels (same packed-block
semantics, same inputs and outputs as the CUDA kernels).

Counterpart of ``repro.kernels.ref``: direct gathers (``index_select``)
and scatter-adds (``index_add_``), no kernel.  They run wherever their
tensors lie; the kernel wrappers call them for CPU tensors, and the tests
and ``chip_smoke.py`` hold each CUDA kernel against them.

Association.  The sum runs as the kernels run it: each ``(c_blk, l)``
block's products are added, cycle by cycle, into a zeroed ``(l, B)``
block tile, and the block tiles are added in stream order into their
window's tile — the reference kernels' "sum within the block, then add to
the tile".  On the CPU ``index_add_`` adds in index order, so there this
is the kernels' exact order; on the card ``index_add_`` uses atomics, so
there the comparison is by tolerance.  Against the reference's oracles,
which scatter every product straight into the window, sums are
reordered: equal on exact-arithmetic inputs, close otherwise.  Slots
whose value is 0 (padding) add nothing, as the kernels skip them, so an
inf or NaN in x at a column only padding points at leaves every row
finite (the reference's oracles return NaN rows there).

The segment-local twins (``*_local_*``) read each slot's x value through
the pack-time segment table — ``x[seg_blk[t, col_loc // l] * l + col_loc
% l]`` — which maps every slot back to its original column, so they give
the resident versions' bits.  They compute that column and gather x
directly instead of building the reference's ``(T, S_blk*l, B)`` tile
array (gigabytes at a real matrix's size); the values are the same.

:func:`gust_spgemm_ref` is the plain SpGEMM: it walks the stream's real
slots (``m != 0``) in stream order, a bounded chunk at a time, and adds
every partial product ``a * b`` into a flat ``W*l*n_out`` accumulator (B
as condensed planes or by row offsets): on the CPU each cell's terms in
stream order from +0, the kernel's own order.
"""

from __future__ import annotations

import torch

__all__ = [
    "dequant_ref",
    "gather_fill_ref",
    "gather_fill_local_ref",
    "gust_spmv_ref",
    "gust_spmv_local_ref",
    "gust_spmv_ragged_ref",
    "gust_spmv_ragged_local_ref",
    "gust_spgemm_ref",
    "SPGEMM_REF_CHUNK",
]


def dequant_ref(
    m_blocks: torch.Tensor,  # (T*c_blk, l) int8 quantized values
    scale_blk: torch.Tensor,  # (T,) f32 per-block scales
    *,
    c_blk: int,
) -> torch.Tensor:
    """The one definition of int8 dequant: ``float32(q) * scale`` — a
    single f32 multiply by the slot's block scale."""
    scale = scale_blk.float().repeat_interleave(c_blk)  # (T*c_blk,)
    return m_blocks.float() * scale[:, None]


def gather_fill_ref(
    col_blocks: torch.Tensor,  # (T, l) original column indices
    x_padded: torch.Tensor,  # (S*l, B) zero-padded vector
) -> torch.Tensor:
    """The Buffer Filler: plain gather ``x[col]``, (T, l, B) f32."""
    idx = col_blocks.reshape(-1).long()
    g = x_padded.float().index_select(0, idx)
    return g.reshape(*col_blocks.shape, x_padded.shape[1])


def _local_columns(
    col_loc: torch.Tensor,  # (T*c_blk, l) block-local columns
    seg_blk: torch.Tensor,  # (T, S_blk) int32 per-block segment table
    *,
    l: int,
    c_blk: int,
) -> torch.Tensor:
    """The original column of every slot of a segment-local stream:
    ``seg_blk[t, col_loc // l] * l + col_loc % l`` (int64)."""
    loc = col_loc.long()
    blk = torch.arange(loc.shape[0], device=loc.device)[:, None] // c_blk
    return seg_blk.long()[blk, loc // l] * l + loc % l


def gather_fill_local_ref(
    col_loc: torch.Tensor,  # (T*c_blk, l) block-local column indices
    seg_blk: torch.Tensor,  # (T, S_blk) int32 per-block segment table
    x_padded: torch.Tensor,  # (S*l, B) zero-padded vector
    *,
    l: int,
    c_blk: int,
) -> torch.Tensor:
    """The segment-local Buffer Filler,
    ``x[seg_blk[t, col_loc // l] * l + col_loc % l]``, (T, l, B) f32 —
    the same values as :func:`gather_fill_ref` on the resident stream."""
    return gather_fill_ref(
        _local_columns(col_loc, seg_blk, l=l, c_blk=c_blk), x_padded
    )


def _block_window_accumulate(
    m_blocks, col_blocks, row_blocks, block_window, x_padded, *,
    num_windows: int, l: int, c_blk: int, scale_blk,
):
    """Shared multiply + two-level scatter-add of both layouts."""
    if scale_blk is not None:
        m = dequant_ref(m_blocks, scale_blk, c_blk=c_blk)
    else:
        m = m_blocks.float()
    rows = m.shape[0]
    if rows % c_blk:
        raise ValueError(f"stream rows {rows} not a multiple of c_blk {c_blk}")
    t_blk = rows // c_blk
    b = x_padded.shape[1]
    dev = m.device
    # a zero-valued (padding) slot adds +0 whatever x holds: see the module note
    partial = m[:, :, None] * gather_fill_ref(col_blocks, x_padded)
    partial.masked_fill_(m[:, :, None] == 0, 0.0)
    blk_of_row = torch.arange(rows, device=dev) // c_blk
    adder = blk_of_row[:, None] * l + row_blocks.long()  # (rows, l)
    tiles = torch.zeros(t_blk * l, b, dtype=torch.float32, device=dev)
    tiles.index_add_(0, adder.reshape(-1), partial.reshape(-1, b))
    dest = block_window.long()[:, None] * l + torch.arange(l, device=dev)
    y = torch.zeros(num_windows * l, b, dtype=torch.float32, device=dev)
    y.index_add_(0, dest.reshape(-1), tiles)
    return y.reshape(num_windows, l, b)


def gust_spmv_ref(
    m_blocks: torch.Tensor,  # (W*C_pad, l) values (0 in padding)
    col_blocks: torch.Tensor,  # (W*C_pad, l) int32/int16
    row_blocks: torch.Tensor,  # (W*C_pad, l) int32/int16 adder index
    x_padded: torch.Tensor,  # (S*l, B)
    *,
    num_windows: int,
    l: int,
    scale_blk: torch.Tensor = None,  # (T_blk,) f32 when the stream is int8
    c_blk: int = 8,
) -> torch.Tensor:
    """Padded layout: gather, multiply, scatter-add into per-window
    accumulators.  ``scale_blk`` dequantizes an int8 stream first.
    Returns (W, l, B) f32."""
    t_blk = m_blocks.shape[0] // c_blk
    block_window = torch.arange(t_blk, device=m_blocks.device) // (
        t_blk // num_windows
    )
    return _block_window_accumulate(
        m_blocks, col_blocks, row_blocks, block_window, x_padded,
        num_windows=num_windows, l=l, c_blk=c_blk, scale_blk=scale_blk,
    )


def gust_spmv_local_ref(
    m_blocks: torch.Tensor,  # (W*C_pad, l) values (0 in padding)
    col_loc: torch.Tensor,  # (W*C_pad, l) block-local columns
    row_blocks: torch.Tensor,  # (W*C_pad, l) int32/int16 adder index
    seg_blk: torch.Tensor,  # (T_blk, S_blk) int32 segment table
    x_padded: torch.Tensor,  # (S*l, B)
    *,
    num_windows: int,
    l: int,
    c_blk: int,
    scale_blk: torch.Tensor = None,  # (T_blk,) f32 when the stream is int8
) -> torch.Tensor:
    """Padded layout, segment-local gather through the pack-time table;
    the same accumulate as :func:`gust_spmv_ref`.  Returns (W, l, B) f32."""
    cols = _local_columns(col_loc, seg_blk, l=l, c_blk=c_blk)
    return gust_spmv_ref(
        m_blocks, cols, row_blocks, x_padded, num_windows=num_windows, l=l,
        scale_blk=scale_blk, c_blk=c_blk,
    )


def gust_spmv_ragged_ref(
    m_blocks: torch.Tensor,  # (T_blk*c_blk, l) values (0 in padding)
    col_blocks: torch.Tensor,  # (T_blk*c_blk, l) int32/int16
    row_blocks: torch.Tensor,  # (T_blk*c_blk, l) int32/int16 adder index
    block_window: torch.Tensor,  # (T_blk,) int32 window id of each block
    x_padded: torch.Tensor,  # (S*l, B)
    *,
    num_windows: int,
    l: int,
    c_blk: int,
    scale_blk: torch.Tensor = None,  # (T_blk,) f32 when the stream is int8
) -> torch.Tensor:
    """Ragged stream: as :func:`gust_spmv_ref`, with the window of each
    block read from ``block_window``.  Returns (W, l, B) f32."""
    return _block_window_accumulate(
        m_blocks, col_blocks, row_blocks, block_window, x_padded,
        num_windows=num_windows, l=l, c_blk=c_blk, scale_blk=scale_blk,
    )


def gust_spmv_ragged_local_ref(
    m_blocks: torch.Tensor,  # (T_blk*c_blk, l) values (0 in padding)
    col_loc: torch.Tensor,  # (T_blk*c_blk, l) block-local columns
    row_blocks: torch.Tensor,  # (T_blk*c_blk, l) int32/int16 adder index
    seg_blk: torch.Tensor,  # (T_blk, S_blk) int32 segment table
    block_window: torch.Tensor,  # (T_blk,) int32 window id of each block
    x_padded: torch.Tensor,  # (S*l, B)
    *,
    num_windows: int,
    l: int,
    c_blk: int,
    scale_blk: torch.Tensor = None,  # (T_blk,) f32 when the stream is int8
) -> torch.Tensor:
    """Ragged stream, segment-local gather: as
    :func:`gust_spmv_ragged_ref` with each slot's column read through the
    segment table.  Returns (W, l, B) f32."""
    cols = _local_columns(col_loc, seg_blk, l=l, c_blk=c_blk)
    return gust_spmv_ragged_ref(
        m_blocks, cols, row_blocks, block_window, x_padded,
        num_windows=num_windows, l=l, c_blk=c_blk, scale_blk=scale_blk,
    )


#: Most partial products :func:`gust_spgemm_ref` materializes at once
#: (slots x B's longest row): about 40 bytes each across its temporaries,
#: so about 1.3 GB at this cap, whatever the stream's length.
SPGEMM_REF_CHUNK = 1 << 25


def _b_rows_of(col, b_vals, b_cols, b_ptr):
    """The entries of B's rows ``col`` (one per slot), flat in slot order:
    ``(slot of each entry, value, column)``.  Planes (``b_ptr`` None): every
    row's ``k_max`` pairs, padding included; offsets: the row's entries."""
    dev = col.device
    if b_ptr is None:
        k_max = b_vals.shape[1]
        rep = torch.arange(col.numel(), device=dev).repeat_interleave(k_max)
        return rep, b_vals.index_select(0, col).reshape(-1), \
            b_cols.index_select(0, col).reshape(-1)
    start = b_ptr[col]
    n = b_ptr[col + 1] - start
    rep = torch.repeat_interleave(torch.arange(col.numel(), device=dev), n)
    first = torch.cumsum(n, 0) - n  # each slot's first entry in the flat list
    e = start[rep] + torch.arange(rep.numel(), device=dev) - first[rep]
    return rep, b_vals[e], b_cols[e]


def gust_spgemm_ref(
    m_blocks: torch.Tensor,  # (T*c_blk, l) A values (0 in padding)
    col_blocks: torch.Tensor,  # (T*c_blk, l) ORIGINAL A columns (B row ids)
    row_blocks: torch.Tensor,  # (T*c_blk, l) adder index
    window: torch.Tensor,  # (T*c_blk,) window id of each stream row
    b_vals: torch.Tensor,  # (R, k_max) B planes, or (nnz,) with b_ptr
    b_cols: torch.Tensor,  # (R, k_max) B planes, or (nnz,) with b_ptr
    *,
    num_windows: int,
    l: int,
    n_out: int,
    b_ptr: torch.Tensor = None,  # (R + 1,) int64 row offsets of B
) -> torch.Tensor:
    """Plain SpGEMM through A's color-block stream, the reference
    oracle's arguments and result: each slot ``(a, row, col=j)`` takes B's
    row ``j``, multiplies its values by ``a`` and adds each product into
    ``(window*l + row, b_col)``.  Returns (W, l, n_out) f32.

    B comes as the condensed planes (row ``j`` is ``k_max`` pairs, padding
    ``(0, 0)`` included, which adds ±0 into column 0) or, with ``b_ptr``,
    by row offsets into flat arrays: the same sums either way.  Slots with
    ``a == 0`` (padding) add ±0 and are dropped before the gather; the rest
    go in stream order, in chunks of at most :data:`SPGEMM_REF_CHUNK`
    products, so memory does not grow with the stream."""
    dev = m_blocks.device
    y = torch.zeros(num_windows * l * n_out, dtype=torch.float32, device=dev)
    if n_out == 0:  # no cell to add into (B's padding plane still has one column)
        return y.reshape(num_windows, l, 0)
    if b_ptr is None:
        k_max = b_vals.shape[1]
    else:
        k_max = int((b_ptr[1:] - b_ptr[:-1]).max()) if b_ptr.numel() > 1 else 0
    m_flat = m_blocks.reshape(-1).float()
    slots = torch.nonzero(m_flat).squeeze(1)  # stream order
    cols, rows = col_blocks.reshape(-1), row_blocks.reshape(-1)
    per = max(1, SPGEMM_REF_CHUNK // max(k_max, 1))
    for s0 in range(0, slots.numel(), per):
        s = slots[s0:s0 + per]
        rep, bv, bc = _b_rows_of(cols[s].long(), b_vals.float(), b_cols, b_ptr)
        part = m_flat[s][rep] * bv
        adder = window[s // l].long() * l + rows[s].long()
        y.index_add_(0, adder[rep] * n_out + bc.long(), part)
    return y.reshape(num_windows, l, n_out)
