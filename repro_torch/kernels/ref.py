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
reordered: equal on exact-arithmetic inputs, close otherwise.
"""

from __future__ import annotations

import torch

__all__ = [
    "dequant_ref",
    "gather_fill_ref",
    "gust_spmv_ref",
    "gust_spmv_ragged_ref",
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
    partial = m[:, :, None] * gather_fill_ref(col_blocks, x_padded)
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
