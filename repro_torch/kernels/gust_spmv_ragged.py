"""Ragged GUST SpMV: wrappers of the CUDA kernels in ``csrc/``.

* :func:`gust_spmv_ragged` (``csrc/gust_spmv.cu``) replaces the TPU
  kernel ``repro.kernels.gust_spmv_ragged.make_gust_spmv_ragged`` (and
  its int8 body ``_kernel_q``): the padded kernel's math over the ragged
  stream, where window ``w`` owns blocks
  ``block_starts[w]:block_starts[w+1]``, the blocks spread over the
  card's CTAs and each window's block tiles folded in stream order by a
  second kernel.
* :func:`gust_spmv_ragged_local` (``csrc/gust_spmv_local.cu``) replaces
  ``make_gust_spmv_ragged_local``: x read through the pack-time segment
  table, each block's tiles staged in shared memory at the block's own
  top (single-buffered), the blocks spread over the card's CTAs and each
  window's block tiles folded in stream order by a second kernel.
* :func:`gust_spmv_ragged_db` (``csrc/gust_spmv_db.cu``) replaces
  ``make_gust_spmv_ragged_db``: the same product with the next chunks of
  the stream copied into a ring of two shared-memory stages while this
  one computes (double-buffered: bulk copies at B > 1 where the leaves'
  rows are whole 16-byte runs, else the register prefetch of
  :func:`gust_spmv_ragged`), the blocks spread over the card's CTAs and
  each window's block tiles folded in stream order by a second kernel.
* :func:`gust_spmv_ragged_local_db` (``csrc/gust_spmv_local_db.cu``)
  replaces ``make_gust_spmv_ragged_local_db``: x read through the
  pack-time segment table, each block's tiles staged one block ahead,
  the blocks spread over the card's CTAs and each window's block tiles
  folded in stream order by a second kernel.

All four (``csrc/gust_spread.cuh``) fold each window's block range from
their scratch.  Each needs ``block_starts``, none ``block_window``, and
none uses atomics.  Bound by memory, as the padded kernels, at the
card's 3.35 TB/s.

On a CPU tensor a wrapper runs the plain version
(:mod:`repro_torch.kernels.ref`); on a CUDA tensor it launches its kernel
or raises.  ``launches``, ``local_launches``, ``db_launches`` and
``local_db_launches`` count the launches of each kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from .gust_spmv import run_kernel
from .ref import gust_spmv_ragged_local_ref, gust_spmv_ragged_ref

__all__ = [
    "gust_spmv_ragged",
    "gust_spmv_ragged_local",
    "gust_spmv_ragged_db",
    "gust_spmv_ragged_local_db",
]

#: Kernel launches made by :func:`gust_spmv_ragged` in this process.
launches = 0
#: ... by :func:`gust_spmv_ragged_local`.
local_launches = 0
#: ... by :func:`gust_spmv_ragged_db`.
db_launches = 0
#: ... by :func:`gust_spmv_ragged_local_db`.
local_db_launches = 0


def gust_spmv_ragged(
    m_blocks: torch.Tensor,  # (T_blk*c_blk, l) values (0 in padding)
    col_blocks: torch.Tensor,  # (T_blk*c_blk, l) int32/int16
    row_blocks: torch.Tensor,  # (T_blk*c_blk, l) int32/int16 adder index
    block_window: torch.Tensor,  # (T_blk,) int32 window id of each block
    block_starts: torch.Tensor,  # (W+1,) int32 per-window block prefix
    x_padded: torch.Tensor,  # (S*l, B) float32
    *,
    num_windows: int,
    l: int,
    c_blk: int,
    scale_blk: Optional[torch.Tensor] = None,  # (T_blk,) f32 for int8
) -> torch.Tensor:
    """Ragged-stream SpMM: returns the (W, l, B) f32 window tiles.  The
    plain version steers blocks by ``block_window``, the kernel by
    ``block_starts``; the packing keeps the two consistent."""
    global launches
    if m_blocks.device.type == "cpu":
        return gust_spmv_ragged_ref(
            m_blocks, col_blocks, row_blocks, block_window, x_padded,
            num_windows=num_windows, l=l, c_blk=c_blk, scale_blk=scale_blk,
        )
    y = run_kernel(
        "gust_spmv", "gust_spmv_ragged", m_blocks, col_blocks, row_blocks,
        x_padded, num_windows=num_windows, l=l, c_blk=c_blk,
        scale_blk=scale_blk, blocks=block_starts, partials=True,
    )
    launches += 1
    return y


def gust_spmv_ragged_local(
    m_blocks: torch.Tensor,  # (T_blk*c_blk, l) values (0 in padding)
    col_loc: torch.Tensor,  # (T_blk*c_blk, l) int32/int16 block-local columns
    row_blocks: torch.Tensor,  # (T_blk*c_blk, l) int32/int16 adder index
    seg_blk: torch.Tensor,  # (T_blk, S_blk) int32 segment table
    block_window: torch.Tensor,  # (T_blk,) int32 window id of each block
    block_starts: torch.Tensor,  # (W+1,) int32 per-window block prefix
    x_padded: torch.Tensor,  # (S*l, B) float32
    *,
    num_windows: int,
    l: int,
    c_blk: int,
    scale_blk: Optional[torch.Tensor] = None,  # (T_blk,) f32 for int8
) -> torch.Tensor:
    """Segment-local, single-buffered ragged-stream SpMM: returns the
    (W, l, B) f32 window tiles."""
    global local_launches
    if m_blocks.device.type == "cpu":
        return gust_spmv_ragged_local_ref(
            m_blocks, col_loc, row_blocks, seg_blk, block_window, x_padded,
            num_windows=num_windows, l=l, c_blk=c_blk, scale_blk=scale_blk,
        )
    y = run_kernel(
        "gust_spmv_local", "gust_spmv_local_ragged", m_blocks, col_loc,
        row_blocks, x_padded, num_windows=num_windows, l=l, c_blk=c_blk,
        scale_blk=scale_blk, blocks=block_starts, seg_blk=seg_blk,
        partials=True,
    )
    local_launches += 1
    return y


def gust_spmv_ragged_db(
    m_blocks: torch.Tensor,  # (T_blk*c_blk, l) values (0 in padding)
    col_blocks: torch.Tensor,  # (T_blk*c_blk, l) int32/int16
    row_blocks: torch.Tensor,  # (T_blk*c_blk, l) int32/int16 adder index
    block_window: torch.Tensor,  # (T_blk,) int32 window id of each block
    block_starts: torch.Tensor,  # (W+1,) int32 per-window block prefix
    x_padded: torch.Tensor,  # (S*l, B) float32
    *,
    num_windows: int,
    l: int,
    c_blk: int,
    scale_blk: Optional[torch.Tensor] = None,  # (T_blk,) f32 for int8
) -> torch.Tensor:
    """Double-buffered ragged-stream SpMM, the same result as
    :func:`gust_spmv_ragged`: returns the (W, l, B) f32 window tiles."""
    global db_launches
    if m_blocks.device.type == "cpu":
        return gust_spmv_ragged_ref(
            m_blocks, col_blocks, row_blocks, block_window, x_padded,
            num_windows=num_windows, l=l, c_blk=c_blk, scale_blk=scale_blk,
        )
    y = run_kernel(
        "gust_spmv_db", "gust_spmv_db_ragged", m_blocks, col_blocks,
        row_blocks, x_padded, num_windows=num_windows, l=l, c_blk=c_blk,
        scale_blk=scale_blk, blocks=block_starts, partials=True,
    )
    db_launches += 1
    return y


def gust_spmv_ragged_local_db(
    m_blocks: torch.Tensor,  # (T_blk*c_blk, l) values (0 in padding)
    col_loc: torch.Tensor,  # (T_blk*c_blk, l) int32/int16 block-local columns
    row_blocks: torch.Tensor,  # (T_blk*c_blk, l) int32/int16 adder index
    seg_blk: torch.Tensor,  # (T_blk, S_blk) int32 segment table
    block_window: torch.Tensor,  # (T_blk,) int32 window id of each block
    block_starts: torch.Tensor,  # (W+1,) int32 per-window block prefix
    x_padded: torch.Tensor,  # (S*l, B) float32
    *,
    num_windows: int,
    l: int,
    c_blk: int,
    scale_blk: Optional[torch.Tensor] = None,  # (T_blk,) f32 for int8
) -> torch.Tensor:
    """Segment-local, double-buffered ragged-stream SpMM: returns the
    (W, l, B) f32 window tiles."""
    global local_db_launches
    if m_blocks.device.type == "cpu":
        return gust_spmv_ragged_local_ref(
            m_blocks, col_loc, row_blocks, seg_blk, block_window, x_padded,
            num_windows=num_windows, l=l, c_blk=c_blk, scale_blk=scale_blk,
        )
    y = run_kernel(
        "gust_spmv_local_db", "gust_spmv_local_db_ragged", m_blocks, col_loc,
        row_blocks, x_padded, num_windows=num_windows, l=l, c_blk=c_blk,
        scale_blk=scale_blk, blocks=block_starts, seg_blk=seg_blk,
        partials=True,
    )
    local_db_launches += 1
    return y
