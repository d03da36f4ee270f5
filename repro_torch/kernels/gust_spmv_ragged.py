"""Ragged GUST SpMV: wrapper of the CUDA kernel in ``csrc/gust_spmv.cu``.

Replaces the TPU kernel
``repro.kernels.gust_spmv_ragged.make_gust_spmv_ragged`` (and its int8
body ``_kernel_q``): the padded kernel's math over the ragged stream,
where window ``w`` owns blocks ``block_starts[w]:block_starts[w+1]``.
The CUDA kernel gives each window one CTA that walks exactly that range,
so it needs no ``block_window`` and no atomics.  Bound by memory, as the
padded kernel, at the card's 3.35 TB/s.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.gust_spmv_ragged_ref`); on a CUDA tensor
it launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from .gust_spmv import check_stream_args, raise_on_launch_error
from .ref import gust_spmv_ragged_ref

__all__ = ["gust_spmv_ragged"]

#: Kernel launches made by :func:`gust_spmv_ragged` in this process.
launches = 0


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
    if m_blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {m_blocks.device}")
    vdt, idt = check_stream_args(
        m_blocks, col_blocks, row_blocks, x_padded, scale_blk, l=l, c_blk=c_blk
    )
    if (
        block_starts.dtype != torch.int32
        or tuple(block_starts.shape) != (num_windows + 1,)
        or block_starts.device != m_blocks.device
        or not block_starts.is_contiguous()
    ):
        raise ValueError(
            f"block_starts must be a contiguous int32 ({num_windows + 1},) "
            f"tensor on {m_blocks.device}, got {block_starts.dtype} "
            f"{tuple(block_starts.shape)} on {block_starts.device}"
        )
    from ._build import load

    lib = load("gust_spmv")
    b = x_padded.shape[1]
    y = torch.empty(num_windows, l, b, dtype=torch.float32, device=m_blocks.device)
    with torch.cuda.device(m_blocks.device):
        err = lib.gust_spmv_ragged(
            m_blocks.data_ptr(), col_blocks.data_ptr(), row_blocks.data_ptr(),
            scale_blk.data_ptr() if scale_blk is not None else None,
            x_padded.data_ptr(), y.data_ptr(), block_starts.data_ptr(),
            vdt, idt, num_windows, l, c_blk, b,
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on_launch_error(lib, err, "gust_spmv_ragged")
    launches += 1
    return y
