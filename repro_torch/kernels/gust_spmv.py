"""Padded GUST SpMV: wrapper of the CUDA kernel in ``csrc/gust_spmv.cu``.

Replaces the TPU kernel ``repro.kernels.gust_spmv.make_gust_spmv`` (and
its int8 body ``_kernel_q``): per ``(c_blk, l)`` block of the padded
stream, gather ``x[col]``, multiply by the value, and add into the
window's ``(l, B)`` tile.  It is bound by memory: each stream slot is
read once (value + 2 index bytes), plus the scales, x and y, at the
card's 3.35 TB/s.  The kernel's design is described in its source.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.gust_spmv_ref`); on a CUDA tensor it
launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ref import gust_spmv_ref

__all__ = ["gust_spmv"]

#: Kernel launches made by :func:`gust_spmv` in this process.
launches = 0

_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_INDEX_CODES = {torch.int32: 0, torch.int16: 1}


def check_stream_args(
    m_blocks, col_blocks, row_blocks, x_padded, scale_blk, *, l, c_blk
):
    """Validate what the CUDA kernels take, shared by the padded and
    ragged wrappers; returns ``(value_code, index_code)``."""
    dev = m_blocks.device
    if m_blocks.dtype not in _VALUE_CODES:
        raise TypeError(f"unsupported value dtype {m_blocks.dtype}")
    if col_blocks.dtype not in _INDEX_CODES or row_blocks.dtype != col_blocks.dtype:
        raise TypeError(
            f"index leaves must share an int32/int16 dtype, got "
            f"{col_blocks.dtype} and {row_blocks.dtype}"
        )
    if x_padded.dtype != torch.float32 or x_padded.dim() != 2:
        raise TypeError(
            f"x must be a 2-D float32 tensor, got {x_padded.dtype} "
            f"{tuple(x_padded.shape)}"
        )
    if not 1 <= l <= 1024:
        raise ValueError(f"l={l} outside the kernel's 1..1024 lanes")
    rows = m_blocks.shape[0]
    shape = (rows, l)
    for name, t in (("m", m_blocks), ("col", col_blocks), ("row", row_blocks)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} stream has shape {tuple(t.shape)}, expected {shape}")
    if rows % c_blk:
        raise ValueError(f"stream rows {rows} not a multiple of c_blk {c_blk}")
    if x_padded.shape[1] < 1:
        raise ValueError("x has no columns")
    quant = m_blocks.dtype == torch.int8
    if quant != (scale_blk is not None):
        raise ValueError("an int8 stream needs scale_blk, and only an int8 stream takes it")
    tensors = [m_blocks, col_blocks, row_blocks, x_padded]
    if quant:
        if scale_blk.dtype != torch.float32 or tuple(scale_blk.shape) != (rows // c_blk,):
            raise ValueError(
                f"scale_blk must be float32 of shape ({rows // c_blk},), got "
                f"{scale_blk.dtype} {tuple(scale_blk.shape)}"
            )
        tensors.append(scale_blk)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    return _VALUE_CODES[m_blocks.dtype], _INDEX_CODES[col_blocks.dtype]


def raise_on_launch_error(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.gust_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")


def gust_spmv(
    m_blocks: torch.Tensor,  # (W*C_pad, l) values (0 in padding)
    col_blocks: torch.Tensor,  # (W*C_pad, l) int32/int16
    row_blocks: torch.Tensor,  # (W*C_pad, l) int32/int16 adder index
    x_padded: torch.Tensor,  # (S*l, B) float32
    *,
    num_windows: int,
    l: int,
    c_blk: int = 8,
    scale_blk: Optional[torch.Tensor] = None,  # (T_blk,) f32 for int8
) -> torch.Tensor:
    """Padded-stream SpMM: returns the (W, l, B) f32 window tiles."""
    global launches
    rows = m_blocks.shape[0]
    if num_windows < 1 or rows % (num_windows * c_blk):
        raise ValueError(
            f"{rows} stream rows do not split into {num_windows} windows of "
            f"c_blk={c_blk} blocks (c_pad must be a multiple of c_blk)"
        )
    if m_blocks.device.type == "cpu":
        return gust_spmv_ref(
            m_blocks, col_blocks, row_blocks, x_padded,
            num_windows=num_windows, l=l, scale_blk=scale_blk, c_blk=c_blk,
        )
    if m_blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {m_blocks.device}")
    vdt, idt = check_stream_args(
        m_blocks, col_blocks, row_blocks, x_padded, scale_blk, l=l, c_blk=c_blk
    )
    from ._build import load

    lib = load("gust_spmv")
    b = x_padded.shape[1]
    y = torch.empty(num_windows, l, b, dtype=torch.float32, device=m_blocks.device)
    with torch.cuda.device(m_blocks.device):
        err = lib.gust_spmv_padded(
            m_blocks.data_ptr(), col_blocks.data_ptr(), row_blocks.data_ptr(),
            scale_blk.data_ptr() if scale_blk is not None else None,
            x_padded.data_ptr(), y.data_ptr(), vdt, idt, num_windows,
            rows // (num_windows * c_blk), l, c_blk, b,
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on_launch_error(lib, err, "gust_spmv")
    launches += 1
    return y
