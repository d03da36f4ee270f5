"""The Buffer Filler: wrapper of the CUDA kernel in ``csrc/gather_fill.cu``.

:func:`gather_fill` replaces the TPU kernel
``repro.kernels.gather_fill.make_gather_fill``: the gathered vector
stream ``out[r, j, :] = x[col[r, j], :]``.  As in the reference, no
execution path calls it (the SpMV kernels gather inside themselves); its
entry point is the function itself.

Bound by memory: the column stream and x read once, the
``(rows, l, B)`` f32 output written once.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.gather_fill_ref`); on a CUDA tensor it
launches the kernel or raises.  ``launches`` counts its launches.
"""

from __future__ import annotations

import torch

from .gust_spmv import _INDEX_CODES, launch
from .ref import gather_fill_ref

__all__ = ["gather_fill"]

#: Kernel launches made by :func:`gather_fill` in this process.
launches = 0


def gather_fill(
    col_blocks: torch.Tensor,  # (rows, l) int32/int16 original columns
    x_padded: torch.Tensor,  # (S*l, B) float32 zero-padded vector
) -> torch.Tensor:
    """``x_padded[col]`` as a (rows, l, B) f32 stream; every column must
    index a row of ``x_padded``."""
    global launches
    if col_blocks.device.type == "cpu":
        return gather_fill_ref(col_blocks, x_padded)
    if col_blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {col_blocks.device}")
    device = col_blocks.device
    if col_blocks.dtype not in _INDEX_CODES or col_blocks.dim() != 2:
        raise TypeError(
            f"col must be a 2-D int32/int16 tensor, got {col_blocks.dtype} "
            f"{tuple(col_blocks.shape)}"
        )
    if x_padded.dtype != torch.float32 or x_padded.dim() != 2 or x_padded.shape[1] < 1:
        raise TypeError(
            f"x must be a 2-D float32 tensor with columns, got {x_padded.dtype} "
            f"{tuple(x_padded.shape)}"
        )
    for t in (col_blocks, x_padded):
        if t.device != device:
            raise ValueError(f"tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    b = x_padded.shape[1]
    out = torch.empty(*col_blocks.shape, b, dtype=torch.float32, device=device)
    if col_blocks.numel() == 0:
        return out
    launch("gather_fill", "gather_fill",
           [col_blocks, x_padded, out, _INDEX_CODES[col_blocks.dtype],
            col_blocks.numel(), b], device)
    launches += 1
    return out
