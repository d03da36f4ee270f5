"""GUST SpGEMM: wrapper of the CUDA kernel in ``csrc/gust_spgemm.cu``.

:func:`gust_spgemm` replaces the TPU kernel
``repro.kernels.gust_spgemm.make_gust_spgemm``: ``C = A @ B`` over A's
color-block stream (either layout, as the ragged block stream that
``block_starts`` steers) and B's condensed ``(R, k_max)`` value/column
planes, into per-window ``(l, n_out)`` f32 accumulators.  One CTA per
window; its accumulator is its own slice of the output in device memory.

Bound by memory: A's stream read once, B's real entries read once (8
bytes each, plus one 32-byte sector per row to find its end; the rows'
padding to ``k_max`` need not be read) and the ``(W, l, n_out)`` output
written once, at the card's 3.35 TB/s.  The kernel's design is described in its source.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.gust_spgemm_ref`); on a CUDA tensor it
launches the kernel or raises.  ``launches`` counts its launches.
"""

from __future__ import annotations

import torch

from ..core.spgemm import row_windows
from .gust_spmv import _check_block_starts, _check_stream_args, launch
from .ref import gust_spgemm_ref

__all__ = ["gust_spgemm"]

#: Kernel launches made by :func:`gust_spgemm` in this process.
launches = 0


def gust_spgemm(
    block_starts: torch.Tensor,  # (W+1,) int32 per-window block prefix
    m_blk: torch.Tensor,  # (T*c_blk, l) f32/bf16 A values (0 in padding)
    col_blk: torch.Tensor,  # (T*c_blk, l) int32/int16 ORIGINAL A columns
    row_blk: torch.Tensor,  # (T*c_blk, l) int32/int16 adder index
    b_vals: torch.Tensor,  # (R, k_max) f32 condensed B values
    b_cols: torch.Tensor,  # (R, k_max) int32 condensed B columns
    *,
    num_windows: int,
    l: int,
    n_out: int,
    c_blk: int,
) -> torch.Tensor:
    """Sparse x sparse through A's stream: returns the (W, l, n_out) f32
    window accumulators."""
    global launches
    if m_blk.device.type == "cpu":
        return gust_spgemm_ref(
            m_blk, col_blk, row_blk, row_windows(block_starts, c_blk),
            b_vals, b_cols, num_windows=num_windows, l=l, n_out=n_out,
        )
    if m_blk.device.type != "cuda":
        raise ValueError(f"unsupported device {m_blk.device}")
    if m_blk.dtype == torch.int8:
        raise TypeError("the SpGEMM kernel takes float32 or bfloat16 A values")
    vdt, idt = _check_stream_args(m_blk, col_blk, row_blk, None, None, l=l, c_blk=c_blk)
    device = m_blk.device
    _check_block_starts(block_starts, num_windows, device)
    for name, t, dt in (("b_vals", b_vals, torch.float32), ("b_cols", b_cols, torch.int32)):
        if t.dtype != dt or t.dim() != 2 or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dt} (R, k_max) tensor on {device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if b_vals.shape != b_cols.shape:
        raise ValueError(f"B planes differ in shape: {tuple(b_vals.shape)} vs {tuple(b_cols.shape)}")
    r_rows, k_max = b_vals.shape
    y = torch.empty(num_windows, l, n_out, dtype=torch.float32, device=device)
    if n_out == 0:
        return y
    lengths = torch.empty(r_rows, dtype=torch.int32, device=device)
    launch(
        "gust_spgemm", "gust_spgemm",
        [m_blk, col_blk, row_blk, block_starts, b_vals, b_cols, lengths, y,
         vdt, idt, num_windows, l, c_blk, r_rows, k_max, n_out],
        device,
    )
    launches += 1
    return y
