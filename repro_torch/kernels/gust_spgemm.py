"""GUST SpGEMM: wrapper of the CUDA kernel in ``csrc/gust_spgemm.cu``.

:func:`gust_spgemm` replaces the TPU kernel
``repro.kernels.gust_spgemm.make_gust_spgemm``: ``C = A @ B`` over A's
color-block stream (either layout, as the ragged block stream that
``block_starts`` steers) and B's rows, into per-window ``(l, n_out)`` f32
accumulators.  B comes as the condensed ``(R, k_max)`` value/column
planes, or with ``b_ptr`` by row offsets into flat value/column arrays.
A pre-pass on the card gathers each adder row's real slots in stream
order and tabulates where each of B's rows enters each output tile; then
each warp of a persistent grid owns one row's tile of output columns
(1,024, the source's ``kTileCols``) at a time, sums its cells in shared
memory in stream order and writes them once.

Bound by memory: A's stream read once, B's real entries read once (8
bytes each, plus one 32-byte sector per row to find its end; the planes'
padding to ``k_max`` need not be read) and the ``(W, l, n_out)`` output
written once, at the card's 3.35 TB/s.  The kernel's design is described
in its source.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.gust_spgemm_ref`); on a CUDA tensor it
launches the kernel or raises.  ``launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.spgemm import row_windows
from .gust_spmv import _check_block_starts, _check_stream_args, launch
from .ref import gust_spgemm_ref

__all__ = ["gust_spgemm", "spgemm_launch_plan"]

#: Kernel launches made by :func:`gust_spgemm` in this process.
launches = 0


def _check_b(b_vals, b_cols, b_ptr, device):
    """Validate B's carrier; returns ``(r_rows, k_max)`` (``k_max`` 0 for
    row offsets)."""
    dim = 2 if b_ptr is None else 1
    for name, t, dt in (("b_vals", b_vals, torch.float32), ("b_cols", b_cols, torch.int32)):
        if t.dtype != dt or t.dim() != dim or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dt} {dim}-D tensor on {device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if b_vals.shape != b_cols.shape:
        raise ValueError(f"B's values and columns differ in shape: {tuple(b_vals.shape)} "
                         f"vs {tuple(b_cols.shape)}")
    if b_ptr is None:
        return b_vals.shape
    if (b_ptr.dtype != torch.int64 or b_ptr.dim() != 1 or b_ptr.numel() < 2
            or b_ptr.device != device or not b_ptr.is_contiguous()):
        raise ValueError(
            f"b_ptr must be a contiguous int64 (R + 1,) tensor on {device}, got "
            f"{b_ptr.dtype} {tuple(b_ptr.shape)} on {b_ptr.device}"
        )
    return b_ptr.numel() - 1, 0


def gust_spgemm(
    block_starts: torch.Tensor,  # (W+1,) int32 per-window block prefix
    m_blk: torch.Tensor,  # (T*c_blk, l) f32/bf16 A values (0 in padding)
    col_blk: torch.Tensor,  # (T*c_blk, l) int32/int16 ORIGINAL A columns
    row_blk: torch.Tensor,  # (T*c_blk, l) int32/int16 adder index
    b_vals: torch.Tensor,  # (R, k_max) f32 B planes, or (nnz,) with b_ptr
    b_cols: torch.Tensor,  # (R, k_max) int32 B planes, or (nnz,) with b_ptr
    *,
    num_windows: int,
    l: int,
    n_out: int,
    c_blk: int,
    b_ptr: Optional[torch.Tensor] = None,  # (R+1,) int64 row offsets of B
    real_slots: Optional[int] = None,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Sparse x sparse through A's stream: returns the (W, l, n_out) f32
    window accumulators.  ``real_slots``, at least the count of nonzero
    values in ``m_blk`` (A's nonzeros, which the SpGEMM path passes), sizes
    the kernel's compact copy of A's real slots; by default every slot of
    the stream (a count too small drops the slots past it).  A ``stats``
    dict receives, on the card, the longest unit of each CTA of the
    row-tile kernel
    (``cta_longest_unit_cycles``, in clock cycles), their largest
    (``longest_unit_cycles``) and the longest slot-loading and product
    phases of a unit (``longest_load_cycles``,
    ``longest_products_cycles``); the call then waits for the card."""
    global launches
    if m_blk.device.type == "cpu":
        return gust_spgemm_ref(
            m_blk, col_blk, row_blk, row_windows(block_starts, c_blk),
            b_vals, b_cols, num_windows=num_windows, l=l, n_out=n_out, b_ptr=b_ptr,
        )
    if m_blk.device.type != "cuda":
        raise ValueError(f"unsupported device {m_blk.device}")
    if m_blk.dtype == torch.int8:
        raise TypeError("the SpGEMM kernel takes float32 or bfloat16 A values")
    vdt, idt = _check_stream_args(m_blk, col_blk, row_blk, None, None, l=l, c_blk=c_blk)
    device = m_blk.device
    _check_block_starts(block_starts, num_windows, device)
    r_rows, k_max = _check_b(b_vals, b_cols, b_ptr, device)
    y = torch.empty(num_windows, l, n_out, dtype=torch.float32, device=device)
    if n_out == 0:
        return y
    rows = m_blk.shape[0]
    slots = m_blk.numel() if real_slots is None else min(int(real_slots), m_blk.numel())
    if slots < 0:
        raise ValueError(f"real_slots={real_slots} is negative")
    work = torch.empty(_workspace_bytes(num_windows, l, c_blk, rows, r_rows, n_out, slots),
                       dtype=torch.uint8, device=device)
    held = None
    if stats is not None:
        grid = spgemm_launch_plan(device)["grid"]
        held = torch.empty(grid, 3, dtype=torch.int64, device=device)
    launch(
        "gust_spgemm", "gust_spgemm",
        [m_blk, col_blk, row_blk, block_starts, b_vals, b_cols,
         0 if b_ptr is None else b_ptr, work, y, 0 if held is None else held,
         vdt, idt, num_windows, l, c_blk, rows, r_rows, k_max, n_out, slots],
        device,
    )
    launches += 1
    if held is not None:
        per_cta = held.cpu()
        stats["cta_longest_unit_cycles"] = per_cta[:, 0].tolist()
        stats.update(zip(("longest_unit_cycles", "longest_load_cycles",
                          "longest_products_cycles"), per_cta.max(0).values.tolist()))
    return y


def _workspace_bytes(num_windows, l, c_blk, rows, r_rows, n_out, slots) -> int:
    from ._build import load

    out = ctypes.c_longlong(0)
    err = load("gust_spgemm").gust_spgemm_workspace(
        num_windows, l, c_blk, rows, r_rows, n_out, slots, ctypes.byref(out))
    if err != 0:
        raise ValueError(f"gust_spgemm_workspace refused W={num_windows}, l={l}, "
                         f"c_blk={c_blk}, rows={rows}, R={r_rows}, n_out={n_out}, "
                         f"slots={slots} (cudaError {err})")
    return out.value


def spgemm_launch_plan(device) -> dict:
    """The launch of the SpGEMM kernel's row-tile kernel on ``device``:
    CTAs per SM (from the occupancy calculator), the grid, shared bytes per
    CTA, warps per CTA, output columns of a warp's tile (``n_t``) and
    ``launch``, its context for the resource audit."""
    from ._build import load

    out = (ctypes.c_int * 5)()
    lib = load("gust_spgemm")
    with torch.cuda.device(device):
        err = lib.gust_spgemm_plan(out)
    if err != 0:
        msg = lib.gust_error_string(err).decode()
        raise RuntimeError(f"gust_spgemm_plan failed: {msg} (cudaError {err})")
    plan = dict(zip(("ctas_per_sm", "grid", "smem_bytes", "warps_per_cta", "n_t"), out))
    plan["launch"] = {"library": "gust_spgemm", "kernel": "row_tiles_kernel",
                      "threads": plan["warps_per_cta"] * 32,
                      "sms": torch.cuda.get_device_properties(device).multi_processor_count}
    return plan
