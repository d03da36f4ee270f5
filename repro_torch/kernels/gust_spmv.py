"""Padded GUST SpMV: wrappers of the CUDA kernels in ``csrc/``.

* :func:`gust_spmv` (``csrc/gust_spmv.cu``) replaces the TPU kernel
  ``repro.kernels.gust_spmv.make_gust_spmv`` (and its int8 body
  ``_kernel_q``): per ``(c_blk, l)`` block of the padded stream, gather
  ``x[col]``, multiply by the value, and add into the window's ``(l, B)``
  tile.  The blocks are spread over the card's CTAs and each window's
  block tiles folded in stream order by a second kernel.
* :func:`gust_spmv_local` (``csrc/gust_spmv_local.cu``) replaces
  ``make_gust_spmv_local``: x read through the pack-time segment table,
  each block's tiles staged in shared memory at the block's own top
  (single-buffered), spread and folded as :func:`gust_spmv`.
* :func:`gust_spmv_db` (``csrc/gust_spmv_db.cu``) replaces
  ``make_gust_spmv_db``: the same product with the stream's slots copied
  into a ring of two shared-memory stages ahead of use (double-buffered:
  bulk copies at B > 1 where the leaves' rows are whole 16-byte runs,
  else :func:`gust_spmv`'s register prefetch), spread and folded as
  :func:`gust_spmv`.
* :func:`gust_spmv_local_db` (``csrc/gust_spmv_local_db.cu``) replaces
  ``make_gust_spmv_local_db``: x read through the pack-time segment
  table, each block's tiles staged one block ahead, spread and folded as
  :func:`gust_spmv`.

``csrc/gust_spread.cuh`` holds the code of every kernel here and of
every ragged one; :func:`spread_launch_plan` reports the launch each of
them makes.

All are bound by memory: each stream slot is read once (value + 2 index
bytes), plus the scales, x once (local: also the referenced prefix of
the segment table) and y, at the card's 3.35 TB/s.  The kernels' design
is described in their sources.

On a CPU tensor a wrapper runs the plain version
(:mod:`repro_torch.kernels.ref`); on a CUDA tensor it launches its kernel
or raises.  ``launches``, ``local_launches``, ``db_launches`` and
``local_db_launches`` count the launches of each kernel.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .ref import gust_spmv_local_ref, gust_spmv_ref

__all__ = [
    "gust_spmv",
    "gust_spmv_local",
    "gust_spmv_db",
    "gust_spmv_local_db",
    "spread_launch_plan",
]

#: Kernel launches made by :func:`gust_spmv` in this process.
launches = 0
#: ... by :func:`gust_spmv_local`.
local_launches = 0
#: ... by :func:`gust_spmv_db`.
db_launches = 0
#: ... by :func:`gust_spmv_local_db`.
local_db_launches = 0

_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_INDEX_CODES = {torch.int32: 0, torch.int16: 1}


def _check_stream_args(
    m_blocks, col_blocks, row_blocks, x_padded, scale_blk, *, l, c_blk
):
    """Validate the stream, x (unless None) and scales a CUDA kernel
    takes; returns ``(value_code, index_code)``."""
    dev = m_blocks.device
    if m_blocks.dtype not in _VALUE_CODES:
        raise TypeError(f"unsupported value dtype {m_blocks.dtype}")
    if col_blocks.dtype not in _INDEX_CODES or row_blocks.dtype != col_blocks.dtype:
        raise TypeError(
            f"index leaves must share an int32/int16 dtype, got "
            f"{col_blocks.dtype} and {row_blocks.dtype}"
        )
    if x_padded is not None and (
        x_padded.dtype != torch.float32 or x_padded.dim() != 2
    ):
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
    if x_padded is not None and x_padded.shape[1] < 1:
        raise ValueError("x has no columns")
    quant = m_blocks.dtype == torch.int8
    if quant != (scale_blk is not None):
        raise ValueError("an int8 stream needs scale_blk, and only an int8 stream takes it")
    tensors = [m_blocks, col_blocks, row_blocks]
    if x_padded is not None:
        tensors.append(x_padded)
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


def _check_seg_blk(seg_blk, rows, c_blk, device) -> int:
    """Validate a segment table for ``rows`` stream rows of ``c_blk``-row
    blocks; returns ``S_blk``."""
    t_blk = rows // c_blk
    if (
        seg_blk.dtype != torch.int32
        or seg_blk.dim() != 2
        or seg_blk.shape[0] != t_blk
        or seg_blk.shape[1] < 1
        or seg_blk.device != device
        or not seg_blk.is_contiguous()
    ):
        raise ValueError(
            f"seg_blk must be a contiguous int32 ({t_blk}, S_blk) tensor on "
            f"{device}, got {seg_blk.dtype} {tuple(seg_blk.shape)} on "
            f"{seg_blk.device}"
        )
    return seg_blk.shape[1]


def _check_block_starts(block_starts, num_windows, device) -> None:
    """Validate a ragged stream's per-window block prefix."""
    if (
        block_starts.dtype != torch.int32
        or tuple(block_starts.shape) != (num_windows + 1,)
        or block_starts.device != device
        or not block_starts.is_contiguous()
    ):
        raise ValueError(
            f"block_starts must be a contiguous int32 ({num_windows + 1},) "
            f"tensor on {device}, got {block_starts.dtype} "
            f"{tuple(block_starts.shape)} on {block_starts.device}"
        )


def _blocks_per_window(rows: int, num_windows: int, c_blk: int) -> int:
    """Blocks per window of a padded stream; raises if it does not split."""
    if num_windows < 1 or rows % (num_windows * c_blk):
        raise ValueError(
            f"{rows} stream rows do not split into {num_windows} windows of "
            f"c_blk={c_blk} blocks (c_pad must be a multiple of c_blk)"
        )
    return rows // (num_windows * c_blk)


def run_kernel(
    lib_name: str,
    entry: str,
    m_blocks: torch.Tensor,
    cols: torch.Tensor,  # col_blocks, or col_loc for the local kernels
    row_blocks: torch.Tensor,
    x_padded: torch.Tensor,
    *,
    num_windows: int,
    l: int,
    c_blk: int,
    scale_blk: Optional[torch.Tensor],
    blocks: Union[int, torch.Tensor],  # padded: blocks per window; ragged: block_starts
    seg_blk: Optional[torch.Tensor] = None,  # the local kernels' segment table
    partials: bool = False,  # the entry point takes a (T_blk, l, B) scratch
) -> torch.Tensor:
    """Check the arguments of C entry point ``entry`` of library
    ``lib_name`` (built at first use), allocate the (W, l, B) f32 output
    (and with ``partials`` the (T_blk, l, B) f32 scratch of block tiles)
    and launch the kernel on the current stream of the stream's device.
    Raises on a tensor the kernel does not take and on a failed launch.

    The entry points take, in order: m, cols, row, [seg_blk], scale, x,
    y, [partials], [block_starts], value code, index code, W, [T_blk],
    [blocks per window], l, c_blk, [S_blk], B, stream."""
    if m_blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {m_blocks.device}")
    vdt, idt = _check_stream_args(
        m_blocks, cols, row_blocks, x_padded, scale_blk, l=l, c_blk=c_blk
    )
    device, b = m_blocks.device, x_padded.shape[1]
    ragged, local = isinstance(blocks, torch.Tensor), seg_blk is not None
    if ragged:
        _check_block_starts(blocks, num_windows, device)
    if local:
        s_blk = _check_seg_blk(seg_blk, m_blocks.shape[0], c_blk, device)
    y = torch.empty(num_windows, l, b, dtype=torch.float32, device=device)
    t_blk = m_blocks.shape[0] // c_blk
    args = [m_blocks, cols, row_blocks] + ([seg_blk] if local else [])
    args += [scale_blk, x_padded, y]
    if partials:
        args.append(torch.empty(t_blk, l, b, dtype=torch.float32, device=device))
    args += ([blocks] if ragged else []) + [vdt, idt, num_windows]
    args += ([t_blk] if partials else []) + ([] if ragged else [blocks])
    args += [l, c_blk] + ([s_blk] if local else []) + [b]
    launch(lib_name, entry, args, device)
    return y


def launch(lib_name: str, entry: str, args, device: torch.device) -> None:
    """Call C entry point ``entry`` of library ``lib_name`` (built at
    first use) with ``args`` (tensors pass their data pointers) and the
    current stream of ``device``; raises if the launch failed."""
    from ._build import load

    lib = load(lib_name)
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.gust_error_string(err).decode()
        raise RuntimeError(f"{entry} kernel launch failed: {msg} (cudaError {err})")


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
    bpw = _blocks_per_window(m_blocks.shape[0], num_windows, c_blk)
    if m_blocks.device.type == "cpu":
        return gust_spmv_ref(
            m_blocks, col_blocks, row_blocks, x_padded,
            num_windows=num_windows, l=l, scale_blk=scale_blk, c_blk=c_blk,
        )
    y = run_kernel(
        "gust_spmv", "gust_spmv_padded", m_blocks, col_blocks, row_blocks,
        x_padded, num_windows=num_windows, l=l, c_blk=c_blk,
        scale_blk=scale_blk, blocks=bpw, partials=True,
    )
    launches += 1
    return y


def gust_spmv_local(
    m_blocks: torch.Tensor,  # (W*C_pad, l) values (0 in padding)
    col_loc: torch.Tensor,  # (W*C_pad, l) int32/int16 block-local columns
    row_blocks: torch.Tensor,  # (W*C_pad, l) int32/int16 adder index
    seg_blk: torch.Tensor,  # (T_blk, S_blk) int32 segment table
    x_padded: torch.Tensor,  # (S*l, B) float32
    *,
    num_windows: int,
    l: int,
    c_blk: int,
    scale_blk: Optional[torch.Tensor] = None,  # (T_blk,) f32 for int8
) -> torch.Tensor:
    """Segment-local, single-buffered padded-stream SpMM: returns the
    (W, l, B) f32 window tiles.  ``c_blk`` is the pack-time block height
    the segment table was built at."""
    global local_launches
    bpw = _blocks_per_window(m_blocks.shape[0], num_windows, c_blk)
    if m_blocks.device.type == "cpu":
        return gust_spmv_local_ref(
            m_blocks, col_loc, row_blocks, seg_blk, x_padded,
            num_windows=num_windows, l=l, c_blk=c_blk, scale_blk=scale_blk,
        )
    y = run_kernel(
        "gust_spmv_local", "gust_spmv_local_padded", m_blocks, col_loc,
        row_blocks, x_padded, num_windows=num_windows, l=l, c_blk=c_blk,
        scale_blk=scale_blk, blocks=bpw, seg_blk=seg_blk, partials=True,
    )
    local_launches += 1
    return y


def gust_spmv_db(
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
    """Double-buffered padded-stream SpMM, the same result as
    :func:`gust_spmv`: returns the (W, l, B) f32 window tiles."""
    global db_launches
    bpw = _blocks_per_window(m_blocks.shape[0], num_windows, c_blk)
    if m_blocks.device.type == "cpu":
        return gust_spmv_ref(
            m_blocks, col_blocks, row_blocks, x_padded,
            num_windows=num_windows, l=l, scale_blk=scale_blk, c_blk=c_blk,
        )
    y = run_kernel(
        "gust_spmv_db", "gust_spmv_db_padded", m_blocks, col_blocks,
        row_blocks, x_padded, num_windows=num_windows, l=l, c_blk=c_blk,
        scale_blk=scale_blk, blocks=bpw, partials=True,
    )
    db_launches += 1
    return y


def gust_spmv_local_db(
    m_blocks: torch.Tensor,  # (W*C_pad, l) values (0 in padding)
    col_loc: torch.Tensor,  # (W*C_pad, l) int32/int16 block-local columns
    row_blocks: torch.Tensor,  # (W*C_pad, l) int32/int16 adder index
    seg_blk: torch.Tensor,  # (T_blk, S_blk) int32 segment table
    x_padded: torch.Tensor,  # (S*l, B) float32
    *,
    num_windows: int,
    l: int,
    c_blk: int,
    scale_blk: Optional[torch.Tensor] = None,  # (T_blk,) f32 for int8
) -> torch.Tensor:
    """Segment-local, double-buffered padded-stream SpMM: returns the
    (W, l, B) f32 window tiles.  ``c_blk`` is the pack-time block height
    the segment table was built at."""
    global local_db_launches
    bpw = _blocks_per_window(m_blocks.shape[0], num_windows, c_blk)
    if m_blocks.device.type == "cpu":
        return gust_spmv_local_ref(
            m_blocks, col_loc, row_blocks, seg_blk, x_padded,
            num_windows=num_windows, l=l, c_blk=c_blk, scale_blk=scale_blk,
        )
    y = run_kernel(
        "gust_spmv_local_db", "gust_spmv_local_db_padded", m_blocks, col_loc,
        row_blocks, x_padded, num_windows=num_windows, l=l, c_blk=c_blk,
        scale_blk=scale_blk, blocks=bpw, seg_blk=seg_blk, partials=True,
    )
    local_db_launches += 1
    return y


#: The library of the spread kernels of each (gather, pipeline): kernels
#: 1/2, 5/7 (the resident ones), 3/4 and 6/8; either layout's entry point
#: reads its library's plan.
_SPREAD_LIBS = {
    ("resident", "single"): "gust_spmv",
    ("resident", "double"): "gust_spmv_db",
    ("local", "single"): "gust_spmv_local",
    ("local", "double"): "gust_spmv_local_db",
}


def spread_launch_plan(
    m_blocks: torch.Tensor,  # (T_blk*c_blk, l) values on the card
    cols: torch.Tensor,  # (T_blk*c_blk, l) int32/int16 columns or col_loc
    row_blocks: torch.Tensor,  # (T_blk*c_blk, l) int32/int16 adder index
    x_padded: torch.Tensor,  # (S*l, B) float32
    *,
    l: int,
    c_blk: int,
    gather: str,  # "resident" or "local"
    pipeline: str,  # "single" or "double"
) -> dict:
    """The launch the spread kernel of ``(gather, pipeline)`` makes for this
    stream on its card (either layout: the block kernel sees only the
    stream): CTAs per SM (from the occupancy calculator), the grid of the
    block kernel, its shared bytes per CTA, the x tiles staged per block
    (0 for the resident gather), the cycles per chunk and the stream
    stages (2: the slots come through the bulk-copy ring, which the
    resident double-buffered kernels 5/7 take at B > 1 where the leaves'
    rows are whole 16-byte runs; 0: register prefetch),
    ``partial_bytes``, the size of the scratch of block tiles, and
    ``launch``, the launch's context for the resource audit
    (``repro_torch.analysis.kernel_audit``)."""
    import ctypes

    from ._build import load

    if (gather, pipeline) not in _SPREAD_LIBS:
        raise ValueError(
            f"(gather, pipeline) must be one of {sorted(_SPREAD_LIBS)}, got "
            f"{(gather, pipeline)!r}"
        )
    name = _SPREAD_LIBS[gather, pipeline]
    b, t_blk = x_padded.shape[1], m_blocks.shape[0] // c_blk
    out = (ctypes.c_int * 7)()
    lib = load(name)
    with torch.cuda.device(m_blocks.device):
        err = getattr(lib, f"{name}_plan")(
            m_blocks.data_ptr(), cols.data_ptr(), row_blocks.data_ptr(),
            _VALUE_CODES[m_blocks.dtype], _INDEX_CODES[cols.dtype], t_blk, l,
            c_blk, b, out,
        )
    if err != 0:
        msg = lib.gust_error_string(err).decode()
        raise RuntimeError(f"{name}_plan failed: {msg} (cudaError {err})")
    keys = ("ctas_per_sm", "grid_x", "grid_y", "smem_bytes", "stage_tiles",
            "chunk_cycles", "stream_stages")
    plan = dict(zip(keys, out))
    plan["partial_bytes"] = t_blk * l * b * 4
    plan["launch"] = {  # what the resource audit needs to know of this launch
        "library": name, "kernel": "spread_partials", "threads": l,
        "sms": torch.cuda.get_device_properties(m_blocks.device).multi_processor_count,
        "value_dtype": str(m_blocks.dtype).removeprefix("torch."),
        "index_dtype": str(cols.dtype).removeprefix("torch."),
        "gather": gather, "pipeline": pipeline, "b": b, "t_blk": t_blk, "l": l,
    }
    return plan
