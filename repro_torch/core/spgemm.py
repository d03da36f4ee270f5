"""SpGEMM: sparse x sparse through a GUST plan's color-block stream.

Counterpart of ``repro.core.spgemm``.  Plan A is scheduled once into a
stream of conflict-free ``(c_blk, l)`` multiply blocks; for SpGEMM each
slot ``(a = A[i, j], row, col = j)`` gathers a **row of B** where SpMV
gathers ``x[j]`` (SpArch's streamed outer products), and the per-window
accumulator tile becomes ``(l, n_out)``.  B reaches the kernel by row
offsets (:func:`row_offsets`, built on the plan's device from the COO:
its real entries row by row, 8 bytes each), so the B bytes scale with
``nnz(B)``, not with the densified ``R·n_out·4`` nor with the
reference's condensed-row planes (:func:`condense_rows`, every row padded
to ``k_max`` pairs: 919 MB for a power-law graph of 16,384 nodes), which
the kernel also takes.  Row ``j`` of the offsets is the real prefix of
row ``j`` of the planes, bit for bit.

The plan's device picks the path: on the card the CUDA kernel
(:func:`repro_torch.kernels.gust_spgemm.gust_spgemm`), on the CPU its
plain version.  The dense ``(m, n_out)`` result is compacted on the
device (``torch.nonzero``, row-major) and only its nonzeros cross to the
host.  The result is a :class:`~repro_torch.core.formats.COOMatrix`:
deduplicated, row-sorted, numerically-zero entries dropped, int64
indices, f32 values — itself a valid ``plan()`` input.

The public entry points are :meth:`GustPlan.spgemm` and
:meth:`GustPlan.spgemm_cost`; this module is their implementation.

Numerical contract: on exact-arithmetic inputs (integer-valued f32 whose
products and partial sums are exactly representable) the result is
bitwise equal to the dense ``dense_from_coo(A) @ dense_from_coo(B)`` on
every layout and device; on arbitrary f32 inputs the paths agree to
float tolerance (their summation orders differ).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from .formats import COOMatrix, coo_from_dense
from .packing import RaggedSchedule, resolve_device

__all__ = [
    "CondensedB",
    "condense_rows",
    "RowOffsetsB",
    "row_offsets",
    "SpgemmCost",
    "spgemm_cost",
    "spgemm",
]


@dataclasses.dataclass(frozen=True)
class CondensedB:
    """B in condensed-row form: every row padded to ``k_max`` pairs.

    ``vals``/``cols`` are ``(r_rows, k_max)`` tensors — f32 values and
    int32 output-column ids — with rows padded to ``r_rows =
    ceil(k / l) * l`` so the A stream's padding column slots (which hold
    their own lane index, < l <= r_rows) always gather in bounds.
    Padding entries hold ``value 0.0, column 0``."""

    shape: Tuple[int, int]  # original B shape (k, n)
    vals: torch.Tensor  # (r_rows, k_max) f32
    cols: torch.Tensor  # (r_rows, k_max) int32
    k_max: int
    r_rows: int

    @property
    def condensed_bytes(self) -> int:
        return int(self.r_rows * self.k_max * (4 + 4))

    @property
    def dense_bytes(self) -> int:
        return int(self.r_rows * self.shape[1] * 4)


def condense_rows(b: COOMatrix, l: int, device="cuda") -> CondensedB:
    """Build the condensed-row planes of ``b`` for a length-``l`` plan,
    on ``device``.

    Duplicate ``(row, col)`` entries are summed (the
    :func:`~repro_torch.core.formats.dense_from_coo` semantics), rows are
    sorted and each row's entries are column-sorted: the reference's
    planes, bit for bit."""
    device = resolve_device(device)
    k, n = b.shape
    r_rows = max(-(-k // l), 1) * l
    if b.nnz == 0:
        return CondensedB(
            shape=(k, n),
            vals=torch.zeros((r_rows, 1), dtype=torch.float32, device=device),
            cols=torch.zeros((r_rows, 1), dtype=torch.int32, device=device),
            k_max=1,
            r_rows=r_rows,
        )
    srt = b.sorted_by_row()
    key = srt.rows * np.int64(n) + srt.cols
    uniq, inv = np.unique(key, return_inverse=True)
    acc = np.zeros(uniq.shape[0], np.float32)
    np.add.at(acc, inv, srt.vals.astype(np.float32))
    rows_u = (uniq // n).astype(np.int64)
    cols_u = (uniq % n).astype(np.int64)
    counts = np.bincount(rows_u, minlength=k)
    k_max = int(max(counts.max(), 1))
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(uniq.shape[0], dtype=np.int64) - starts[rows_u]
    vals = np.zeros((r_rows, k_max), np.float32)
    cols = np.zeros((r_rows, k_max), np.int32)
    vals[rows_u, pos] = acc
    cols[rows_u, pos] = cols_u
    return CondensedB(
        shape=(k, n),
        vals=torch.from_numpy(vals).to(device),
        cols=torch.from_numpy(cols).to(device),
        k_max=k_max,
        r_rows=r_rows,
    )


@dataclasses.dataclass(frozen=True)
class RowOffsetsB:
    """B by row offsets: row ``j`` is entries ``ptr[j]:ptr[j+1]`` of
    ``vals``/``cols`` (its merged entries, columns ascending), for
    ``r_rows = ceil(k / l) * l`` rows as :class:`CondensedB` has (the rows
    past ``k`` are empty)."""

    ptr: torch.Tensor  # (r_rows + 1,) int64
    vals: torch.Tensor  # (nnz,) f32
    cols: torch.Tensor  # (nnz,) int32
    r_rows: int

    @property
    def nbytes(self) -> int:
        return int((self.r_rows + 1) * 8 + self.vals.numel() * (4 + 4))


def row_offsets(b: COOMatrix, l: int, device="cuda") -> RowOffsetsB:
    """B by row offsets for a length-``l`` plan, built on ``device`` from
    the COO: the rows of :func:`condense_rows`'s planes without their
    padding, bit for bit.

    A stable sort on ``row * n + col`` puts each row's entries in column
    order and keeps a cell's duplicates in their order in ``b``, which is
    their order in ``b.sorted_by_row()``; the duplicates are then summed
    in f32 from +0 in that order, as ``condense_rows``'s ``np.add.at``
    sums them (a sum of 0 stays an entry there and here).  Pass ``t`` adds
    the ``t``-th term of every cell that has one: with the cells ordered
    by their count of terms, most first, those are a prefix, so the passes
    together touch each entry once."""
    device = resolve_device(device)
    k, n = b.shape
    r_rows = max(-(-k // l), 1) * l
    ptr = torch.zeros(r_rows + 1, dtype=torch.int64, device=device)
    if b.nnz == 0:
        return RowOffsetsB(ptr=ptr, vals=torch.zeros(0, dtype=torch.float32, device=device),
                           cols=torch.zeros(0, dtype=torch.int32, device=device),
                           r_rows=r_rows)
    rows, cols, vals = (torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
                        for a, dt in ((b.rows, np.int64), (b.cols, np.int64),
                                      (b.vals, np.float32)))
    key, order = torch.sort(rows * n + cols, stable=True)
    cells, terms = torch.unique_consecutive(key, return_counts=True)
    first = torch.cumsum(terms, 0) - terms
    vals = vals[order]
    most, by_terms = torch.sort(terms, descending=True, stable=True)
    first = first[by_terms]
    # cells with more than t terms, for every t below the most terms of a cell
    having = torch.bincount(most).flip(0).cumsum(0).flip(0)[1:].tolist()
    acc_by_terms = torch.zeros(cells.numel(), dtype=torch.float32, device=device)
    for t, live in enumerate(having):
        acc_by_terms[:live] += vals[first[:live] + t]
    acc = torch.empty_like(acc_by_terms)
    acc[by_terms] = acc_by_terms
    torch.cumsum(torch.bincount(cells // n, minlength=r_rows), 0, out=ptr[1:])
    return RowOffsetsB(ptr=ptr, vals=acc, cols=(cells % n).to(torch.int32), r_rows=r_rows)


@dataclasses.dataclass(frozen=True)
class SpgemmCost:
    """Predicted cost of one ``A @ B`` product — no execution, no pack.

    ``products`` is the multiply/merge count (Σ over nnz(A) of B's
    matching row nnz); ``out_nnz_estimate`` the balls-in-bins estimate of
    the result's nnz; ``scratch_bytes`` one window's ``(l, n_out)`` f32
    accumulator; ``b_condensed_bytes``/``b_dense_bytes`` the streamed-B
    footprint of the condensed format against densifying;
    ``flop_reduction`` the FLOP win over a dense ``(m, k) @ (k, n)``."""

    products: int
    out_nnz_estimate: int
    out_density_estimate: float
    scratch_bytes: int
    b_condensed_bytes: int
    b_dense_bytes: int
    k_max: int
    streamed_slots: int
    spgemm_flops: int
    dense_flops: int
    flop_reduction: float

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _as_coo(other) -> COOMatrix:
    from .plan import GustPlan

    if isinstance(other, COOMatrix):
        return other
    if isinstance(other, GustPlan):
        if other._source is None:
            raise ValueError(
                "spgemm(other=GustPlan) needs the plan's source matrix; "
                "this plan was built from a schedule — pass the COOMatrix "
                "directly"
            )
        return other._source
    if isinstance(other, (np.ndarray, torch.Tensor)):
        if isinstance(other, torch.Tensor):
            other = other.detach().cpu()
        dense = np.asarray(other)
        if dense.ndim != 2:
            raise ValueError(f"dense B must be 2-D, got shape {dense.shape}")
        return coo_from_dense(dense)
    raise TypeError(
        "spgemm() takes a COOMatrix, GustPlan or dense array for B; got "
        f"{type(other).__name__}"
    )


def _a_cols(plan_a) -> np.ndarray:
    """Original column index of every real scheduled slot of A."""
    if plan_a._source is not None:
        return np.asarray(plan_a._source.cols, np.int64)
    s = plan_a.sched
    return np.asarray(s.col_sch, np.int64)[np.asarray(s.valid)]


def _check_shapes(plan_a, b: COOMatrix) -> Tuple[int, int, int]:
    m, k = plan_a.shape
    if b.shape[0] != k:
        raise ValueError(
            f"spgemm shape mismatch: A is {m}x{k}, B is "
            f"{b.shape[0]}x{b.shape[1]}"
        )
    return m, k, b.shape[1]


def spgemm_cost(plan_a, other) -> SpgemmCost:
    """Price ``plan_a @ other`` without executing (or packing)."""
    b = _as_coo(other)
    m, k, n_out = _check_shapes(plan_a, b)
    l = plan_a.l
    b_row_nnz = b.row_nnz()
    products = int(b_row_nnz[_a_cols(plan_a)].sum())

    # balls-in-bins output-nnz estimate: row i of C receives
    # prod_i = Σ_{j in A row i} nnz(B[j, :]) candidate columns out of n
    if plan_a._source is not None and n_out:
        src = plan_a._source
        per_row = np.zeros(m, np.float64)
        np.add.at(per_row, src.rows, b_row_nnz[src.cols].astype(np.float64))
        est = float(np.sum(n_out * -np.expm1(per_row * np.log1p(-1.0 / n_out))))
    elif n_out and m:
        per_row = products / float(m)
        est = float(m * n_out * -np.expm1(per_row * np.log1p(-1.0 / n_out)))
    else:
        est = 0.0
    out_nnz = int(min(round(est), m * n_out))

    # streamed A slots at the plan's resolved layout, from the schedule
    # alone (no pack): padded streams W * C_pad, ragged only real blocks
    cw = plan_a.sched.colors_per_window
    cb = plan_a.config.c_blk
    if plan_a.layout == "ragged":
        blocks = int(np.maximum(-(-cw // cb), 1).sum())
    else:
        blocks = plan_a.sched.num_windows * max(
            -(-int(cw.max() if cw.size else 1) // cb), 1
        )
    streamed_slots = blocks * cb * l

    r_rows = max(-(-k // l), 1) * l
    k_max = int(max(b_row_nnz.max() if b.nnz else 1, 1))
    spgemm_flops = 2 * products
    dense_flops = 2 * m * k * n_out
    return SpgemmCost(
        products=products,
        out_nnz_estimate=out_nnz,
        out_density_estimate=out_nnz / float(m * n_out) if m and n_out else 0.0,
        scratch_bytes=l * n_out * 4,
        b_condensed_bytes=r_rows * k_max * 8,
        b_dense_bytes=r_rows * n_out * 4,
        k_max=k_max,
        streamed_slots=streamed_slots,
        spgemm_flops=spgemm_flops,
        dense_flops=dense_flops,
        flop_reduction=dense_flops / max(spgemm_flops, 1),
    )


def _stream_view(art):
    """Unified ragged-style view of either packed layout: the number of
    blocks and the ``block_window``/``block_starts`` steering pair (a
    padded artifact is the stream whose every window owns ``C_pad/c_blk``
    blocks)."""
    if isinstance(art, RaggedSchedule):
        return art.num_blocks, art.block_window, art.block_starts
    cpb = art.c_pad // art.c_blk
    dev = art.device
    bw = torch.arange(art.num_windows, dtype=torch.int32, device=dev)
    bw = bw.repeat_interleave(cpb)
    bs = torch.arange(art.num_windows + 1, dtype=torch.int32, device=dev) * cpb
    return art.num_windows * cpb, bw, bs


def row_windows(block_starts: torch.Tensor, c_blk: int) -> torch.Tensor:
    """The window of every stream row (the plain version's ``window``
    argument), from the per-window block prefix that :func:`_stream_view`
    gives."""
    counts = block_starts[1:].long() - block_starts[:-1].long()
    wins = torch.arange(counts.numel(), dtype=torch.int32, device=block_starts.device)
    return wins.repeat_interleave(counts).repeat_interleave(c_blk)


def float_artifact(plan_a):
    """Plan A's packed stream, rejected when int8-quantized."""
    art = plan_a.artifact
    if art.quantized:
        raise ValueError(
            "spgemm on an int8-quantized plan is not supported: the "
            "SpGEMM bit-identity contract is pinned for float value "
            "streams (re-pack A with value_dtype='float32')"
        )
    return art


def window_product(art, b: Union[RowOffsetsB, CondensedB], n_out: int,
                   real_slots=None) -> torch.Tensor:
    """The ``(W, l, n_out)`` f32 window accumulators of ``A @ B`` over
    A's stream ``art`` and B by row offsets or as condensed planes;
    ``real_slots`` (at least A's nonzeros) sizes the kernel's copy of A's
    real slots."""
    from ..kernels.gust_spgemm import gust_spgemm

    _, _, bs = _stream_view(art)
    return gust_spgemm(
        bs, art.m_blk, art.col_blk, art.row_blk, b.vals, b.cols,
        b_ptr=b.ptr if isinstance(b, RowOffsetsB) else None, real_slots=real_slots,
        num_windows=art.num_windows, l=art.l, n_out=n_out, c_blk=art.c_blk,
    )


def to_original_rows(art, y_win: torch.Tensor, m: int) -> torch.Tensor:
    """The window accumulators as the dense ``(m, n_out)`` product in
    A's original row order."""
    w, l, n_out = y_win.shape
    y_sorted = y_win.reshape(w * l, n_out)  # not (-1, n_out): n_out may be 0
    if art.identity_perm:
        return y_sorted[:m]
    out = torch.zeros(max(m, y_sorted.shape[0]), n_out, dtype=torch.float32,
                      device=y_sorted.device)
    out[art.row_perm.long()] = y_sorted
    return out[:m]


def spgemm_dense(plan_a, other) -> torch.Tensor:
    """The dense ``(m, n_out)`` f32 product ``plan_a @ other`` on the plan's
    device (the kernel's window accumulators in original row order)."""
    b = _as_coo(other)
    m, _, n_out = _check_shapes(plan_a, b)
    art = float_artifact(plan_a)
    offsets = row_offsets(b, art.l, device=art.device)
    y = window_product(art, offsets, n_out, real_slots=plan_a.sched.nnz)
    return to_original_rows(art, y, m)


def compact(c_dense: torch.Tensor):
    """The nonzeros of ``c_dense`` on its device, in row-major order:
    ``(rows, cols, vals)``."""
    idx = torch.nonzero(c_dense)
    rows, cols = idx[:, 0], idx[:, 1]
    return rows, cols, c_dense[rows, cols]


def to_host(shape, rows, cols, vals) -> COOMatrix:
    """The compacted nonzeros copied to the host as a :class:`COOMatrix`."""
    return COOMatrix(tuple(shape), rows.cpu().numpy(), cols.cpu().numpy(),
                     vals.cpu().numpy())


def spgemm(plan_a, other) -> COOMatrix:
    """``C = A @ B`` over plan A's color-block stream; returns a sparse
    deduplicated row-sorted :class:`COOMatrix` (numerically-zero entries
    dropped) that can itself be ``plan()``-ed.  Quantized (int8) plans are
    rejected: re-pack A at f32/bf16."""
    c_dense = spgemm_dense(plan_a, other)
    return to_host(c_dense.shape, *compact(c_dense))
