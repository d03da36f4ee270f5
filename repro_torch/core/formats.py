"""Sparse-matrix storage formats used by GUST.

The paper's preprocessing (§3.3) converts a sparse matrix into the *GUST
scheduled format*: three ``l × C_total`` arrays (we store them transposed as
``C_total × l`` so a "cycle" is a contiguous row — the natural streaming
layout) holding the rearranged values (``M_sch``), the adder index for the
crossbar (``Row_sch`` = original row mod ``l``) and the original column index
used by the Buffer Filler to gather vector elements (``Col_sch``).

Everything here is plain-numpy preprocessing (the paper runs it on a CPU
too); the PyTorch/CUDA execution layer consumes the resulting arrays.
Counterpart of ``repro.core.formats``, kept as its own copy so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "COOMatrix",
    "GustSchedule",
    "coo_from_dense",
    "dense_from_coo",
    "csr_from_coo",
]


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Coordinate-format sparse matrix (the paper's input representation)."""

    shape: Tuple[int, int]
    rows: np.ndarray  # (nnz,) int64
    cols: np.ndarray  # (nnz,) int64
    vals: np.ndarray  # (nnz,) float

    def __post_init__(self):
        if self.rows.shape != self.cols.shape or self.rows.shape != self.vals.shape:
            raise ValueError("rows/cols/vals must have identical shapes")
        m, n = self.shape
        if self.nnz and (self.rows.max() >= m or self.cols.max() >= n):
            raise ValueError("index out of bounds for declared shape")

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def density(self) -> float:
        m, n = self.shape
        return self.nnz / float(m * n) if m and n else 0.0

    def row_nnz(self) -> np.ndarray:
        return np.bincount(self.rows, minlength=self.shape[0]).astype(np.int64)

    def col_nnz(self) -> np.ndarray:
        return np.bincount(self.cols, minlength=self.shape[1]).astype(np.int64)

    def sorted_by_row(self) -> "COOMatrix":
        order = np.lexsort((self.cols, self.rows))
        return COOMatrix(self.shape, self.rows[order], self.cols[order], self.vals[order])

    def sorted_by_col(self) -> "COOMatrix":
        """Entries ordered by (col, row) — the column-major twin of
        :meth:`sorted_by_row` (CSC assembly, transpose chaining)."""
        order = np.lexsort((self.rows, self.cols))
        return COOMatrix(self.shape, self.rows[order], self.cols[order], self.vals[order])

    def transpose(self) -> "COOMatrix":
        """``Aᵀ`` with entries in the transpose's row-major order (so
        ``t.sorted_by_row()`` is a no-op reorder).  Values are shared,
        not copied: ``dense_from_coo(coo.transpose()) ==
        dense_from_coo(coo).T`` including duplicate-entry summation."""
        srt = self.sorted_by_col()
        return COOMatrix(
            (self.shape[1], self.shape[0]), srt.cols, srt.rows, srt.vals
        )


def coo_from_dense(dense: np.ndarray) -> COOMatrix:
    rows, cols = np.nonzero(dense)
    return COOMatrix(dense.shape, rows.astype(np.int64), cols.astype(np.int64), dense[rows, cols])


def dense_from_coo(coo: COOMatrix) -> np.ndarray:
    out = np.zeros(coo.shape, dtype=coo.vals.dtype)
    np.add.at(out, (coo.rows, coo.cols), coo.vals)
    return out


def csr_from_coo(coo: COOMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, indices, data) CSR triple — used by baseline dataflow models."""
    srt = coo.sorted_by_row()
    indptr = np.zeros(coo.shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, srt.rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, srt.cols.copy(), srt.vals.copy()


@dataclasses.dataclass(frozen=True)
class GustSchedule:
    """The GUST scheduled format (paper §3.3, Listings 1-2).

    A length-``l`` GUST processes the matrix window-by-window (sets of ``l``
    rows).  Cycle ``c`` of window ``w`` lives at global row
    ``window_starts[w] + c`` of the three schedule arrays.

    Attributes:
      l:             accelerator length (number of multipliers == adders).
      shape:         original matrix shape ``(m, n)``.
      nnz:           number of real nonzeros scheduled.
      m_sch:         (C_total, l) float — value entering multiplier ``j`` at a
                     given cycle; 0.0 in padding slots.
      row_sch:       (C_total, l) int32 — adder index (row mod l, post
                     row-permutation); 0 in padding slots (safe: value is 0).
      col_sch:       (C_total, l) int32 — ORIGINAL column index for the
                     vector gather; clipped lane index in padding slots.
      window_starts: (num_windows + 1,) int64 prefix of per-window colors.
      row_perm:      (m,) int64 — ``row_perm[scheduled_pos] = original_row``
                     (identity when load balancing is off).  The SpMV output
                     of scheduled row ``s`` belongs to original row
                     ``row_perm[s]``.
      valid:         (C_total, l) bool — True for real (non-padding) slots.
    """

    l: int
    shape: Tuple[int, int]
    nnz: int
    m_sch: np.ndarray
    row_sch: np.ndarray
    col_sch: np.ndarray
    window_starts: np.ndarray
    row_perm: np.ndarray
    valid: np.ndarray

    @property
    def num_windows(self) -> int:
        return int(self.window_starts.shape[0] - 1)

    @property
    def total_colors(self) -> int:
        return int(self.window_starts[-1])

    @property
    def colors_per_window(self) -> np.ndarray:
        return np.diff(self.window_starts)

    @property
    def cycles(self) -> int:
        """Execution cycles: Σ_w C_w plus the 3-level pipeline fill (paper
        §3.4: 'GUST has 3 levels', i.e. +2)."""
        return self.total_colors + 2

    @property
    def hardware_utilization(self) -> float:
        """#NZ operations per cycle per arithmetic unit (paper §1 / Eq. 11)."""
        return self.nnz / float(self.l * self.cycles) if self.cycles else 0.0

    def window_cycle_of(self, global_cycle: np.ndarray) -> np.ndarray:
        """Map a global schedule row to its window id."""
        return np.searchsorted(self.window_starts, global_cycle, side="right") - 1

    def memory_bytes(self, value_bytes: int = 4) -> int:
        """Footprint of the scheduled stream (M_sch + Row_sch + Col_sch)."""
        c_total = self.total_colors
        row_bits = max(int(np.ceil(np.log2(max(self.l, 2)))), 1)
        col_bits = 32
        per_slot = value_bytes * 8 + row_bits + col_bits
        return int(np.ceil(c_total * self.l * per_slot / 8))
