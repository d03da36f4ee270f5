"""Three-step sort-based load balancing (paper §3.5).

The number of colors a window needs is governed by Eq. 1:

    C_w = max( max_i #NZ(row i),  max_j Σ_b #NZ(column-segment b at lane j) )

so the schedule length is set by the *heaviest* row / lane, not the total
work.  The balancer reduces the spread:

  Step 1: sort matrix rows by #NZ (groups similarly-heavy rows into the same
          window, so no window is held hostage by one dense row mixed with
          empty ones).
  Step 2: within each window, sort the column segments (contiguous blocks of
          ``l`` columns) by their #NZ.
  Step 3: reverse the internal column order of segments at even (1-based)
          sorted positions.  Lane of a column is its intra-segment offset, so
          the reversal flips offsets ``k -> l-1-k`` for alternating segments:
          if heavy segments share a skewed intra-segment distribution, the
          alternation cancels the skew across lanes.  (This matches the
          paper's length-2 example: columns ``1..8`` in segments
          ``(1,2)(3,4)(5,6)(7,8)`` become ``1,2,4,3,5,6,8,7``.)

Only the *lane assignment* changes: ``Col_sch`` always records original
column indices, so the vector gather is untouched.  Step 1 permutes output
rows; the permutation is recorded in ``GustSchedule.row_perm``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .formats import COOMatrix

__all__ = ["balance_rows", "balance_lanes"]


def balance_rows(coo: COOMatrix) -> Tuple[np.ndarray, np.ndarray]:
    """Step 1.  Returns ``(row_perm, new_rows)`` where
    ``row_perm[scheduled_pos] = original_row`` and ``new_rows`` are the
    per-nonzero scheduled row positions."""
    nnz_per_row = coo.row_nnz()
    # Descending, stable: heavy rows first; ties keep original order.
    row_perm = np.argsort(-nnz_per_row, kind="stable").astype(np.int64)
    inv = np.empty_like(row_perm)
    inv[row_perm] = np.arange(coo.shape[0], dtype=np.int64)
    return row_perm, inv[coo.rows]


def balance_lanes(
    rows_w: np.ndarray, cols: np.ndarray, l: int, n: int
) -> np.ndarray:
    """Steps 2 + 3, applied per window.  ``rows_w`` are *window ids* per
    nonzero (post step-1), ``cols`` original column indices.  Returns the
    lane assignment (0..l-1) per nonzero.

    Default (unbalanced) lane is ``col % l``.  Balancing re-ranks the
    ``ceil(n/l)`` column segments of each window by #NZ and alternately
    reverses intra-segment offsets.
    """
    num_segments = -(-n // l)
    seg = cols // l
    offset = cols - seg * l  # == cols % l

    if rows_w.size == 0:
        return offset.astype(np.int64)

    num_windows = int(rows_w.max()) + 1
    # #NZ per (window, segment)
    flat = rows_w * num_segments + seg
    counts = np.bincount(flat, minlength=num_windows * num_segments).reshape(
        num_windows, num_segments
    )
    # Step 2: rank segments per window by count, descending, stable.
    order = np.argsort(-counts, axis=1, kind="stable")  # rank -> segment
    rank_of = np.empty_like(order)
    rows_idx = np.arange(num_windows)[:, None]
    rank_of[rows_idx, order] = np.arange(num_segments)[None, :]
    # Step 3: even (1-based) sorted positions get reversed internal order.
    ranks = rank_of[rows_w, seg]
    reverse = (ranks % 2) == 1
    lane = np.where(reverse, l - 1 - offset, offset)
    return lane.astype(np.int64)
