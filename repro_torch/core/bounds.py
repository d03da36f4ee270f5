"""Statistical utilization bound (paper §3.4, Eqs. 1-11).

For an N×N uniform-density-p matrix and a length-l GUST, the expected color
count per window is bounded by the expected max of 2l Gaussians:

    E[C]    <= N p + sqrt(2 N p (1-p) log(2 l))                     (Eq. 9)
    E[exec] = (N/l) * E[C] + 2                                      (Eq. 10)
    E[util] = 1 / (1 + sqrt(2 (1-p) log(2l) / (N p)))               (Eq. 11)

(The paper uses natural log — the derivation sets t = sqrt(2 log 2l)/σ.)
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "expected_colors_bound",
    "expected_execution_cycles",
    "expected_utilization",
    "eq1_colors",
]


def expected_colors_bound(n: int, p: float, l: int) -> float:
    """Eq. 9 upper bound on E[C] for one window of an N×N uniform matrix."""
    mu = n * p
    sigma2 = n * p * (1.0 - p)
    return mu + np.sqrt(2.0 * sigma2 * np.log(2.0 * l))


def expected_execution_cycles(n: int, p: float, l: int) -> float:
    """Eq. 10: expected total cycles (N/l windows, +2 pipeline levels)."""
    return (n / l) * expected_colors_bound(n, p, l) + 2.0


def expected_utilization(n: int, p: float, l: int) -> float:
    """Eq. 11 (closed form, drops the +2)."""
    return 1.0 / (1.0 + np.sqrt(2.0 * (1.0 - p) * np.log(2.0 * l) / (n * p)))


def eq1_colors(row_nnz_window: np.ndarray, lane_nnz_window: np.ndarray) -> int:
    """Eq. 1: the König lower bound for one window — max vertex degree of
    the bipartite graph (max row nnz vs max lane nnz)."""
    mr = int(row_nnz_window.max()) if row_nnz_window.size else 0
    ml = int(lane_nnz_window.max()) if lane_nnz_window.size else 0
    return max(mr, ml)
