"""Graph analytics over GUST plans: PageRank, triangles, GNN propagation.

Counterpart of ``repro.graph.analytics``, with the reference's signatures
plus ``device`` (default ``"cuda"``), forwarded to every ``plan()``.
The workloads are plan-amortized: PageRank schedules the transition
matrix once and runs tens of ``spmv`` iterations against it; triangle
counting is one SpGEMM (``A·A``, kept dense on the plan's device) read
at A's own edges there; GNN feature propagation schedules the normalized
adjacency once and applies it per layer through ``spmm``.

The adjacency handling:

  * :func:`pagerank` — column-stochastic transition ``P = (D⁻¹ A)ᵀ`` over
    the *binarized* pattern, power iteration with uniform teleport and
    dangling-node mass redistribution;
  * :func:`triangle_count` — undirected simple graph: binarize,
    symmetrize (pattern of ``A ∨ Aᵀ``), drop self-loops; triangles =
    ``Σ (A·A) ⊙ A / 6``;
  * :func:`feature_propagation` — GCN-style ``Â = D^{-1/2}(A+I)D^{-1/2}``
    applied ``num_layers`` times.

All three accept a dense array or :class:`~repro_torch.core.formats.COOMatrix`
adjacency plus an optional :class:`~repro_torch.core.plan.PlanConfig`.
Results come back on the host as numpy arrays, as the reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.formats import COOMatrix, coo_from_dense
from ..core.plan import PlanConfig, plan
from ..core.spgemm import spgemm_dense

__all__ = [
    "PageRankResult",
    "TriangleCountResult",
    "pagerank",
    "triangle_count",
    "feature_propagation",
]


def _as_adjacency(adj) -> COOMatrix:
    if isinstance(adj, COOMatrix):
        coo = adj
    else:
        dense = np.asarray(adj)
        if dense.ndim != 2:
            raise ValueError(f"adjacency must be 2-D, got shape {dense.shape}")
        coo = coo_from_dense(dense)
    if coo.shape[0] != coo.shape[1]:
        raise ValueError(f"adjacency must be square, got {coo.shape}")
    return coo


def _pattern(coo: COOMatrix, *, symmetrize: bool = False,
             drop_diagonal: bool = False) -> COOMatrix:
    """Binarized (0/1 f32) deduplicated pattern of ``coo``; optionally the
    symmetric closure ``A ∨ Aᵀ`` and/or with the diagonal removed."""
    n = coo.shape[0]
    key = coo.rows * np.int64(n) + coo.cols
    if symmetrize:
        key = np.concatenate([key, coo.cols * np.int64(n) + coo.rows])
    key = np.unique(key)
    rows, cols = key // n, key % n
    if drop_diagonal:
        keep = rows != cols
        rows, cols = rows[keep], cols[keep]
    return COOMatrix(
        coo.shape, rows.astype(np.int64), cols.astype(np.int64),
        np.ones(rows.shape[0], np.float32),
    )


@dataclasses.dataclass(frozen=True)
class PageRankResult:
    """Converged (or max-iter) PageRank scores and the iteration trace."""

    scores: np.ndarray  # (n,) f32, sums to 1
    iterations: int
    converged: bool
    residual: float  # final L1 step size

    def top(self, k: int = 10) -> np.ndarray:
        """Node ids of the ``k`` highest-ranked vertices."""
        return np.argsort(-self.scores)[:k]


def pagerank(
    adj,
    *,
    damping: float = 0.85,
    tol: float = 1e-6,
    max_iter: int = 200,
    config: Optional[PlanConfig] = None,
    device="cuda",
) -> PageRankResult:
    """Plan-amortized PageRank power iteration.

    The transition matrix ``P = (D⁻¹ A)ᵀ`` is scheduled **once**; every
    iteration is one ``plan.spmv`` plus the scalar teleport/dangling
    correction:

        r ← d·(P r + dangling_mass/n) + (1-d)/n

    The iterate is float64 on the plan's device (the same IEEE arithmetic
    as the reference's host numpy; the spmv itself runs f32); ``tol``
    below ~1e-7·n hits the f32 execution noise floor and reports
    ``converged=False`` at ``max_iter``."""
    A = _pattern(_as_adjacency(adj))
    n = A.shape[0]
    if n == 0:
        return PageRankResult(np.zeros(0, np.float32), 0, True, 0.0)
    deg = A.row_nnz().astype(np.float64)
    dangling = deg == 0
    # P = (D^-1 A)^T: divide each edge by its source out-degree, transpose
    inv = np.zeros(n, np.float64)
    inv[~dangling] = 1.0 / deg[~dangling]
    norm = COOMatrix(A.shape, A.rows, A.cols,
                     (A.vals * inv[A.rows]).astype(np.float32))
    p = plan(norm.transpose(), config, device=device)

    dev = p.device
    dangling_t = torch.from_numpy(dangling).to(dev)
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    teleport = (1.0 - damping) / n
    converged, it, resid = False, 0, float("inf")
    for it in range(1, max_iter + 1):
        dangling_mass = r[dangling_t].sum() / n
        step = p.spmv(r.float()).double()
        r_new = damping * (step + dangling_mass) + teleport
        r_new /= r_new.sum()  # renormalize f32 drift
        resid = float((r_new - r).abs().sum())
        r = r_new
        if resid < tol:
            converged = True
            break
    return PageRankResult(r.float().cpu().numpy(), it, converged, resid)


@dataclasses.dataclass(frozen=True)
class TriangleCountResult:
    """Triangle census of the undirected simple graph of ``adj``."""

    triangles: int
    per_node: np.ndarray  # (n,) int64 — triangles through each vertex
    spgemm_nnz: int  # nnz of the A·A product that was masked

    @property
    def clustering_coefficient(self) -> float:
        """Global (transitivity-style) clustering: 3·triangles / open
        wedges, 0.0 on wedge-free graphs."""
        deg = self._degrees
        wedges = float(np.sum(deg * (deg - 1) / 2))
        return 3.0 * self.triangles / wedges if wedges else 0.0

    _degrees: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64), repr=False
    )


def triangle_count(
    adj, *, config: Optional[PlanConfig] = None, device="cuda"
) -> TriangleCountResult:
    """Count triangles via ``A·A`` masked by ``A``: the SpGEMM kernel's
    dense ``A·A`` on the plan's device, read there at A's edges; only the
    per-node sums and the product's nonzero count cross to the host.

    ``adj`` is read as an undirected simple graph: the pattern is
    binarized, symmetrized and stripped of self-loops first.  With A the
    resulting 0/1 symmetric adjacency, ``(A·A)[i, j]`` counts the common
    neighbours of ``i`` and ``j``; restricted to actual edges and summed
    it counts each triangle 6 times (3 edges × 2 directions).
    ``spgemm_nnz`` is the nonzero count of ``A·A``, the ``nnz`` of
    :meth:`GustPlan.spgemm`'s result."""
    A = _pattern(_as_adjacency(adj), symmetrize=True, drop_diagonal=True)
    n = A.shape[0]
    if A.nnz == 0:
        return TriangleCountResult(
            0, np.zeros(n, np.int64), 0,
            _degrees=np.zeros(n, np.int64),
        )
    p = plan(A, config, device=device)
    AA = spgemm_dense(p, A)
    rows = torch.from_numpy(A.rows).to(AA.device)
    on_edge = torch.round(AA[rows, torch.from_numpy(A.cols).to(AA.device)]).long()
    per_node = torch.zeros(n, dtype=torch.int64, device=AA.device)
    per_node.index_add_(0, rows, on_edge)
    # each triangle at vertex i closes 2 of i's edge slots
    per_node = per_node.cpu().numpy() // 2
    total = int(per_node.sum()) // 3
    return TriangleCountResult(
        total, per_node, int(torch.count_nonzero(AA)), _degrees=A.row_nnz(),
    )


def feature_propagation(
    adj,
    features,
    *,
    num_layers: int = 2,
    add_self_loops: bool = True,
    config: Optional[PlanConfig] = None,
    device="cuda",
) -> np.ndarray:
    """GCN-style feature propagation: ``H ← Â H`` applied ``num_layers``
    times with ``Â = D^{-1/2}(A + I)D^{-1/2}`` (symmetric normalization
    over the binarized symmetric pattern).  The normalized adjacency is
    scheduled once; each layer is one :meth:`GustPlan.spmm` over the
    ``(n, F)`` feature block, which stays on the plan's device between
    layers."""
    A = _pattern(_as_adjacency(adj), symmetrize=True, drop_diagonal=True)
    n = A.shape[0]
    H = np.asarray(features, np.float32)
    if H.ndim != 2 or H.shape[0] != n:
        raise ValueError(
            f"features must be (n={n}, F), got {np.asarray(features).shape}"
        )
    if num_layers < 1:
        return H
    rows, cols, vals = A.rows, A.cols, A.vals
    if add_self_loops:
        diag = np.arange(n, dtype=np.int64)
        rows = np.concatenate([rows, diag])
        cols = np.concatenate([cols, diag])
        vals = np.concatenate([vals, np.ones(n, np.float32)])
    deg = np.bincount(rows, weights=vals, minlength=n)
    d_inv_sqrt = np.zeros(n, np.float64)
    nz = deg > 0
    d_inv_sqrt[nz] = 1.0 / np.sqrt(deg[nz])
    norm_vals = (vals * d_inv_sqrt[rows] * d_inv_sqrt[cols]).astype(np.float32)
    a_hat = COOMatrix((n, n), rows, cols, norm_vals)
    p = plan(a_hat, config, device=device)
    h = torch.from_numpy(H).to(p.device)
    for _ in range(num_layers):
        h = p.spmm(h)
    return h.cpu().numpy()
