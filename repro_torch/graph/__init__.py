"""Graph analytics on GUST plans: PageRank, triangle counting, GNN
feature propagation.

Counterpart of ``repro.graph``: every sparse product runs through a
:class:`~repro_torch.core.plan.GustPlan`, on the card unless the caller
passes ``device="cpu"``.
"""

from .analytics import (
    PageRankResult,
    TriangleCountResult,
    feature_propagation,
    pagerank,
    triangle_count,
)

__all__ = [
    "PageRankResult",
    "TriangleCountResult",
    "pagerank",
    "triangle_count",
    "feature_propagation",
]
