"""GustLinear — a magnitude-pruned linear layer executed by GUST.

Counterpart of ``repro.core.gust_linear``.  Decode-time LM inference is
matvec-dominated: every projection computes ``W @ x`` for a handful of
activation vectors.  ``GustLinear`` holds a magnitude-pruned weight as a
:class:`~repro_torch.core.plan.GustPlan` on the card (scheduled and packed
once, at construction) and runs ``forward`` through the plan's
batch-major ``transpose_io`` path.

The reference's deprecated ``SparsityConfig`` shim (its Pallas/jnp
``backend`` choice) has no port counterpart: the plan's device chooses
the path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .formats import COOMatrix
from .packing import default_cache
from .plan import PlanConfig, plan as _plan

__all__ = ["GustLinear", "prune_by_magnitude"]


def prune_by_magnitude(w: np.ndarray, density: float) -> np.ndarray:
    """Keep the largest-|w| entries at the requested density."""
    if not 0.0 < density <= 1.0:
        raise ValueError("density must be in (0, 1]")
    k = max(int(round(w.size * density)), 1)
    thresh = np.partition(np.abs(w).ravel(), w.size - k)[w.size - k]
    out = np.where(np.abs(w) >= thresh, w, 0.0)
    return out


class GustLinear(torch.nn.Module):
    """``y = W_sparse @ x`` with W held as a :class:`GustPlan`.

    ``forward`` maps ``x (B, n)`` to ``(B, m)`` (a 1-D ``x (n,)`` to
    ``(m,)``).  Construction: ``GustLinear(w, config=PlanConfig(...),
    density=0.1, device="cuda")``; the default config is the reference's
    (``layout="padded"``, the rest at ``PlanConfig`` defaults).  The weight
    (numpy or torch) is pruned on the host in float32.

    Construction goes through the content-keyed
    :class:`~repro_torch.core.packing.ScheduleCache` (``cache``), so the
    schedule and packed tensors outlive this module (bounded by the
    cache's LRU size); :func:`repro_torch.core.packing.clear_cache`
    releases them.
    """

    def __init__(
        self,
        w,
        *,
        config: Optional[PlanConfig] = None,
        density: Optional[float] = None,
        cache=default_cache,
        device="cuda",
    ):
        super().__init__()
        if isinstance(w, torch.Tensor):
            w = w.detach().cpu().numpy()
        w = np.asarray(w)
        if w.ndim != 2:
            raise ValueError("GustLinear expects a 2-D weight matrix")
        if config is None:
            config = PlanConfig(layout="padded")
        if density is None:
            density = 0.1
        self.config = config
        self.density = density
        self.shape = w.shape
        w_pruned = prune_by_magnitude(np.asarray(w, np.float32), density)
        rows, cols = np.nonzero(w_pruned)
        coo = COOMatrix(
            w.shape,
            rows.astype(np.int64),
            cols.astype(np.int64),
            w_pruned[rows, cols].astype(np.float32),
        )
        self.nnz = coo.nnz
        # Plan once, at construction; touching .artifact packs on the card.
        self.plan = _plan(coo, config, cache=cache, device=device)
        self.sched = self.plan.sched
        self.packed = self.plan.artifact

    @property
    def cycles(self) -> int:
        return self.sched.cycles

    @property
    def hardware_utilization(self) -> float:
        return self.sched.hardware_utilization

    def forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.plan.device)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None, :]
        y = self.plan.spmm(x, transpose_io=True)
        return y[0] if squeeze else y

    def extra_repr(self) -> str:
        m, n = self.shape
        return f"{n} -> {m}, nnz={self.nnz}, device={self.plan.device}"
