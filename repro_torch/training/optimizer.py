"""AdamW with global-norm clipping (counterpart of
``repro.training.optimizer``).

Written by hand, not ``torch.optim``: decoupled weight decay falls only on
leaves with ``ndim >= 2`` (the stacked ``(R, d)`` norm scales included, as
in the reference), and the step's scalars (``lr``, ``b1 ** step``, the
bias corrections) are float32 tensors on the parameters' device, computed
as the reference computes them.  m and v are float32; ``step`` is an int32
scalar.  Nothing is updated in place: the update returns new tensors, so a
step that raises leaves the state it was given as it was.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..models.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "schedule", "init_opt_state", "global_norm",
           "clip_by_global_norm", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac * lr``; a float32
    scalar on ``step``'s device."""
    dev = step.device
    step = step.float()
    warm = step / _f32(max(cfg.warmup_steps, 1), dev)
    prog = (step - _f32(cfg.warmup_steps, dev)) / _f32(
        max(cfg.total_steps - cfg.warmup_steps, 1), dev)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = _f32(cfg.min_lr_frac, dev) + _f32((1 - cfg.min_lr_frac) * 0.5, dev) * (
        _f32(1.0, dev) + torch.cos(_f32(math.pi, dev) * prog))
    return _f32(cfg.lr, dev) * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> Dict[str, Any]:
    """Zero float32 m and v of each parameter's shape and device, step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, whole=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.
    For a tree of shards, ``whole`` maps the vector of the leaves' local
    sums to their whole leaves' sums (``tensor_parallel.over_shards``), so
    that each leaf is counted once over the mesh."""
    sums = torch.stack([torch.sum(torch.square(x.float())) for x in tree_leaves(tree)])
    if whole is not None:
        sums = whole(sums)
    return torch.sqrt(torch.sum(sums))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    one = _f32(1.0, norm.device)
    return torch.minimum(one, _f32(max_norm, norm.device) / torch.clamp(norm, min=1e-9))


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """(float32 grads scaled so their global norm is at most ``max_norm``,
    the norm before scaling)."""
    g = global_norm(grads)
    scale = _clip_scale(g, max_norm)
    return tree_map(lambda x: x.float() * scale, grads), g


def adamw_update(cfg: AdamWConfig, params, grads, state, whole=None):
    """One AdamW step.  Returns (params, state, metrics ``grad_norm`` and
    ``lr``), all new tensors.  Each leaf's gradient is clipped as
    :func:`clip_by_global_norm` clips it, inside the leaf's update, so that
    no clipped copy of the whole tree is held.  On shards, ``whole`` (see
    :func:`global_norm`) makes the clip's norm the whole tree's."""
    gnorm = global_norm(grads, whole)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    dev = step.device
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    c1, c2 = _f32(1 - cfg.b1, dev), _f32(1 - cfg.b2, dev)
    bc1 = _f32(1.0, dev) - torch.pow(b1, step.float())
    bc2 = _f32(1.0, dev) - torch.pow(b2, step.float())
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)

    out = ([], [], [])

    def upd(p, g, m, v):
        g = g.float() * scale
        m2 = b1 * m + c1 * g
        v2 = b2 * v + c2 * g * g
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + wd * p.float()
        for acc, leaf in zip(out, ((p.float() - lr * delta).to(p.dtype), m2, v2)):
            acc.append(leaf)

    tree_map(upd, params, grads, state["m"], state["v"])
    params2, m2, v2 = (tree_unflatten(params, leaves) for leaves in out)
    return params2, {"m": m2, "v": v2, "step": step}, {"grad_norm": gnorm, "lr": lr}
