"""Gradient compression with error feedback (counterpart of
``repro.training.compression``): each gradient leaf plus its residual is
quantized to int8 with one float32 scale per tensor, the dequantized
value goes on to the reduction and the optimizer, and what quantization
lost stays in the residual for the next step.  ``torch.round`` rounds
half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..models.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["CompressionConfig", "init_residual", "compress_grads", "ef_correct"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enable: bool = False
    bits: int = 8  # int8 quantization


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _quant(x: torch.Tensor, bits: int, amax=None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(codes, scale, dequantized); ``amax`` the largest magnitude of the
    whole tensor when ``x`` is a shard of it (default ``x``'s own)."""
    qmax = float(2 ** (bits - 1) - 1)
    if amax is None:
        amax = torch.amax(torch.abs(x))
    # a true division (by a scalar on the host the card would multiply by
    # its reciprocal)
    scale = amax / torch.tensor(qmax, device=x.device)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    deq = q.float() * scale
    return q, scale, deq


def compress_grads(grads, residual, cfg: CompressionConfig, whole=None):
    """(dequantized grads, new residual); both trees unchanged when
    compression is off.  For trees of shards, ``whole`` maps the vector of
    the leaves' local largest magnitudes to their whole leaves'
    (``tensor_parallel.over_shards`` with a max), so that every shard of a
    leaf takes the whole leaf's scale."""
    if not cfg.enable:
        return grads, residual
    pairs = list(zip(tree_leaves(grads), tree_leaves(residual)))
    amax = None
    if whole is not None:
        amax = whole(torch.stack([torch.amax(torch.abs(g.float() + r)) for g, r in pairs]))
    deq, res = [], []
    for i, (g, r) in enumerate(pairs):
        x = g.float() + r
        _, _, d = _quant(x, cfg.bits, None if amax is None else amax[i])
        deq.append(d)
        res.append(x - d)
    return tree_unflatten(grads, deq), tree_unflatten(grads, res)


def ef_correct(grads, residual, cfg: CompressionConfig):
    """Alias kept for callers that separate the error-feedback step."""
    return compress_grads(grads, residual, cfg)
