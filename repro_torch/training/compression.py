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

from ..models.tree import tree_map, tree_unflatten

__all__ = ["CompressionConfig", "init_residual", "compress_grads", "ef_correct"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enable: bool = False
    bits: int = 8  # int8 quantization


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _quant(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    qmax = float(2 ** (bits - 1) - 1)
    # a true division (by a scalar on the host the card would multiply by
    # its reciprocal)
    scale = torch.amax(torch.abs(x)) / torch.tensor(qmax, device=x.device)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    deq = q.float() * scale
    return q, scale, deq


def compress_grads(grads, residual, cfg: CompressionConfig):
    """(dequantized grads, new residual); both trees unchanged when
    compression is off."""
    if not cfg.enable:
        return grads, residual
    deq, res = [], []

    def one(g, r):
        x = g.float() + r
        _, _, d = _quant(x, cfg.bits)
        deq.append(d)
        res.append(x - d)

    tree_map(one, grads, residual)
    return tree_unflatten(grads, deq), tree_unflatten(grads, res)


def ef_correct(grads, residual, cfg: CompressionConfig):
    """Alias kept for callers that separate the error-feedback step."""
    return compress_grads(grads, residual, cfg)
