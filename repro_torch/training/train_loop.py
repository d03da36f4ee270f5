"""The train step (counterpart of ``repro.training.train_loop``):
activation checkpointing (``remat``), the compute dtype, microbatch
accumulation and optional error-feedback compression, then AdamW.

    train_step = make_train_step(lm, cfg)
    state, metrics = train_step(state, batch)

``state = {"params", "opt": {"m", "v", "step"}, "residual"?}``, a tree of
tensors on one device; gradients come from autograd through
``LM.loss_fn``.  The step builds every tensor of the new state anew and
never writes the old one, so a step that raises (a transient fault, an
out-of-memory error) leaves ``state`` as it was and ``retrying`` runs it
again to the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from ..models.model_zoo import LM
from ..models.tree import tree_leaves, tree_unflatten
from .compression import CompressionConfig, compress_grads, init_residual
from .optimizer import AdamWConfig, adamw_update, init_opt_state

__all__ = ["TrainConfig", "make_train_step", "init_train_state"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1  # gradient accumulation
    dtype: str = "bfloat16"  # compute dtype
    remat: bool = True
    compression: CompressionConfig = CompressionConfig()

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def init_train_state(lm: LM, generator: torch.Generator, cfg: TrainConfig,
                     device="cuda") -> Dict[str, Any]:
    """Parameters drawn from ``generator`` (``LM.init``) on ``device``,
    zero optimizer state, and a zero residual when compression is on."""
    params = lm.init(generator, device=device)
    state = {"params": params, "opt": init_opt_state(params)}
    if cfg.compression.enable:
        state["residual"] = init_residual(params)
    return state


def _split_micro(batch, n: int, i: int):
    """Rows ``[i·B/n, (i+1)·B/n)`` of every batch entry: microbatch ``i``
    as the reference's ``(n, B/n, ...)`` reshape gives it."""
    def r(x):
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]
    return {k: r(v) for k, v in batch.items()}


def make_train_step(lm: LM, cfg: TrainConfig) -> Callable:
    dtype = cfg.compute_dtype

    def value_and_grad(params, batch):
        """(loss, the gradient of each leaf in ``tree_leaves`` order) by
        autograd; a leaf the loss does not reach gets a zero gradient, as
        ``jax.grad`` gives it."""
        leaves = tree_leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss, _ = lm.loss_fn(tree_unflatten(params, live), batch, dtype=dtype,
                                 remat=cfg.remat)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def train_step(state, batch):
        params = state["params"]
        if cfg.microbatches > 1:
            g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree_leaves(params)]
            loss_sum = torch.zeros((), dtype=torch.float32, device=g_sum[0].device)
            for i in range(cfg.microbatches):
                loss, grads = value_and_grad(params, _split_micro(batch, cfg.microbatches, i))
                for acc, g in zip(g_sum, grads):
                    acc.add_(g.float())
                del grads
                loss_sum = loss_sum + loss
            n = torch.tensor(float(cfg.microbatches), device=loss_sum.device)
            grads = [acc.div_(n) for acc in g_sum]
            del g_sum
            loss = loss_sum / n
        else:
            loss, grads = value_and_grad(params, batch)
        grads = tree_unflatten(params, grads)

        residual = state.get("residual")
        if cfg.compression.enable:
            grads, residual = compress_grads(grads, residual, cfg.compression)

        params2, opt2, om = adamw_update(cfg.opt, params, grads, state["opt"])
        new_state = {"params": params2, "opt": opt2}
        if cfg.compression.enable:
            new_state["residual"] = residual
        return new_state, {"loss": loss, **om}

    return train_step
