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

With a ``mesh`` (a ``DeviceMesh``), ``make_train_step(lm, cfg, mesh)`` is
the data-parallel step, the eager counterpart of the reference's step
jitted with a batch sharded over ``("pod", "data")``: every rank is given
the same global batch and takes its rows of each microbatch (microbatch
``i`` keeps the reference's rows, split over the ranks), each rank's loss
is its rows' masked sum over the count of every rank's rows, and the
gradients are summed over the DP group (``bucketed`` + ``ring_all_reduce``,
or ``compressed_psum`` per leaf with compression on); AdamW then runs the
same on every rank.  A batch whose rows do not divide by
``microbatches × ranks`` is not split: every rank runs it whole, and
nothing is reduced.  Parameters stay whole on every rank: the "model"
(TP / EP) and FSDP placements of ``distributed.sharding.param_specs`` are
not executed (ROADMAP §1 item 8).

An MoE arch routes per rank under DP: each rank routes only its own rows
(expert capacity, drops and ``moe_ffn``'s chunks follow its share of the
batch), and the load-balance and z aux enters as the mean of the ranks'
aux losses, not the aux of the global batch that the reference's sharded
step computes (ROADMAP §3, Departures).  The cross-entropy is the global
masked mean all the same.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from ..distributed.collectives import bucketed, compressed_psum, ring_all_reduce, unbucketed
from ..distributed.sharding import dp_axes
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


def _dp_group(mesh):
    """The process group of ``mesh``'s DP axes (None without one)."""
    dp = dp_axes(mesh)
    if not dp:
        return None
    if len(dp) == 1:
        return mesh.get_group(dp[0])
    return mesh[dp]._flatten().get_group()


def make_train_step(lm: LM, cfg: TrainConfig, mesh=None) -> Callable:
    dtype = cfg.compute_dtype
    group = _dp_group(mesh) if mesh is not None else None
    k = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0

    def value_and_grad(params, batch, denom=None):
        """(loss, the gradient of each leaf in ``tree_leaves`` order) by
        autograd through ``LM.loss_fn``; a leaf the loss does not reach
        gets a zero gradient, as ``jax.grad`` gives it.  ``denom`` (a DP
        rank's rows) is the mask count over every rank's rows: the ranks'
        losses add up to the global one."""
        leaves = tree_leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss, _ = lm.loss_fn(tree_unflatten(params, live), batch, dtype=dtype,
                                 remat=cfg.remat, denom=denom,
                                 shards=1 if denom is None else k)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def rank_value_and_grad(params, micro, split: bool):
        if not split:
            return value_and_grad(params, micro)
        mine = _split_micro(micro, k, rank)
        denom = mine["loss_mask"].sum()
        dist.all_reduce(denom, group=group)
        return value_and_grad(params, mine, denom)

    def train_step(state, batch):
        params = state["params"]
        rows = next(iter(batch.values())).shape[0]
        split = group is not None and rows % (max(cfg.microbatches, 1) * k) == 0
        if cfg.microbatches > 1:
            g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree_leaves(params)]
            loss_sum = torch.zeros((), dtype=torch.float32, device=g_sum[0].device)
            for i in range(cfg.microbatches):
                loss, grads = rank_value_and_grad(
                    params, _split_micro(batch, cfg.microbatches, i), split)
                for acc, g in zip(g_sum, grads):
                    acc.add_(g.float())
                del grads
                loss_sum = loss_sum + loss
            n = torch.tensor(float(cfg.microbatches), device=loss_sum.device)
            grads = [acc.div_(n) for acc in g_sum]
            del g_sum
        else:
            loss_sum, grads = rank_value_and_grad(params, batch, split)
            n = None
        residual = state.get("residual")
        if split:  # the ranks' shares of the loss and the gradients, summed
            loss_sum = loss_sum.clone()
            dist.all_reduce(loss_sum, group=group)
            if cfg.compression.enable:
                pairs = [compressed_psum(g, r, group, cfg.compression.bits)
                         for g, r in zip(grads, tree_leaves(residual))]
                grads = [g for g, _ in pairs]
                residual = tree_unflatten(residual, [r for _, r in pairs])
            else:
                buckets, spec = bucketed(grads)
                grads = unbucketed([ring_all_reduce(b, group) for b in buckets], spec)
        loss = loss_sum if n is None else loss_sum / n
        grads = tree_unflatten(params, grads)
        if cfg.compression.enable and not split:
            grads, residual = compress_grads(grads, residual, cfg.compression)

        params2, opt2, om = adamw_update(cfg.opt, params, grads, state["opt"])
        new_state = {"params": params2, "opt": opt2}
        if cfg.compression.enable:
            new_state["residual"] = residual
        return new_state, {"loss": loss, **om}

    return train_step
