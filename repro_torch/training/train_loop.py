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
nothing is reduced.

**A sharded state** (:func:`shard_train_state`: each rank holds its shard
of every parameter and optimizer leaf, as ``local_shape`` gives it under
``param_specs``) runs the step with the placement executed, the
counterpart of the reference's step jitted with ``param_specs``
shardings: the same row split and the same ``LM.loss_fn``, run under the
state's placement (``distributed/tensor_parallel.py``: the "model" dims
as tensor and expert parallelism inside the blocks, the "data" dims as
FSDP, each leaf gathered before its block runs and its gradient
reduce-scattered after).  A leaf with a "data" dim is then summed over
the data ranks by that reduce-scatter (and over "pod" here, on a
multi-pod mesh); a leaf replicated over "data" keeps the ``bucketed`` +
``ring_all_reduce`` sum.  The global-norm clip counts each leaf once over
the mesh; compression quantizes each summed leaf with the whole leaf's
scale (the reference's global semantics); AdamW runs on the shards.  The
loss and ``grad_norm`` are the global ones on every rank.  The rows must
divide by ``microbatches × DP ranks``.  A whole state on a mesh runs the
data-parallel step above, unchanged.

An MoE arch routes per rank under DP: each rank routes only its own rows
(expert capacity, drops and ``moe_ffn``'s chunks follow its share of the
batch), and the load-balance and z aux enters as the mean of the ranks'
aux losses, not the aux of the global batch that the reference's sharded
step computes (ROADMAP §3, Departures).  The cross-entropy is the global
masked mean all the same.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from ..distributed.collectives import bucketed, compressed_psum, ring_all_reduce, unbucketed
from ..distributed.sharding import dp_axes, param_specs
from ..distributed.tensor_parallel import (Placement, gather_tree, mesh_axes, names,
                                           over_shards, shard_tree)
from ..models.model_zoo import LM
from ..models.tree import tree_leaves, tree_map, tree_unflatten
from .compression import CompressionConfig, compress_grads, init_residual
from .optimizer import AdamWConfig, adamw_update, init_opt_state

__all__ = ["TrainConfig", "make_train_step", "init_train_state", "ShardedTrainState",
           "shard_train_state", "gather_train_state"]


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


class ShardedTrainState(dict):
    """A train state whose leaves are this rank's shards, with the
    parameter ``specs`` (``param_specs``' tree, by which m, v and the
    residual are laid out too) and the ``mesh`` they are over."""

    def __init__(self, tree, specs, mesh):
        super().__init__(tree)
        self.specs = specs
        self.mesh = mesh

    def state_specs(self):
        """The spec tree of the whole state (the step counter replicated)."""
        return _state_specs(self, self.specs)


def _state_specs(state, specs):
    out = {"params": specs, "opt": {"m": specs, "v": specs, "step": ()}}
    if "residual" in state:
        out["residual"] = specs
    return out


def shard_train_state(state, mesh) -> ShardedTrainState:
    """This rank's shards of a whole train state (params, m, v and the
    residual each cut by ``param_specs(params, mesh, "train")``; the step
    counter whole): the counterpart of placing the reference's state under
    its ``param_specs`` shardings."""
    specs = param_specs(state["params"], mesh, mode="train")
    return ShardedTrainState(shard_tree(state, _state_specs(state, specs), mesh_axes(mesh)),
                             specs, mesh)


def gather_train_state(state: ShardedTrainState):
    """The whole state from every rank's shards (a collective: every rank
    of the mesh calls it); the inverse of :func:`shard_train_state`."""
    return gather_tree(dict(state), state.state_specs(), mesh_axes(state.mesh))


def _leaf_specs(params, specs):
    """The specs of ``params``' leaves, in ``tree_leaves`` order."""
    out = []
    tree_map(lambda _, s: out.append(s), params, specs)
    return out


def _ring_sum(tensors, group):
    """Each tensor summed over ``group`` (``bucketed`` + ``ring_all_reduce``);
    a group of one rank sums nothing."""
    if not tensors or dist.get_world_size(group) == 1:
        return list(tensors)
    buckets, spec = bucketed(tensors)
    return unbucketed([ring_all_reduce(b, group) for b in buckets], spec)


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
    axes = mesh_axes(mesh) if mesh is not None else {}

    def value_and_grad(params, batch, denom=None, place=None):
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
                                 shards=1 if denom is None else k, place=place)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def rank_value_and_grad(params, micro, split: bool, place):
        if not split:
            return value_and_grad(params, micro)
        mine = _split_micro(micro, k, rank)
        denom = mine["loss_mask"].sum()
        dist.all_reduce(denom, group=group)
        return value_and_grad(params, mine, denom, place)

    def place_data(spec) -> bool:
        data = axes.get("data")
        return data is not None and data.size > 1 and any("data" in names(e) for e in spec)

    def sharded_sums(grads, specs):
        """The DP sums of a sharded state's gradients: a leaf with a "data"
        dim was reduce-scattered over the data ranks in the backward
        (``gather_leaf``) and is summed over "pod" here; the rest over the
        whole DP group."""
        fsdp = [place_data(s) for s in specs]
        rest = _ring_sum([g for g, f in zip(grads, fsdp) if not f], group)
        pod = axes.get("pod")
        own = [g for g, f in zip(grads, fsdp) if f]
        if pod is not None and pod.size > 1:
            own = _ring_sum(own, pod.group)
        rest, own = iter(rest), iter(own)
        return [next(own) if f else next(rest) for f in fsdp]

    def train_step(state, batch):
        params = state["params"]
        sharded = isinstance(state, ShardedTrainState)
        if sharded and mesh is None:
            raise ValueError("a sharded train state runs under make_train_step(lm, cfg, mesh)")
        place = Placement(state.specs, axes) if sharded else None
        rows = next(iter(batch.values())).shape[0]
        split = group is not None and rows % (max(cfg.microbatches, 1) * k) == 0
        if sharded and not split:
            raise ValueError(f"a sharded step splits its rows over {k} DP ranks and "
                             f"{cfg.microbatches} microbatches: {rows} rows do not divide")
        if cfg.microbatches > 1:
            g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree_leaves(params)]
            loss_sum = torch.zeros((), dtype=torch.float32, device=g_sum[0].device)
            for i in range(cfg.microbatches):
                loss, grads = rank_value_and_grad(
                    params, _split_micro(batch, cfg.microbatches, i), split, place)
                for acc, g in zip(g_sum, grads):
                    acc.add_(g.float())
                del grads
                loss_sum = loss_sum + loss
            n = torch.tensor(float(cfg.microbatches), device=loss_sum.device)
            grads = [acc.div_(n) for acc in g_sum]
            del g_sum
        else:
            loss_sum, grads = rank_value_and_grad(params, batch, split, place)
            n = None
        residual = state.get("residual")
        whole = whole_max = None
        if sharded:  # each leaf counted once over the mesh
            specs = _leaf_specs(params, state.specs)
            whole = functools.partial(over_shards, leaf_specs=specs, axes=axes)
            whole_max = functools.partial(whole, op=dist.ReduceOp.MAX)
        if split:  # the ranks' shares of the loss and the gradients, summed
            loss_sum = loss_sum.clone()
            dist.all_reduce(loss_sum, group=group)
            if sharded:
                grads = sharded_sums(grads, specs)
            elif cfg.compression.enable:
                pairs = [compressed_psum(g, r, group, cfg.compression.bits)
                         for g, r in zip(grads, tree_leaves(residual))]
                grads = [g for g, _ in pairs]
                residual = tree_unflatten(residual, [r for _, r in pairs])
            else:
                grads = _ring_sum(grads, group)
        loss = loss_sum if n is None else loss_sum / n
        grads = tree_unflatten(params, grads)
        if cfg.compression.enable and (sharded or not split):
            grads, residual = compress_grads(grads, residual, cfg.compression, whole_max)

        params2, opt2, om = adamw_update(cfg.opt, params, grads, state["opt"], whole)
        new_state = {"params": params2, "opt": opt2}
        if cfg.compression.enable:
            new_state["residual"] = residual
        if sharded:
            new_state = ShardedTrainState(new_state, state.specs, state.mesh)
        return new_state, {"loss": loss, **om}

    return train_step
