"""Tensor, expert and fully-sharded parallelism: the execution of
``param_specs``' "model" and "data" placements.

The reference gets these from XLA's partitioner: it jits the train step
with ``param_specs`` shardings and GSPMD inserts the collectives.  Eager
PyTorch has no partitioner, so the port places each parameter itself and
runs the collectives around the blocks:

* **The collectives** are ``torch.autograd.Function`` pairs over one mesh
  axis (Megatron-LM's conjugate operators), each the identity on an axis
  of size 1:

  - :func:`copy_to` — the identity forward, the gradient summed over the
    axis backward: the input of a column-parallel projection (and a
    whole weight that each rank reads only in part);
  - :func:`reduce_from` — the sum over the axis forward, the identity
    backward: the output of a row-parallel projection;
  - :func:`gather_from` — the concatenation along a dim forward, this
    rank's slice of the gradient backward (its consumer runs whole on
    every rank of the axis);
  - :func:`gather_leaf` — FSDP: a leaf's "data" shards concatenated
    forward, the gradient reduce-scattered (summed over the data ranks,
    each keeping its shard) backward.

* **The placement** (:class:`Placement`): the spec tree of
  ``distributed.sharding.param_specs`` and the mesh's axes.  A block asks
  it whether a dim of one of its leaves is split (:meth:`Placement.split`:
  the spec names the axis, and the axis has more than one rank); it never
  decides that itself.  :meth:`Placement.use` gives a block its leaves:
  repetition ``r`` of the stacked ``(R, ...)`` leaves and every "data" dim
  gathered (:func:`gather_leaf`), inside the block's activation
  checkpoint, so that remat gathers again in the backward and no rank
  holds a whole stack.

* **Serving** (:class:`ServePlacement`): the same placement plus the
  spec tree of the caches (``cache_spec_overrides``') that a level of the
  model reads, and this rank's rows of the batch.  :meth:`Placement.block`
  gives a stack's block its leaves and placement, the serving one with
  the block's cache specs; a block asks :meth:`ServePlacement.cache_split`
  whether a cache dim is split over "model".  Serving runs no backward:
  the collectives are called under ``torch.no_grad()``.

* **Shards** (:func:`shard_tree`, :func:`gather_tree`): each rank's
  shard of a whole tree, as ``local_shape`` gives it, and the whole tree
  back from the shards.

Imports neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.tree import tree_map
from . import collectives
from .collectives import all_gather_dim, all_reduce_sum, reduce_scatter_dim

__all__ = ["Axis", "mesh_axes", "Placement", "ServePlacement", "copy_to", "reduce_from", "gather_from",
           "gather_leaf", "all_reduce_max", "sub", "names", "shard_tree", "gather_tree",
           "over_shards", "shard_index"]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group, this rank's
    index in it (the group rank: the order of gathers and of shards) and
    its size."""

    name: str
    group: Any
    rank: int
    size: int


def mesh_axes(mesh) -> Dict[str, Axis]:
    """Name -> :class:`Axis` for each axis of a ``DeviceMesh``."""
    out = {}
    for name in mesh.mesh_dim_names:
        group = mesh.get_group(name)
        out[name] = Axis(name, group, dist.get_rank(group), dist.get_world_size(group))
    return out


def names(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (None, a name, or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# ---------------------------------------------------------------------------
# The conjugate collectives
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axis.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_sum(x, axis.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, x.shape[dim]
        return all_gather_dim(x, dim, axis.group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather_dim(x, dim, axis.group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.axis.group), None, None


def _live(axis: Optional[Axis]) -> bool:
    return axis is not None and axis.size > 1


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Identity forward; the gradient summed over ``axis`` backward."""
    return _CopyTo.apply(x, axis) if _live(axis) else x


def reduce_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum over ``axis`` forward; the identity backward."""
    return _ReduceFrom.apply(x, axis) if _live(axis) else x


def gather_from(x: torch.Tensor, dim: int, axis: Optional[Axis]) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` forward; this rank's
    slice of the gradient backward."""
    return _GatherFrom.apply(x, dim, axis) if _live(axis) else x


def gather_leaf(x: torch.Tensor, dim: int, axis: Optional[Axis]) -> torch.Tensor:
    """FSDP: the leaf's shards concatenated along ``dim`` forward; the
    gradient reduce-scattered over ``axis`` backward."""
    return _GatherLeaf.apply(x, dim, axis) if _live(axis) else x


def all_reduce_max(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis`` (no gradient)."""
    return collectives.all_reduce_max(x, axis.group) if _live(axis) else x


# ---------------------------------------------------------------------------
# The placement a block reads
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """A (sub)tree of parameter specs and the mesh's axes."""

    specs: Any
    axes: Dict[str, Axis]

    def sub(self, *keys) -> "Placement":
        specs = self.specs
        for k in keys:
            specs = specs[k]
        return dataclasses.replace(self, specs=specs)

    @property
    def model(self) -> Optional[Axis]:
        return self.axes.get("model")

    def split(self, leaf: str, dim: int) -> bool:
        """Whether dim ``dim`` of leaf ``leaf`` is split over "model": its
        spec names the axis and the axis has more than one rank."""
        return _over_model(self.specs[leaf], dim, self.model)

    def block(self, part: str, i: int, tree):
        """(the leaves block ``i`` of a stack's ``part`` runs, its
        placement): ``part`` "reps" takes ``tree`` as one repetition of
        the stacked leaves, "tail" as a tail block's (:meth:`use`)."""
        return self.sub(part, i).use(tree, stacked=part == "reps")

    def use(self, tree, stacked: bool = False):
        """(the leaves a block runs, the block's placement): with
        ``stacked``, ``tree`` is one repetition of stacked leaves (their
        specs' leading None dropped); every "data" dim is gathered."""
        specs = tree_map(lambda _, s: tuple(s[1:]) if stacked else s, tree, self.specs)
        data = self.axes.get("data")

        def one(x, spec):
            for dim, entry in enumerate(spec):
                if "data" in names(entry):
                    x = gather_leaf(x, dim, data)
            return x

        return tree_map(one, tree, specs), dataclasses.replace(self, specs=specs)

    def gathered(self, tree):
        """``tree`` with every dim split over "model" gathered
        (:func:`gather_from`): for a mixer that runs whole on every rank."""
        def one(x, spec):
            for dim, entry in enumerate(spec):
                if "model" in names(entry):
                    x = gather_from(x, dim, self.model)
            return x

        return tree_map(one, tree, self.specs)


def _over_model(spec, dim: int, model: Optional[Axis]) -> bool:
    return dim < len(spec) and "model" in names(spec[dim]) and _live(model)


def _drop_lead(specs):
    """A block's stacked cache specs (dicts of specs) for one repetition:
    each spec's leading entry dropped."""
    if isinstance(specs, dict):
        return {k: _drop_lead(v) for k, v in specs.items()}
    return tuple(specs[1:])


@dataclasses.dataclass(frozen=True)
class ServePlacement(Placement):
    """A serving placement: the parameters' :class:`Placement`, the spec
    (sub)tree of the caches read at this level (``cache``: a stack's cache
    tree at the stack, a block's cache at the block), and this rank's
    batch rows (``rows``: ``(first, count)``, None when every rank holds
    every row)."""

    cache: Any = None
    rows: Optional[Tuple[int, int]] = None

    def at(self, cache) -> "ServePlacement":
        """This placement reading the cache specs ``cache``."""
        return dataclasses.replace(self, cache=cache)

    def block(self, part: str, i: int, tree):
        leaves, place = super().block(part, i, tree)
        if self.cache is None:
            return leaves, place
        cache = self.cache[part][i]
        return leaves, place.at(_drop_lead(cache) if part == "reps" else cache)

    def cache_split(self, leaf: str, dim: int) -> bool:
        """Whether dim ``dim`` of cache leaf ``leaf`` is split over "model"."""
        return _over_model(self.cache[leaf], dim, self.model)

    def take_rows(self, x):
        """This rank's rows of a batch-leading tensor (a scalar as it is)."""
        if self.rows is None or not torch.is_tensor(x) or x.dim() == 0:
            return x
        return x.narrow(0, *self.rows)


def sub(place: Optional[Placement], *keys) -> Optional[Placement]:
    """``place.sub(*keys)``, or None without a placement."""
    return None if place is None else place.sub(*keys)


def over_shards(values: torch.Tensor, leaf_specs, axes: Dict[str, Axis],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Per-leaf partial values (a vector in leaf order: sums of squares, or
    maxima with ``op=MAX``) made whole-leaf values: for each axis with more
    than one rank, the leaves split over it take the reduction over its
    ranks; a leaf replicated over an axis keeps its own value, so it is
    counted once."""
    for name, ax in axes.items():
        mask = [name in {n for e in spec for n in names(e)} for spec in leaf_specs]
        if not _live(ax) or not any(mask):
            continue
        reduced = values.detach().contiguous().clone()
        dist.all_reduce(reduced, op=op, group=ax.group)
        values = torch.where(torch.tensor(mask, device=values.device), reduced, values)
    return values


# ---------------------------------------------------------------------------
# Shards of a whole tree, and back
# ---------------------------------------------------------------------------


def shard_index(entry, axes: Dict[str, Axis]) -> Tuple[int, int]:
    """(this rank's index, the number of shards) along a dim's axes (a
    spec entry)."""
    idx, count = 0, 1
    for n in names(entry):
        idx = idx * axes[n].size + axes[n].rank
        count *= axes[n].size
    return idx, count


def shard_tree(tree, specs, axes: Dict[str, Axis]):
    """This rank's shard of every leaf of ``tree`` (``local_shape`` of it
    under its spec), each a tensor of its own storage."""
    def one(x, spec):
        for dim, entry in enumerate(spec):
            idx, count = shard_index(entry, axes)
            if count > 1:
                n = x.shape[dim] // count
                x = x.narrow(dim, idx * n, n)
        return x.clone(memory_format=torch.contiguous_format)

    return tree_map(one, tree, specs)


def gather_tree(tree, specs, axes: Dict[str, Axis]):
    """The whole tree from every rank's shards (the inverse of
    :func:`shard_tree`; a collective: every rank calls it)."""
    def one(x, spec):
        for dim, entry in enumerate(spec):
            for n in reversed(names(entry)):
                x = all_gather_dim(x, dim, axes[n].group)
        return x

    return tree_map(one, tree, specs)
