"""KV-cache accounting for serving: dtype policy, shapes, bytes.

Counterpart of ``repro.serving.kv_cache``.  The cache structure lives
with the blocks (``models/attention.py`` for K/V, ``models/recurrent.py``
for the recurrent states, stacked by ``models/transformer.py``); this
module sizes it per (arch × shape) without allocating: :func:`cache_specs`
builds the tree on the meta device.  K/V and the recurrent conv states
take the policy's dtype; the recurrent ``h``, ``C``, ``n`` and ``m`` stay
float32.  :func:`cache_shardings` gives each leaf's spec over a device
mesh (``distributed.sharding.cache_spec_overrides``).

:func:`shard_serve_state` cuts each rank's shards of a model's parameters
(``param_specs(..., mode="serve")``) and caches (the same cache rule),
with the serving placement that ``LM.prefill``, ``LM.decode_step`` and
``decode_step_gust`` take as ``place=``; :func:`gather_serve_state` is
its inverse.  :func:`init_serve_state` does the same for fresh caches
without ever holding a whole cache leaf: each shard is made at its local
shape, filled as :meth:`LM.init_caches` fills a whole cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..distributed.sharding import (cache_spec_overrides, dp_entry, local_shape,
                                    map_with_path, param_specs)
from ..distributed.tensor_parallel import (ServePlacement, gather_tree, mesh_axes,
                                           shard_index, shard_tree)
from ..models.model_zoo import LM
from ..models.tree import tree_leaves, tree_map

__all__ = ["CachePolicy", "cache_specs", "cache_shardings", "cache_bytes",
           "cache_tree_specs", "serve_placement", "ShardedServeState", "shard_serve_state",
           "init_serve_state", "gather_serve_state"]


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    dtype: str = "bfloat16"  # KV dtype (recurrent f32 states keep f32)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def cache_specs(lm: LM, batch: int, seq_len: int, policy: CachePolicy = CachePolicy()):
    """The serving cache tree as meta-device tensors (no allocation)."""
    return lm.init_caches(batch, seq_len, policy.torch_dtype, device="meta")


def cache_shardings(lm: LM, mesh, batch: int, seq_len: int,
                    policy: CachePolicy = CachePolicy()):
    """The spec of every cache leaf over ``mesh`` (a ``DeviceMesh`` or a
    ``MeshLayout``): batch over DP, the cache length over "model"."""
    return cache_tree_specs(cache_specs(lm, batch, seq_len, policy), mesh, batch)


def cache_tree_specs(caches, mesh, batch: int):
    """The spec of every leaf of the cache tree ``caches`` (whole, of a
    batch of ``batch``) over ``mesh``."""
    return map_with_path(cache_spec_overrides(mesh, batch), caches)


def _batch_of(caches) -> int:
    """The batch of a stack's cache tree (dim 1 of a rep-stacked leaf,
    dim 0 of a tail leaf)."""
    for part, b_dim in (("reps", 1), ("tail", 0)):
        leaves = tree_leaves(caches[part])
        if leaves:
            return int(leaves[0].shape[b_dim])
    raise ValueError("a cache tree without leaves")


def serve_placement(params, caches, mesh) -> ServePlacement:
    """The serving placement over ``mesh`` (a ``DeviceMesh``) of whole
    ``params`` and ``caches`` (any device, the meta device included):
    ``param_specs(..., mode="serve")``, the cache rule's specs, the mesh's
    axes, and this rank's rows of the batch where the DP axes split it."""
    batch = _batch_of(caches)
    axes = mesh_axes(mesh)
    idx, count = shard_index(dp_entry(mesh), axes)
    rows = None if count == 1 or batch % count else (idx * (batch // count), batch // count)
    return ServePlacement(param_specs(params, mesh, mode="serve"), axes,
                          cache=cache_tree_specs(caches, mesh, batch), rows=rows)


@dataclasses.dataclass
class ShardedServeState:
    """This rank's shards of a model's parameters and caches, with the
    placement that the serving entry points take as ``place=`` (its
    ``specs`` and ``cache`` the two spec trees)."""

    params: Any
    caches: Any
    place: ServePlacement


def shard_serve_state(params, caches, mesh) -> ShardedServeState:
    """This rank's shards (``local_shape``'s, each of its own storage) of
    whole ``params`` and ``caches`` over ``mesh``: the counterpart of
    placing the reference's serving arguments under ``param_specs(...,
    mode="serve")`` and ``cache_spec_overrides``."""
    place = serve_placement(params, caches, mesh)
    return ShardedServeState(shard_tree(params, place.specs, place.axes),
                             shard_tree(caches, place.cache, place.axes), place)


def _fill(x: torch.Tensor):
    """The one value a fresh cache leaf holds (0 for a leaf of no
    elements: a stack of no repetitions)."""
    if not x.numel():
        return 0
    value = x.reshape(-1)[0]
    if not bool((x == value).all()):
        raise ValueError("a fresh cache leaf that is not one value throughout")
    return value.item()


def init_serve_state(lm: LM, params, mesh, batch: int, seq_len: int,
                     dtype=torch.bfloat16) -> ShardedServeState:
    """This rank's shards of whole ``params`` and of fresh serving caches
    of ``batch`` x ``seq_len`` over ``mesh``, as :func:`shard_serve_state`
    gives them for ``lm.init_caches(batch, seq_len, dtype)``, but with no
    whole cache leaf allocated: the cache tree is laid out on the meta
    device, and each shard made at its ``local_shape`` on the parameters'
    device, holding the value that leaf of a fresh cache holds (read from
    a cache of one row and one position)."""
    caches = lm.init_caches(batch, seq_len, dtype, device="meta")
    place = serve_placement(params, caches, mesh)
    device = tree_leaves(params)[0].device
    fills = tree_map(_fill, lm.init_caches(1, 1, dtype, device="cpu"))
    shards = tree_map(lambda x, spec, fill: torch.full(local_shape(tuple(x.shape), spec, mesh),
                                                       fill, dtype=x.dtype, device=device),
                      caches, place.cache, fills)
    return ShardedServeState(shard_tree(params, place.specs, place.axes), shards, place)


def gather_serve_state(state: ShardedServeState):
    """(whole params, whole caches) from every rank's shards (a
    collective: every rank of the mesh calls it); the inverse of
    :func:`shard_serve_state`."""
    place = state.place
    return (gather_tree(state.params, place.specs, place.axes),
            gather_tree(state.caches, place.cache, place.axes))


def cache_bytes(lm: LM, batch: int, seq_len: int,
                policy: CachePolicy = CachePolicy()) -> int:
    """Total cache footprint (all layers, all sequences), in Python ints
    (``math.prod`` over each shape: no 32-bit overflow at 123B scale)."""
    return sum(
        x.element_size() * math.prod(x.shape)
        for x in tree_leaves(cache_specs(lm, batch, seq_len, policy))
    )
