"""KV-cache accounting for serving: dtype policy, shapes, bytes.

Counterpart of ``repro.serving.kv_cache``.  The cache structure lives
with the blocks (``models/attention.py`` for K/V, ``models/recurrent.py``
for the recurrent states, stacked by ``models/transformer.py``); this
module sizes it per (arch × shape) without allocating: :func:`cache_specs`
builds the tree on the meta device.  K/V and the recurrent conv states
take the policy's dtype; the recurrent ``h``, ``C``, ``n`` and ``m`` stay
float32.  :func:`cache_shardings` gives each leaf's spec over a device
mesh (``distributed.sharding.cache_spec_overrides``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..distributed.sharding import cache_spec_overrides, map_with_path
from ..models.model_zoo import LM
from ..models.tree import tree_leaves

__all__ = ["CachePolicy", "cache_specs", "cache_shardings", "cache_bytes"]


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
    return map_with_path(cache_spec_overrides(mesh, batch),
                     cache_specs(lm, batch, seq_len, policy))


def cache_bytes(lm: LM, batch: int, seq_len: int,
                policy: CachePolicy = CachePolicy()) -> int:
    """Total cache footprint (all layers, all sequences), in Python ints
    (``math.prod`` over each shape: no 32-bit overflow at 123B scale)."""
    return sum(
        x.element_size() * math.prod(x.shape)
        for x in tree_leaves(cache_specs(lm, batch, seq_len, policy))
    )
