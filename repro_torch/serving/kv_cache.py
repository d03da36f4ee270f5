"""KV-cache accounting for serving: dtype policy, shapes, bytes.

Counterpart of ``repro.serving.kv_cache``.  The cache structure lives
with the blocks (``models/attention.py``, stacked by
``models/transformer.py``); this module sizes it per (arch × shape)
without allocating: :func:`cache_specs` builds the tree on the meta
device.  ``cache_shardings`` (placement over a device mesh) comes with
the multi-GPU slice (ROADMAP §1 item 8).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.model_zoo import LM
from ..models.tree import tree_leaves

__all__ = ["CachePolicy", "cache_specs", "cache_bytes"]


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    dtype: str = "bfloat16"  # KV dtype

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def cache_specs(lm: LM, batch: int, seq_len: int, policy: CachePolicy = CachePolicy()):
    """The serving cache tree as meta-device tensors (no allocation)."""
    return lm.init_caches(batch, seq_len, policy.torch_dtype, device="meta")


def cache_bytes(lm: LM, batch: int, seq_len: int,
                policy: CachePolicy = CachePolicy()) -> int:
    """Total cache footprint (all layers, all sequences), in Python ints
    (``math.prod`` over each shape: no 32-bit overflow at 123B scale)."""
    return sum(
        x.element_size() * math.prod(x.shape)
        for x in tree_leaves(cache_specs(lm, batch, seq_len, policy))
    )
