"""Config system: ArchConfig / ShapeConfig dataclasses + registry.

Copied from ``repro.configs.base`` (it imports no JAX); only the module
path that :func:`get_arch` imports differs.

``ArchConfig`` fully determines a model: layer pattern, attention geometry,
MoE, frontend kind.  ``reduced()`` derives the family-preserving smoke
config (same block pattern, tiny widths) used by per-arch CPU tests.
``ShapeConfig`` is one of the four assigned input shapes.

Registration is import-driven: each ``configs/<arch>.py`` module defines
``CONFIG`` and calls :func:`register`; :func:`get_arch` imports on demand
so ``--arch <id>`` works from every launcher.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

__all__ = [
    "ArchConfig",
    "ShapeConfig",
    "SHAPES",
    "register",
    "get_arch",
    "list_archs",
    "ARCH_IDS",
]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # ssm | hybrid | moe | dense | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    # block pattern: tuple of block-type ids, tiled to n_layers
    #   global | local | chunked | moe_global | moe_chunked | rec | mlstm | slstm
    pattern: Tuple[str, ...] = ("global",)
    d_head: int = 0  # 0 -> d_model // n_heads
    local_window: int = 0  # sliding-window size for 'local' blocks
    chunk_size: int = 0  # chunk size for 'chunked' blocks
    global_cache_cap: int = 0  # decode-cache cap for global layers (long ctx)
    rope_theta: float = 10_000.0
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    mlp_kind: str = "swiglu"
    norm_kind: str = "rms"
    tie_embeddings: bool = True
    emb_scale: bool = False  # gemma-style sqrt(d) embedding scale
    frontend: str = "token"  # token | embed (vlm stub) | encdec (audio stub)
    n_enc_layers: int = 0  # encoder depth for encdec
    enc_seq: int = 0  # encoder (source) length for encdec shapes
    attn_block_size: int = 1024  # online-softmax KV block
    mlstm_expand: int = 2
    source: str = ""  # provenance note

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the embedding/logits shard over any
        mesh axis (seamless's 256206 would otherwise replicate a
        (B, S, V) f32 logits tensor on every chip).  Padding logits are
        masked to -inf in ``LM._logits``."""
        return -(-self.vocab // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.frontend == "encdec"

    @property
    def sub_quadratic(self) -> bool:
        """True if decode memory/compute per token is bounded (can serve
        long_500k): every block is recurrent, windowed, or cap-bounded."""
        for b in self.pattern:
            if b in ("global", "moe_global") and not self.global_cache_cap:
                return False
        return True

    def reduced(self) -> "ArchConfig":
        """Family-preserving smoke config: tiny dims, same pattern."""
        pat = self.pattern
        n_layers = max(len(pat), 2 if len(pat) == 1 else len(pat))
        n_kv = min(self.n_kv, 2)
        n_heads = max(min(self.n_heads, 4) // n_kv * n_kv, n_kv)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers + (1 if len(pat) > 1 else 0),  # force a tail
            d_model=64,
            n_heads=n_heads,
            n_kv=n_kv,
            d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            local_window=min(self.local_window, 16) if self.local_window else 0,
            chunk_size=min(self.chunk_size, 16) if self.chunk_size else 0,
            global_cache_cap=min(self.global_cache_cap, 32)
            if self.global_cache_cap
            else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_enc_layers=min(self.n_enc_layers, 2) if self.n_enc_layers else 0,
            enc_seq=min(self.enc_seq, 16) if self.enc_seq else 0,
            attn_block_size=64,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


ARCH_IDS = (
    "xlstm_125m",
    "recurrentgemma_9b",
    "llama4_scout_17b_a16e",
    "dbrx_132b",
    "gemma3_4b",
    "phi3_mini_3_8b",
    "mistral_large_123b",
    "yi_6b",
    "llava_next_mistral_7b",
    "seamless_m4t_medium",
)

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[_canon(cfg.name)] = cfg
    return cfg


def _canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_arch(name: str) -> ArchConfig:
    key = _canon(name)
    if key not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{key}")
    return _REGISTRY[key]


def list_archs():
    return list(ARCH_IDS)
