"""Block assembly + layer stacks.

Counterpart of ``repro.models.transformer``.  A model is a sequence of
blocks tiled from a short pattern (``ArchConfig.pattern``): ``reps`` full
repetitions of the pattern, then a tail of ``n_layers % len(pattern)``
blocks.  The reference scans over the repetitions; the port runs a
Python loop over them and keeps the reference's tree layout, so
parameters carry across one to one:

  * pattern-position parameters are stacked along a leading ``reps`` axis
    (``params["reps"][i]`` leaves are ``(R, ...)``), tail blocks are
    ``params["tail"][i]``;
  * caches likewise: ``(R, B, ...)`` leaves, batch at axis 1.

Three regimes per block and stack: ``*_train`` (full sequence, forward
only), ``*_prefill`` (full sequence, a new cache out) and ``*_decode``
(one token, the cache written in place; see ``attention.decode_step``).

Only ``attn_mlp`` blocks (global, local and chunked attention + MLP) run
in the port so far.  :func:`make_block_cfg` parses every block type of
the ten architectures; the other kinds (``attn_moe``, ``rec``, ``mlstm``,
``slstm``, ``enc``, ``xattn``) raise ``NotImplementedError`` when they
are initialized or run (ROADMAP §1 item 5 lists them as next).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig
from . import attention as A
from .layers import apply_norm, init_mlp, init_norm, mlp
from .tree import tree_map

__all__ = [
    "BlockCfg",
    "StackCfg",
    "make_block_cfg",
    "make_stack_cfg",
    "require_ported",
    "init_block",
    "block_train",
    "block_prefill",
    "block_decode",
    "init_block_cache",
    "init_stack",
    "stack_train",
    "stack_prefill",
    "stack_decode",
    "init_stack_caches",
    "insert_slot_caches",
    "rep_slice",
]

#: Block kinds that the port runs.
PORTED_KINDS = ("attn_mlp",)


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """The reference's block config.  ``moe``, ``mlstm``, ``slstm`` and
    ``rglru`` (the specs of the kinds not ported yet) stay ``None``."""

    kind: str  # attn_mlp | attn_moe | rec | mlstm | slstm | enc | xattn
    d_model: int
    norm_kind: str = "rms"
    mlp_kind: str = "swiglu"
    d_ff: int = 0
    attn: Optional[A.AttnSpec] = None
    cross: Optional[A.AttnSpec] = None
    moe: Optional[object] = None
    mlstm: Optional[object] = None
    slstm: Optional[object] = None
    rglru: Optional[object] = None


def make_block_cfg(cfg: ArchConfig, block_type: str) -> BlockCfg:
    d = cfg.d_model
    base_attn = dict(
        d_model=d,
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv,
        d_head=cfg.head_dim,
        rope_theta=cfg.rope_theta,
        block_size=cfg.attn_block_size,
    )
    common = dict(d_model=d, norm_kind=cfg.norm_kind, mlp_kind=cfg.mlp_kind, d_ff=cfg.d_ff)

    if block_type in ("global", "moe_global"):
        attn = A.AttnSpec(mode="global", max_cache=cfg.global_cache_cap, **base_attn)
    elif block_type in ("local", "moe_local"):
        attn = A.AttnSpec(mode="local", window=cfg.local_window, **base_attn)
    elif block_type in ("chunked", "moe_chunked"):
        attn = A.AttnSpec(mode="chunked", window=cfg.chunk_size, **base_attn)
    elif block_type == "enc":
        attn = A.AttnSpec(mode="global", causal=False, **base_attn)
    elif block_type == "xattn":
        attn = A.AttnSpec(mode="global", max_cache=cfg.global_cache_cap, **base_attn)
    else:
        attn = None

    if block_type.startswith("moe_"):
        return BlockCfg(kind="attn_moe", attn=attn, **common)
    if block_type in ("global", "local", "chunked"):
        return BlockCfg(kind="attn_mlp", attn=attn, **common)
    if block_type == "enc":
        return BlockCfg(kind="enc", attn=attn, **common)
    if block_type == "xattn":
        cross = A.AttnSpec(mode="global", causal=False, use_rope=False, **base_attn)
        return BlockCfg(kind="xattn", attn=attn, cross=cross, **common)
    if block_type in ("rec", "mlstm", "slstm"):
        return BlockCfg(kind=block_type, **common)
    raise ValueError(f"unknown block type {block_type!r}")


def require_ported(bc: BlockCfg) -> None:
    """Raise ``NotImplementedError`` for a block kind the port does not
    run yet."""
    if bc.kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {bc.kind!r} is not ported yet (ROADMAP §1 item 5: "
            "MoE, then the recurrent blocks, then enc/xattn); the port runs "
            f"{PORTED_KINDS}"
        )


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def init_block(gen, bc: BlockCfg):
    require_ported(bc)
    d = bc.d_model
    return {
        "ln_attn": init_norm(d, kind=bc.norm_kind, gen=gen),
        "attn": A.init_attention(gen, bc.attn),
        "ln_mlp": init_norm(d, kind=bc.norm_kind, gen=gen),
        "mlp": init_mlp(gen, d, bc.d_ff, kind=bc.mlp_kind),
    }


def _ffn(p, x, bc: BlockCfg):
    """Second residual branch: the MLP."""
    return mlp(p["mlp"], apply_norm(p["ln_mlp"], x, kind=bc.norm_kind), kind=bc.mlp_kind)


def block_train(p, x, bc: BlockCfg):
    require_ported(bc)
    h = apply_norm(p["ln_attn"], x, kind=bc.norm_kind)
    x = x + A.attend_train(p["attn"], h, bc.attn)
    return x + _ffn(p, x, bc), 0.0


def init_block_cache(bc: BlockCfg, batch: int, seq_len: int, enc_seq: int = 0,
                     dtype=torch.bfloat16, device="cuda"):
    require_ported(bc)
    return A.init_cache(bc.attn, batch, seq_len, dtype, device)


def block_prefill(p, x, bc: BlockCfg, cache, start: int = 0):
    require_ported(bc)
    h = apply_norm(p["ln_attn"], x, kind=bc.norm_kind)
    y, cache = A.prefill_into_cache(p["attn"], h, bc.attn, cache, start)
    x = x + y
    return x + _ffn(p, x, bc), cache


def block_decode(p, x, bc: BlockCfg, cache, pos):
    require_ported(bc)
    h = apply_norm(p["ln_attn"], x, kind=bc.norm_kind)
    y, cache = A.decode_step(p["attn"], h, bc.attn, cache, pos)
    x = x + y
    return x + _ffn(p, x, bc), cache


# ---------------------------------------------------------------------------
# Stack = a loop over pattern repetitions + the tail
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StackCfg:
    pattern: Tuple[BlockCfg, ...]
    reps: int
    n_tail: int  # tail blocks reuse pattern[:n_tail] configs
    enc_seq: int = 0

    @property
    def n_layers(self) -> int:
        return self.reps * len(self.pattern) + self.n_tail


def make_stack_cfg(cfg: ArchConfig, pattern: Tuple[str, ...], n_layers: int) -> StackCfg:
    blocks = tuple(make_block_cfg(cfg, t) for t in pattern)
    reps = n_layers // len(pattern)
    n_tail = n_layers % len(pattern)
    return StackCfg(pattern=blocks, reps=reps, n_tail=n_tail, enc_seq=cfg.enc_seq)


def rep_slice(tree, r: int):
    """Repetition ``r`` of a rep-stacked tree (views, no copy)."""
    return tree_map(lambda a: a[r], tree)


def init_stack(gen, sc: StackCfg):
    """Rep-stacked ``(R, ...)`` parameters per pattern position, drawn
    layer by layer into one preallocated tensor per leaf, then the tail."""
    rep_params = []
    for bc in sc.pattern:
        stacked = None
        for r in range(sc.reps):
            one = init_block(gen, bc)
            if stacked is None:
                stacked = tree_map(lambda a: a.new_empty((sc.reps, *a.shape)), one)
            if gen is not None:
                tree_map(lambda full, a: full[r].copy_(a), stacked, one)
        rep_params.append(stacked)
    tail_params = [init_block(gen, sc.pattern[i]) for i in range(sc.n_tail)]
    return {"reps": tuple(rep_params), "tail": tail_params}


def stack_train(params, x, sc: StackCfg):
    """Forward over the stack; returns (x, aux)."""
    aux = 0.0
    for r in range(sc.reps):
        for i, bc in enumerate(sc.pattern):
            x, a = block_train(rep_slice(params["reps"][i], r), x, bc)
            aux = aux + a
    for i in range(sc.n_tail):
        x, a = block_train(params["tail"][i], x, sc.pattern[i])
        aux = aux + a
    return x, aux


def init_stack_caches(sc: StackCfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                      device="cuda"):
    rep_caches = []
    for bc in sc.pattern:
        one = init_block_cache(bc, batch, seq_len, sc.enc_seq, dtype, device)
        rep_caches.append(
            tree_map(lambda a: a.unsqueeze(0).expand(sc.reps, *a.shape).clone(), one)
        )
    tail_caches = [
        init_block_cache(sc.pattern[i], batch, seq_len, sc.enc_seq, dtype, device)
        for i in range(sc.n_tail)
    ]
    return {"reps": tuple(rep_caches), "tail": tail_caches}


def insert_slot_caches(caches, one, slot: int):
    """Serving admission, in place: copy batch row 0 of a batch-1 stack
    cache into batch row ``slot`` of the full stack cache.  Rep-stacked
    leaves carry batch at axis 1 (``(R, B, ...)``), tail leaves at axis
    0.  Returns ``caches``."""
    for cf, co in zip(caches["reps"], one["reps"]):
        A.insert_slot(cf, co, slot, axis=1)
    for cf, co in zip(caches["tail"], one["tail"]):
        A.insert_slot(cf, co, slot, axis=0)
    return caches


def stack_prefill(params, x, sc: StackCfg, caches, start: int = 0):
    """Prompt pass; returns (x, new caches).  ``caches`` is not written."""
    rep_caches = [[] for _ in sc.pattern]
    for r in range(sc.reps):
        for i, bc in enumerate(sc.pattern):
            x, c = block_prefill(rep_slice(params["reps"][i], r), x, bc,
                                 rep_slice(caches["reps"][i], r), start)
            rep_caches[i].append(c)
    stacked = tuple(
        tree_map(lambda *layers: torch.stack(layers), *per_layer)
        if per_layer else caches["reps"][i]
        for i, per_layer in enumerate(rep_caches)
    )
    tail_caches = []
    for i in range(sc.n_tail):
        x, c = block_prefill(
            params["tail"][i], x, sc.pattern[i], caches["tail"][i], start
        )
        tail_caches.append(c)
    return x, {"reps": stacked, "tail": tail_caches}


def stack_decode(params, x, sc: StackCfg, caches, pos):
    """One token through the stack; every layer's cache is written in
    place.  Returns (x, caches)."""
    for r in range(sc.reps):
        for i, bc in enumerate(sc.pattern):
            x, _ = block_decode(rep_slice(params["reps"][i], r), x, bc,
                                rep_slice(caches["reps"][i], r), pos)
    for i in range(sc.n_tail):
        x, _ = block_decode(params["tail"][i], x, sc.pattern[i], caches["tail"][i], pos)
    return x, caches
