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
(one token).  At decode, attention K/V is written into the cache in
place (``attention.decode_step``), while recurrent states come back as
new tensors and the stack returns them in fresh ``(R, B, ...)`` leaves:
the caches a decode step was given keep their states, so the step can be
repeated to the same bits (``recurrent``'s module docstring).

Block kinds: ``attn_mlp`` (global, local and chunked attention + MLP),
``attn_moe`` (attention + the MoE FFN: llama4, dbrx), ``rec`` (RG-LRU +
MLP: recurrentgemma), ``mlstm`` and ``slstm`` (xlstm).
:func:`make_block_cfg` parses every block type of the ten
architectures; ``enc`` and ``xattn`` (seamless) raise
``NotImplementedError`` when they are initialized or run (ROADMAP §1
item 5 lists them as next).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig
from . import attention as A
from . import recurrent as R
from .layers import _device, apply_norm, init_mlp, init_norm, mlp
from .moe import MoESpec, init_moe, moe_ffn
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
PORTED_KINDS = ("attn_mlp", "attn_moe", "rec", "mlstm", "slstm")
#: Kinds whose cache is a recurrent state: new tensors at every decode step.
STATE_KINDS = ("rec", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    kind: str  # attn_mlp | attn_moe | rec | mlstm | slstm | enc | xattn
    d_model: int
    norm_kind: str = "rms"
    mlp_kind: str = "swiglu"
    d_ff: int = 0
    attn: Optional[A.AttnSpec] = None
    cross: Optional[A.AttnSpec] = None
    moe: Optional[MoESpec] = None
    mlstm: Optional[R.MLSTMSpec] = None
    slstm: Optional[R.SLSTMSpec] = None
    rglru: Optional[R.RGLRUSpec] = None


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
        moe = MoESpec(
            d_model=d,
            d_ff=cfg.d_ff,
            n_experts=cfg.n_experts,
            top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
        )
        return BlockCfg(kind="attn_moe", attn=attn, moe=moe, **common)
    if block_type in ("global", "local", "chunked"):
        return BlockCfg(kind="attn_mlp", attn=attn, **common)
    if block_type == "enc":
        return BlockCfg(kind="enc", attn=attn, **common)
    if block_type == "xattn":
        cross = A.AttnSpec(mode="global", causal=False, use_rope=False, **base_attn)
        return BlockCfg(kind="xattn", attn=attn, cross=cross, **common)
    if block_type == "rec":
        return BlockCfg(kind="rec", rglru=R.RGLRUSpec(d_model=d), **common)
    if block_type == "mlstm":
        return BlockCfg(
            kind="mlstm",
            mlstm=R.MLSTMSpec(d_model=d, n_heads=cfg.n_heads, expand=cfg.mlstm_expand),
            **common,
        )
    if block_type == "slstm":
        return BlockCfg(
            kind="slstm", slstm=R.SLSTMSpec(d_model=d, n_heads=cfg.n_heads), **common
        )
    raise ValueError(f"unknown block type {block_type!r}")


def require_ported(bc: BlockCfg) -> None:
    """Raise ``NotImplementedError`` for a block kind the port does not
    run yet."""
    if bc.kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {bc.kind!r} is not ported yet (ROADMAP §1 item 5: "
            "the enc/xattn blocks and the encdec frontend); the port runs "
            f"{PORTED_KINDS}"
        )


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def init_block(gen, bc: BlockCfg):
    require_ported(bc)
    d = bc.d_model
    p = {}
    if bc.kind in ("attn_mlp", "attn_moe"):
        p["ln_attn"] = init_norm(d, kind=bc.norm_kind, gen=gen)
        p["attn"] = A.init_attention(gen, bc.attn)
        p["ln_mlp"] = init_norm(d, kind=bc.norm_kind, gen=gen)
        if bc.kind == "attn_moe":
            p["moe"] = init_moe(gen, bc.moe)
        else:
            p["mlp"] = init_mlp(gen, d, bc.d_ff, kind=bc.mlp_kind)
    elif bc.kind == "rec":
        p["ln_rec"] = init_norm(d, kind=bc.norm_kind, gen=gen)
        p["rec"] = R.init_rglru(gen, bc.rglru)
        p["ln_mlp"] = init_norm(d, kind=bc.norm_kind, gen=gen)
        p["mlp"] = init_mlp(gen, d, bc.d_ff, kind=bc.mlp_kind)
    else:  # mlstm | slstm
        p["ln"] = init_norm(d, kind=bc.norm_kind, gen=gen)
        init = R.init_mlstm if bc.kind == "mlstm" else R.init_slstm
        p["core"] = init(gen, getattr(bc, bc.kind))
    return p


def _ffn(p, x, bc: BlockCfg):
    """Second residual branch: the MLP or the MoE FFN.  Returns (delta,
    aux); aux is 0.0 for the MLP."""
    h = apply_norm(p["ln_mlp"], x, kind=bc.norm_kind)
    if bc.kind == "attn_moe":
        return moe_ffn(p["moe"], h, bc.moe)
    return mlp(p["mlp"], h, kind=bc.mlp_kind), 0.0


#: A recurrent block's norm and parameter keys, its spec's field on
#: :class:`BlockCfg`, and its train and decode functions.
_MIXERS = {
    "rec": ("ln_rec", "rec", "rglru", R.rglru_train, R.rglru_decode),
    "mlstm": ("ln", "core", "mlstm", R.mlstm_train, R.mlstm_decode),
    "slstm": ("ln", "core", "slstm", R.slstm_train, R.slstm_decode),
}


def _has_ffn(bc: BlockCfg) -> bool:
    return bc.kind in ("attn_mlp", "attn_moe", "rec")


def block_train(p, x, bc: BlockCfg):
    """Returns (x, aux)."""
    require_ported(bc)
    if bc.kind in STATE_KINDS:
        ln, core, spec, train, _ = _MIXERS[bc.kind]
        h = apply_norm(p[ln], x, kind=bc.norm_kind)
        x = x + train(p[core], h, getattr(bc, spec))
    else:
        h = apply_norm(p["ln_attn"], x, kind=bc.norm_kind)
        x = x + A.attend_train(p["attn"], h, bc.attn)
    aux = 0.0
    if _has_ffn(bc):
        delta, aux = _ffn(p, x, bc)
        x = x + delta
    return x, aux


def init_block_cache(bc: BlockCfg, batch: int, seq_len: int, enc_seq: int = 0,
                     dtype=torch.bfloat16, device="cuda"):
    """A zeroed cache: attention K/V and positions, or a recurrent state
    (float32 ``h``/``C``/``n``/``m``; conv states in ``dtype``)."""
    require_ported(bc)
    if bc.kind == "rec":
        return R.rglru_init_state(bc.rglru, batch, dtype, device)
    if bc.kind == "mlstm":
        return R.mlstm_init_state(bc.mlstm, batch, dtype, device)
    if bc.kind == "slstm":
        return R.slstm_init_state(bc.slstm, batch, dtype, device)
    return A.init_cache(bc.attn, batch, seq_len, dtype, device)


def block_prefill(p, x, bc: BlockCfg, cache, start: int = 0):
    """Returns (x, a new cache); ``cache`` is not written."""
    require_ported(bc)
    if bc.kind in STATE_KINDS:
        ln, core, spec, train, _ = _MIXERS[bc.kind]
        h = apply_norm(p[ln], x, kind=bc.norm_kind)
        y, cache = train(p[core], h, getattr(bc, spec), cache, return_state=True)
    else:
        h = apply_norm(p["ln_attn"], x, kind=bc.norm_kind)
        y, cache = A.prefill_into_cache(p["attn"], h, bc.attn, cache, start)
    x = x + y
    if _has_ffn(bc):
        x = x + _ffn(p, x, bc)[0]
    return x, cache


def block_decode(p, x, bc: BlockCfg, cache, pos):
    """Returns (x, cache): attention writes ``cache`` in place and returns
    it; a recurrent block returns a new state and leaves ``cache`` as it
    was."""
    require_ported(bc)
    if bc.kind in STATE_KINDS:
        ln, core, spec, _, step = _MIXERS[bc.kind]
        h = apply_norm(p[ln], x, kind=bc.norm_kind)
        y, cache = step(p[core], h, getattr(bc, spec), cache)
    else:
        h = apply_norm(p["ln_attn"], x, kind=bc.norm_kind)
        y, cache = A.decode_step(p["attn"], h, bc.attn, cache, pos)
    x = x + y
    if _has_ffn(bc):
        x = x + _ffn(p, x, bc)[0]
    return x, cache


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
            del one  # one layer's draw at a time (an MoE layer's experts are GBs)
        if stacked is None:  # no full repetition: (0, ...) leaves, as in the reference
            stacked = tree_map(lambda a: torch.empty((0, *a.shape), dtype=a.dtype,
                                                     device=_device(gen)),
                               init_block(None, bc))
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
    """One token through the stack.  Attention caches are written in
    place; each recurrent state comes back as a new tensor, the rep-stacked
    ones stacked into fresh ``(R, B, ...)`` leaves, so ``caches`` keeps
    the states it had (the step can be repeated to the same bits).
    Returns (x, the new cache tree)."""
    states = [[] for _ in sc.pattern]
    for r in range(sc.reps):
        for i, bc in enumerate(sc.pattern):
            x, c = block_decode(rep_slice(params["reps"][i], r), x, bc,
                                rep_slice(caches["reps"][i], r), pos)
            if bc.kind in STATE_KINDS:
                states[i].append(c)
    reps = tuple(
        tree_map(lambda *layers: torch.stack(layers), *per_layer)
        if bc.kind in STATE_KINDS and per_layer else caches["reps"][i]
        for i, (bc, per_layer) in enumerate(zip(sc.pattern, states))
    )
    tail = []
    for i in range(sc.n_tail):
        x, c = block_decode(params["tail"][i], x, sc.pattern[i], caches["tail"][i], pos)
        tail.append(c)
    return x, {"reps": reps, "tail": tail}
