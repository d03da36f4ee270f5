"""Attention: GQA with global / sliding-window / chunked-local masking.

Counterpart of ``repro.models.attention``: self-attention and the
cross-attention of the encoder-decoder blocks.  Query/output heads live
on one flat ``H`` axis and the ``KV``
heads are repeated to ``H`` at compute time; caches hold only the ``KV``
heads.  The softmax is the reference's own code, op for op (no fused
library attention), so the two packages agree within float32 tolerance:

  * ``attend_train``  — full-sequence causal attention, directly when
    ``max(Sq, Sk) <= 2·block_size`` (``_sdpa``), else the online softmax
    over KV blocks (``_blocked_sdpa``);
  * ``prefill_into_cache`` — the same pass, returning a new cache filled
    with the prompt's last ``cache_len`` positions (dense or ring);
  * ``decode_step`` — one token per row against the cache, at per-row
    positions, in the reference's ``(KV, G)`` score form;
  * ``cross_kv`` / ``attend_cross`` — the encoder memory projected once,
    and non-causal, non-rotary attention of the decoder over it (the
    blocked path for a memory longer than ``2·block_size``).

Tensor parallel (training): under a placement (``place=``) whose specs
split the heads of ``wq`` over "model", the block runs on the rank's
heads: ``wq``/``wk``/``wv`` column-parallel (the input's gradient summed
over the model ranks, :func:`~repro_torch.distributed.tensor_parallel.copy_to`),
``wo`` row-parallel (the float32 partial outputs summed).  The local head
counts are the leaves' own.  Where the rule leaves ``wk``/``wv`` whole (the
KV heads do not divide the axis), each rank projects every KV head, its
query head ``h`` (global index) reads KV head ``h // groups``, and the
whole weights' gradients are summed over the model ranks, each having
read only its heads' share.  Where the rule leaves ``wq`` whole, the
attention runs whole on every model rank.

Tensor parallel (serving): under a serving placement
(:class:`~repro_torch.distributed.tensor_parallel.ServePlacement`, whose
``cache`` specs are ``cache_spec_overrides``') the cache holds every KV
head at this rank's batch rows; its ``pos`` leaf is whole (the rule
replicates it), and its length is split over "model" where the rule says
(the length divides the axis):

  * ``prefill_into_cache`` runs the prompt head-parallel as above, gathers
    the new K/V over heads and keeps this rank's cache positions;
  * ``decode_step`` over a split length is a flash decode: the token's q
    and K/V heads gathered over "model" (``(B, 1, H, dh)``), the slot
    ``pos % c`` written by the rank that owns it, each rank's scores of its
    positions for every head, and their softmax combined over "model" in
    float32 (the max, then the sums of ``exp(s - max)`` and of its
    weighted V), each rank keeping its heads' slice of ``o`` for the
    row-parallel ``wo``.  Over a whole length each rank scores only its
    heads against the whole cache, KV head ``h // groups`` by global
    index;
  * ``cross_cache`` / ``decode_cross`` do the same for the encoder
    memory's ``ck``/``cv``, whose length the rule splits likewise.

``decode_step`` writes the new token's K/V/position into the cache **in
place** (the reference rebinds a new cache).  Each write lands in the
cell the same call reads back after it, and the values depend only on
the call's inputs, so a call that fails part-way and is repeated writes
the same values into the same cells before reading them: the retried
step gives the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..distributed.tensor_parallel import all_reduce_max, copy_to, gather_from, reduce_from
from .layers import _f32, _he, _matmul_to, _row_parallel, rope
from .tree import tree_map

__all__ = [
    "AttnSpec",
    "init_attention",
    "attend_train",
    "cross_kv",
    "attend_cross",
    "cache_len",
    "init_cache",
    "insert_slot",
    "prefill_into_cache",
    "decode_step",
    "cross_cache",
    "decode_cross",
]


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    mode: str = "global"  # global | local | chunked
    window: int = 0  # window size (local) or chunk size (chunked)
    rope_theta: float = 10_000.0
    use_rope: bool = True
    causal: bool = True  # False for encoder self-attention
    block_size: int = 1024  # KV block for the online-softmax path
    max_cache: int = 0  # decode-cache capacity for global layers (0 = seq)

    @property
    def groups(self) -> int:
        return self.n_heads // self.n_kv


def init_attention(gen, spec: AttnSpec):
    d, hq, hk, dh = spec.d_model, spec.n_heads, spec.n_kv, spec.d_head
    return {
        "wq": _he(gen, (d, hq, dh)),
        "wk": _he(gen, (d, hk, dh)),
        "wv": _he(gen, (d, hk, dh)),
        "wo": _he(gen, (hq, dh, d), scale_axis=1),
    }


def _scale(d_head: int) -> float:
    """``1 / sqrt(d_head)`` in float32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d_head)))


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, dh) -> (B, S, H, dh); head h reads kv head h // groups."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def _project(x: torch.Tensor, w: torch.Tensor, dtype=None) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` in float32, cast to ``dtype`` (x's by
    default)."""
    d, h, k = w.shape
    y = _f32(x) @ w.reshape(d, h * k)
    return y.reshape(*x.shape[:-1], h, k).to(dtype or x.dtype)


def _heads_axis(place):
    """The model axis when ``place`` splits the query heads, else None."""
    return place.model if place is not None and place.split("wq", 1) else None


def _out(o: torch.Tensor, wo: torch.Tensor, dtype, place=None) -> torch.Tensor:
    """``einsum("bqhk,hkd->bqd", preferred_element_type=dtype)``;
    row-parallel over the rank's heads under a placement."""
    h, k, d = wo.shape
    a, w = o.reshape(*o.shape[:-2], h * k), wo.reshape(h * k, d)
    axis = _heads_axis(place)
    if axis is not None:
        return _row_parallel(a, w, dtype, axis)
    return _matmul_to(a, w, dtype)


def _kv_weights(p, place):
    """``wk``, ``wv`` as the rank's heads read them: a split leaf as it
    is, a whole one under a split ``wq`` with its gradient summed over the
    model ranks."""
    axis = _heads_axis(place)
    if axis is None or place.split("wk", 1):
        return p["wk"], p["wv"]
    return copy_to(p["wk"], axis), copy_to(p["wv"], axis)


def _kv_index(spec: AttnSpec, place, n_q: int, n_kv: int, device,
              every_kv: bool = False) -> torch.Tensor:
    """The KV head (an index into this rank's k, or with ``every_kv`` into
    a k of every KV head) of each of the rank's ``n_q`` query heads:
    global head ``h`` reads KV head ``h // groups``."""
    axis = place.model
    heads = axis.rank * n_q + torch.arange(n_q, device=device)
    kv = torch.div(heads, spec.groups, rounding_mode="floor")
    if place.split("wk", 1) and not every_kv:
        kv = kv - axis.rank * n_kv
    return kv


def _every_kv_head(k, v, place):
    """The token's K/V with every KV head (gathered over "model" where the
    rank projected only its own): what a serving cache holds."""
    if place is not None and _heads_axis(place) is not None and place.split("wk", 1):
        return gather_from(k, 2, place.model), gather_from(v, 2, place.model)
    return k, v


def _length_axis(place, leaf: str = "k"):
    """The model axis when a serving placement splits the cache length
    (dim 1 of cache leaf ``leaf``), else None."""
    return place.model if place is not None and place.cache_split(leaf, 1) else None


def _qkv(p, x, spec: AttnSpec, positions, place=None):
    axis = _heads_axis(place)
    xin = x if axis is None else copy_to(_f32(x), axis)
    wk, wv = _kv_weights(p, place)
    q, k, v = (_project(xin, w, x.dtype) for w in (p["wq"], wk, wv))
    if spec.use_rope:
        q = rope(q, positions, theta=spec.rope_theta)
        k = rope(k, positions, theta=spec.rope_theta)
    return q, k, v


def _mask(spec: AttnSpec, qpos, kpos):
    """Boolean (..., Sq, Sk) mask from query/key positions: (Sq,) and
    (Sk,), or per row (B, Sq) and (B, Sk)."""
    q, k = qpos[..., :, None], kpos[..., None, :]
    valid = k >= 0
    if spec.causal:
        m = k <= q
    else:
        m = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                       device=qpos.device)
    if spec.mode == "local" and spec.window:
        m = m & (k > q - spec.window)
    elif spec.mode == "chunked" and spec.window:
        m = m & (torch.div(k, spec.window, rounding_mode="floor")
                 == torch.div(q, spec.window, rounding_mode="floor"))
    return m & valid


def _softmax0(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis; a fully masked row gives zeros."""
    p = torch.softmax(s, dim=-1)
    return torch.where(torch.isnan(p), torch.zeros((), dtype=p.dtype, device=p.device), p)


def _sdpa(q, k_full, v_full, mask, d_head):
    """Direct path. q: (B,Sq,H,dh), k_full/v_full: (B,Sk,H,dh)."""
    s = torch.einsum("bqhk,bshk->bhqs", _f32(q), _f32(k_full))
    s = torch.where(mask[None, None], s * _scale(d_head),
                    torch.tensor(-torch.inf, device=s.device))
    p = _softmax0(s)
    return torch.einsum("bhqs,bshk->bqhk", p.to(v_full.dtype), v_full)


def _blocked_sdpa(q, k_full, v_full, spec: AttnSpec, qpos, kpos):
    """Online softmax over KV blocks; O(S·T) live memory."""
    b, sq, h, dh = q.shape
    sk = k_full.shape[1]
    t = min(spec.block_size, sk)
    nb = -(-sk // t)
    pad = nb * t - sk
    if pad:
        k_full = torch.nn.functional.pad(k_full, (0, 0, 0, 0, 0, pad))
        v_full = torch.nn.functional.pad(v_full, (0, 0, 0, 0, 0, pad))
        kpos = torch.nn.functional.pad(kpos, (0, pad), value=-1)
    scale = _scale(dh)
    dev = q.device
    neg_inf = torch.tensor(-torch.inf, device=dev)
    zero = torch.zeros((), device=dev)
    m_run = torch.full((b, h, sq), -torch.inf, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=dev)
    q32 = _f32(q)
    for j in range(nb):
        blk = slice(j * t, (j + 1) * t)
        kj, vj, pj = k_full[:, blk], v_full[:, blk], kpos[blk]
        s = torch.einsum("bqhk,bthk->bhqt", q32, _f32(kj)) * scale
        s = torch.where(_mask(spec, qpos, pj)[None, None], s, neg_inf)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, zero)
        corr = torch.exp(torch.where(torch.isfinite(m_run), m_run - m_safe, neg_inf))
        corr = torch.where(torch.isfinite(corr), corr, zero)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqt,bthk->bhqk", p, _f32(vj))
        m_run = m_new
    o = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return o.permute(0, 2, 1, 3).to(q.dtype)  # (B,Sq,H,dh)


def _attend(p, q, k, v, spec: AttnSpec, qpos, kpos, x_dtype, place=None,
            every_kv: bool = False):
    if _heads_axis(place) is None:
        kf = _expand_kv(k, spec.groups)
        vf = _expand_kv(v, spec.groups)
    else:
        idx = _kv_index(spec, place, q.shape[2], k.shape[2], k.device, every_kv)
        kf, vf = k[:, :, idx], v[:, :, idx]
    sq, sk = q.shape[1], kf.shape[1]
    if max(sq, sk) <= 2 * spec.block_size:
        o = _sdpa(q, kf, vf, _mask(spec, qpos, kpos), spec.d_head)
    else:
        o = _blocked_sdpa(q, kf, vf, spec, qpos, kpos)
    return _out(o, p["wo"], x_dtype, place)


def _positions(s: int, start: int, device) -> torch.Tensor:
    return start + torch.arange(s, dtype=torch.int32, device=device)


def attend_train(p, x, spec: AttnSpec, positions=None, place=None) -> torch.Tensor:
    """Full-sequence attention (training / prefill compute); tensor
    parallel over the heads under ``place`` (module docstring)."""
    if positions is None:
        positions = _positions(x.shape[1], 0, x.device)
    q, k, v = _qkv(p, x, spec, positions, place)
    return _attend(p, q, k, v, spec, positions, positions, x.dtype, place)


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_kv(p, memory, spec: AttnSpec, place=None):
    """Project the encoder memory (B, Sk, d) once: (k, v), each (B, Sk,
    KV, dh) in the memory's dtype; every decode step reuses them.  Under
    ``place``, the rank's KV heads (all of them where ``wk`` is whole)."""
    axis = _heads_axis(place)
    mem = memory if axis is None else copy_to(_f32(memory), axis)
    wk, wv = _kv_weights(p, place)
    return _project(mem, wk, memory.dtype), _project(mem, wv, memory.dtype)


def attend_cross(p, x, k, v, spec: AttnSpec, place=None) -> torch.Tensor:
    """Full (non-causal, non-rotary) attention of x (B, Sq, d) over the
    precomputed memory K/V (B, Sk, KV, dh); the rank's query heads under
    ``place``."""
    axis = _heads_axis(place)
    q = _project(x if axis is None else copy_to(_f32(x), axis), p["wq"], x.dtype)
    qpos = _positions(q.shape[1], 0, x.device)
    kpos = _positions(k.shape[1], 0, x.device)
    return _attend(p, q, k.to(q.dtype), v.to(q.dtype), spec, qpos, kpos, x.dtype, place)


# ---------------------------------------------------------------------------
# KV cache (dense or ring) + decode
# ---------------------------------------------------------------------------


def cache_len(spec: AttnSpec, seq_len: int) -> int:
    """Physical cache capacity for a layer at a given serving seq_len."""
    if spec.mode in ("local", "chunked") and spec.window:
        return min(spec.window, seq_len)
    if spec.max_cache:
        return min(spec.max_cache, seq_len)
    return seq_len


def init_cache(spec: AttnSpec, batch: int, seq_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """``k``/``v`` (B, c, KV, dh) zeros and ``pos`` (B, c) int32 at -1:
    the original position per cache slot, per sequence, so batch rows at
    different decode positions mask independently."""
    c = cache_len(spec, seq_len)
    shape = (batch, c, spec.n_kv, spec.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, c), -1, dtype=torch.int32, device=device),
    }


def insert_slot(cache, one, slot: int, axis: int = 0):
    """Slot-local cache insertion, in place: write batch row 0 of the
    batch-1 cache tree ``one`` into batch row ``slot`` of ``cache`` (at
    ``axis``; rep-stacked leaves are ``(R, B, ...)``, so ``axis=1``),
    leaving every other row untouched.  Every leaf is batch-leading: K/V,
    the cross-attention memory (``ck``/``cv``) and the recurrent states.
    Returns ``cache``."""
    tree_map(lambda full, row: full.select(axis, slot).copy_(row.select(axis, 0)),
             cache, one)
    return cache


def prefill_into_cache(p, x, spec: AttnSpec, cache, start: int = 0, place=None):
    """Run attention over a prompt of length S and return (output, a new
    cache holding the final ``cache_len`` positions); ``cache`` itself is
    not written.  Under a serving ``place``, head-parallel, the new cache
    this rank's shard (module docstring)."""
    s = x.shape[1]
    positions = _positions(s, start, x.device)
    q, k, v = _qkv(p, x, spec, positions, place)
    out = _attend(p, q, k, v, spec, positions, positions, x.dtype, place)
    k, v = _every_kv_head(k, v, place)

    c = cache["pos"].shape[-1]  # the whole length: the rule never splits pos
    take = min(c, s)
    tail_pos = positions[s - take:]
    slots = (tail_pos % c).long()  # ring placement; identity when c >= S
    new = {name: cache[name].clone() for name in ("k", "v", "pos")}
    new["pos"][:, slots] = tail_pos
    axis = _length_axis(place)
    if axis is None:
        k, v = k[:, s - take:], v[:, s - take:]
    else:  # this rank's positions of the split length (host arithmetic: no sync)
        cl = new["k"].shape[1]
        js = [j for j in range(s - take, s) if (start + j) % c // cl == axis.rank]
        slots = torch.tensor([(start + j) % c - axis.rank * cl for j in js],
                             dtype=torch.long, device=x.device)
        idx = torch.tensor(js, dtype=torch.long, device=x.device)
        k, v = k[:, idx], v[:, idx]
    new["k"][:, slots] = k.to(new["k"].dtype)
    new["v"][:, slots] = v.to(new["v"].dtype)
    return out, new


def decode_step(p, x, spec: AttnSpec, cache, pos, place=None):
    """One token: x (B, 1, d); ``pos`` is a scalar or a (B,) vector of
    per-sequence positions.  Writes the token's K/V/position into
    ``cache`` in place (module docstring) and returns (y, cache).  Under
    a serving ``place``, ``x`` is this rank's rows and ``pos`` the whole
    batch's (the whole ``pos`` leaf takes every row's)."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    heads, length = _heads_axis(place), _length_axis(place)
    if heads is not None or length is not None:
        return _decode_sharded(p, x, spec, cache, pos, place, heads, length), cache
    kc, vc, pc = cache["k"], cache["v"], cache["pos"]
    if place is not None:  # this rank's rows: the pos leaf takes every row's
        pos, pc = _write_pos(pc, pos, place)
    elif pos.dim() == 0:
        pos = pos.expand(b)
    positions = pos[:, None]  # (B, 1): per-row rope + mask query positions
    q, k, v = _qkv(p, x, spec, positions)
    c = kc.shape[1]
    slot = (pos % c).long()  # (B,) ring placement per sequence
    bidx = torch.arange(b, device=x.device)
    kc[bidx, slot] = k[:, 0].to(kc.dtype)
    vc[bidx, slot] = v[:, 0].to(vc.dtype)
    pc[bidx, slot] = pos

    # GQA scores in (KV, G) form: the cache is never head-expanded.
    q5 = q.reshape(b, 1, spec.n_kv, spec.groups, spec.d_head)
    s = torch.einsum("bqegk,bsek->begqs", _f32(q5), _f32(kc.to(q.dtype)))
    s = s * _scale(spec.d_head)  # (B, KV, G, 1, c)
    # per-row mask: row i attends under its own query position pos[i]
    # against its own cached key positions pc[i]
    msk = _mask(spec, positions, pc)  # (B, 1, c)
    s = torch.where(msk[:, None, None], s, torch.tensor(-torch.inf, device=s.device))
    w = _softmax0(s)
    o = torch.einsum("begqs,bsek->bqegk", w.to(q.dtype), vc.to(q.dtype))
    o = o.reshape(b, 1, spec.n_heads, spec.d_head)
    return _out(o, p["wo"], x.dtype), cache


# ---------------------------------------------------------------------------
# Serving under a placement (module docstring)
# ---------------------------------------------------------------------------


def _flash_decode(q, kc, vc, mask, d_head: int, axis) -> torch.Tensor:
    """One query token of every head, q (B, 1, H, dh), against this rank's
    cache positions kc/vc (B, c_l, KV, dh) of every KV head, in the
    reference's ``(KV, G)`` score form, the softmax combined over ``axis``
    (the ranks holding the other positions) in float32: the max over every
    rank's scores, then the sums of ``exp(s - max)`` and of its weighted V.
    ``mask`` (B, 1, c_l) or None.  Returns (B, 1, H, dh) in q's dtype; a
    row masked everywhere gives zeros."""
    b, _, h, dh = q.shape
    kv = kc.shape[2]
    q5 = _f32(q).reshape(b, 1, kv, h // kv, dh)
    s = torch.einsum("bqegk,bsek->begqs", q5, _f32(kc)) * _scale(d_head)
    if mask is not None:
        s = torch.where(mask[:, None, None], s, torch.tensor(-torch.inf, device=s.device))
    top = all_reduce_max(s.amax(dim=-1, keepdim=True), axis)  # (B, KV, G, 1, 1)
    top = torch.where(torch.isfinite(top), top, torch.zeros((), device=s.device))
    e = torch.exp(s - top)
    part = torch.cat([torch.einsum("begqs,bsek->begqk", e, _f32(vc)),
                      e.sum(dim=-1, keepdim=True)], dim=-1)
    tot = reduce_from(part, axis)
    o = tot[..., :dh] / torch.clamp(tot[..., dh:], min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, 1, h, dh).to(q.dtype)


def _my_heads(o, heads, n: int):
    """This rank's ``n`` heads of an every-head ``o`` (B, 1, H, dh)."""
    return o if heads is None else o.narrow(2, heads.rank * n, n)


def _write_pos(pc, pos, place):
    """Every row's position into its slot of the whole ``pos`` leaf (the
    rule replicates it: each rank writes the same), from ``pos``, a scalar
    or every row's (B,); returns (this rank's positions, its rows of the
    leaf, a view)."""
    every = pos.expand(pc.shape[0]) if pos.dim() == 0 else pos
    rows = torch.arange(pc.shape[0], device=pc.device)
    pc[rows, (every % pc.shape[-1]).long()] = every
    return place.take_rows(every), place.take_rows(pc)


def _decode_sharded(p, x, spec: AttnSpec, cache, pos, place, heads, length):
    """``decode_step`` under a serving placement that splits the heads or
    the cache length over "model" (module docstring); returns y."""
    kc, vc = cache["k"], cache["v"]
    c = cache["pos"].shape[-1]  # the whole length
    pos, pc = _write_pos(cache["pos"], pos, place)
    positions = pos[:, None]
    b = x.shape[0]
    q, k, v = _qkv(p, x, spec, positions, place)
    k, v = _every_kv_head(k, v, place)
    slot = (pos % c).long()
    bidx = torch.arange(b, device=x.device)
    if length is None:  # the whole length: this rank's heads against every position
        kc[bidx, slot] = k[:, 0].to(kc.dtype)
        vc[bidx, slot] = v[:, 0].to(vc.dtype)
        mask = _mask(spec, positions, pc)  # (B, 1, c)
        idx = _kv_index(spec, place, q.shape[2], kc.shape[2], x.device, every_kv=True)
        s = torch.einsum("bqhk,bshk->bhqs", _f32(q), _f32(kc[:, :, idx].to(q.dtype)))
        s = torch.where(mask[:, None], s * _scale(spec.d_head),
                        torch.tensor(-torch.inf, device=s.device))
        w = _softmax0(s)
        o = torch.einsum("bhqs,bshk->bqhk", w.to(q.dtype), vc[:, :, idx].to(q.dtype))
        return _out(o, p["wo"], x.dtype, place)
    # the rank owning the slot writes it; the others write back what the cell held
    cl = kc.shape[1]
    local = slot - length.rank * cl
    mine = ((local >= 0) & (local < cl))[:, None, None]
    local = local.clamp(0, cl - 1)
    kc[bidx, local] = torch.where(mine, k[:, 0].to(kc.dtype), kc[bidx, local])
    vc[bidx, local] = torch.where(mine, v[:, 0].to(vc.dtype), vc[bidx, local])
    kpos = pc.narrow(1, length.rank * cl, cl)
    qa = q if heads is None else gather_from(q, 2, heads)
    o = _flash_decode(qa, kc, vc, _mask(spec, positions, kpos), spec.d_head, length)
    return _out(_my_heads(o, heads, q.shape[2]), p["wo"], x.dtype, place)


def cross_cache(k, v, place=None):
    """The cross-attention cache's ``ck``/``cv`` from the memory's K/V
    (``cross_kv``'s): under a serving ``place``, every KV head and this
    rank's positions of the memory where the rule splits its length."""
    k, v = _every_kv_head(k, v, place)
    axis = _length_axis(place, "ck")
    if axis is None:
        return k, v
    n = k.shape[1]
    if n % axis.size:
        raise ValueError(f"a memory of {n} positions does not split over {axis.size} "
                         "model ranks, as the cache's rule does")
    n //= axis.size
    return k.narrow(1, axis.rank * n, n), v.narrow(1, axis.rank * n, n)


def decode_cross(p, x, ck, cv, spec: AttnSpec, place=None) -> torch.Tensor:
    """Decode's cross-attention of x (B, 1, d) over the cached memory
    ``ck``/``cv`` (:func:`cross_cache`); :func:`attend_cross` without a
    placement that splits the heads or the memory's length."""
    heads, length = _heads_axis(place), _length_axis(place, "ck")
    if heads is None and length is None:
        return attend_cross(p, x, ck, cv, spec, place)
    q = _project(x if heads is None else copy_to(_f32(x), heads), p["wq"], x.dtype)
    if length is None:  # this rank's heads against the whole memory
        pos = _positions(ck.shape[1], 0, x.device)
        return _attend(p, q, ck.to(q.dtype), cv.to(q.dtype), spec,
                       _positions(1, 0, x.device), pos, x.dtype, place, every_kv=True)
    qa = q if heads is None else gather_from(q, 2, heads)
    o = _flash_decode(qa, ck, cv, None, spec.d_head, length)
    return _out(_my_heads(o, heads, q.shape[2]), p["wo"], x.dtype, place)
