"""Attention: GQA with global / sliding-window / chunked-local masking.

Counterpart of ``repro.models.attention`` (self-attention; the
cross-attention of encoder-decoder blocks comes with the ``xattn``
slice).  Query/output heads live on one flat ``H`` axis and the ``KV``
heads are repeated to ``H`` at compute time; caches hold only the ``KV``
heads.  The softmax is the reference's own code, op for op (no fused
library attention), so the two packages agree within float32 tolerance:

  * ``attend_train``  — full-sequence causal attention, directly when
    ``max(Sq, Sk) <= 2·block_size`` (``_sdpa``), else the online softmax
    over KV blocks (``_blocked_sdpa``);
  * ``prefill_into_cache`` — the same pass, returning a new cache filled
    with the prompt's last ``cache_len`` positions (dense or ring);
  * ``decode_step`` — one token per row against the cache, at per-row
    positions, in the reference's ``(KV, G)`` score form.

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

from .layers import _f32, _he, _matmul_to, rope

__all__ = [
    "AttnSpec",
    "init_attention",
    "attend_train",
    "cache_len",
    "init_cache",
    "insert_slot",
    "prefill_into_cache",
    "decode_step",
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


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` in float32, cast to x's dtype."""
    d, h, k = w.shape
    y = _f32(x) @ w.reshape(d, h * k)
    return y.reshape(*x.shape[:-1], h, k).to(x.dtype)


def _out(o: torch.Tensor, wo: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum("bqhk,hkd->bqd", preferred_element_type=dtype)``."""
    h, k, d = wo.shape
    return _matmul_to(o.reshape(*o.shape[:-2], h * k), wo.reshape(h * k, d), dtype)


def _qkv(p, x, spec: AttnSpec, positions):
    q, k, v = _project(x, p["wq"]), _project(x, p["wk"]), _project(x, p["wv"])
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


def _attend(p, q, k, v, spec: AttnSpec, qpos, kpos, x_dtype):
    kf = _expand_kv(k, spec.groups)
    vf = _expand_kv(v, spec.groups)
    sq, sk = q.shape[1], kf.shape[1]
    if max(sq, sk) <= 2 * spec.block_size:
        o = _sdpa(q, kf, vf, _mask(spec, qpos, kpos), spec.d_head)
    else:
        o = _blocked_sdpa(q, kf, vf, spec, qpos, kpos)
    return _out(o, p["wo"], x_dtype)


def _positions(s: int, start: int, device) -> torch.Tensor:
    return start + torch.arange(s, dtype=torch.int32, device=device)


def attend_train(p, x, spec: AttnSpec, positions=None) -> torch.Tensor:
    """Full-sequence attention (training / prefill compute)."""
    if positions is None:
        positions = _positions(x.shape[1], 0, x.device)
    q, k, v = _qkv(p, x, spec, positions)
    return _attend(p, q, k, v, spec, positions, positions, x.dtype)


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
    leaving every other row untouched.  Returns ``cache``."""
    for key, full in cache.items():
        full.select(axis, slot).copy_(one[key].select(axis, 0))
    return cache


def prefill_into_cache(p, x, spec: AttnSpec, cache, start: int = 0):
    """Run attention over a prompt of length S and return (output, a new
    cache holding the final ``cache_len`` positions); ``cache`` itself is
    not written."""
    s = x.shape[1]
    positions = _positions(s, start, x.device)
    q, k, v = _qkv(p, x, spec, positions)
    out = _attend(p, q, k, v, spec, positions, positions, x.dtype)

    c = cache["k"].shape[1]
    take = min(c, s)
    tail_pos = positions[s - take:]
    slots = (tail_pos % c).long()  # ring placement; identity when c >= S
    new = {name: cache[name].clone() for name in ("k", "v", "pos")}
    new["k"][:, slots] = k[:, s - take:].to(new["k"].dtype)
    new["v"][:, slots] = v[:, s - take:].to(new["v"].dtype)
    new["pos"][:, slots] = tail_pos
    return out, new


def decode_step(p, x, spec: AttnSpec, cache, pos):
    """One token: x (B, 1, d); ``pos`` is a scalar or a (B,) vector of
    per-sequence positions.  Writes the token's K/V/position into
    ``cache`` in place (module docstring) and returns (y, cache)."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if pos.dim() == 0:
        pos = pos.expand(b)
    positions = pos[:, None]  # (B, 1): per-row rope + mask query positions
    q, k, v = _qkv(p, x, spec, positions)
    kc, vc, pc = cache["k"], cache["v"], cache["pos"]
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
