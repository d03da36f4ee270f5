"""Recurrent sequence mixers: xLSTM (mLSTM + sLSTM) and RG-LRU (Griffin).

Counterpart of ``repro.models.recurrent``.  Each mixer has the three
regimes of attention:

  * ``*_train`` — the full sequence (``return_state=True`` also returns
    the state after the last position: the recurrent models' prefill);
  * ``*_decode`` — one token, O(1) in sequence length.

Every state leaf is batch-leading (``(B, ...)``), so serving's
slot-local admission (``insert_slot``, re-exported here as the reference
does) writes one request's state into its own batch row.  Decode is
row-independent, so a request decoded in a batch gets the bits of the
same request decoded alone.

**State is never written in place.**  ``*_decode`` and ``*_train``
return new state tensors and leave the state they were given as it was.
A recurrent update ``h <- a·h + b`` reads the state it would overwrite,
so a decode step that failed after writing its state could not be
repeated to the same bits; with new tensors the serving loop keeps the
old state until the step has succeeded (``serving/serve_loop.py``).

The reference's ``lax.scan`` loops become Python loops over time (sLSTM)
and over chunks (mLSTM).  RG-LRU's ``jax.lax.associative_scan`` becomes
the recurrence ``h_t = a_t·h_{t-1} + b_t`` run in time order, with the
carried state folded into step 0 as the reference does; the products
round in another order than the associative tree, so the two agree
within float32 tolerance, not bitwise.

``jax.nn.softplus`` is ``torch.logaddexp(x, 0)`` (``F.softplus`` turns
linear above 20), ``jax.nn.log_sigmoid`` is ``F.logsigmoid`` and
``jax.nn.gelu`` is the tanh form (``layers.gelu``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .attention import insert_slot
from .layers import _device, _f32, _he, _matmul_to, _normal, gelu

__all__ = [
    "insert_slot",
    "MLSTMSpec",
    "init_mlstm",
    "mlstm_train",
    "mlstm_init_state",
    "mlstm_decode",
    "SLSTMSpec",
    "init_slstm",
    "slstm_train",
    "slstm_init_state",
    "slstm_decode",
    "RGLRUSpec",
    "init_rglru",
    "rglru_train",
    "rglru_init_state",
    "rglru_decode",
]


def _inv_sqrt(n: int) -> float:
    """``1 / sqrt(n)`` in float32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


# ===========================================================================
# mLSTM
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class MLSTMSpec:
    d_model: int
    n_heads: int
    expand: int = 2  # up-projection factor
    conv_width: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def d_head(self) -> int:
        return self.d_inner // self.n_heads


def init_mlstm(gen, spec: MLSTMSpec):
    d, di, h = spec.d_model, spec.d_inner, spec.n_heads
    return {
        "w_up": _he(gen, (d, di)),
        "w_ogate": _he(gen, (d, di)),
        "conv": _normal(gen, (spec.conv_width, di)) * 0.1,
        "wq": _he(gen, (di, di)),
        "wk": _he(gen, (di, di)),
        "wv": _he(gen, (di, di)),
        "w_if": _he(gen, (di, 2 * h)),  # input & forget gate pre-activations
        "w_down": _he(gen, (di, d)),
        "skip_scale": torch.ones((di,), dtype=torch.float32, device=_device(gen)),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, D), w: (W, D).  ``state``: (B, W-1, D),
    the trailing inputs carried for decode continuity.  Returns (out, new
    state); the new state is a new tensor."""
    width = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(width))
    new_state = xp[:, xp.shape[1] - (width - 1):].contiguous()
    return out.to(x.dtype), new_state


def _mlstm_qkvif(p, x, spec: MLSTMSpec, conv_state=None):
    b, s, _ = x.shape
    h, dh = spec.n_heads, spec.d_head
    up = (_f32(x) @ p["w_up"]).to(x.dtype)
    conv_out, conv_state = _causal_conv(up, p["conv"], conv_state)
    conv_act = F.silu(_f32(conv_out)).to(x.dtype)
    # the f32 weights promote q, k, v to f32, as in the reference
    q = (_f32(conv_act) @ p["wq"]).reshape(b, s, h, dh)
    k = (_f32(conv_act) @ p["wk"]).reshape(b, s, h, dh)
    v = (_f32(up) @ p["wv"]).reshape(b, s, h, dh)
    gates = _f32(conv_act) @ p["w_if"]
    i_pre, f_pre = gates[..., :h], gates[..., h:]
    logf = F.logsigmoid(f_pre)
    ogate = torch.sigmoid(_f32(x) @ p["w_ogate"])
    skip = conv_act * p["skip_scale"]
    return q, k, v, i_pre, logf, ogate, up, skip, conv_state


def _mlstm_chunk_scan(q, k, v, i_pre, logf, state):
    """Chunkwise-parallel stabilized mLSTM core: the quadratic gated form
    within a chunk, the ``(C, n, m)`` state carried across chunks.

    q/k/v: (B, NC, T, H, D); i_pre/logf: (B, NC, T, H).
    state: (C (B,H,D,D), n (B,H,D), m (B,H)).
    Returns h (B, NC, T, H, D) and the final state."""
    b, nc, t, h, d = q.shape
    scale = _inv_sqrt(d)
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    C, n, m = state
    hs = []
    for c in range(nc):
        qc, kc, vc, ic, lfc = q[:, c], k[:, c], v[:, c], i_pre[:, c], logf[:, c]
        Fc = torch.cumsum(lfc, dim=1)  # inclusive prefix logf, (B,T,H)
        # intra-chunk decay D[t,s] = F_t - F_s + i_s for s <= t, else -inf
        Dm = Fc[:, :, None] - Fc[:, None, :] + ic[:, None, :, :]  # (B,T,S,H)
        Dm = torch.where(causal[None, :, :, None], Dm,
                         torch.tensor(float("-inf"), device=q.device))
        inter = m[:, None] + Fc  # inter-chunk decay for queries, (B,T,H)
        m_new_q = torch.maximum(inter, Dm.amax(dim=2))
        m_q = torch.where(torch.isfinite(m_new_q), m_new_q, torch.zeros_like(m_new_q))

        w_intra = torch.exp(Dm - m_q[:, :, None, :])  # (B,T,S,H)
        w_inter = torch.exp(inter - m_q)  # (B,T,H)

        s_qk = torch.einsum("bthd,bshd->btsh", qc, kc) * scale
        sw = s_qk * w_intra
        intra_num = torch.einsum("btsh,bshd->bthd", sw, vc)
        inter_num = (torch.einsum("bthd,bhde->bthe", qc, C) * scale) * w_inter[..., None]
        num = intra_num + inter_num

        intra_den = sw.sum(dim=2)
        inter_den = (torch.einsum("bthd,bhd->bth", qc, n) * scale) * w_inter
        den = torch.maximum(torch.abs(intra_den + inter_den), torch.exp(-m_q))
        hs.append(num / den[..., None])

        # the state at the end of the chunk
        F_T = Fc[:, -1]  # (B,H)
        decay_k = F_T[:, None] - Fc + ic  # F_T - F_s + i_s, (B,T,H)
        m_next = torch.maximum(m + F_T, decay_k.amax(dim=1))
        w_k = torch.exp(decay_k - m_next[:, None])
        carry = torch.exp(m + F_T - m_next)
        C = carry[:, :, None, None] * C + torch.einsum(
            "bthd,bthe->bhde", kc * w_k[..., None], vc)
        n = carry[:, :, None] * n + torch.einsum("bthd,bth->bhd", kc, w_k)
        m = m_next
    return torch.stack(hs, dim=1), (C, n, m)


def mlstm_init_state(spec: MLSTMSpec, batch: int, dtype=torch.float32, device="cuda"):
    """Zeroed state; ``C``, ``n`` and ``m`` stay float32, the conv state
    takes ``dtype``."""
    h, dh = spec.n_heads, spec.d_head
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, h, dh, dh), **f32),
        "n": torch.zeros((batch, h, dh), **f32),
        "m": torch.zeros((batch, h), **f32),
        "conv": torch.zeros((batch, spec.conv_width - 1, spec.d_inner), dtype=dtype,
                            device=device),
    }


def _pad_time(a, pad: int, fill: float):
    return torch.cat([a, a.new_full((a.shape[0], pad, *a.shape[2:]), fill)], dim=1)


def mlstm_train(p, x, spec: MLSTMSpec, state=None, return_state: bool = False):
    """(B, S, d) -> (B, S, d).  The sequence is padded to a multiple of
    ``chunk = min(spec.chunk, S)`` with ``i_pre = -1e9`` and ``logf = 0``
    (the padded steps add nothing to the state and decay nothing)."""
    b, s, d = x.shape
    q, k, v, i_pre, logf, ogate, up, skip, conv_state = _mlstm_qkvif(
        p, x, spec, None if state is None else state["conv"])
    t = min(spec.chunk, s)
    nc = -(-s // t)
    pad = nc * t - s
    if pad:
        q, k, v = _pad_time(q, pad, 0.0), _pad_time(k, pad, 0.0), _pad_time(v, pad, 0.0)
        i_pre, logf = _pad_time(i_pre, pad, -1e9), _pad_time(logf, pad, 0.0)
    h, dh = spec.n_heads, spec.d_head
    shp = (b, nc, t, h, dh)
    if state is not None:
        core_state = (state["C"], state["n"], state["m"])
    else:
        zeros = mlstm_init_state(spec, b, device=x.device)
        core_state = (zeros["C"], zeros["n"], zeros["m"])
    hs, core_state = _mlstm_chunk_scan(
        q.reshape(shp), k.reshape(shp), v.reshape(shp),
        i_pre.reshape(b, nc, t, h), logf.reshape(b, nc, t, h), core_state)
    hflat = hs.reshape(b, nc * t, h * dh)[:, :s]
    y = (_f32(ogate) * (_f32(hflat) + _f32(skip))).to(x.dtype)
    out = _matmul_to(y, p["w_down"], x.dtype)
    if return_state:
        C, n, m = core_state
        return out, {"C": C, "n": n, "m": m, "conv": conv_state}
    return out


def mlstm_decode(p, x, spec: MLSTMSpec, state):
    """One token.  x: (B, 1, d).  Returns (out, a new state)."""
    q, k, v, i_pre, logf, ogate, up, skip, conv_state = _mlstm_qkvif(
        p, x, spec, state["conv"])
    b = x.shape[0]
    h, dh = spec.n_heads, spec.d_head
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]  # (B,H,D), f32
    i1, f1 = i_pre[:, 0], logf[:, 0]  # (B,H)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(f1 + m, i1)
    fw = torch.exp(f1 + m - m_new)[:, :, None, None]
    iw = torch.exp(i1 - m_new)[:, :, None, None]
    C_new = fw * C + iw * torch.einsum("bhd,bhe->bhde", k1, v1)
    n_new = fw[..., 0] * n + iw[..., 0] * k1
    scale = _inv_sqrt(dh)
    num = torch.einsum("bhd,bhde->bhe", q1, C_new) * scale
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q1, n_new) * scale),
                        torch.exp(-m_new))
    hvec = (num / den[..., None]).reshape(b, 1, h * dh)
    y = (_f32(ogate) * (hvec + _f32(skip))).to(x.dtype)
    out = _matmul_to(y, p["w_down"], x.dtype)
    return out, {"C": C_new, "n": n_new, "m": m_new, "conv": conv_state}


# ===========================================================================
# sLSTM
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class SLSTMSpec:
    d_model: int
    n_heads: int
    proj_factor: float = 4.0 / 3.0

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff(self) -> int:
        return int(self.d_model * self.proj_factor)


def init_slstm(gen, spec: SLSTMSpec):
    d, h, dh = spec.d_model, spec.n_heads, spec.d_head
    dev = _device(gen)
    return {
        "w_in": _he(gen, (d, 4, d)),  # input projections of gates z, i, f, o
        "r": _normal(gen, (4, h, dh, dh)) * _inv_sqrt(dh),  # block-diagonal per head
        "bias": torch.zeros((4, d), dtype=torch.float32, device=dev),
        "gn_scale": torch.ones((d,), dtype=torch.float32, device=dev),
        "w_up_gate": _he(gen, (d, spec.d_ff)),
        "w_up": _he(gen, (d, spec.d_ff)),
        "w_down": _he(gen, (spec.d_ff, d)),
    }


def slstm_init_state(spec: SLSTMSpec, batch: int, dtype=torch.float32, device="cuda"):
    """The initial state, all float32 (``n`` starts at 1)."""
    shape, f32 = (batch, spec.d_model), dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.ones(shape, **f32),
            "h": torch.zeros(shape, **f32), "m": torch.zeros(shape, **f32)}


def _slstm_cell(p, xt, state, spec: SLSTMSpec):
    """One timestep.  xt: (B, 4, d) pre-activations from the input
    projection.  Returns (new state, h)."""
    b = xt.shape[0]
    h_heads = state["h"].reshape(b, spec.n_heads, spec.d_head)
    rec = torch.einsum("bhk,ghkl->bghl", _f32(h_heads), p["r"]).reshape(b, 4, spec.d_model)
    pre = _f32(xt) + rec + p["bias"][None]
    z = torch.tanh(pre[:, 0])
    i_pre, f_pre = pre[:, 1], pre[:, 2]
    o = torch.sigmoid(pre[:, 3])
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    iw = torch.exp(i_pre - m_new)
    fw = torch.exp(logf + state["m"] - m_new)
    c_new = fw * state["c"] + iw * z
    n_new = torch.maximum(fw * state["n"] + iw, torch.exp(-m_new))
    h_new = o * (c_new / n_new)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}, h_new


def _slstm_core(p, x, spec: SLSTMSpec, state):
    b, s, d = x.shape
    xin = (_f32(x).reshape(b * s, d) @ p["w_in"].reshape(d, 4 * d)).reshape(b, s, 4, d)
    hs = []
    for i in range(s):
        state, h = _slstm_cell(p, xin[:, i], state, spec)
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), state


def _slstm_out(p, x, hs):
    """Headwise group norm, then the gated FFN projection."""
    hs32 = _f32(hs)
    mu = hs32.mean(-1, keepdim=True)
    var = hs32.var(-1, keepdim=True, correction=0)
    hn = ((hs32 - mu) * torch.rsqrt(var + 1e-6) * p["gn_scale"]).to(x.dtype)
    g = gelu(_f32(hn) @ p["w_up_gate"])
    u = _f32(hn) @ p["w_up"]
    return ((g * u) @ p["w_down"]).to(x.dtype)


def slstm_train(p, x, spec: SLSTMSpec, state=None, return_state: bool = False):
    if state is None:
        state = slstm_init_state(spec, x.shape[0], device=x.device)
    hs, state = _slstm_core(p, x, spec, state)
    out = _slstm_out(p, x, hs)
    return (out, state) if return_state else out


def slstm_decode(p, x, spec: SLSTMSpec, state):
    """One token: the train pass over one step.  Returns (out, a new state)."""
    return slstm_train(p, x, spec, state, return_state=True)


# ===========================================================================
# RG-LRU (Griffin recurrent block)
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    d_model: int
    d_rnn: int = 0  # 0 -> d_model
    conv_width: int = 4
    c_const: float = 8.0

    @property
    def width(self) -> int:
        return self.d_rnn or self.d_model


def _softplus(x):
    """``jax.nn.softplus``: ``log(1 + e^x)`` at every x."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_rglru(gen, spec: RGLRUSpec):
    d, w = spec.d_model, spec.width
    # a deterministic Λ (not a draw): a = exp(-c·softplus(Λ)·r) starts near
    # 0.9..0.999
    lin = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=_device(gen))
    lam = torch.log(torch.expm1(-torch.log(lin) / spec.c_const))
    return {
        "w_x": _he(gen, (d, w)),
        "w_gate_branch": _he(gen, (d, w)),
        "conv": _normal(gen, (spec.conv_width, w)) * 0.1,
        "w_rgate": _he(gen, (w, w)),
        "w_igate": _he(gen, (w, w)),
        "lam": lam,
        "w_out": _he(gen, (w, d)),
    }


def rglru_init_state(spec: RGLRUSpec, batch: int, dtype=torch.float32, device="cuda"):
    """Zeroed state; ``h`` stays float32, the conv state takes ``dtype``."""
    return {
        "h": torch.zeros((batch, spec.width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, spec.conv_width - 1, spec.width), dtype=dtype,
                            device=device),
    }


def _rglru_gates(p, u, spec: RGLRUSpec):
    """u: (B, S, W), the post-conv branch.  Returns (log_a, gated input)."""
    r = torch.sigmoid(_f32(u) @ p["w_rgate"])
    i = torch.sigmoid(_f32(u) @ p["w_igate"])
    log_a = -spec.c_const * _softplus(p["lam"])[None, None] * r  # (B,S,W) <= 0
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * _f32(u))
    return log_a, gated


def _rglru_branches(p, x):
    branch = (_f32(x) @ p["w_x"]).to(x.dtype)
    gate = gelu(_f32(x) @ p["w_gate_branch"]).to(x.dtype)
    return branch, gate


def rglru_train(p, x, spec: RGLRUSpec, state=None, return_state: bool = False):
    """Griffin's recurrent block: a gated two-branch block around the
    RG-LRU recurrence, run in time order (module docstring)."""
    if state is None:
        state = rglru_init_state(spec, x.shape[0], device=x.device)
    branch, gate = _rglru_branches(p, x)
    u, conv_state = _causal_conv(branch, p["conv"], state["conv"])
    log_a, gated = _rglru_gates(p, u, spec)
    a_seq = torch.exp(log_a)
    h = gated[:, 0] + a_seq[:, 0] * state["h"]  # the carried state folded into step 0
    hs = [h]
    for t in range(1, x.shape[1]):
        h = a_seq[:, t] * h + gated[:, t]
        hs.append(h)
    h_seq = torch.stack(hs, dim=1)
    y = (h_seq * _f32(gate)).to(x.dtype)
    out = _matmul_to(y, p["w_out"], x.dtype)
    if return_state:
        return out, {"h": h, "conv": conv_state}
    return out


def rglru_decode(p, x, spec: RGLRUSpec, state):
    """One token.  Returns (out, a new state)."""
    branch, gate = _rglru_branches(p, x)
    u, conv_state = _causal_conv(branch, p["conv"], state["conv"])
    log_a, gated = _rglru_gates(p, u, spec)
    h_new = torch.exp(log_a[:, 0]) * state["h"] + gated[:, 0]
    y = (h_new[:, None] * _f32(gate)).to(x.dtype)
    out = _matmul_to(y, p["w_out"], x.dtype)
    return out, {"h": h_new, "conv": conv_state}
