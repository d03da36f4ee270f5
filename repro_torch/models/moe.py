"""Mixture-of-Experts FFN: token-choice top-k routing with capacity.

Counterpart of ``repro.models.moe``.  Each selected (token, expert) pair
gets a rank within its expert by a cumulative count; pairs past the
capacity are dropped.  The kept tokens are gathered into a grouped
``(E, C, d)`` buffer through the inverse index (``inv[slot] = token``,
the zero sentinel row ``T`` for an empty slot), every expert runs as one
batched product (``torch.bmm``) over all ``E`` experts, and the outputs
are combined back per token.

Used by llama4-scout (16 experts, top-1) and dbrx (16 experts, top-4).

Two points where the port must take care to give the reference's
results (ROADMAP §3):

  * **ranks** (``_route``): the rank of a pair is the exclusive
    cumulative count over the token-major ``(T·k, E)`` one-hot, so the
    earlier token (and, within a token, the earlier of its ``k`` picks)
    wins a contested slot, as in the reference.  On ties among router
    probabilities ``jax.lax.top_k`` keeps the lower expert first, while
    ``torch.topk`` promises no order; continuous router values make ties
    measure-zero, and the port does not try to match them.
  * **the combine** (``_combine``): the reference scatter-adds the
    weighted expert rows into a zeroed ``(T + 1, d)`` buffer
    (``.at[inv].add``), one update per slot in slot order.  On the card,
    ``index_add_`` adds with atomics in no fixed order, so a token with
    ``top_k > 1`` would change its bits from run to run (breaking solo ≡
    concurrent and retries).  The port instead gathers each token's
    ``k`` weighted rows at their destination slots and adds them one by
    one in ascending slot order, starting from 0.0: the reference's order
    of updates, with no atomics.

Decode runs every expert's weights through the grouped product, experts
with no token included, as the reference's grouped einsum does: a
decode step reads all ``E`` experts' weights.

Expert parallel (training): under a placement (``place=``) whose specs
split the experts over "model", every model rank routes the same
replicated tokens whole (routing, capacity and aux are the same on each),
runs only its ``E / tp`` experts' products on their rows of the grouped
buffer, and ``gather_from`` collects the ``(E, cap, d)`` outputs in
expert order; the combine then adds each token's slots in ascending slot
order as above, so the bits are those of the single-process step wherever
the expert products give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..distributed.tensor_parallel import copy_to, gather_from
from .layers import _f32, _he, _matmul_to

__all__ = ["MoESpec", "init_moe", "moe_ffn"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    min_capacity: int = 4
    router_z_coef: float = 1e-3
    token_chunk: int = 16_384  # dispatch chunk: capacity is enforced per chunk


def init_moe(gen, spec: MoESpec):
    e, d, f = spec.n_experts, spec.d_model, spec.d_ff
    return {
        "router": _he(gen, (d, e)),
        "w_gate": _he(gen, (e, d, f), scale_axis=1),
        "w_up": _he(gen, (e, d, f), scale_axis=1),
        "w_down": _he(gen, (e, f, d), scale_axis=1),
    }


def _capacity(tokens: int, spec: MoESpec) -> int:
    c = int(tokens * spec.top_k * spec.capacity_factor / spec.n_experts)
    return max(c, spec.min_capacity)


def moe_ffn(p, x: torch.Tensor, spec: MoESpec, place=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, d) -> ((B, S, d), aux).  aux = load balance + router z-loss,
    a float32 scalar.

    A token stream longer than ``token_chunk`` (and a multiple of it) is
    dispatched chunk by chunk, as the reference's ``lax.scan`` does:
    capacity is per chunk and aux is the mean over chunks."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    if t > spec.token_chunk and t % spec.token_chunk == 0:
        nc = t // spec.token_chunk
        outs, aux_sum = [], 0.0
        for chunk in xf.split(spec.token_chunk):
            yc, aux = _moe_tokens(p, chunk, spec, place)
            outs.append(yc)
            aux_sum = aux_sum + aux
        return torch.cat(outs).reshape(b, s, d).to(x.dtype), aux_sum / nc
    out, aux = _moe_tokens(p, xf, spec, place)
    return out.reshape(b, s, d).to(x.dtype), aux


class Route(NamedTuple):
    """One dispatch: router ``logits`` and ``probs`` (T, E) in f32, the
    renormalised ``gate_vals`` and ``expert_idx`` (T, k), ``keep`` (T, k)
    (the pair's rank is under capacity), ``dest`` (T, k), each pair's
    slot in the flat ``(E·cap,)`` buffer (``E·cap`` for a dropped pair),
    and ``cap``."""

    logits: torch.Tensor
    probs: torch.Tensor
    gate_vals: torch.Tensor
    expert_idx: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    cap: int


def _route(p, xf: torch.Tensor, spec: MoESpec) -> Route:
    t = xf.shape[0]
    e, k = spec.n_experts, spec.top_k
    cap = _capacity(t, spec)
    logits = _f32(xf) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    # ties: torch.topk promises no order among equal values (module docstring)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # rank of each (token, pick) within its expert: the exclusive count of
    # earlier picks of that expert in token-major order
    flat_sel = F.one_hot(expert_idx, e).reshape(t * k, e)
    rank = torch.cumsum(flat_sel, dim=0) - flat_sel
    rank = (rank * flat_sel).sum(-1).reshape(t, k)
    keep = rank < cap
    dest = torch.where(keep, expert_idx * cap + rank, torch.full_like(rank, e * cap))
    return Route(logits, probs, gate_vals, expert_idx, keep, dest, cap)


def _experts(p, gx: torch.Tensor, dtype) -> torch.Tensor:
    """The expert FFN (SwiGLU), batched over the leaves' experts."""
    g = F.silu(torch.bmm(gx, p["w_gate"]))
    u = torch.bmm(gx, p["w_up"])
    return _matmul_to((g * u).to(dtype), p["w_down"], dtype)


def _moe_tokens(p, xf: torch.Tensor, spec: MoESpec, place=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, d) -> ((T, d), aux)."""
    t, d = xf.shape
    e, k = spec.n_experts, spec.top_k
    r = _route(p, xf, spec)
    cap = r.cap

    # dispatch by the inverse index: token ids scattered onto the kept
    # pairs' slots (unique: ranks are distinct within an expert); every
    # dropped pair writes the spare slot E·cap, cut off after, so no shape
    # depends on the routing (no host sync; a meta-device run has the
    # shapes); an empty slot keeps the sentinel row t
    slots = r.dest.reshape(-1)
    tokens = torch.arange(t, device=xf.device).repeat_interleave(k)
    inv = torch.full((e * cap + 1,), t, dtype=torch.long, device=xf.device)
    inv[slots] = tokens
    inv = inv[:e * cap]
    w_slot = torch.zeros((e * cap + 1,), dtype=torch.float32, device=xf.device)
    w_slot[slots] = r.gate_vals.reshape(-1).float()
    w_slot = w_slot[:e * cap]
    xf_pad = torch.cat([xf, xf.new_zeros((1, d))])
    axis = place.model if place is not None and place.split("w_up", 0) else None
    if axis is None:  # every expert here
        y = _experts(p, _f32(xf_pad[inv].reshape(e, cap, d)), xf.dtype)
    else:  # this rank's experts' rows, then every rank's outputs in expert order
        local = p["w_up"].shape[0]
        rows = inv.reshape(e, cap)[axis.rank * local:(axis.rank + 1) * local]
        y = gather_from(_experts(p, copy_to(_f32(xf_pad), axis)[rows], xf.dtype), 0, axis)

    y_w = y.reshape(e * cap, d).float() * w_slot[:, None]
    out = _combine(y_w, r.dest).to(xf.dtype)

    # aux losses: Switch-style load balance + router z-loss
    me = r.probs.mean(dim=0)
    ce = (F.one_hot(r.expert_idx, e).sum(1) > 0).float().mean(dim=0)
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    return out, lb + spec.router_z_coef * z


def _combine(y_w: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Each token's weighted expert rows summed in ascending slot order
    from 0.0, with no atomics (module docstring).  ``y_w``: (E·cap, d)
    f32; ``dest``: (T, k), ``E·cap`` for a dropped pair, which reads a
    zero row."""
    rows = torch.cat([y_w, y_w.new_zeros((1, y_w.shape[1]))])
    order = torch.sort(dest, dim=-1).values
    out = torch.zeros((dest.shape[0], y_w.shape[1]), dtype=torch.float32,
                      device=y_w.device)
    for j in range(order.shape[1]):
        out = out + rows[order[:, j]]
    return out
