"""Core neural layers: linear, norms, embedding, RoPE, MLP (plain PyTorch ops).

Counterpart of ``repro.models.layers``.  Everything is an
``init_*(generator, ...) -> params`` plus an apply function over nested
dicts of tensors, with the reference's parameter names and shapes, so a
parameter tree carries across leaf for leaf
(:func:`repro_torch.core.convert.from_reference_params`).

Conventions, as in the reference:

  * activations are (B, S, d);
  * parameters are float32 and made on the generator's device (the meta
    device, with no allocation, when the generator is ``None``);
  * products take float32 inputs and accumulate in float32, then cast to
    the activation dtype: the reference's ``preferred_element_type``.
    Torch multiplies no bf16 activation by an f32 weight, so a bf16
    activation is cast up first, which is the reference's promotion;
    where the reference asks for a bf16 result of a bf16 activation
    (the output projections), XLA rounds the weight to bf16 first, and
    so does :func:`_matmul_to`.  TF32 stays off (``torch.backends.cuda.matmul.allow_tf32`` is left at
    its default, ``False``).

``gelu`` is the tanh approximation, the default of ``jax.nn.gelu``.

Under a :class:`~repro_torch.distributed.tensor_parallel.Placement`
(``place=``) whose specs split a leaf over "model", the embedding and the
logits are vocab-parallel (each rank its rows of the table) and the MLP
is column- then row-parallel, its partial products summed in float32
before the cast.  Without one, or on a one-rank axis, each runs whole.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.tensor_parallel import copy_to, reduce_from

__all__ = [
    "init_linear",
    "linear",
    "init_norm",
    "rms_norm",
    "layer_norm",
    "apply_norm",
    "init_embedding",
    "embed",
    "unembed",
    "rope",
    "init_mlp",
    "mlp",
    "gelu",
]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _device(gen: Optional[torch.Generator]) -> torch.device:
    return torch.device("meta") if gen is None else gen.device


def _normal(gen: Optional[torch.Generator], shape: Tuple[int, ...]) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)


def _he(gen, shape, scale_axis=0):
    fan_in = shape[scale_axis]
    return _normal(gen, shape) * float(np.float32(1.0) / np.sqrt(np.float32(fan_in)))


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def _matmul_f32(a: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """:func:`_matmul_to` before its cast: the float32 product."""
    if a.dtype == dtype:
        w = w.to(dtype)
    return _f32(a) @ _f32(w)


def _matmul_to(a: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum(a, w, preferred_element_type=dtype)`` for an f32 weight
    ``w``, accumulated in f32 and cast to ``dtype``.  Where ``a`` is
    already in a narrower ``dtype`` (bf16), XLA multiplies in that dtype:
    the weight is rounded to it first, so it is here too (a no-op at
    f32)."""
    return _matmul_f32(a, w, dtype).to(dtype)


def _row_parallel(a: torch.Tensor, w: torch.Tensor, dtype, axis) -> torch.Tensor:
    """:func:`_matmul_to` of a row-parallel weight: this rank's float32
    partial product summed over ``axis``, then cast."""
    return reduce_from(_matmul_f32(a, w, dtype), axis).to(dtype)


# ---------------------------------------------------------------------------
# Linear / norm / embedding
# ---------------------------------------------------------------------------


def init_linear(gen, d_in: int, d_out: int, *, bias: bool = False):
    """``{"w": (d_in, d_out)}`` He-initialized on ``gen``'s device, with a
    zero ``"b": (d_out,)`` when ``bias``."""
    p = {"w": _he(gen, (d_in, d_out))}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=_device(gen))
    return p


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` accumulated in float32 and cast to ``x.dtype``."""
    y = _matmul_to(x, p["w"], torch.float32)
    if "b" in p:
        y = y + p["b"]
    return y.to(x.dtype)


def init_norm(d: int, *, kind: str = "rms", gen: Optional[torch.Generator] = None):
    """Unit scale (and zero bias for ``kind="layer"``) on ``gen``'s device
    (the meta device when ``gen`` is ``None``)."""
    dev = _device(gen)
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=dev)}
    if kind == "layer":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=dev)
    return p


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = _f32(x)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = _f32(x)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def apply_norm(p, x, *, kind: str = "rms"):
    return rms_norm(p, x) if kind == "rms" else layer_norm(p, x)


def init_embedding(gen, vocab: int, d: int):
    return {"table": _normal(gen, (vocab, d)) * 0.02}


def _vocab_axis(place):
    """The model axis when ``place`` splits the table's rows, else None."""
    return place.model if place is not None and place.split("table", 0) else None


def embed(p, tokens: torch.Tensor, dtype=torch.float32, place=None) -> torch.Tensor:
    """The table's rows of ``tokens``; vocab-parallel, each rank looks up
    the tokens in its rows (zeros elsewhere) and the ranks' rows are
    summed."""
    axis = _vocab_axis(place)
    if axis is None:
        return p["table"][tokens.long()].to(dtype)
    rows = p["table"].shape[0]
    local = tokens.long() - axis.rank * rows
    inside = (local >= 0) & (local < rows)
    found = p["table"][local.clamp(0, rows - 1)] * inside[..., None]
    return reduce_from(found, axis).to(dtype)


def unembed(p, x: torch.Tensor, place=None) -> torch.Tensor:
    """Tied logits projection: (B, S, d) @ table^T -> (B, S, V), f32;
    vocab-parallel, this rank's (B, S, V / tp) columns."""
    return copy_to(_f32(x), _vocab_axis(place)) @ p["table"].T


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10_000.0
         ) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, D), positions: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    pos = positions.to(torch.float32)
    if positions.dim() == 1:
        ang = (pos[:, None] * freq[None, :])[None, :, None, :]  # (1, S, 1, half)
    else:
        ang = (pos[..., None] * freq)[:, :, None, :]  # (B, S, 1, half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain GELU)
# ---------------------------------------------------------------------------


def init_mlp(gen, d: int, d_ff: int, *, kind: str = "swiglu"):
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": _he(gen, (d, d_ff)),
            "w_up": _he(gen, (d, d_ff)),
            "w_down": _he(gen, (d_ff, d)),
        }
    return {"w_up": _he(gen, (d, d_ff)), "w_down": _he(gen, (d_ff, d))}


def mlp(p, x: torch.Tensor, *, kind: str = "swiglu", place=None) -> torch.Tensor:
    """The MLP; column-parallel ``w_gate``/``w_up`` and row-parallel
    ``w_down`` where ``place`` splits ``d_ff``."""
    axis = place.model if place is not None and place.split("w_up", 1) else None
    x32 = copy_to(_f32(x), axis)
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else gelu
        g = act(x32 @ p["w_gate"])
        u = x32 @ p["w_up"]
        h = (g * u).to(x.dtype)
    else:
        h = gelu(x32 @ p["w_up"]).to(x.dtype)
    if axis is not None:
        return _row_parallel(h, p["w_down"], x.dtype, axis)
    return _matmul_to(h, p["w_down"], x.dtype)
