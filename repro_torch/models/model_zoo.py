"""ArchConfig -> model: init / forward / prefill / decode.

Counterpart of ``repro.models.model_zoo``.  :class:`LM` owns no tensors:
it holds the stack config derived from an ``ArchConfig`` and runs over a
parameter tree that :meth:`LM.init` draws from a ``torch.Generator`` (or
that :func:`repro_torch.core.convert.from_reference_params` carries
across from the reference), with the reference's names and nesting.

Frontends: ``token`` (an ordinary token LM) and ``embed`` (llava: the
prompt arrives as precomputed embeddings (B, S, d); decode continues from
the token table).  Every block kind of the decoder-only archs runs:
dense attention + MLP, MoE (llama4, dbrx), RG-LRU (recurrentgemma) and
mLSTM/sLSTM (xlstm).  The ``encdec`` frontend and its ``enc``/``xattn``
blocks (seamless) raise ``NotImplementedError`` (ROADMAP §1 item 5).
Training's loss (``loss_fn``, ``softmax_xent``) comes with the training
slice; the forward, ``train_logits``, is here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..core.packing import resolve_device
from . import transformer as T
from .layers import apply_norm, embed, init_embedding, init_norm, unembed
from .tree import tree_leaves, tree_map

__all__ = ["LM", "build_model"]


class LM(torch.nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        if cfg.is_encdec:
            raise NotImplementedError(
                f"{cfg.name}: the encdec frontend is not ported yet (ROADMAP §1 "
                "item 5, with the enc/xattn blocks)"
            )
        self.cfg = cfg
        self.stack = T.make_stack_cfg(cfg, cfg.pattern, cfg.n_layers)
        for bc in self.stack.pattern:
            T.require_ported(bc)
        self.enc_stack = self.dec_stack = None

    # -- params ------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator], device="cuda") -> Dict:
        """Random parameters drawn from ``generator`` on its own device,
        then moved to ``device``.  With ``generator=None`` every leaf is a
        meta-device tensor of the right shape and dtype (no allocation)."""
        cfg, gen = self.cfg, generator
        p = {
            "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model),
            "final_norm": init_norm(cfg.d_model, kind=cfg.norm_kind, gen=gen),
            "stack": T.init_stack(gen, self.stack),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model)
        if gen is None:
            return p
        device = _resolve(device)
        return tree_map(lambda a: a.to(device), p)

    def param_count(self, params) -> int:
        return sum(x.numel() for x in tree_leaves(params))

    # -- helpers -----------------------------------------------------------
    def _embed_tokens(self, params, tokens, dtype):
        x = embed(params["embed"], tokens, dtype)
        if self.cfg.emb_scale:
            scale = torch.sqrt(torch.tensor(float(self.cfg.d_model), dtype=torch.float32))
            x = x * scale.to(dtype=dtype, device=x.device)
        return x

    def _logits(self, params, x):
        x = apply_norm(params["final_norm"], x, kind=self.cfg.norm_kind)
        table = params["lm_head" if "lm_head" in params else "embed"]
        logits = unembed(table, x)
        if self.cfg.padded_vocab != self.cfg.vocab:
            vocab = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(vocab < self.cfg.vocab, logits,
                                 torch.tensor(-1e30, device=logits.device))
        return logits

    def _inputs(self, params, batch, dtype):
        if self.cfg.frontend == "embed":
            return batch["embeds"].to(dtype)
        return self._embed_tokens(params, batch["tokens"], dtype)

    # -- forward -----------------------------------------------------------
    def train_logits(self, params, batch, *, dtype=torch.bfloat16):
        """Full-sequence logits (B, S, padded_vocab) in f32 and the aux
        loss: the MoE blocks' aux summed over the stack (0.0 for a stack
        without MoE)."""
        x = self._inputs(params, batch, dtype)
        x, aux = T.stack_train(params["stack"], x, self.stack)
        return self._logits(params, x), aux

    def forward(self, params, batch, *, dtype=torch.bfloat16):
        return self.train_logits(params, batch, dtype=dtype)

    # -- serving -----------------------------------------------------------
    def init_caches(self, batch: int, seq_len: int, dtype=torch.bfloat16, device="cuda"):
        """Zeroed caches on ``device`` (``"meta"``: shapes only)."""
        return T.init_stack_caches(self.stack, batch, seq_len, dtype, _resolve(device))

    def insert_slot_caches(self, caches, one, slot):
        """Slot-local admission, in place: write batch row 0 of the
        batch-1 cache tree ``one`` (a fresh per-request prefill) into
        batch row ``slot`` of ``caches``.  No other slot is touched."""
        return T.insert_slot_caches(caches, one, slot)

    def prefill(self, params, batch, caches, *, dtype=torch.bfloat16):
        """Process the prompt; returns (last-position logits, new caches).
        ``caches`` is not written."""
        x = self._inputs(params, batch, dtype)
        x, caches = T.stack_prefill(params["stack"], x, self.stack, caches)
        return self._logits(params, x[:, -1:]), caches

    def decode_step(self, params, caches, tokens, pos, *, dtype=torch.bfloat16):
        """One token for every sequence.  tokens: (B, 1) int; ``pos`` a
        scalar or a (B,) vector of per-sequence positions.  Returns
        (logits (B, 1, V), the new cache tree): attention K/V is written
        into ``caches`` in place, recurrent states come back as new
        tensors and ``caches`` keeps the old ones
        (``transformer.stack_decode``)."""
        x = self._embed_tokens(params, tokens, dtype)
        x, caches = T.stack_decode(params["stack"], x, self.stack, caches, pos)
        return self._logits(params, x), caches


def _resolve(device) -> torch.device:
    """The port's device rule (a named card must exist), with the meta
    device allowed for shape-only trees."""
    device = torch.device(device)
    return device if device.type == "meta" else resolve_device(device)


def build_model(cfg: ArchConfig) -> LM:
    return LM(cfg)
