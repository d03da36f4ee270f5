"""ArchConfig -> model: init / forward / prefill / decode.

Counterpart of ``repro.models.model_zoo``.  :class:`LM` owns no tensors:
it holds the stack config derived from an ``ArchConfig`` and runs over a
parameter tree that :meth:`LM.init` draws from a ``torch.Generator`` (or
that :func:`repro_torch.core.convert.from_reference_params` carries
across from the reference), with the reference's names and nesting.

Frontends: ``token`` (an ordinary token LM), ``embed`` (llava: the
prompt arrives as precomputed embeddings (B, S, d); decode continues from
the token table) and ``encdec`` (seamless: an encoder over precomputed
source frames (B, S_enc, d), the speech frontend being a stub, then a
decoder over tokens with cross-attention into the encoder's memory).
Every block kind runs: dense attention + MLP, MoE (llama4, dbrx), RG-LRU
(recurrentgemma), mLSTM/sLSTM (xlstm), ``enc`` and ``xattn`` (seamless).
Training's loss is :meth:`LM.loss_fn` over :func:`softmax_xent`, its
gradients autograd's through ``train_logits`` (with ``remat``, one
activation checkpoint per pattern repetition and tail block).  On a
sharded train state the same loss runs under the state's placement
(``place=``: ``distributed/tensor_parallel.py``): the embedding and the
logits vocab-parallel, the blocks tensor and expert parallel, the stacks'
leaves gathered over "data" per block.  Serving on a sharded state
(``serving.shard_serve_state``) runs :meth:`LM.prefill` and
:meth:`LM.decode_step` the same way under its serving placement, over
this rank's shard of the caches, under ``torch.no_grad()``: they take the
whole batch, run this data rank's rows, and return those rows' logits
gathered whole over "model".
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..core.packing import resolve_device
from ..distributed.tensor_parallel import all_reduce_max, gather_from, reduce_from, sub
from . import transformer as T
from .layers import _vocab_axis, apply_norm, embed, init_embedding, init_norm, unembed
from .tree import tree_leaves, tree_map

__all__ = ["LM", "build_model", "softmax_xent"]


def softmax_xent(logits, labels, mask, z_coef: float = 1e-4, denom=None, vocab=None):
    """Masked mean cross-entropy plus z-loss, in float32.  Returns (loss,
    ``{"xent"}``).  The gold logit is gathered (the reference selects it
    with an iota compare and a sum over the vocabulary: the same value).
    ``denom`` is the mask count to divide by (default ``mask.sum()``): a
    data-parallel rank passes the count over every rank's rows, so that
    the ranks' losses add up to the global masked mean.  ``vocab`` (a
    model axis) says that ``logits`` are this rank's columns of a
    vocab-parallel projection: the max, the sum of exponentials and the
    gold logit are then reduced over its ranks, so ``logz`` (and the
    z-loss) are the whole vocabulary's."""
    logits = logits.float()
    if vocab is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        cols = logits.shape[-1]
        top = all_reduce_max(logits.detach().amax(dim=-1), vocab)
        logz = torch.log(reduce_from(torch.exp(logits - top[..., None]).sum(-1), vocab)) + top
        local = labels.long() - vocab.rank * cols
        inside = (local >= 0) & (local < cols)
        mine = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])[..., 0]
        gold = reduce_from(mine * inside, vocab)
    xent = logz - gold
    zloss = z_coef * (logz ** 2)
    denom = torch.clamp(mask.sum() if denom is None else denom, min=1.0)
    loss = ((xent + zloss) * mask).sum() / denom
    return loss, {"xent": (xent * mask).sum() / denom}


class LM(torch.nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.stack = T.make_stack_cfg(cfg, cfg.pattern, cfg.n_layers)
        if cfg.is_encdec:
            self.enc_stack = T.make_stack_cfg(cfg, ("enc",), cfg.n_enc_layers)
            self.dec_stack = T.make_stack_cfg(cfg, ("xattn",), cfg.n_layers)
        else:
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
        }
        if cfg.is_encdec:
            p["encoder"] = T.init_stack(gen, self.enc_stack)
            p["enc_norm"] = init_norm(cfg.d_model, kind=cfg.norm_kind, gen=gen)
            p["decoder"] = T.init_stack(gen, self.dec_stack)
        else:
            p["stack"] = T.init_stack(gen, self.stack)
        if not cfg.tie_embeddings:
            p["lm_head"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model)
        if gen is None:
            return p
        device = _resolve(device)
        return tree_map(lambda a: a.to(device), p)

    def param_count(self, params) -> int:
        return sum(x.numel() for x in tree_leaves(params))

    # -- helpers -----------------------------------------------------------
    def _embed_tokens(self, params, tokens, dtype, place=None):
        x = embed(params["embed"], tokens, dtype, place=sub(place, "embed"))
        if self.cfg.emb_scale:
            scale = torch.sqrt(torch.tensor(float(self.cfg.d_model), dtype=torch.float32))
            x = x * scale.to(dtype=dtype, device=x.device)
        return x

    def _head(self, params) -> str:
        return "lm_head" if "lm_head" in params else "embed"

    def _logits(self, params, x, place=None):
        """(B, S, padded_vocab) f32 logits; vocab-parallel under ``place``,
        this rank's columns (the padding mask at their global indices)."""
        x = apply_norm(params["final_norm"], x, kind=self.cfg.norm_kind)
        head = sub(place, self._head(params))
        logits = unembed(params[self._head(params)], x, place=head)
        if self.cfg.padded_vocab != self.cfg.vocab:
            axis = _vocab_axis(head)
            start = 0 if axis is None else axis.rank * logits.shape[-1]
            vocab = start + torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(vocab < self.cfg.vocab, logits,
                                 torch.tensor(-1e30, device=logits.device))
        return logits

    def _whole_logits(self, params, x, place=None):
        """:meth:`_logits` gathered whole over "model" (serving: a sampler
        can run on any rank)."""
        logits = self._logits(params, x, place)
        return gather_from(logits, -1, _vocab_axis(sub(place, self._head(params))))

    def _inputs(self, params, batch, dtype, place=None):
        if self.cfg.frontend == "embed":
            return batch["embeds"].to(dtype)
        return self._embed_tokens(params, batch["tokens"], dtype, place)

    def _encode(self, params, src_frames, remat=False, place=None):
        """The encoder's memory (B, S_enc, d) from the source frames."""
        h, _ = T.stack_train(params["encoder"], src_frames, self.enc_stack, remat=remat,
                             place=sub(place, "encoder"))
        return apply_norm(params["enc_norm"], h, kind=self.cfg.norm_kind)

    def _serve_stack(self) -> T.StackCfg:
        return self.dec_stack if self.cfg.is_encdec else self.stack

    def _stack_key(self) -> str:
        return "decoder" if self.cfg.is_encdec else "stack"

    def _stack_params(self, params):
        return params[self._stack_key()]

    def _memory(self, params, batch, dtype, remat=False, place=None):
        """The encoder's memory for an encdec batch, else None."""
        if not self.cfg.is_encdec:
            return None
        return self._encode(params, batch["src_frames"].to(dtype), remat, place)

    # -- forward -----------------------------------------------------------
    def train_logits(self, params, batch, *, dtype=torch.bfloat16, remat=False, place=None):
        """Full-sequence logits (B, S, padded_vocab) in f32 and the aux
        loss: the MoE blocks' aux summed over the stack (0.0 for a stack
        without MoE).  An encdec batch holds ``src_frames`` (B, S_enc, d)
        and the decoder's ``tokens``.  ``remat`` checkpoints the stacks'
        activations for a backward pass (the values are the same).
        ``place`` (a sharded state's placement over ``params``, this rank's
        shards) runs the model parallel: the logits are then this rank's
        vocab columns."""
        memory = self._memory(params, batch, dtype, remat, place)
        x = self._inputs(params, batch, dtype, place)
        x, aux = T.stack_train(self._stack_params(params), x, self._serve_stack(), memory,
                               remat=remat, place=sub(place, self._stack_key()))
        return self._logits(params, x, place), aux

    def forward(self, params, batch, *, dtype=torch.bfloat16):
        return self.train_logits(params, batch, dtype=dtype)

    # -- training ----------------------------------------------------------
    def loss_fn(self, params, batch, *, dtype=torch.bfloat16, remat=True, denom=None,
                shards: int = 1, place=None):
        """(total, metrics): the masked cross-entropy and z-loss of
        ``batch["labels"]`` under ``batch["loss_mask"]``, plus ``1e-2`` times
        the MoE aux loss; the metrics carry ``xent`` and ``aux``.  A
        data-parallel rank, one of ``shards``, passes ``denom``, the mask
        count over every rank's rows: its cross-entropy is its rows' masked
        sum over ``denom`` and its aux weighs ``1/shards``, so that the
        ranks' totals add up to the global masked mean plus the mean of the
        ranks' aux losses.  ``place``: the placement of a sharded state's
        ``params`` (:meth:`train_logits`); the loss is the same on every
        model rank."""
        logits, aux = self.train_logits(params, batch, dtype=dtype, remat=remat, place=place)
        vocab = _vocab_axis(sub(place, self._head(params)))
        loss, metrics = softmax_xent(logits, batch["labels"], batch["loss_mask"], denom=denom,
                                     vocab=vocab)
        total = loss + 1e-2 * (aux / shards)
        metrics["aux"] = aux
        return total, metrics

    # -- serving -----------------------------------------------------------
    def init_caches(self, batch: int, seq_len: int, dtype=torch.bfloat16, device="cuda"):
        """Zeroed caches on ``device`` (``"meta"``: shapes only); an
        encdec model's are the decoder's, with the memory's ``ck``/``cv``
        at ``enc_seq`` frames."""
        return T.init_stack_caches(self._serve_stack(), batch, seq_len, dtype,
                                   _resolve(device))

    def insert_slot_caches(self, caches, one, slot):
        """Slot-local admission, in place: write batch row 0 of the
        batch-1 cache tree ``one`` (a fresh per-request prefill) into
        batch row ``slot`` of ``caches``.  No other slot is touched."""
        return T.insert_slot_caches(caches, one, slot)

    def prefill(self, params, batch, caches, *, dtype=torch.bfloat16, place=None):
        """Process the prompt; returns (last-position logits, new caches).
        ``caches`` is not written.  An encdec prompt is ``src_frames`` and
        ``tokens``: the encoder runs once here, and its memory's K/V go
        into the new caches.  ``place``: a sharded serve state's placement
        (``params`` and ``caches`` this rank's shards, ``batch`` the whole
        batch): the logits are this data rank's rows, every column."""
        if place is None:
            return self._prefill(params, batch, caches, dtype, None)
        with torch.no_grad():
            batch = {k: place.take_rows(v) for k, v in batch.items()}
            return self._prefill(params, batch, caches, dtype, place)

    def _prefill(self, params, batch, caches, dtype, place):
        memory = self._memory(params, batch, dtype, place=None if place is None else place.at(None))
        x = self._inputs(params, batch, dtype, place)
        x, caches = T.stack_prefill(self._stack_params(params), x, self._serve_stack(),
                                    caches, memory, place=sub(place, self._stack_key()))
        return self._whole_logits(params, x[:, -1:], place), caches

    def decode_step(self, params, caches, tokens, pos, *, dtype=torch.bfloat16, place=None):
        """One token for every sequence.  tokens: (B, 1) int; ``pos`` a
        scalar or a (B,) vector of per-sequence positions.  Returns
        (logits (B, 1, V), the new cache tree): attention K/V is written
        into ``caches`` in place, recurrent states come back as new
        tensors and ``caches`` keeps the old ones
        (``transformer.stack_decode``).  ``place``: as :meth:`prefill`'s
        (``tokens`` and ``pos`` the whole batch's)."""
        if place is None:
            return self._decode(params, caches, tokens, pos, dtype, None)
        with torch.no_grad():
            return self._decode(params, caches, place.take_rows(tokens), pos, dtype, place)

    def _decode(self, params, caches, tokens, pos, dtype, place):
        x = self._embed_tokens(params, tokens, dtype, place)
        x, caches = T.stack_decode(self._stack_params(params), x, self._serve_stack(),
                                   caches, pos, place=sub(place, self._stack_key()))
        return self._whole_logits(params, x, place), caches

    # -- input specs (meta tensors for the dry-run account) ------------------
    def input_specs(self, seq_len: int, batch: int, kind: str) -> Dict:
        """Meta-device stand-ins for every model input of a shape cell
        (``kind``: ``train``, ``prefill`` or ``decode``), with the
        reference's dtypes: bf16 ``embeds`` / ``src_frames``, int32 tokens
        and labels, f32 ``loss_mask``."""
        cfg = self.cfg

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        i32 = torch.int32
        if kind in ("train", "prefill"):
            specs: Dict = {}
            if cfg.frontend == "embed":
                specs["embeds"] = meta((batch, seq_len, cfg.d_model), torch.bfloat16)
            elif cfg.is_encdec:
                enc_s = min(seq_len, cfg.enc_seq or seq_len)
                specs["src_frames"] = meta((batch, enc_s, cfg.d_model), torch.bfloat16)
                specs["tokens"] = meta((batch, seq_len), i32)
            else:
                specs["tokens"] = meta((batch, seq_len), i32)
            if kind == "train":
                specs["labels"] = meta((batch, seq_len), i32)
                specs["loss_mask"] = meta((batch, seq_len), torch.float32)
            return specs
        if kind == "decode":
            return {"tokens": meta((batch, 1), i32)}
        raise ValueError(kind)


def _resolve(device) -> torch.device:
    """The port's device rule (a named card must exist), with the meta
    device allowed for shape-only trees."""
    device = torch.device(device)
    return device if device.type == "meta" else resolve_device(device)


def build_model(cfg: ArchConfig) -> LM:
    return LM(cfg)
