"""Serving driver: prefill/decode step factories + continuous batching.

Counterpart of ``repro.serving.serve_loop``.  ``make_serve_fns`` returns
the step functions; :class:`ServeLoop` is the host-side driver of
continuous batching over fixed decode slots:

  * **Per-slot prefill** — admission runs the new request's prompt as a
    batch-1 prefill and copies the resulting cache into ONLY its own
    batch row (``LM.insert_slot_caches``).
  * **Per-slot positions** — every decode step carries a (B,) position
    vector, so requests with different prompt lengths each attend at
    their own position.
  * **Sampling on the device** — batched greedy (``argmax``: the first
    maximum, as in the reference) or a max-subtracted Gumbel-max at
    temperature > 0, each row with noise from a ``torch.Generator``
    seeded from (seed, request id, token index): a request's sampled
    continuation is independent of what else shares the batch.  It
    cannot equal ``jax.random``'s draws.
  * **Bounded admission queue with counted load-shed**, per-request
    deadlines, ``cancel``, and fault containment at three sites
    (``serve.admit``, ``serve.decode``, ``serve.slot``): every request
    terminates with exactly one ``RequestResult`` (DONE / FAILED /
    TIMEOUT / SHED / CANCELLED).

The decode writes each layer's new K/V into the caches in place (the
reference rebinds new ones after a step succeeds) and returns every
recurrent state as a new tensor (``transformer.stack_decode``); the loop
rebinds ``self.caches`` only after the step and the sampler succeeded.
A batched-decode fault still leaves the step repeatable: the retried
step writes the same K/V values into the same cells before reading them
(``attention.decode_step``) and starts from the states the failed step
did not touch, so it gives the bits of a step that never failed.
Per-request outputs are bit-identical to a solo run of the same request
on an engine of the same batch: decode compute is row-independent at a
fixed batch shape and admission writes are slot-local.  For MoE stacks
this holds at a batch of at most ``MoESpec.min_capacity`` (4): no expert
can then receive more tokens than its capacity, so no pair is dropped;
at a larger batch co-scheduled requests compete for capacity, as in the
reference.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.packing import resolve_device
from ..models.model_zoo import LM
from ..resilience import faults
from ..resilience.fallback import fallback_counters
from ..resilience.lifecycle import RequestResult, RequestStatus
from .gust_serve import GustServeConfig, decode_step_gust, gustify

__all__ = [
    "ServeConfig",
    "make_serve_fns",
    "make_sampler",
    "ServeLoop",
    "RequestResult",
    "RequestStatus",
]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int
    seq_len: int  # cache capacity
    dtype: str = "bfloat16"
    temperature: float = 0.0  # 0 = greedy
    eos_id: Optional[int] = None  # retire a slot when it samples this token
    queue_capacity: int = 64  # bounded admission queue (full -> counted SHED)
    gust: Optional[GustServeConfig] = None  # None = dense decode
    # default per-request deadlines (enqueue/submit may override per
    # request); None = unbounded.  max_steps_per_request counts decode
    # steps while admitted; max_seconds_per_request is a wall budget.
    max_steps_per_request: Optional[int] = None
    max_seconds_per_request: Optional[float] = None
    # consecutive contained decode-step failures tolerated before the
    # active set is retired FAILED instead of retrying forever
    max_step_failures: int = 8

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def make_serve_fns(lm: LM, cfg: ServeConfig, gust_tree=None, *, device="cuda"):
    """Returns (prefill_fn, decode_fn, init_caches_fn).

    ``init_caches_fn`` takes an optional batch override (the serve loop
    prefills new requests at batch=1) and allocates on ``device``;
    ``decode_fn`` takes ``pos`` as a (B,) vector of per-slot positions.
    The GUST decode runs the per-layer plans that ``gustify`` built.
    """
    dtype = cfg.torch_dtype
    device = resolve_device(device)

    def init_caches(batch: Optional[int] = None):
        return lm.init_caches(batch or cfg.batch, cfg.seq_len, dtype, device=device)

    def prefill_fn(params, batch, caches):
        return lm.prefill(params, batch, caches, dtype=dtype)

    if cfg.gust is not None:
        if gust_tree is None:
            raise ValueError("gust serving requires a gustify() tree")

        def decode_fn(params, caches, tokens, pos):
            return decode_step_gust(lm, params, gust_tree, caches, tokens, pos,
                                    dtype=dtype)
    else:

        def decode_fn(params, caches, tokens, pos):
            return lm.decode_step(params, caches, tokens, pos, dtype=dtype)

    return prefill_fn, decode_fn, init_caches


def _row_seed(seed: int, rid: int, step: int) -> int:
    """A 63-bit generator seed keyed on (seed, request id, token index)."""
    state = np.random.SeedSequence([seed, rid, step]).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


def make_sampler(temperature: float) -> Callable:
    """Batched sampler on the logits' device:
    (logits (B, V), seed, rid_step (B, 2) ints) -> (B,) int32 tensor.

    Greedy at ``temperature <= 0`` (``argmax``, the first maximum).  The
    temperature path subtracts the per-row max before scaling, so logits
    of magnitude ~1e3+ stay finite, and samples by the Gumbel-max trick,
    which never exponentiates the logits: row r adds Gumbel noise drawn
    from a generator seeded by ``(seed, rid_step[r, 0], rid_step[r, 1])``
    and takes the argmax.
    """

    def sample(logits, seed, rid_step):
        logits = logits.float()
        if temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        z = (logits - logits.amax(dim=-1, keepdim=True)) / temperature
        rows = []
        for r, (rid, step) in enumerate(np.asarray(rid_step).tolist()):
            gen = torch.Generator(device=z.device).manual_seed(_row_seed(seed, rid, step))
            u = torch.rand(z.shape[-1], generator=gen, device=z.device)
            gumbel = -torch.log(-torch.log(u))
            rows.append(torch.argmax(z[r] + gumbel))
        return torch.stack(rows).to(torch.int32)

    return sample


@dataclasses.dataclass
class _Slot:
    active: bool = False
    request_id: int = -1
    pos: int = 0
    generated: Optional[List[int]] = None
    max_new: int = 0
    steps: int = 0  # decode steps taken while this request held the slot
    deadline_steps: Optional[int] = None
    deadline_s: Optional[float] = None
    admitted_t: float = 0.0


class ServeLoop:
    """Host-side continuous-batching driver over fixed decode slots, on
    the device of ``params``.

    Requests are (prompt_tokens, max_new_tokens).  ``submit`` admits
    immediately into a free slot (raising when none is free);
    ``enqueue`` parks the request in the bounded admission queue and
    ``step``/``run_to_completion`` admit as slots free up.  Each
    admission prefills ONLY its own slot (batch-1 prefill + slot-local
    cache insert) and each decode step advances every active slot one
    token at that slot's own position.
    """

    def __init__(self, lm: LM, params, cfg: ServeConfig, seed: int = 0):
        self.lm, self.params, self.cfg = lm, params, cfg
        self.device = params["embed"]["table"].device
        gust_tree = None
        if cfg.gust is not None:
            gust_tree = gustify(lm, params, cfg.gust)
        self.gust_tree = gust_tree
        self._prefill, self._decode, init = make_serve_fns(
            lm, cfg, gust_tree, device=self.device)
        self._insert = lm.insert_slot_caches
        self._sampler = make_sampler(cfg.temperature)
        self.caches = init()
        # batch-1 cache template reused by every admission (prefill does
        # not write its input cache)
        self._cache_template_b1 = init(1)
        self.slots = [_Slot() for _ in range(cfg.batch)]
        self._base_key = seed
        self._next_id = 0
        self.pending: Deque[Tuple] = collections.deque()
        self.completed: Dict[int, List[int]] = {}
        self.results: Dict[int, RequestResult] = {}
        self._decode_failures = 0  # consecutive contained step failures
        self.stats = {
            "decode_steps": 0, "active_slot_steps": 0, "prefills": 0,
            "done": 0, "failed": 0, "timeouts": 0, "shed": 0,
            "cancelled": 0, "decode_retries": 0,
        }

    # -- lifecycle bookkeeping ---------------------------------------------
    def _retire(
        self,
        rid: int,
        status: RequestStatus,
        tokens: Optional[List[int]] = None,
        *,
        reason: str = "",
        steps: int = 0,
    ) -> RequestResult:
        """Record the one terminal result for ``rid`` (first status
        wins) and bump its status counter; DONE also lands in
        ``completed``."""
        if rid in self.results:
            return self.results[rid]
        res = RequestResult(rid, status, list(tokens or []), reason, steps)
        self.results[rid] = res
        key = {
            RequestStatus.DONE: "done",
            RequestStatus.FAILED: "failed",
            RequestStatus.TIMEOUT: "timeouts",
            RequestStatus.SHED: "shed",
            RequestStatus.CANCELLED: "cancelled",
        }[status]
        self.stats[key] = self.stats.get(key, 0) + 1
        if status is RequestStatus.DONE:
            self.completed[rid] = res.tokens
        return res

    # -- admission ---------------------------------------------------------
    def enqueue(
        self,
        prompt: np.ndarray,
        max_new: int,
        *,
        deadline_steps: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> int:
        """Park one request in the bounded admission queue.  Returns id.
        At ``queue_capacity`` the request is load-shed: it gets an id and
        terminates at once with a counted ``status=SHED`` result."""
        rid = self._next_id
        self._next_id += 1
        if len(self.pending) >= self.cfg.queue_capacity:
            self._retire(
                rid, RequestStatus.SHED,
                reason=f"admission queue full (capacity {self.cfg.queue_capacity})",
            )
            return rid
        self.pending.append((
            rid, np.asarray(prompt, np.int32), int(max_new),
            deadline_steps, deadline_s,
        ))
        return rid

    def submit(
        self,
        prompt: np.ndarray,
        max_new: int,
        *,
        deadline_steps: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> int:
        """Admit one request into a free slot NOW; runs its prefill.
        Raises when no slot is free; an admission *fault* retires the
        request FAILED instead of propagating."""
        free = [i for i, s in enumerate(self.slots) if not s.active]
        if not free:
            raise RuntimeError("no free slots")
        rid = self._next_id
        self._next_id += 1
        try:
            self._admit(
                free[0], rid, np.asarray(prompt, np.int32), int(max_new),
                deadline_steps, deadline_s,
            )
        except Exception as err:  # contained: only this request fails
            self._retire(
                rid, RequestStatus.FAILED, reason=f"admission failed: {err!r}"
            )
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a pending or active request: it retires CANCELLED
        (keeping any tokens generated so far) and frees its slot.  False
        when ``rid`` is unknown or already terminal."""
        if rid in self.results:
            return False
        for entry in self.pending:
            if entry[0] == rid:
                self.pending.remove(entry)
                self._retire(rid, RequestStatus.CANCELLED, reason="cancelled while queued")
                return True
        for i, s in enumerate(self.slots):
            if s.active and s.request_id == rid:
                self._retire(
                    rid, RequestStatus.CANCELLED, s.generated,
                    reason="cancelled while active", steps=s.steps,
                )
                self.slots[i] = _Slot()
                return True
        return False

    def _admit(
        self,
        i: int,
        rid: int,
        prompt: np.ndarray,
        max_new: int,
        deadline_steps: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ):
        """Per-slot prefill at the prompt's exact length (what keeps
        admission bit-identical to a solo run) + slot-local cache copy."""
        faults.trip("serve.admit", tag=str(rid))
        tokens = torch.from_numpy(prompt).to(self.device)[None]
        logits, one = self._prefill(self.params, {"tokens": tokens},
                                    self._cache_template_b1)
        self.caches = self._insert(self.caches, one, i)
        first = int(self._sample_rows(logits[:, -1], [(rid, 0)])[0])
        self.stats["prefills"] += 1
        slot = _Slot(
            True, rid, int(prompt.shape[0]), [first], max_new,
            deadline_steps=(
                deadline_steps if deadline_steps is not None
                else self.cfg.max_steps_per_request
            ),
            deadline_s=(
                deadline_s if deadline_s is not None
                else self.cfg.max_seconds_per_request
            ),
            admitted_t=time.monotonic(),
        )
        if self._finished(slot, first):
            self._retire(rid, RequestStatus.DONE, slot.generated)
        else:
            self.slots[i] = slot

    def _admit_from_queue(self):
        free = [i for i, s in enumerate(self.slots) if not s.active]
        while free and self.pending:
            rid, prompt, max_new, dl_steps, dl_s = self.pending.popleft()
            try:
                self._admit(free.pop(0), rid, prompt, max_new, dl_steps, dl_s)
            except Exception as err:
                # Contained: a faulted admission retires ONLY this request
                # (its slot was never activated, and a partial copy into an
                # inactive row cannot reach other rows: attention is per-row).
                self._retire(
                    rid, RequestStatus.FAILED,
                    reason=f"admission failed: {err!r}",
                )
            # _admit may complete the request at once (EOS/max_new=0),
            # leaving the slot free: recompute
            free = [i for i, s in enumerate(self.slots) if not s.active]

    # -- sampling ----------------------------------------------------------
    def _sample_rows(self, logits_rows, rid_step: List[Tuple[int, int]]) -> np.ndarray:
        """One token per row; ``rid_step[r] = (request_id, token index)``
        keys row r's draw, so each request's sampled continuation is
        independent of which other requests share the batch."""
        return self._sampler(logits_rows, self._base_key, rid_step).cpu().numpy()

    def _finished(self, slot: _Slot, token: int) -> bool:
        if self.cfg.eos_id is not None and token == self.cfg.eos_id:
            return True
        return len(slot.generated) >= slot.max_new + 1

    # -- decode ------------------------------------------------------------
    def _expire_deadlines(self):
        """Retire every active slot whose decode-step or wall budget has
        expired: TIMEOUT with the tokens generated so far."""
        now = time.monotonic()
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            over_steps = s.deadline_steps is not None and s.steps >= s.deadline_steps
            over_wall = s.deadline_s is not None and now - s.admitted_t >= s.deadline_s
            if over_steps or over_wall:
                why = (
                    f"step budget {s.deadline_steps} exhausted" if over_steps
                    else f"wall budget {s.deadline_s}s exhausted"
                )
                self._retire(
                    s.request_id, RequestStatus.TIMEOUT, s.generated,
                    reason=why, steps=s.steps,
                )
                self.slots[i] = _Slot()

    def step(self) -> int:
        """Admit from the queue, then one decode step for all active
        slots (each at its own position); returns #active after
        retirement.

        No exception escapes: admission faults retire one request, and a
        batched decode/sample fault is contained HERE — the step is
        repeated next call and gives the bits of a step that never failed
        (module docstring).  After ``cfg.max_step_failures`` consecutive
        contained failures the active set retires FAILED instead of
        spinning.
        """
        self._admit_from_queue()
        self._expire_deadlines()
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return 0
        toks = np.zeros((self.cfg.batch, 1), np.int32)
        pos = np.zeros((self.cfg.batch,), np.int32)
        for i in active:
            toks[i, 0] = self.slots[i].generated[-1]
            pos[i] = self.slots[i].pos
        try:
            faults.trip("serve.decode")
            logits, new_caches = self._decode(
                self.params, self.caches, torch.from_numpy(toks).to(self.device),
                torch.from_numpy(pos).to(self.device),
            )
            sampled = self._sample_rows(
                logits[:, 0],
                [
                    # inactive rows sample garbage that is discarded
                    (s.request_id, len(s.generated)) if s.active else (0, 0)
                    for s in self.slots
                ],
            )
        except Exception as err:  # sanctioned containment (the reference's)
            self.stats["decode_retries"] = self.stats.get("decode_retries", 0) + 1
            self._decode_failures += 1
            if self._decode_failures >= self.cfg.max_step_failures:
                for i in active:
                    s = self.slots[i]
                    self._retire(
                        s.request_id, RequestStatus.FAILED, s.generated,
                        reason=(
                            f"decode failed {self._decode_failures} "
                            f"consecutive steps: {err!r}"
                        ),
                        steps=s.steps,
                    )
                    self.slots[i] = _Slot()
                self._decode_failures = 0
            return len([s for s in self.slots if s.active])
        self._decode_failures = 0
        self.caches = new_caches
        self.stats["decode_steps"] += 1
        self.stats["active_slot_steps"] += len(active)
        for i in active:
            s = self.slots[i]
            try:
                faults.trip("serve.slot", tag=str(s.request_id))
                tok = int(sampled[i])
                s.generated.append(tok)
                s.pos += 1
                s.steps += 1
                if self._finished(s, tok):
                    self._retire(
                        s.request_id, RequestStatus.DONE, s.generated,
                        steps=s.steps,
                    )
                    self.slots[i] = _Slot()
            except Exception as err:  # contained: one slot, one request
                self._retire(
                    s.request_id, RequestStatus.FAILED, s.generated,
                    reason=f"slot fault: {err!r}", steps=s.steps,
                )
                self.slots[i] = _Slot()
        return len([s for s in self.slots if s.active])

    @property
    def occupancy(self) -> float:
        """Mean fraction of decode-slot work spent on live requests."""
        steps = self.stats["decode_steps"]
        if steps == 0:
            return 0.0
        return self.stats["active_slot_steps"] / (steps * self.cfg.batch)

    def resilience_stats(self) -> Dict[str, int]:
        """Lifecycle + degradation counters in one snapshot: terminal
        statuses, contained decode retries, and the process-wide
        fallback counters."""
        out = {
            k: self.stats.get(k, 0)
            for k in (
                "done", "failed", "timeouts", "shed", "cancelled",
                "decode_retries",
            )
        }
        out.update({f"fallback_{k}": v for k, v in fallback_counters.items()})
        return out

    def run_to_completion(self, max_steps: int = 10_000):
        """Drain the admission queue and every active slot (bounded)."""
        for _ in range(max_steps):
            if self.step() == 0 and not self.pending:
                return
