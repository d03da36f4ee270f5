"""Deterministic synthetic token pipeline (counterpart of
``repro.data.pipeline``, numpy only: batch ``i`` is bit for bit the
reference's).

Production data pipelines (SSTable/ArrayRecord readers, shuffle buffers,
tokenizers) are host-side; what the training framework needs from them is a
deterministic, restartable, per-host-sharded stream of fixed-shape batches.
This module provides exactly that contract with a synthetic source so every
layer above it (train loop, checkpoint/resume, multi-host sharding) is
exercised for real:

  * **Determinism / restartability** — batch ``i`` is a pure function of
    ``(seed, i)``; resuming from a checkpointed ``step`` reproduces the
    exact stream (the same property a seeded shuffle-buffer pipeline gives
    you, without needing the data on disk).
  * **Per-host sharding** — each host draws only its ``1/num_hosts`` slice
    of the global batch, indexed by ``host_id``; a global batch is the
    concatenation over hosts, so data parallelism sees disjoint data.
  * **Prefetch** — a small lookahead queue mirrors double-buffered host
    pipelines; on CPU it is a correctness no-op but keeps the caller-side
    API identical to production.

Token statistics follow a Zipf distribution over the vocabulary (matching
natural-language frequency structure) so losses move like real training
rather than like uniform noise.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["PipelineConfig", "TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    zipf_alpha: float = 1.1  # token-frequency skew
    prefetch: int = 2

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by "
                f"num_hosts {self.num_hosts}"
            )
        if not (0 <= self.host_id < self.num_hosts):
            raise ValueError("host_id out of range")

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts


class TokenPipeline:
    """Deterministic, restartable, host-sharded token stream.

    ``batch_at(step)`` is the pure-function access path (used for elastic
    resume: any host can reproduce any step).  Iteration with prefetch is
    the caller-facing path.
    """

    def __init__(self, cfg: PipelineConfig, start_step: int = 0):
        self.cfg = cfg
        self._step = start_step
        # Zipf-ish categorical over the vocab, frozen per pipeline.
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_alpha)
        self._probs = p / p.sum()
        self._queue: deque = deque()

    # -- pure access ------------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Host-local batch for global step ``step`` (pure in (seed, step,
        host_id)).  Labels are next-token shifted; last position wraps to
        BOS=0 and is masked by ``loss_mask``."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id])
        )
        shape = (cfg.host_batch, cfg.seq_len)
        tokens = rng.choice(cfg.vocab_size, size=shape, p=self._probs).astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.zeros((cfg.host_batch, 1), np.int32)], axis=1
        )
        loss_mask = np.ones(shape, np.float32)
        loss_mask[:, -1] = 0.0
        return {"tokens": tokens, "labels": labels, "loss_mask": loss_mask}

    # -- iterator with prefetch -------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        while len(self._queue) < self.cfg.prefetch:
            self._queue.append(self.batch_at(self._step + len(self._queue)))
        batch = self._queue.popleft()
        self._step += 1
        return batch

    @property
    def step(self) -> int:
        return self._step

    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: PipelineConfig, state: Dict[str, int]) -> "TokenPipeline":
        if state.get("seed", cfg.seed) != cfg.seed:
            raise ValueError("checkpointed pipeline seed differs from config")
        return cls(cfg, start_step=int(state["step"]))
