"""Deterministic fault injection — seedable, replayable, zero-cost off.

The serving stack's correctness argument (ROADMAP §Resilience
invariants) is only as strong as the faults it has actually survived.
This module makes fault-time behavior *testable* the same way the
packed-format invariants made schedule-time behavior testable: a
:class:`FaultPlan` maps **named injection sites** (a stable public
contract, listed below) to error/delay/corruption specs, and every
hardened call path calls :func:`trip` at its site.

Design rules:

* **Off by default, zero overhead when disabled.**  No plan installed
  means :func:`trip` is one module-global ``None`` check — no
  allocation, no dict lookup, no string formatting.  A ``FaultPlan`` is
  an execution knob: it never enters a
  ``ScheduleCache``/``PlanStore`` key (it is not part of
  ``PlanConfig`` at all), so injected runs and clean runs share
  artifacts.
* **Deterministic by seed.**  Each spec draws its probabilistic
  triggers from its own ``numpy`` Generator seeded by
  ``sha1(seed | site | spec index)`` — the k-th hit at a site sees the
  same draw regardless of how other sites interleave, in-process and
  across processes.  ``FaultPlan.fired`` records the exact fault
  sequence so every chaos run is replayable and comparable.
* **Sites are a contract.**  Renaming a site silently un-arms every
  chaos test that targets it; the known sites are enumerated in
  :data:`KNOWN_SITES` and new hardened paths must extend it.

Named sites (``tag`` refines the match; ``None`` matches any)::

    store.get          PlanStore.get file read        (tag: store key)
    store.get.corrupt  PlanStore.get post-read        (kind="corrupt")
    store.put          PlanStore.put container write  (tag: store key)
    store.put.crash    PlanStore.put pre-fsync crash  (tag: store key)
    pack.materialize   GustPlan.artifact lazy pack
    kernel.execute     execute_spmm dispatch          (tag: "cuda" | "plain")
    gather.local       execute_spmm local-gather path
    serve.admit        ServeLoop._admit               (tag: request id)
    serve.decode       ServeLoop.step batched decode
    serve.slot         ServeLoop.step per-slot retire (tag: request id)

Usage::

    plan = FaultPlan([FaultSpec("serve.decode", times=2)], seed=7)
    with injected(plan):
        loop.run_to_completion()
    assert plan.fired  # the replayable fault sequence
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FaultError",
    "FaultSpec",
    "FaultPlan",
    "KNOWN_SITES",
    "trip",
    "install",
    "clear",
    "injected",
    "enabled",
]

#: The stable injection-site names (ROADMAP §Resilience invariants).
KNOWN_SITES = (
    "store.get",
    "store.get.corrupt",
    "store.put",
    "store.put.crash",
    "pack.materialize",
    "kernel.execute",
    "gather.local",
    "serve.admit",
    "serve.decode",
    "serve.slot",
)

_KINDS = ("error", "delay", "corrupt")


class FaultError(RuntimeError):
    """Default exception an ``error`` spec raises at its site."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: where, what, how often.

    Attributes:
      site:    injection-site name (see :data:`KNOWN_SITES`).
      kind:    ``error`` (raise), ``delay`` (sleep ``delay_s``), or
               ``corrupt`` (returned to the call site, which applies a
               deterministic corruption — only sites documented as
               ``kind="corrupt"`` honor it).
      times:   trigger at most this many times (``-1`` = every hit).
      after:   skip the first ``after`` eligible hits (arm late).
      rate:    per-hit trigger probability; draws come from the spec's
               own seeded stream, so partial-rate schedules replay
               exactly.
      delay_s: sleep length for ``kind="delay"``.
      error:   exception *type* for ``kind="error"`` (default
               :class:`FaultError`) — e.g. ``OSError`` to exercise an
               I/O retry path.
      tag:     only trip calls carrying this tag (``None`` = any); call
               sites tag with the request id / backend / store key.
    """

    site: str
    kind: str = "error"
    times: int = 1
    after: int = 0
    rate: float = 1.0
    delay_s: float = 0.0
    error: type = FaultError
    tag: Optional[str] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")


def _spec_seed(seed: int, site: str, index: int) -> int:
    """Process-stable per-spec stream seed (``hash()`` is salted; sha1
    is not)."""
    h = hashlib.sha1(f"gust-fault|{seed}|{site}|{index}".encode()).digest()
    return int.from_bytes(h[:8], "little")


@dataclasses.dataclass
class _SpecState:
    spec: FaultSpec
    rng: np.random.Generator
    hits: int = 0
    trips: int = 0


class FaultPlan:
    """A seeded schedule of faults over the named injection sites.

    ``fired`` is the replayable record: a list of
    ``(sequence, site, tag, kind)`` tuples in trigger order — two runs
    of the same workload under the same plan seed produce the same
    record *and* (by the containment contracts) the same surviving
    outputs.  ``reset()`` rearms the plan for an identical replay.
    """

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.seed = int(seed)
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        for s in self.specs:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"FaultPlan takes FaultSpecs, got {type(s).__name__}")
        self._by_site: Dict[str, List[_SpecState]] = {}
        self.fired: List[Tuple[int, str, Optional[str], str]] = []
        self.reset()

    def reset(self) -> "FaultPlan":
        """Rearm every spec and clear the fired record (exact replay)."""
        self._by_site = {}
        for i, spec in enumerate(self.specs):
            self._by_site.setdefault(spec.site, []).append(
                _SpecState(
                    spec,
                    np.random.default_rng(_spec_seed(self.seed, spec.site, i)),
                )
            )
        self.fired = []
        return self

    # -- the hot path --------------------------------------------------------

    def _trip(self, site: str, tag: Optional[str]) -> Optional[FaultSpec]:
        states = self._by_site.get(site)
        if not states:
            return None
        corrupt: Optional[FaultSpec] = None
        for st in states:
            spec = st.spec
            if spec.tag is not None and spec.tag != tag:
                continue
            st.hits += 1
            if st.hits <= spec.after:
                continue
            if 0 <= spec.times <= st.trips:
                continue
            if spec.rate < 1.0 and st.rng.random() >= spec.rate:
                continue
            st.trips += 1
            self.fired.append((len(self.fired), site, tag, spec.kind))
            if spec.kind == "delay":
                time.sleep(spec.delay_s)
            elif spec.kind == "error":
                raise spec.error(
                    f"injected fault at {site!r}"
                    + (f" (tag={tag!r})" if tag is not None else "")
                )
            elif corrupt is None:
                corrupt = spec
        return corrupt

    # -- introspection -------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        """Trips per site (the chaos-report summary)."""
        out: Dict[str, int] = {}
        for site, states in self._by_site.items():
            n = sum(st.trips for st in states)
            if n:
                out[site] = n
        return out

    def fingerprint(self) -> Tuple[Tuple[int, str, Optional[str], str], ...]:
        """Hashable form of ``fired`` for determinism assertions."""
        return tuple(self.fired)

    def __repr__(self) -> str:
        return (
            f"FaultPlan(seed={self.seed}, specs={len(self.specs)}, "
            f"fired={len(self.fired)})"
        )


# ---------------------------------------------------------------------------
# The ambient active plan.  Injection sites must be reachable from deep
# call stacks (jitted trace bodies, store internals) without threading a
# plan object through every hot-path signature — and the disabled check
# must cost one global read.
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def trip(site: str, tag: Optional[str] = None) -> Optional[FaultSpec]:
    """Injection-site hook.  With no plan installed this is a single
    ``None`` check (the zero-overhead contract); with one installed it
    may raise, sleep, or return a ``corrupt`` spec for the caller to
    apply."""
    if _ACTIVE is None:
        return None
    return _ACTIVE._trip(site, tag)


def enabled() -> bool:
    """True when a FaultPlan is installed (callers may skip building
    tags — the only per-call work trip() can't skip itself)."""
    return _ACTIVE is not None


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` as the ambient fault plan (None disarms)."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def clear() -> None:
    """Disarm fault injection (equivalent to ``install(None)``)."""
    install(None)


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """Scope a fault plan: ``with injected(plan): ...`` — always
    disarms on exit, so a crashed chaos test can't poison the suite."""
    prev = _ACTIVE
    install(plan)
    try:
        yield plan
    finally:
        install(prev)
