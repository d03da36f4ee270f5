"""Graceful degradation: the single fallback decision point — jax-free.

Mirrors the rule that every layout/gather choice flows through one
``resolve_*`` function: **every runtime downgrade flows through**
:func:`resolve_fallback`, is applied by a sanctioned containment site
(lint GUST-L03/L07 allowlists), and is **counted** — surfaced on
``GustPlan.cost()`` (``fallback_*`` fields) and ``ServeLoop`` stats.
Degradation is never silent and never an exception on the serving path.

The degradation order (ROADMAP §Resilience invariants):

* ``kernel``:  pallas → jnp       (tolerance-level equal: the XLA oracle
                                   computes the same math, different op
                                   order — NOT gated bitwise)
* ``gather``:  local → resident   (bitwise equal: resident ≡ local)
* ``store``:   stored → fresh     (bitwise equal: warm ≡ cold)

Each chain is one step deep by design — the floor of every chain is the
always-available reference path, so a second failure is a real bug and
*should* propagate to the serve-step containment layer.

The port keeps the reference's table (so :func:`resolve_fallback` answers
as the reference does) but applies only the ``store`` stage: a failing
CUDA kernel or segment-local gather is never retried on another path,
since that would hide a fault of the card's code behind a plain result.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = [
    "resolve_fallback",
    "record_fallback",
    "fallback_counters",
    "reset_fallback_counters",
]

#: stage -> (degraded-from, degraded-to).  The *only* legal downgrades.
_CHAIN = {
    "kernel": ("pallas", "jnp"),
    "gather": ("local", "resident"),
    "store": ("stored", "fresh"),
}

#: Process-wide downgrade counts, keyed "<from>_to_<to>".  Snapshot /
#: delta these around a region to attribute downgrades to it.
fallback_counters: Dict[str, int] = {
    "pallas_to_jnp": 0,
    "local_to_resident": 0,
    "stored_to_fresh": 0,
}


def resolve_fallback(stage: str, current: str) -> Optional[str]:
    """The one decision point: what does ``current`` degrade to at
    ``stage``?  Returns the downgraded choice, or ``None`` when
    ``current`` is already the floor of its chain (caller must let the
    error propagate to the next containment layer)."""
    chain = _CHAIN.get(stage)
    if chain is None:
        raise ValueError(f"unknown fallback stage {stage!r}; have {sorted(_CHAIN)}")
    src, dst = chain
    return dst if current == src else None


def record_fallback(stage: str) -> str:
    """Count one applied downgrade at ``stage``; returns the counter key
    so call sites can mirror it into their own stats."""
    src, dst = _CHAIN[stage]
    key = f"{src}_to_{dst}"
    fallback_counters[key] += 1
    return key


def reset_fallback_counters() -> Dict[str, int]:
    """Zero the process-wide counters; returns the pre-reset snapshot."""
    snap = dict(fallback_counters)
    for k in fallback_counters:
        fallback_counters[k] = 0
    return snap
