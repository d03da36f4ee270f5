"""Bounded retry with jittered exponential backoff — jax-free.

Generalizes ``training.fault_tolerance.retrying`` (which re-exports this)
so the store and serving paths can share one retry policy without
importing the training stack.  Additions over the training original:

* **Jittered exponential backoff** — attempt *k* sleeps
  ``min(max_delay, base_delay * 2**k) * (1 + jitter * u)`` with ``u``
  drawn from a seeded stream, so a fleet of retriers doesn't
  thundering-herd a recovering store, and tests replay exact schedules.
* **Max-elapsed budget** — retrying stops early when the *next* sleep
  would push total elapsed time past ``max_elapsed`` seconds; a serving
  path must degrade (ROADMAP §Resilience invariants), not block.

Defaults keep the training semantics exactly: ``base_delay=0`` means no
sleeping and ``max_retries + 1`` total attempts, with the same terminal
``RuntimeError`` message.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type

import numpy as np

__all__ = ["retrying", "backoff_schedule"]


def backoff_schedule(
    attempts: int,
    *,
    base_delay: float = 0.0,
    max_delay: float = 30.0,
    jitter: float = 0.5,
    seed: Optional[int] = None,
) -> Tuple[float, ...]:
    """The sleep (seconds) before each retry, as ``retrying`` would draw
    it.  Exposed so tests can assert the exact jittered schedule."""
    rng = np.random.default_rng(seed)
    out = []
    for attempt in range(attempts):
        delay = min(max_delay, base_delay * (2.0 ** attempt))
        if jitter > 0:
            delay *= 1.0 + jitter * float(rng.random())
        out.append(delay)
    return tuple(out)


def retrying(
    fn: Callable,
    *,
    max_retries: int = 3,
    retry_on: Tuple[Type[BaseException], ...] = (RuntimeError,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    base_delay: float = 0.0,
    max_delay: float = 30.0,
    jitter: float = 0.5,
    max_elapsed: Optional[float] = None,
    seed: Optional[int] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Wrap ``fn`` with bounded, optionally backed-off retry.

    The caller re-supplies the last known-good state on each attempt, so
    a retry is semantically a restart-from-checkpoint (training) or a
    re-read (store).  ``sleep`` is injectable so tests assert schedules
    without wall-clock cost.
    """

    def wrapped(*args, **kwargs):
        rng = np.random.default_rng(seed)
        t0 = time.monotonic()
        err: Optional[BaseException] = None
        for attempt in range(max_retries + 1):
            try:
                return fn(*args, **kwargs)
            except retry_on as e:  # transient: retry from caller's state
                err = e
                if on_retry:
                    on_retry(attempt, e)
                if attempt >= max_retries:
                    break
                delay = min(max_delay, base_delay * (2.0 ** attempt))
                if jitter > 0 and delay > 0:
                    delay *= 1.0 + jitter * float(rng.random())
                if max_elapsed is not None:
                    elapsed = time.monotonic() - t0
                    if elapsed + delay > max_elapsed:
                        raise RuntimeError(
                            f"step failed after {attempt + 1} attempts "
                            f"({elapsed:.3f}s elapsed, budget "
                            f"{max_elapsed}s): {err!r}"
                        ) from err
                if delay > 0:
                    sleep(delay)
        raise RuntimeError(
            f"step failed after {max_retries} retries: {err!r}"
        ) from err

    return wrapped
