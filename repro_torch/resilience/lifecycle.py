"""Request lifecycle vocabulary for the serving loop — jax-free.

Every request a serving loop ever sees terminates
with exactly one :class:`RequestResult` carrying a definite
:class:`RequestStatus` — the chaos gate (``benchmarks/chaos_bench.py``)
is precisely "no request is ever lost, whatever faults fire".

Statuses:

* ``DONE``      — retired normally (EOS or ``max_new`` reached).
* ``FAILED``    — a contained fault retired this request; other slots'
                  token streams are bitwise unaffected (slot-local containment).
* ``TIMEOUT``   — the per-request deadline (decode-step or wall budget)
                  expired; tokens generated so far are preserved.
* ``SHED``      — rejected at admission: the bounded queue was full
                  (reject-newest backpressure, counted).
* ``CANCELLED`` — explicitly cancelled via ``ServeLoop.cancel(rid)``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List

__all__ = ["RequestStatus", "RequestResult"]


class RequestStatus(str, enum.Enum):
    """Terminal states; ``str``-valued so records JSON-serialize as the
    plain status name."""

    DONE = "DONE"
    FAILED = "FAILED"
    TIMEOUT = "TIMEOUT"
    SHED = "SHED"
    CANCELLED = "CANCELLED"

    def __str__(self) -> str:  # "DONE", not "RequestStatus.DONE"
        return self.value


@dataclasses.dataclass
class RequestResult:
    """Terminal record for one request.

    ``tokens`` holds whatever was generated before retirement (empty for
    SHED); ``reason`` is a human-readable cause for non-DONE statuses;
    ``steps`` counts the decode steps this request was active for.
    """

    rid: int
    status: RequestStatus
    tokens: List[int] = dataclasses.field(default_factory=list)
    reason: str = ""
    steps: int = 0

    @property
    def ok(self) -> bool:
        return self.status is RequestStatus.DONE
