"""``repro_torch.resilience`` — fault injection, retry, lifecycle, fallback.

Counterpart of ``repro.resilience`` (numpy only, copied): the same
``KNOWN_SITES``, the same seeded ``fired`` sequences, the same
``resolve_fallback`` table.  Four legs:

* :mod:`.faults`    — deterministic seeded fault injection over named
                      sites (``FaultPlan`` / ``FaultSpec`` / ``trip``).
* :mod:`.retry`     — jittered-exponential-backoff bounded retry.
* :mod:`.lifecycle` — ``RequestStatus`` / ``RequestResult``: every
                      request terminates with a definite status.
* :mod:`.fallback`  — the single ``resolve_fallback`` decision point
                      plus process-wide downgrade counters.  The port
                      applies only the ``store`` stage (stored → fresh);
                      a failed kernel or gather on the card reaches the
                      caller.
"""

from .faults import (  # noqa: F401
    KNOWN_SITES,
    FaultError,
    FaultPlan,
    FaultSpec,
    clear,
    enabled,
    injected,
    install,
    trip,
)
from .fallback import (  # noqa: F401
    fallback_counters,
    record_fallback,
    reset_fallback_counters,
    resolve_fallback,
)
from .lifecycle import RequestResult, RequestStatus  # noqa: F401
from .retry import backoff_schedule, retrying  # noqa: F401

__all__ = [
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "KNOWN_SITES",
    "trip",
    "install",
    "clear",
    "injected",
    "enabled",
    "retrying",
    "backoff_schedule",
    "RequestStatus",
    "RequestResult",
    "resolve_fallback",
    "record_fallback",
    "fallback_counters",
    "reset_fallback_counters",
]
