"""repro_torch.analysis — static verification of GUST artifacts and of the
port's kernels.

Counterpart of ``repro.analysis``; two legs, neither of which launches a
kernel:

* :mod:`repro_torch.analysis.verify` — the artifact verifier, rule for
  rule the reference's: every machine-checkable packed-format contract
  (padding canonicalization, ragged block metadata, gather tables, scale
  leaves, collision-freedom, index dtypes, canonical COO) as an
  executable rule with a ``GUST-Pxx`` id.  Entry points: :func:`verify`
  / :class:`Finding`, plus ``GustPlan.verify()`` and the ``PlanStore``
  verify-on-load mode.
* :mod:`repro_torch.analysis.kernel_audit` — the Hopper resource audit
  (``GUST-Hxx``), the counterpart of the reference's TPU audit: per
  library, from ``ptxas``' report of its build, registers, spills and
  static shared memory per kernel; per launch plan, shared memory,
  registers and the grid against the card's budgets and the stream's
  extents.

The reference's policy linter (``lint``) encodes the JAX package's own
source rules and is not ported.  Imports resolve lazily (PEP 562):
importing ``repro_torch.analysis`` pulls in no kernel module.

CLI::

    python -m repro_torch.analysis verify <store-dir>   # artifact store scan
    python -m repro_torch.analysis audit                # kernel resource audit
"""

from typing import TYPE_CHECKING

_EXPORTS = {
    "Finding": "repro_torch.analysis.verify",
    "verify": "repro_torch.analysis.verify",
    "verify_artifact": "repro_torch.analysis.verify",
    "audit_kernels": "repro_torch.analysis.kernel_audit",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module_name = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.analysis' has no attribute {name!r}"
        ) from None
    import importlib

    value = getattr(importlib.import_module(module_name), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


if TYPE_CHECKING:  # static analyzers see the real symbols
    from repro_torch.analysis.kernel_audit import audit_kernels  # noqa: F401
    from repro_torch.analysis.verify import (  # noqa: F401
        Finding,
        verify,
        verify_artifact,
    )
