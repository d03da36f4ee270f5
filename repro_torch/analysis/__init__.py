"""repro_torch.analysis — static verification of GUST artifacts, of the
port's kernels and of its sources.

Counterpart of ``repro.analysis``; three legs, none of which launches a
kernel:

* :mod:`repro_torch.analysis.verify` — the artifact verifier, rule for
  rule the reference's: every machine-checkable packed-format contract
  (padding canonicalization, ragged block metadata, gather tables, scale
  leaves, collision-freedom, index dtypes, canonical COO) as an
  executable rule with a ``GUST-Pxx`` id.  Entry points: :func:`verify`
  / :class:`Finding`, plus ``GustPlan.verify()`` and the ``PlanStore``
  verify-on-load mode.
* :mod:`repro_torch.analysis.kernel_audit` — the Hopper audit
  (``GUST-Hxx``), the counterpart of the reference's TPU audit: per
  library, from ``ptxas``' report of its build, registers, spills and
  static shared memory per kernel; per launch plan, shared memory,
  registers and the grid against the card's budgets and the stream's
  extents; and from the CUDA sources alone (no ``nvcc``), GUST-H07, the
  asynchronous copies of the spread template (every TMA-ring stage and
  every ``cp.async`` group waited on before it is read, each refill
  into the stage just read): :func:`audit_rings`.
* :mod:`repro_torch.analysis.lint` — the policy linter (``GUST-L01``,
  ``L03``..``L07``) over the ``repro_torch/`` sources: :func:`lint_sources`.

``verify`` names both a submodule and the function: once the submodule
is imported, ``repro_torch.analysis.verify`` is the module.  The
function is always ``repro_torch.verify``.  Imports resolve lazily (PEP
562): importing ``repro_torch.analysis`` pulls in no kernel module.

CLI::

    python -m repro_torch.analysis verify <store-dir>   # artifact store scan
    python -m repro_torch.analysis lint                 # policy linter
    python -m repro_torch.analysis audit                # kernel audit (H01..H07)
    python -m repro_torch.analysis audit --rings        # H07 only, no nvcc
"""

from typing import TYPE_CHECKING

_EXPORTS = {
    "Finding": "repro_torch.analysis.verify",
    "verify": "repro_torch.analysis.verify",
    "verify_artifact": "repro_torch.analysis.verify",
    "audit_kernels": "repro_torch.analysis.kernel_audit",
    "audit_rings": "repro_torch.analysis.kernel_audit",
    "lint_sources": "repro_torch.analysis.lint",
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
    from repro_torch.analysis.kernel_audit import audit_kernels, audit_rings  # noqa: F401
    from repro_torch.analysis.lint import lint_sources  # noqa: F401
    from repro_torch.analysis.verify import (  # noqa: F401
        Finding,
        verify,
        verify_artifact,
    )
