"""CLI for the static analysis legs::

    python -m repro_torch.analysis verify <store-dir>   # verify every artifact
    python -m repro_torch.analysis audit                # kernel resource audit

Exit status is nonzero when any check fails.  ``verify`` runs anywhere
(numpy over the store's files); ``audit`` builds every kernel library
that is not built yet (``nvcc``) and starts the card's occupancy
calculator for the launch plans, so it runs on a machine with the card.
"""

from __future__ import annotations

import argparse
import sys


def _cmd_verify(args: argparse.Namespace) -> int:
    from repro_torch.analysis.verify import verify
    from repro_torch.core.plan_store import PlanStore

    store = PlanStore(args.store_dir)
    keys = store.keys()
    if not keys:
        print(f"no artifacts under {args.store_dir}")
        return 0
    bad = 0
    for key in keys:
        record = store.get(key)
        if record is None:
            bad += 1
            print(f"{key}: UNPARSEABLE (counted corrupt by the store)")
            continue
        spec = record["spec"]
        findings = verify(spec["leaves"], spec["meta"])
        if findings:
            bad += 1
            print(f"{key}: {len(findings)} finding(s)")
            for f in findings:
                print(f"  {f}")
        else:
            print(f"{key}: ok")
    print(f"{len(keys)} artifact(s), {bad} failing")
    return 1 if bad else 0


def _cmd_audit(args: argparse.Namespace) -> int:
    from repro_torch.analysis.kernel_audit import audit_kernels, default_plans

    result = audit_kernels(plans=default_plans())
    print(result.report())
    return 1 if result.findings else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="GUST static analysis: artifact verifier, Hopper kernel "
                    "resource audit.",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_verify = sub.add_parser("verify", help="verify every artifact in a "
                                             "PlanStore directory")
    p_verify.add_argument("store_dir")
    p_verify.set_defaults(fn=_cmd_verify)

    p_audit = sub.add_parser("audit", help="registers, spills, shared memory "
                                           "and launch plans of every kernel")
    p_audit.set_defaults(fn=_cmd_audit)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
