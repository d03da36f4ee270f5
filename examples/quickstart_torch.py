"""Quickstart on the PyTorch/CUDA port: plan a sparse matrix once with GUST
edge-coloring, execute the SpMV many ways through the one plan/execute
API, and print the paper's headline metrics for this matrix.

The whole pipeline is two calls:

    p = repro_torch.plan(matrix, repro_torch.PlanConfig(l=256))  # schedule + pack once
    y = p.spmv(v)                                                # execute many times

On the card (the default) every product runs the hand-written CUDA
kernels; ``--device cpu`` runs their plain PyTorch versions.  Asking for
``cuda`` where there is none is an error, never a quiet fallback.

    PYTHONPATH=. python examples/quickstart_torch.py [--device cpu] [--n 1024]
"""

import argparse

import numpy as np
import torch

import repro_torch
from repro_torch.core.baselines import all_designs
from repro_torch.core.packing import resolve_device
from repro_torch.resilience.faults import FaultError, injected


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1024, help="rows and columns of the matrix")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    m = n = args.n
    density = 0.02
    dense = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(
        np.float32
    )
    v = rng.standard_normal(n).astype(np.float32)
    print(f"matrix: {m}x{n}, density={density:.3f}, device={dev}")

    # 1. plan: bipartite edge-coloring schedule + packed execution layout,
    #    computed once per matrix (paper §3.3/§5.3 amortization; the plan
    #    is served from a content-keyed cache on repeat calls)
    p = repro_torch.plan(dense, repro_torch.PlanConfig(l=256, layout="auto"), device=dev)
    cost = p.cost()
    print(f"plan: {p}")
    print(f"schedule: {p.sched.num_windows} windows, "
          f"{p.sched.total_colors} colors, {cost.cycles} cycles, "
          f"utilization={cost.utilization:.1%}")
    print(f"layout: {cost.layout} (padding waste {cost.waste_ratio:.2f}x), "
          f"stream {cost.stream_bytes / 1e6:.1f} MB, "
          f"Eq.10 predicted cycles {cost.expected_cycles:,.0f}")

    # 2. execute: plan SpMV == dense matvec.  The plan's device picks the
    #    path (the CUDA kernels on the card), where the reference picks a
    #    backend; there is no second backend to ask for.
    y_ref = dense @ v
    y_plan = p.spmv(v).cpu().numpy()
    print("plan-vs-dense max err:  ", np.abs(y_plan - y_ref).max())

    # 3. the same plan on a multi-vector (decode-batch) input: the
    #    reference's Pallas step is this plan's kernel path
    x8 = rng.standard_normal((n, 8)).astype(np.float32)
    y8 = p.spmm(x8).cpu().numpy()
    print("spmm (B=8)-vs-dense max err:", np.abs(y8 - dense @ x8).max())

    # 4. int8 per-block-scaled values: the stream shrinks ~4x on the
    #    value bytes (one f32 scale per c_blk block rides along) and the
    #    kernels dequantize in-register with a single f32 multiply
    p8 = repro_torch.plan(dense, repro_torch.PlanConfig(l=256, value_dtype="int8"),
                          device=dev)
    y_int8 = p8.spmv(v).cpu().numpy()
    c8 = p8.cost()
    print(f"int8 stream {c8.stream_bytes / 1e6:.1f} MB "
          f"(f32 was {cost.stream_bytes / 1e6:.1f} MB), "
          f"quantization err: {np.abs(y_int8 - y_ref).max():.4f}")

    # 5. measured autotuning: sweep (c_blk, l, layout, gather) against a
    #    probe batch; the fastest measured candidate wins unless the
    #    static defaults hold up (resolve_tuning's margin)
    tuned = p.tune(torch.from_numpy(x8), iters=2)
    r = tuned.tuning
    print(f"tuned: {r.baseline} -> {r.choice} "
          f"({r.improvement:.2f}x measured, "
          f"{len(r.measurements)} candidates timed, {len(r.pruned)} pruned)")

    # 6. the paper's comparison (Fig. 7 on this matrix; the FPGA cycle
    #    model, not a time of this device)
    print("\ndesign comparison (cycles / utilization):")
    for name, rep in all_designs(repro_torch.coo_from_dense(dense), 256,
                                 device=dev).items():
        print(f"  {name:12s} {rep.cycles:12,.0f} cycles   "
              f"util={rep.utilization:8.4%}")

    # 7. SpGEMM: the same plan multiplies by another sparse matrix —
    #    A's color-block stream becomes an outer-product schedule over
    #    B's condensed rows, and the sparse result is itself plan()-able
    AA = p.spgemm(p)  # C = A @ A, emitted as a canonical sparse COO
    sc = p.spgemm_cost(p)
    print(f"\nspgemm: A*A nnz={AA.nnz} "
          f"(density {AA.nnz / (m * n):.4f}), "
          f"{sc.products:,} multiplies vs {sc.dense_flops // 2:,} dense "
          f"({sc.flop_reduction:.1f}x fewer)")
    p2 = repro_torch.plan(AA, repro_torch.PlanConfig(l=256), device=dev)
    y2 = p2.spmv(v).cpu().numpy()
    print("chained (A*A)v max err:", np.abs(y2 - dense @ (dense @ v)).max())

    # 8. graph analytics ride on spmv/spgemm: PageRank on this pattern
    pr = repro_torch.pagerank(dense, config=repro_torch.PlanConfig(l=256), device=dev)
    print(f"pagerank: converged={pr.converged} in {pr.iterations} iters, "
          f"top-3 nodes {pr.top(3).tolist()}")

    # 9. static verification: every packed-format contract (GUST-Pxx)
    #    checked over the plan's leaves, no kernel runs.  The same checks
    #    run over a PlanStore directory as `python -m repro_torch.analysis
    #    verify <dir>` (plus `lint` and `audit` for the source-policy and
    #    kernel rules).
    findings = p.verify()
    print(f"\nverify: {len(findings)} finding(s) "
          f"({'clean' if not findings else findings[0].rule})")

    # 10. chaos: the same plan under deterministic fault injection.  The
    #     port keeps no kernel or gather fallback (a failing kernel is
    #     never hidden behind a plain result): the fault at gather.local
    #     reaches the caller, and no fallback is counted.
    p_loc = repro_torch.plan(dense, repro_torch.PlanConfig(l=256, gather="local"),
                             device=dev)
    chaos = repro_torch.FaultPlan([repro_torch.FaultSpec("gather.local")], seed=0)
    try:
        with injected(chaos):
            p_loc.spmv(v)
        raised = None
    except FaultError as err:
        raised = type(err).__name__
    print(f"chaos: fired={[f[1] for f in chaos.fired]}, raised={raised}, "
          f"fallbacks={p_loc.cost().fallback_gather}")
    if raised is None or p_loc.cost().fallback_gather:
        raise SystemExit("the injected gather fault did not reach the caller")


if __name__ == "__main__":
    main()
