"""Conjugate-gradient solver on a GUST plan of the PyTorch/CUDA port — the
paper's §5.3 amortization argument end-to-end: plan ONCE (schedule +
pack), run hundreds of SpMVs against changing vectors inside an
iterative solver.  The vectors stay on the plan's device; on the card
(the default) every SpMV is a hand-written CUDA kernel.

    PYTHONPATH=. python examples/cg_solver_torch.py [--device cpu] [--n 512]
"""

import argparse
import time

import numpy as np
import torch

import repro_torch
from repro_torch.core.packing import resolve_device


def make_spd(n: int, density: float, seed: int = 0) -> np.ndarray:
    """Sparse symmetric positive-definite system (paper: Ax=y solvers)."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density / 2) * rng.standard_normal((n, n))
    a = (a + a.T).astype(np.float32)
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(1) + 1.0  # diag dominance
    return a


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=512, help="unknowns of the system")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    n = args.n
    a_dense = make_spd(n, 0.05)
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)

    # preprocessing: one plan (schedule + packed layout), reused by every
    # iteration — the schedule-once/execute-many contract made explicit.
    # The reference picks its jnp backend here; in the port the plan's
    # device picks the path.
    t0 = time.time()
    p = repro_torch.plan(a_dense, repro_torch.PlanConfig(l=64), device=dev)
    cost = p.cost()
    pre_s = time.time() - t0
    print(f"plan: {pre_s:.2f}s ({cost.cycles} modeled cycles/SpMV, "
          f"util={cost.utilization:.1%}, layout={cost.layout}, device={dev})")

    def matvec(v):
        return p.spmm(v[:, None])[:, 0]

    # conjugate gradient
    x = torch.zeros(n, device=dev)
    r = torch.as_tensor(b, device=dev) - matvec(x)
    d = r
    rs = float(r @ r)
    t0 = time.time()
    for it in range(200):
        ad = matvec(d)
        alpha = rs / float(d @ ad)
        x = x + alpha * d
        r = r - alpha * ad
        rs_new = float(r @ r)
        if it % 25 == 0:
            print(f"  iter {it:3d} residual {np.sqrt(rs_new):.3e}")
        if np.sqrt(rs_new) < 1e-5:
            print(f"  converged at iter {it}")
            break
        d = r + (rs_new / rs) * d
        rs = rs_new
    sync()
    solve_s = time.time() - t0
    err = np.abs(a_dense @ x.cpu().numpy() - b).max()
    print(f"solve: {solve_s:.2f}s, |Ax-b|_inf = {err:.2e}")
    print(f"amortization: 1 plan ({pre_s:.2f}s) served "
          f"{it + 1} SpMVs (paper §5.3: schedule once, solve many)")
    if not err < 1e-3:
        raise SystemExit(f"the solve did not converge: |Ax-b|_inf = {err:.2e}")


if __name__ == "__main__":
    main()
