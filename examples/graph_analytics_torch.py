"""Graph analytics on GUST plans of the PyTorch/CUDA port: SpGEMM-powered
PageRank, triangle counting and GNN feature propagation over the
synthetic matrix suite.

  * ``GustPlan.spgemm`` — sparse×sparse through A's color-block stream
    (condensed outer products; on the card the SpGEMM kernel), returning
    a sparse COO that is itself ``repro_torch.plan()``-ed (chained A·A);
  * ``repro_torch.graph.pagerank`` — schedule the transition matrix once,
    run the whole power iteration against that one plan;
  * ``triangle_count`` / ``feature_propagation`` — A·A masked by A, and
    ``Â H`` per GNN layer.

    PYTHONPATH=. python examples/graph_analytics_torch.py [--device cpu] [--n 512]
"""

import argparse

import numpy as np

import repro_torch
from repro_torch.core.packing import resolve_device
from repro_torch.data.matrices import synth_power_law
from repro_torch.graph import feature_propagation, pagerank, triangle_count


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=512, help="nodes of the graph")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n = args.n
    adj = synth_power_law(n, 0.02, seed=3)
    cfg = repro_torch.PlanConfig(l=64)
    print(f"graph: {n} nodes, {adj.nnz} edges (power-law), device={dev}")

    # 1. the SpGEMM primitive: A·A through the plan's color-block stream,
    #    bitwise-checked against the dense product (integer-valued A)
    pattern = repro_torch.COOMatrix(
        adj.shape, adj.rows, adj.cols, np.ones(adj.nnz, np.float32)
    )
    p = repro_torch.plan(pattern, cfg, device=dev)
    cost = p.spgemm_cost(pattern)
    aa = p.spgemm(pattern)
    dense_ref = repro_torch.dense_from_coo(pattern) @ repro_torch.dense_from_coo(pattern)
    bitwise = np.array_equal(repro_torch.dense_from_coo(aa), dense_ref)
    print(f"spgemm: A·A nnz={aa.nnz} (estimated {cost.out_nnz_estimate}), "
          f"{cost.products} merge ops, "
          f"{cost.flop_reduction:.0f}x fewer FLOPs than dense, "
          f"bitwise vs dense: {bitwise}")

    # 2. chained plans: the sparse product re-plans directly
    p2 = repro_torch.plan(aa, cfg, device=dev)
    v = rng.standard_normal(n).astype(np.float32)
    y = p2.spmv(v).cpu().numpy()
    print(f"chained plan(A·A): {p2} -> spmv max err "
          f"{np.abs(y - dense_ref @ v).max():.2e}")

    # 3. PageRank: one plan for the transition matrix, many spmv iterations
    pr = pagerank(adj, config=cfg, device=dev)
    print(f"pagerank: converged={pr.converged} in {pr.iterations} iters "
          f"(residual {pr.residual:.2e}), top nodes: {pr.top(5).tolist()}")

    # 4. triangle census: one spgemm + the mask at A's edges
    tc = triangle_count(adj, config=cfg, device=dev)
    print(f"triangles: {tc.triangles} "
          f"(clustering coefficient {tc.clustering_coefficient:.4f}, "
          f"A·A nnz {tc.spgemm_nnz})")

    # 5. GNN feature propagation: Â scheduled once, one spmm per layer
    feats = rng.standard_normal((n, 16)).astype(np.float32)
    out = feature_propagation(adj, feats, num_layers=2, config=cfg, device=dev)
    print(f"gnn propagation: features {feats.shape} -> {out.shape}, "
          f"norm ratio {np.linalg.norm(out) / np.linalg.norm(feats):.3f}")
    if not (bitwise and pr.converged):
        raise SystemExit("A·A is not the dense product, or PageRank did not converge")


if __name__ == "__main__":
    main()
