"""End-to-end LM training driver example on the PyTorch/CUDA port: train a
~100M-param yi-family model with checkpointing and fault tolerance, then
hand one trained MLP matrix to a GUST plan.

On the card (the default) the same driver that ``python -m
repro_torch.launch.train`` runs is called as a library; ``--device cpu``
runs it on the CPU, and the size flags shrink it for a quick run there.

    PYTHONPATH=. python examples/train_lm_torch.py [--steps 300] [--device cpu]
        [--layers 6 --d-model 512 --seq-len 128]
"""

import argparse
import dataclasses
import tempfile

from repro_torch.configs.base import get_arch, register
from repro_torch.core.packing import resolve_device
from repro_torch.launch.train import run_training


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--seq-len", type=int, default=128)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a ~100M-param family member: same blocks as yi-6b, scaled down
    base = get_arch(args.arch)
    d, heads = args.d_model, max(args.d_model // 64, 1)
    cfg = dataclasses.replace(
        base,
        name=base.name + "-100m",
        n_layers=args.layers,
        d_model=d,
        n_heads=heads,
        n_kv=max(heads // 4, 1),
        d_head=64,
        d_ff=d * 11 // 4,
        vocab=8192,
    )
    register(cfg)
    n_params_est = cfg.n_layers * (
        cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv) * cfg.head_dim
        + cfg.n_heads * cfg.head_dim * cfg.d_model
        + 3 * cfg.d_model * cfg.d_ff
    ) + cfg.vocab * cfg.d_model
    print(f"training {cfg.name}: ~{n_params_est/1e6:.0f}M params, "
          f"{args.steps} steps on {dev}")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        state, history = run_training(
            cfg.name,
            reduced=False,
            steps=args.steps,
            seq_len=args.seq_len,
            global_batch=8,
            lr=3e-3,
            microbatches=2,
            ckpt_dir=ckpt_dir,
            ckpt_every=max(args.steps // 3, 1),
            dtype="float32",
            log_every=25,
            device=dev,
        )
    print(f"loss: {history[0]:.3f} -> {history[-1]:.3f} "
          f"({(1 - history[-1]/history[0])*100:.1f}% reduction)")

    # train -> serve handoff: plan one trained MLP matrix through the GUST
    # plan/execute API (this is what gustify does for the whole stack at
    # weight-load time — schedule once, decode many)
    import repro_torch

    w = state["params"]["stack"]["reps"][0]["mlp"]["w_down"][0].T.detach().cpu().numpy()
    gl = repro_torch.GustLinear(
        w, config=repro_torch.PlanConfig(l=64), density=0.25, device=dev
    )
    cost = gl.plan.cost()
    print(f"GUST handoff: w_down {w.shape} pruned to 25% density -> "
          f"{cost.cycles} cycles/SpMV, util={cost.utilization:.1%}, "
          f"layout={cost.layout}")
    if not history[-1] < history[0]:
        raise SystemExit("the loss did not fall")


if __name__ == "__main__":
    main()
