"""Serving example on the PyTorch/CUDA port: batched requests against a
small model, dense vs GUST-sparse decode side by side — the paper's
technique as a serving feature.

Engine build plans every MLP matrix exactly once (``gustify`` ->
``repro_torch.plan``, content-keyed cache) and each decode step executes
the stacked plans — schedule once, decode many.  On the card (the
default) the GUST decode runs the hand-written SpMV kernels.

    PYTHONPATH=. python examples/serve_lm_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.packing import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.serving import GustServeConfig, ServeConfig, ServeLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch("yi_6b").reduced()
    lm = build_model(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    # mixed-length prompts, served CONCURRENTLY: per-slot prefill and
    # per-slot positions make each output identical to a solo run
    prompts = [rng.integers(0, cfg.vocab, ln).astype(np.int32)
               for ln in (8, 4, 12, 6)]

    streams = {}
    for label, gust in (
        ("dense decode", None),
        ("GUST decode (density 0.5, schedule computed once at load)",
         GustServeConfig(density=0.5, gust_length=16)),
    ):
        sc = ServeConfig(batch=4, seq_len=128, dtype="float32", gust=gust)
        t0 = time.time()
        loop = ServeLoop(lm, params, sc)
        build_s = time.time() - t0
        t0 = time.time()
        rids = [loop.enqueue(pr, max_new=8) for pr in prompts]
        loop.run_to_completion()
        outs = {rid: loop.completed[rid] for rid in rids}
        gen_s = time.time() - t0
        toks = sum(len(v) for v in outs.values())
        print(f"{label}:")
        print(f"  engine build {build_s:.2f}s (includes scheduling for GUST), "
              f"{toks} tokens in {gen_s:.2f}s "
              f"({loop.stats['decode_steps']} decode steps, "
              f"slot occupancy {loop.occupancy:.0%}, device {dev})")
        if gust is not None and loop.gust_tree is not None:
            util = {k: f"{v['stream_utilization']:.2%}"
                    for k, v in loop.gust_tree["stats"].items()}
            print(f"  scheduled-stream utilization per matrix: {util}")
        print(f"  first completion: {list(outs.values())[0]}")
        streams[label] = [len(v) for v in outs.values()]
    dense_lens, gust_lens = streams.values()
    if not all(dense_lens) or dense_lens != gust_lens:
        raise SystemExit(f"requests did not complete alike: {streams}")


if __name__ == "__main__":
    main()
