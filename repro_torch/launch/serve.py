"""Serving driver: a mixed-length request stream against a (reduced or
full) model, dense or GUST-sparse decode, with continuous batching.

Counterpart of ``repro.launch.serve``.  Requests are enqueued up front
(bounded admission queue) and the loop admits into free slots while
other requests are mid-decode: per-slot prefill + per-slot positions make
every request's output identical to a solo run, so batching is purely a
throughput knob (``tok_per_s`` / ``slot_occupancy``; ``--serial`` serves
one request at a time for comparison).

The GUST path plans every MLP matrix once at engine build
(``serving.gust_serve.gustify``) and runs each decode step's MLP
products through the stacked plans; ``--ragged`` and ``--compact`` map
onto the plan's layout and dtypes.  The device (``--device``, default
``cuda``) chooses the path: the CUDA kernels on the card, their plain
PyTorch versions on the CPU; there is no ``--use-kernel``.

Usage:
    python -m repro_torch.launch.serve --arch yi_6b --reduced --device cpu \\
        --requests 6 --max-new 16 [--gust --density 0.2 --ragged --compact]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs.base import get_arch
from ..core.packing import resolve_device
from ..models.model_zoo import build_model
from ..serving import GustServeConfig, ServeConfig, ServeLoop

__all__ = ["run_serving"]


def run_serving(
    arch: str,
    *,
    reduced: bool = True,
    batch: int = 4,
    seq_len: int = 128,
    requests: int = 4,
    prompt_len: int = 8,
    max_new: int = 8,
    gust: bool = False,
    density: float = 0.25,
    gust_length: int = 32,
    ragged: bool = False,
    compact: bool = False,
    plan_store: str = None,
    serial: bool = False,
    temperature: float = 0.0,
    eos_id=None,
    seed: int = 0,
    deadline_steps: int = None,
    deadline_s: float = None,
    device="cuda",
):
    """Serve ``requests`` mixed-length prompts on random-init weights drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``; returns
    (tokens per request id, the stats dict)."""
    device = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    lm = build_model(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(seed), device=device)
    gcfg = None
    if gust:
        gcfg = GustServeConfig(
            density=density, gust_length=gust_length,
            ragged=ragged, compact=compact, plan_store=plan_store,
        )
    sc = ServeConfig(batch=batch, seq_len=seq_len, dtype="float32", gust=gcfg,
                     temperature=temperature, eos_id=eos_id,
                     queue_capacity=max(requests, 64),
                     max_steps_per_request=deadline_steps,
                     max_seconds_per_request=deadline_s)
    loop = ServeLoop(lm, params, sc, seed=seed)
    rng = np.random.default_rng(seed)
    # mixed-length trace: prompt lengths cycle between prompt_len//2 and
    # prompt_len — the workload per-slot positions exist for
    lengths = [max(1, prompt_len // 2), prompt_len, max(1, 3 * prompt_len // 4)]
    prompts = [
        rng.integers(0, cfg.vocab, lengths[r % len(lengths)]).astype(np.int32)
        for r in range(requests)
    ]
    t0 = time.time()
    done = {}
    if serial:  # one-request-at-a-time baseline
        for prompt in prompts:
            rid = loop.submit(prompt, max_new=max_new)
            loop.run_to_completion()
            done[rid] = loop.completed[rid]
    else:  # continuous batching: enqueue the stream, drain the queue
        rids = [loop.enqueue(prompt, max_new=max_new) for prompt in prompts]
        loop.run_to_completion()
        # non-DONE requests (TIMEOUT under a deadline, SHED past
        # capacity) carry their terminal result instead of completed[]
        done = {
            rid: loop.completed.get(
                rid, loop.results[rid].tokens if rid in loop.results else []
            )
            for rid in rids
        }
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = sum(len(v) for v in done.values())
    stats = {
        "requests": len(done),
        "tokens_generated": toks,
        "wall_s": round(dt, 2),
        "tok_per_s": round(toks / dt, 1),
        "decode_steps": loop.stats["decode_steps"],
        "slot_occupancy": round(loop.occupancy, 4),
        "mode": "serial" if serial else "continuous",
        "gust": bool(gust),
        # lifecycle + degradation counters: terminal statuses and the
        # process-wide fallback counters
        "resilience": loop.resilience_stats(),
    }
    if gust and loop.gust_tree is not None:
        # per-matrix entries only — "plan_store" is the store's counter dict
        mat_stats = {
            k: v for k, v in loop.gust_tree["stats"].items()
            if k not in ("plan_store", "fallbacks")
        }
        stats["gust_stream_utilization"] = {
            k: round(v["stream_utilization"], 4) for k, v in mat_stats.items()
        }
        stats["gust_streamed_slots"] = {
            k: v["streamed_slots"] for k, v in mat_stats.items()
        }
        if "plan_store" in loop.gust_tree["stats"]:
            stats["gust_plan_store"] = loop.gust_tree["stats"]["plan_store"]
    return done, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (their plain "
                    "PyTorch versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--gust", action="store_true")
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--gust-length", type=int, default=32)
    ap.add_argument("--ragged", action="store_true",
                    help="stack ragged color-block streams (only real "
                    "cycle blocks) instead of the padded C_pad layout")
    ap.add_argument("--compact", action="store_true",
                    help="bf16 values + int16 indices: halves the streamed "
                    "schedule bytes")
    ap.add_argument("--plan-store", type=str, default=None,
                    help="directory for the persistent PlanStore: warm "
                    "starts load packed plans off disk with zero coloring")
    ap.add_argument("--serial", action="store_true",
                    help="one-request-at-a-time baseline (default is "
                    "continuous batching over the admission queue)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="retire a request when it samples this token")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="per-request decode-step budget; expiry retires "
                    "the request with status=TIMEOUT (tokens kept)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock budget in seconds")
    args = ap.parse_args(argv)
    _, stats = run_serving(
        args.arch, batch=args.batch, seq_len=args.seq_len,
        requests=args.requests, prompt_len=args.prompt_len,
        max_new=args.max_new, gust=args.gust, density=args.density,
        gust_length=args.gust_length, ragged=args.ragged, compact=args.compact,
        plan_store=args.plan_store, serial=args.serial,
        temperature=args.temperature, eos_id=args.eos_id,
        deadline_steps=args.deadline_steps, deadline_s=args.deadline_s,
        device=args.device,
    )
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
