"""Training launcher (counterpart of ``repro.launch.train``): config
registry -> model -> train step -> deterministic pipeline -> checkpoint
policy -> fault-tolerance wrappers, on one device (``--device``, default
``cuda``; ``cpu`` runs the same step on the CPU).

Usage:
    python -m repro_torch.launch.train --arch yi_6b --reduced --device cpu \\
        --steps 50 --ckpt-dir /tmp/ckpt [--resume]

Prints one JSON line ``{"first_loss", "last_loss"}`` last.  Batches are
the reference's: ``TokenPipeline.batch_at(step)`` and, for the ``embed``
and ``encdec`` stubs, the same numpy draws, so a run of either package
resumes from the other's checkpoint on the same data.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..configs.base import get_arch
from ..core.packing import resolve_device
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..models.model_zoo import build_model
from ..training import (
    AdamWConfig,
    TrainConfig,
    init_train_state,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from ..training.fault_tolerance import (
    CheckpointPolicy,
    StragglerMonitor,
    install_preemption_handler,
    retrying,
)

__all__ = ["run_training"]


def _make_batch_fn(lm, cfg, seq_len: int, batch: int, seed: int, device="cuda"):
    """Batch source per frontend kind (token / embed / encdec stubs), on
    ``device``."""
    pipe = TokenPipeline(
        PipelineConfig(vocab_size=cfg.vocab, seq_len=seq_len, global_batch=batch, seed=seed)
    )
    rng = np.random.default_rng(seed + 1)
    device = resolve_device(device)

    def next_batch(step: int):
        b = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}
        if cfg.frontend == "embed":
            # early-fusion stub: embeddings derived deterministically
            emb = rng.standard_normal((batch, seq_len, cfg.d_model)).astype(np.float32)
            b = {"embeds": torch.from_numpy(emb).to(device), "labels": b["labels"],
                 "loss_mask": b["loss_mask"]}
        elif cfg.is_encdec:
            enc_s = min(seq_len, cfg.enc_seq or seq_len)
            src = rng.standard_normal((batch, enc_s, cfg.d_model)).astype(np.float32)
            b["src_frames"] = torch.from_numpy(src).to(device)
        return b

    return next_batch


def run_training(
    arch: str,
    *,
    reduced: bool = True,
    steps: int = 50,
    seq_len: int = 64,
    global_batch: int = 8,
    lr: float = 1e-3,
    microbatches: int = 1,
    ckpt_dir: str = "",
    ckpt_every: int = 20,
    resume: bool = False,
    seed: int = 0,
    dtype: str = "float32",
    log_every: int = 10,
    device="cuda",
):
    """Train ``arch`` from parameters drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (or from the newest checkpoint in
    ``ckpt_dir`` with ``resume``).  Returns (state, the per-step losses)."""
    device = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    lm = build_model(cfg)
    tc = TrainConfig(
        opt=AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps),
        microbatches=microbatches,
        dtype=dtype,
    )
    state = init_train_state(lm, torch.Generator(device=device).manual_seed(seed), tc,
                             device=device)
    start_step = 0
    if resume and ckpt_dir:
        last = latest_step(ckpt_dir)
        if last is not None:
            state, _ = restore_checkpoint(ckpt_dir, last, state, device=device)
            start_step = last
            print(f"resumed from step {last}")

    step_fn = retrying(make_train_step(lm, tc), max_retries=2)
    next_batch = _make_batch_fn(lm, cfg, seq_len, global_batch, seed, device)
    policy = CheckpointPolicy(every_steps=ckpt_every)
    monitor = StragglerMonitor()
    flag = install_preemption_handler({"preempted": False})

    history = []
    for step in range(start_step, steps):
        monitor.start()
        batch = next_batch(step)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt, straggler = monitor.stop()
        history.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(
                f"step {step:5d} loss {loss:8.4f} gnorm "
                f"{float(metrics['grad_norm']):7.3f} {dt*1e3:7.1f} ms"
                + (" [straggler]" if straggler else "")
            )
        if ckpt_dir and (policy.should_save(step + 1) or flag["preempted"]):
            save_checkpoint(ckpt_dir, step + 1, state)
            policy.gc(ckpt_dir)
            if flag["preempted"]:
                print("preempted: checkpointed and exiting")
                return state, history
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, state)
    return state, history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    _, history = run_training(
        args.arch, reduced=args.reduced, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.batch, lr=args.lr, microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, resume=args.resume,
        dtype=args.dtype, device=args.device,
    )
    print(json.dumps({"first_loss": history[0], "last_loss": history[-1]}))


if __name__ == "__main__":
    main()
