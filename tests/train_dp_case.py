"""The data-parallel train step's cases for the CPU tests, run by the rank
programs (``torch_dist_ranks.py``) from the states and batches that the
test wrote to ``<dir>/dp_cases.pt`` (:func:`write_cases`):

* ``phi3``: a reduced phi3 step at microbatches 2 whose ``loss_mask``
  differs between the ranks' rows, plain and with compression (each
  data-parallel rank starting from its own residual, :func:`rank_residual`),
  run data-parallel over ``mesh`` and in one process from the same state;
* ``llama4``: a reduced llama4 (MoE) step at microbatches 1, run
  data-parallel only (it routes per rank).

Imports neither ``jax`` nor ``repro``."""

import os

import numpy as np
import torch

BATCH, SEQ = 8, 32
CASES = {"phi3": ("phi3_mini_3_8b", 2), "llama4": ("llama4_scout_17b_a16e", 1)}
LR = 1e-3


def dp_batch(vocab: int, seed: int = 3):
    """Tokens, labels and a ``loss_mask`` whose density grows down the
    rows, so that the ranks' masks differ (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((BATCH, SEQ)) < np.linspace(0.2, 1.0, BATCH)[:, None])
    return {
        "tokens": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
        "labels": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
        "loss_mask": mask.astype(np.float32),
    }


def train_config(case: str, compression: bool = False):
    from repro_torch.training import AdamWConfig, TrainConfig
    from repro_torch.training.compression import CompressionConfig

    return TrainConfig(opt=AdamWConfig(lr=LR), dtype="float32",
                       microbatches=CASES[case][1],
                       compression=CompressionConfig(enable=compression))


def lm_of(case: str):
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model

    return build_model(get_arch(CASES[case][0]).reduced())


def write_cases(tmp_dir, states) -> None:
    """Save ``{case: {"state", "batch"}}``: ``states[case]`` the port's
    train state (residual-free), the batch from :func:`dp_batch`."""
    out = {}
    for case, state in states.items():
        batch = dp_batch(lm_of(case).cfg.vocab)
        out[case] = {"state": state, "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}
    torch.save(out, os.path.join(str(tmp_dir), "dp_cases.pt"))


def rank_residual(params, rank: int):
    """Rank ``rank``'s starting error-feedback residual: seeded noise of
    each parameter's shape, another on each rank (numpy, float32)."""
    from repro_torch.models.tree import tree_map

    rng = np.random.default_rng(100 + rank)
    return tree_map(lambda p: torch.from_numpy(
        (1e-4 * rng.standard_normal(tuple(p.shape))).astype(np.float32)), params)


def dp_case(mesh, tmp_dir):
    import torch.distributed as dist

    from repro_torch.training import make_train_step
    from repro_torch.training.compression import init_residual

    cases = torch.load(os.path.join(str(tmp_dir), "dp_cases.pt"))
    out = {}
    for case, c in cases.items():
        lm = lm_of(case)
        tags = ("plain", "compressed") if case == "phi3" else ("plain",)
        for tag in tags:
            tc = train_config(case, tag == "compressed")
            state = dict(c["state"])
            steps = [("dp", make_train_step(lm, tc, mesh))]
            if case == "phi3":
                steps.append(("single", make_train_step(lm, tc)))
            for name, step in steps:
                if tc.compression.enable:  # each DP rank its own residual
                    state["residual"] = (rank_residual(state["params"], dist.get_rank())
                                         if name == "dp" else init_residual(state["params"]))
                new, metrics = step(state, c["batch"])
                out[f"{case}/{tag}/{name}"] = {"loss": metrics["loss"],
                                               "grad_norm": metrics["grad_norm"],
                                               "state": new}
    return out
