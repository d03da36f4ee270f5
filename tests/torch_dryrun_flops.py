"""Matmul FLOPs of one reduced train step, the dry-run account's against
the reference's HLO analysis.

The port: ``repro_torch.launch.cost_account.account_cell`` (the step run
on meta tensors under ``FlopCounterMode``) on a one-device mesh.  The
reference: ``analyze_hlo(...).dot_flops`` of its train step jitted and
compiled on one CPU device (``2·|result|·|contraction|`` per dot, loop
trip counts applied).  Both at the arch's ``reduced()`` config, batch 8 ×
64 tokens, bf16 compute, remat, one microbatch.

    PYTHONPATH=src python tests/torch_dryrun_flops.py   # every arch's ratio

prints one JSON line: arch -> {"port", "reference", "ratio"}.
"""

import json

import jax
import torch

BATCH, SEQ = 8, 64


def reference_dot_flops(arch: str) -> int:
    from repro.configs.base import get_arch
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models.model_zoo import build_model
    from repro.training import TrainConfig, init_train_state, make_train_step

    lm = build_model(get_arch(arch).reduced())
    tc = TrainConfig(dtype="bfloat16", remat=True)
    state = jax.eval_shape(lambda: init_train_state(lm, jax.random.PRNGKey(0), tc))
    batch = lm.input_specs(SEQ, BATCH, "train")
    compiled = jax.jit(make_train_step(lm, tc)).lower(state, batch).compile()
    return int(analyze_hlo(compiled.as_text()).dot_flops)


def port_matmul_flops(arch: str) -> int:
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import MeshLayout
    from repro_torch.launch.cost_account import account_cell
    from repro_torch.models.model_zoo import build_model

    lm = build_model(get_arch(arch).reduced())
    rec = account_cell(lm, "train", BATCH, SEQ, MeshLayout((1, 1), ("data", "model")),
                       param_dtype=torch.float32, compute_dtype=torch.bfloat16)
    return int(rec["matmul_flops_per_device"])


def ratios(archs) -> dict:
    out = {}
    for arch in archs:
        port, ref = port_matmul_flops(arch), reference_dot_flops(arch)
        out[arch] = {"port": port, "reference": ref, "ratio": port / ref}
    return out


if __name__ == "__main__":
    from repro_torch.configs import ARCH_IDS

    print(json.dumps(ratios(ARCH_IDS)))
