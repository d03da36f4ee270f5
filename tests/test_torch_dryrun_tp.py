"""The dry-run account of a train cell divides tensor parallelism
(``launch/cost_account.account_cell``: rank 0's sharded step on meta
shards over torch's ``fake`` process-group backend).

On a (1, 4) layout, reduced yi-6b (4 query heads, 2 KV heads, d_ff 128)
at 8 × 64 tokens, float32:

* the attention scores and values (``bmm``) and every projection split
  over "model" count 1/4 of the whole step's (a (1, 1) layout) matmul
  FLOPs; the K and V projections stay whole (2 KV heads do not divide 4
  ranks: each rank projects them all), so ``mm`` is
  ``(whole - kv) / 4 + kv``, ``kv`` being their FLOPs: forward, the
  remat's recompute and the backward's two products;
* the bytes per device still equal ``tree_bytes_per_device`` of the
  parameter and optimizer trees under the rules;
* the TP sums are counted as rank 0's traffic (there is no FSDP traffic
  at one data rank), and the fake process group is gone after the count.
"""

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import MeshLayout, param_specs, tree_bytes_per_device
from repro_torch.launch.cost_account import account_cell
from repro_torch.models.model_zoo import build_model

torch.set_num_threads(1)

BATCH, SEQ = 8, 64


def _account(shape):
    lm = build_model(get_arch("yi_6b").reduced())
    return lm, account_cell(lm, "train", BATCH, SEQ, MeshLayout(shape, ("data", "model")),
                            param_dtype=torch.float32, compute_dtype=torch.float32)


def test_train_account_divides_tensor_parallelism():
    lm, whole = _account((1, 1))
    _, tp = _account((1, 4))
    cfg = lm.cfg
    assert tp["flops_by_op"]["aten.bmm"] * 4 == whole["flops_by_op"]["aten.bmm"]
    tokens = BATCH * SEQ
    kv = 4 * cfg.n_layers * 2 * tokens * cfg.d_model * 2 * cfg.n_kv * cfg.head_dim
    assert tp["flops_by_op"]["aten.mm"] == (whole["flops_by_op"]["aten.mm"] - kv) // 4 + kv
    assert tp["matmul_flops_per_device"] < whole["matmul_flops_per_device"] / 3
    assert tp["peak_temp_bytes"] < whole["peak_temp_bytes"]
    assert whole["collective_bytes"] == 0 and tp["collective_bytes"] > 0
    assert set(tp["traffic"]) == {"all_reduce"}  # the TP sums; no FSDP at one data rank
    assert not dist.is_initialized()


def test_train_account_bytes_per_device_follow_the_rules():
    lm, rec = _account((1, 4))
    layout = MeshLayout((1, 4), ("data", "model"))
    params = lm.init(None)
    specs = param_specs(params, layout)
    want = tree_bytes_per_device(params, specs, layout)
    assert rec["bytes_per_device"]["params"] == want
    assert rec["bytes_per_device"]["optimizer"] == 2 * want + 4  # m, v and the step
