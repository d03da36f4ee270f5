"""The dry-run account's serving cells divide the placements as the
sharded serve step executes them (``launch/cost_account.account_cell``:
rank 0's sharded prefill or decode step on meta shards over torch's
``fake`` process-group backend).

Four gloo ranks (program ``serve``, ``serve_tp_case.py``) serve reduced
yi-6b on (2, 2), dense and GUST, and reduced llama4-scout on (1, 4), batch
4, float32 parameters and caches; the account reckons the same decode
cells on the same layouts:

* its parameter and cache bytes per device equal what every rank
  allocated for its shards;
* the bytes each collective sends in a decode step equal what rank 0's
  ``collectives.traffic`` counted in its last decode step (the TP sums and
  gathers, the flash decode's max and sums, the logits' gather), and a
  GUST decode sends the dense one's less its MLP's row-parallel sums (the
  plans are replicated: their products move nothing);
* on (1, 4) the decode step's matmul FLOPs and temporaries fall below a
  (1, 1) layout's, and the fake process group is gone after the count.
"""

import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import MeshLayout
from repro_torch.launch.cost_account import account_cell
from repro_torch.serving import GustServeConfig, dryrun_specs

from serve_tp_case import greedy_tokens, lm_of, run_cases, serve_inputs

torch.set_num_threads(1)

BATCH, PROMPT, STEPS = 4, 14, 2
GUST = dict(density=0.5, gust_length=16)
#: name -> (arch, mesh, cache length, GUST config)
CASES = {"yi-2x2": ("yi_6b", (2, 2), 32, None),
         "gust-2x2": ("yi_6b", (2, 2), 32, GUST),
         "llama4-1x4": ("llama4_scout_17b_a16e", (1, 4), 30, None)}
F32 = dict(param_dtype=torch.float32, cache_dtype=torch.float32,
           compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {}
    for name, (arch, mesh, seq_len, gust) in CASES.items():
        lm = lm_of(arch)
        params = lm.init(torch.Generator().manual_seed(0), device="cpu")
        batch = serve_inputs(lm.cfg, BATCH, PROMPT)
        cases[name] = dict(arch=arch, mesh=mesh, params=params, batch=batch,
                           tokens=greedy_tokens(lm, params, batch, seq_len, STEPS,
                                                torch.float32, gust),
                           seq_len=seq_len, dtype="float32", gust=gust)
    return run_cases(tmp_path_factory.mktemp("serve_account"), cases, world=4)


def _account(name, mesh=None):
    arch, layout, seq_len, gust = CASES[name]
    lm = lm_of(arch)
    specs = dryrun_specs(lm, GustServeConfig(**gust)) if gust else None
    return account_cell(lm, "decode", BATCH, seq_len,
                        MeshLayout(mesh or layout, ("data", "model")), gust_specs=specs,
                        **F32)


@pytest.mark.parametrize("name", list(CASES))
def test_serve_account_bytes_equal_the_ranks_shards(ranks, name):
    rec = _account(name)
    held = rec["bytes_per_device"]["params"] + rec["bytes_per_device"]["caches"]
    assert all(r["bytes"] == held for r in ranks[name].values())


@pytest.mark.parametrize("name", list(CASES))
def test_serve_account_traffic_equals_the_ranks(ranks, name):
    rec = _account(name)
    assert rec["traffic"] == ranks[name][0]["traffic"]
    assert rec["collective_bytes"] == sum(r["bytes"] for r in rec["traffic"].values()) > 0
    assert not dist.is_initialized()


def test_gust_decode_sends_the_dense_decode_less_its_mlp_sums(ranks):
    """The GUST MLP runs whole on each rank's rows: the dense MLP's
    row-parallel sum, one (rows, 1, d) float32 all-reduce a layer over two
    model ranks, is all it does not send."""
    gust, dense = ranks["gust-2x2"][0]["traffic"], ranks["yi-2x2"][0]["traffic"]
    cfg = lm_of("yi_6b").cfg
    rows, tp = BATCH // 2, 2
    assert gust["all_gather"] == dense["all_gather"]
    assert gust["all_reduce"]["calls"] == dense["all_reduce"]["calls"] - cfg.n_layers
    assert gust["all_reduce"]["bytes"] == dense["all_reduce"]["bytes"] - (
        cfg.n_layers * rows * cfg.d_model * 4 * 2 * (tp - 1) // tp)
    assert _account("gust-2x2")["gust_flops"] > 0


def test_serve_account_divides_tensor_parallelism():
    whole, tp = _account("yi-2x2", (1, 1)), _account("yi-2x2", (1, 4))
    assert tp["matmul_flops_per_device"] < whole["matmul_flops_per_device"]
    assert tp["peak_temp_bytes"] < whole["peak_temp_bytes"]
    assert whole["traffic"] == {} and whole["collective_bytes"] == 0
    assert not any("upper bound" in n for n in tp["notes"])
