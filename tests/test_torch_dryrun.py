"""The meta-device dry-run account (``repro_torch.launch.cost_account``,
``repro_torch.launch.dryrun``) against the reference's dry-run.

* ``n_params`` equals the reference's ``_count_params`` for every arch.
* On a (2, 4) mesh, every cell's per-device argument bytes (parameters,
  AdamW state, caches, inputs; the GUST decode cell's stream) equal the
  sum over the reference's ``build_cell`` arguments of
  ``NamedSharding.shard_shape`` bytes, exactly, for every arch and shape
  the reference does not skip.
* ``LM.input_specs`` gives the reference's shapes and dtypes.
* The cell policies (``microbatches_for``, ``skip_reason``) are the
  reference's; the CLI writes one record per cell, skips a cached one,
  and a record carries its memory limit, roofline terms and notes.
"""

import functools
import json

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.distributed.sharding import MeshLayout, tree_bytes_per_device
from repro_torch.launch import dryrun
from repro_torch.launch.cost_account import LiveBytes, cell_specs, cell_trees
from repro_torch.models.model_zoo import build_model
from repro_torch.models.tree import tree_leaves
from repro_torch.serving.gust_serve import GustServeConfig, dryrun_specs

from conftest import run_spmd_subprocess

torch.set_num_threads(1)

MESH = MeshLayout((2, 4), ("data", "model"))

_REFERENCE = """
import json
import numpy as np
from repro.launch.dryrun import (SHAPES, _count_params, build_cell,
                                 build_gust_decode_cell, microbatches_for, skip_reason)
from repro.configs.base import ARCH_IDS, get_arch
from repro.models.model_zoo import build_model
import jax
from jax.sharding import Mesh
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))

def arg_bytes(specs, shardings):
    leaves = jax.tree.leaves(specs)
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    assert len(leaves) == len(shs)
    return int(sum(int(np.prod(sh.shard_shape(x.shape))) * x.dtype.itemsize
                   for x, sh in zip(leaves, shs)))

out = {"bytes": {}, "n_params": {}, "microbatches": {}, "skip": {}, "inputs": {}}
for arch in ARCH_IDS:
    lm = build_model(get_arch(arch))
    out["n_params"][arch] = _count_params(jax.eval_shape(lambda: lm.init(jax.random.PRNGKey(0))))
    for shape in SHAPES:
        out["skip"][f"{arch}/{shape}"] = skip_reason(arch, shape)
        if skip_reason(arch, shape):
            continue
        _, specs, shardings, meta = build_cell(arch, shape, mesh)
        out["bytes"][f"{arch}/{shape}"] = arg_bytes(specs, shardings)
        if "microbatches" in meta:
            out["microbatches"][f"{arch}/{shape}"] = meta["microbatches"]
    for kind in ("train", "prefill", "decode"):
        out["inputs"][f"{arch}/{kind}"] = {
            k: [list(v.shape), str(v.dtype)] for k, v in lm.input_specs(64, 8, kind).items()}
_, specs, shardings, meta = build_gust_decode_cell("yi_6b", mesh)
out["bytes"]["yi_6b/gust"] = arg_bytes(specs, shardings)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    out = run_spmd_subprocess(_REFERENCE, devices=8, timeout=300)
    return json.loads(out.strip().splitlines()[-1])


def _port_bytes(arch, shape_name, gust=False):
    lm = build_model(get_arch(arch))
    shape = SHAPES[shape_name]
    dtype = torch.float32 if shape.kind == "train" else torch.bfloat16
    specs = dryrun_specs(lm, GustServeConfig()) if gust else None
    trees = cell_trees(lm, shape.kind, shape.global_batch, shape.seq_len,
                       param_dtype=dtype, gust_specs=specs)
    sp = cell_specs(trees, MESH, shape.kind, shape.global_batch)
    return sum(tree_bytes_per_device(t, sp[k], MESH) for k, t in trees.items())


def test_argument_bytes_per_device_equal_reference(reference):
    for key, want in reference["bytes"].items():
        arch, shape = key.split("/")
        got = (_port_bytes("yi_6b", "decode_32k", gust=True) if shape == "gust"
               else _port_bytes(arch, shape))
        assert got == want, (key, got, want)


def test_n_params_and_policies_equal_reference(reference):
    for arch in ARCH_IDS:
        lm = build_model(get_arch(arch))
        n = sum(x.numel() for x in tree_leaves(lm.init(None)))
        assert n == reference["n_params"][arch], arch
        for shape in SHAPES:
            assert dryrun.skip_reason(arch, shape) == reference["skip"][f"{arch}/{shape}"]
            key = f"{arch}/{shape}"
            if key in reference["microbatches"]:
                assert dryrun.microbatches_for(n, SHAPES[shape], MESH) == (
                    reference["microbatches"][key])
        for kind in ("train", "prefill", "decode"):
            got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                   for k, v in lm.input_specs(64, 8, kind).items()}
            assert got == reference["inputs"][f"{arch}/{kind}"], (arch, kind)
            assert all(v.device.type == "meta" for v in lm.input_specs(64, 8, kind).values())


def test_cli_writes_records_and_skips_cached(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "seamless_m4t_medium", "--shape", "decode_32k"]) == 0
    assert dryrun.main(["--arch", "yi_6b", "--shape", "long_500k"]) == 0
    rec = json.loads((tmp_path / "seamless_m4t_medium__decode_32k__single.json").read_text())
    assert rec["ok"] and rec["mesh"] == "single" and rec["kind"] == "decode"
    assert rec["memory_limit"]["source"] and rec["roofline"]["dominant"] in (
        "compute", "memory", "collective")
    assert rec["bytes_per_device"]["arguments"] == sum(
        v for k, v in rec["bytes_per_device"].items() if k != "arguments")
    assert rec["matmul_flops_per_device"] > 0 and rec["peak_temp_bytes"] > 0
    skip = json.loads((tmp_path / "yi_6b__long_500k__single.json").read_text())
    assert skip["skipped"] and "long_500k" in skip["reason"]
    capsys.readouterr()
    assert dryrun.main(["--arch", "seamless_m4t_medium", "--shape", "decode_32k"]) == 0
    assert "[OK]" not in capsys.readouterr().out  # cached: not run again


def test_live_bytes_counts_saved_activations():
    w = torch.empty(100, 100, device="meta", requires_grad=True)
    x = torch.empty(8, 100, device="meta")
    with LiveBytes() as live:
        h = x
        for _ in range(5):
            h = torch.tanh(h @ w)
        held = live.now
    # each tanh output is saved for the backward (8 x 100 f32 a layer)
    assert held == 5 * 8 * 100 * 4 and live.peak == held + 8 * 100 * 4
    stacked = torch.empty(4, 100, 100, device="meta")
    with LiveBytes() as live:
        layer = stacked[2]  # a view of an argument's storage: nothing new
        y = x @ layer.T
    assert live.peak == y.numel() * 4


SEQ_FOR_LOOPS = {"xlstm_125m": 300, "recurrentgemma_9b": 48}


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["xlstm_125m", "recurrentgemma_9b"])
def test_meta_time_loops_count_as_the_loop(arch, kind):
    """The account runs the recurrent mixers' time steps (and mLSTM
    chunks) at once on the meta device (``count_step``, under
    ``time_loops_at_once``): a prefill's or a train step's matmul FLOPs,
    and a prefill's logits and cache shapes, equal the host loop's on the
    CPU, exactly; the model's own loops are back after the count.
    xlstm runs 300 tokens: two mLSTM chunks of 256."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.cost_account import count_step
    from repro_torch.models import recurrent
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.optimizer import init_opt_state

    loops = (recurrent._mlstm_chunk_scan, recurrent._slstm_scan, recurrent._rglru_scan)
    lm = build_model(get_arch(arch).reduced())
    seq = SEQ_FOR_LOOPS[arch]
    runs = {}
    for dev in ("cpu", "meta"):
        params = (lm.init(torch.Generator().manual_seed(0), device="cpu") if dev == "cpu"
                  else lm.init(None))
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 for k, v in lm.input_specs(seq, 2, kind).items()}
        if kind == "prefill":
            caches = lm.init_caches(2, seq, torch.float32, device=dev)
            fn, args = functools.partial(lm.prefill, dtype=torch.float32), (params, batch,
                                                                             caches)
        else:
            fn = make_train_step(lm, TrainConfig(dtype="float32"))
            args = ({"params": params, "opt": init_opt_state(params)}, batch)
        if dev == "cpu":
            with FlopCounterMode(display=False) as flops:
                out = fn(*args)
            count = flops.get_total_flops()
        else:
            out, cost = count_step(fn, *args)
            count = cost["matmul_flops"]
        shapes = ([tuple(x.shape) for x in tree_leaves(out)] if kind == "prefill"
                  else [tuple(x.shape) for x in tree_leaves(out[0])])
        runs[dev] = (count, shapes)
    assert runs["cpu"] == runs["meta"]
    assert (recurrent._mlstm_chunk_scan, recurrent._slstm_scan, recurrent._rglru_scan) == loops
