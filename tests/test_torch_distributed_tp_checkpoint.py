"""Sharded checkpoints in the reference's layout (``training/checkpoint.py``
on a ``ShardedTrainState``), on a (2, 2) mesh of 4 gloo ranks
(``train_tp_case.checkpoint_case``, program ``tp_checkpoint``).

The reference trains reduced phi3 one jitted step and writes that state
with its own ``save_checkpoint``.  On every rank of the port:

* the reference's checkpoint restored into a sharded state equals the
  shards cut in memory (``shard_train_state`` of the same state carried
  across, ``from_reference_train_state``) bit for bit;
* two sharded steps resumed from the reference's checkpoint equal the
  uninterrupted run's two steps bit for bit;
* a sharded save after the first step (rank 0 gathers each leaf and
  writes it) restores bit for bit, and the second step from the restored
  state equals the uninterrupted run's bit for bit;
* the port's sharded checkpoint holds the whole state in the reference's
  layout: the reference's ``restore_checkpoint`` reads it, every
  parameter and optimizer leaf bitwise the gathered state's;
* the gathered state after two sharded steps is the single-process
  run's within 1e-6 (so the bitwise resumes are of a run that is right).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import get_arch as ref_get_arch
from repro.models.model_zoo import build_model as ref_build
from repro.training import AdamWConfig as RefAdamWConfig
from repro.training import TrainConfig as RefTrainConfig
from repro.training import init_train_state as ref_init_train_state
from repro.training import make_train_step as ref_make_train_step
from repro.training import restore_checkpoint as ref_restore
from repro.training import save_checkpoint as ref_save

from repro_torch.configs import get_arch
from repro_torch.core.convert import from_reference_train_state
from repro_torch.models.tree import tree_leaves
from repro_torch.training import make_train_step

from test_torch_models import pairs
from torch_dist_ranks import run_ranks
from train_tp_case import LR, lm_of, tp_batch, train_config

torch.set_num_threads(1)

ARCH = "phi3_mini_3_8b"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    rtc = RefTrainConfig(opt=RefAdamWConfig(lr=LR), dtype="float32", microbatches=2)
    rlm = ref_build(ref_get_arch(ARCH).reduced())
    rstate = ref_init_train_state(rlm, jax.random.PRNGKey(0), rtc)
    batch = tp_batch(lm_of(ARCH).cfg)
    rstate, _ = jax.jit(ref_make_train_step(rlm, rtc))(
        rstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    ref_dir = str(tmp / "ref_ckpt")
    ref_save(ref_dir, 1, rstate)
    state = from_reference_train_state(jax.tree.map(np.asarray, rstate),
                                       get_arch(ARCH).reduced(), device="cpu")
    torch.save({"arch": ARCH, "state": state, "ref_dir": ref_dir, "ref_step": 1},
               str(tmp / "ckpt_case.pt"))
    outs = run_ranks("tp_checkpoint", 4, tmp, timeout=240)
    return {"outs": outs, "state": state, "ref_state": rstate}


@pytest.mark.parametrize("check", ["restored_equals_cut", "resumed_equals_uninterrupted",
                                   "round_trip", "continued_equals_uninterrupted"])
def test_sharded_checkpoint_is_bitwise(ckpt, check):
    assert all(out[check] for out in ckpt["outs"]), [out[check] for out in ckpt["outs"]]
    assert all(out["restored_is_sharded"] == "ShardedTrainState" for out in ckpt["outs"])


def test_sharded_run_equals_the_whole_run(ckpt):
    lm = lm_of(ARCH)
    state, step = ckpt["state"], make_train_step(lm, train_config(2))
    for _ in range(2):
        state, _ = step(state, tp_batch(lm.cfg))
    whole = ckpt["outs"][0]["whole"]
    for a, b in zip(tree_leaves(state), tree_leaves(whole)):
        assert float((a.float() - b.float()).abs().max()) <= 1e-6


def test_reference_reads_the_sharded_checkpoint(ckpt):
    out = ckpt["outs"][0]
    restored, extra = ref_restore(out["port_dir"], 1, ckpt["ref_state"])
    assert extra == {"note": "sharded"}
    for part in ("params", "opt"):
        for path, r, t in pairs(restored[part], out["saved"][part]):
            assert np.array_equal(np.asarray(r), t.numpy()), (part, path)
