"""The sharded train step (``shard_train_state`` + ``make_train_step(lm,
cfg, mesh)``): ``param_specs``' "model" (TP) and "data" (FSDP) placements
executed, each rank holding only its shards.  The counterpart of the
reference's ``tests/test_distributed.py::test_sharded_train_step_runs_and_matches_single_device``
(a reduced phi3 step jitted with ``param_specs`` shardings on a 2 × 4
``("data", "model")`` mesh, held to the single-device step).

Four gloo ranks (one process each, ``torch_dist_ranks.run_ranks``,
program ``tp``: ``train_tp_case.py``) run reduced phi3 at microbatches 2
on a batch of 8 × 32 whose ``loss_mask`` differs down the rows, from the
reference's initial state carried across, on (2, 2) and (1, 4)
``("data", "model")`` meshes (on (1, 4) the 2 KV heads stay whole under
4 model ranks: each rank's query heads read them whole) and a (2, 2, 1)
``("pod", "data", "model")`` mesh (FSDP over "data", its gradients then
summed over "pod"), two steps each, plain and (on (2, 2)) with
compression:

* the first step gives the reference's jitted single-device step its
  loss and ``grad_norm`` within 1e-5 relative and every parameter within
  the reference's ``rtol=2e-4, atol=2e-5``;
* both steps give the port's single-process step the loss and
  ``grad_norm`` within 1e-5 relative and, plain, every parameter within
  1e-6.  With compression the parameters are not held to 1e-6: the TP
  sums reorder float32 additions, and a gradient element within that
  noise of an int8 rounding boundary takes the other code, one quantum
  (1/127 of the leaf's largest magnitude) apart; instead
  ``compress_grads`` on every rank's shards of a seeded gradient and
  residual (each leaf quantized with the whole leaf's scale through
  ``over_shards``) gathers to ``compress_grads`` of the whole trees bit
  for bit;
* every rank's shards have ``local_shape``'s shapes, its parameter and
  optimizer bytes equal ``tree_bytes_per_device``'s, ``gather_train_state``
  gives the whole state back bit for bit, and no rank allocates a whole
  stacked leaf during the steps.
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

from repro_torch.configs import get_arch
from repro_torch.core.convert import from_reference_train_state
from repro_torch.training.compression import init_residual

from test_torch_models import pairs
from torch_dist_ranks import run_ranks
from train_tp_case import (LR, TOL_LOSS, check_shards, check_steps, lm_of, single_steps,
                           tp_batch, write_cases)

torch.set_num_threads(1)

ARCH = "phi3_mini_3_8b"
REF_TOL = dict(rtol=2e-4, atol=2e-5)  # the reference's microbatch tolerance
CASES = {"2x2": ((2, 2), False), "1x4": ((1, 4), False), "2x2-compressed": ((2, 2), True),
         "2x2x1": ((2, 2, 1), False)}
STEPS = 2


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The ranks' results, the reference's jitted step and the port's
    single-process steps, from the reference's initial state."""
    tmp = tmp_path_factory.mktemp("tp_train")
    rtc = RefTrainConfig(opt=RefAdamWConfig(lr=LR), dtype="float32", microbatches=2)
    rlm = ref_build(ref_get_arch(ARCH).reduced())
    rstate = ref_init_train_state(rlm, jax.random.PRNGKey(0), rtc)
    state = from_reference_train_state(jax.tree.map(np.asarray, rstate),
                                       get_arch(ARCH).reduced(), device="cpu")
    cases = {}
    for name, (mesh, comp) in CASES.items():
        start = dict(state)
        if comp:
            start["residual"] = init_residual(state["params"])
        cases[name] = dict(arch=ARCH, mesh=mesh, state=start, microbatches=2,
                           compression=comp, steps=STEPS)
    write_cases(tmp, cases)
    outs = run_ranks("tp", 4, tmp, timeout=240)
    lm = lm_of(ARCH)
    batch = tp_batch(lm.cfg)
    ref = jax.jit(ref_make_train_step(rlm, rtc))(
        rstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    single = {name: single_steps(ARCH, c["state"], STEPS, c["compression"])
              for name, c in cases.items()}
    return {"outs": outs, "ref": ref, "single": single}


@pytest.mark.parametrize("name", ["2x2", "1x4"])
def test_sharded_step_matches_reference_single_device(tp, name):
    rnew, rm = tp["ref"]
    got = tp["outs"][0][name]["steps"][0]
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(rm[k])) <= TOL_LOSS * abs(float(rm[k])), k
    for path, r, t in pairs(rnew["params"], got["state"]["params"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **REF_TOL, err_msg=str(path))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_equals_single_process(tp, name):
    ranks = dict(enumerate(o[name] for o in tp["outs"]))
    check_steps(ranks, tp["single"][name], params=not CASES[name][1])


def test_compression_over_shards_equals_whole(tp):
    assert all(rank["2x2-compressed"]["compress_equals_whole"] for rank in tp["outs"])


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_only_its_shards(tp, name):
    check_shards(dict(enumerate(o[name] for o in tp["outs"])))
