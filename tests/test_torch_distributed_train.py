"""The data-parallel train step (``make_train_step(lm, cfg, mesh)``), the
eager counterpart of the reference's sharded step
(``tests/test_distributed.py``, ``test_sharded_train_step_runs_and_matches_single_device``).

Two gloo ranks (one process each, ``torch_dist_ranks.run_ranks``) run the
cases of ``train_dp_case.py`` from states this file writes:

* A reduced phi3 step at microbatches 2 whose ``loss_mask`` differs
  between the ranks' rows, from the reference's initial state: the
  data-parallel step gives the port's single-process loss within 1e-5
  relative and every parameter within 1e-6 (the global masked mean: the
  ranks reduce their masked sums and counts, not their means; the
  gradients summed by ``bucketed`` + ``ring_all_reduce``), and both ranks
  hold the same parameters bit for bit.  It gives the reference's jitted
  single-device step on the same state and batch the loss and
  ``grad_norm`` within 1e-5 relative and every parameter within the
  reference's ``rtol=2e-4, atol=2e-5`` (``tests/test_training.py``).
* The same step with compression (``compressed_psum`` per leaf) equals,
  bit for bit, the step composed by hand: each rank's gradient of its
  rows (its microbatch shares summed in order and halved), ``val = g_r +
  res_r`` (each rank's own starting residual, seeded noise) quantized to
  int8 with one scale per leaf (written out here in numpy), the two
  ranks' dequantized payloads added, then AdamW; each rank's new residual
  is its own ``val - deq``.
* A reduced llama4 (MoE) step routes per rank: it equals, bit for bit,
  the step composed from each rank's own rows (its own routing, capacity
  and aux, the aux weighing ``1/2``) with the gradients summed, then
  AdamW; its loss is not the loss of the global batch.
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
from repro_torch.models.tree import tree_leaves, tree_unflatten
from repro_torch.training import init_train_state
from repro_torch.training.optimizer import adamw_update

from test_torch_models import pairs
from torch_dist_ranks import run_ranks
from train_dp_case import LR, dp_batch, lm_of, rank_residual, train_config, write_cases

torch.set_num_threads(1)

WORLD = 2
TOL_LOSS = 1e-5  # relative
TOL_PARAMS = 1e-6  # absolute, every element
REF_TOL = dict(rtol=2e-4, atol=2e-5)  # the reference's microbatch tolerance


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The ranks' results, the reference's step on phi3, and the states
    and batches they started from."""
    tmp = tmp_path_factory.mktemp("dp_train")
    rtc = RefTrainConfig(opt=RefAdamWConfig(lr=LR), dtype="float32", microbatches=2)
    rlm = ref_build(ref_get_arch("phi3_mini_3_8b").reduced())
    rstate = ref_init_train_state(rlm, jax.random.PRNGKey(0), rtc)
    states = {
        "phi3": from_reference_train_state(jax.tree.map(np.asarray, rstate),
                                           get_arch("phi3_mini_3_8b").reduced(),
                                           device="cpu"),
        "llama4": init_train_state(lm_of("llama4"), torch.Generator().manual_seed(0),
                                   train_config("llama4"), device="cpu"),
    }
    write_cases(tmp, states)
    outs = run_ranks("train", WORLD, tmp, timeout=240)
    batch = dp_batch(rlm.cfg.vocab)
    rnew, rm = jax.jit(ref_make_train_step(rlm, rtc))(
        rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"outs": outs, "states": states, "ref": (rnew, rm)}


def _batch(case):
    return {k: torch.from_numpy(v) for k, v in dp_batch(lm_of(case).cfg.vocab).items()}


def _rows(batch, n, i):
    m = next(iter(batch.values())).shape[0] // n
    return {k: v[i * m:(i + 1) * m] for k, v in batch.items()}


def _rank_grads(case, params, batch, rank):
    """Rank ``rank``'s loss and gradient leaves as the step composes them
    by hand: its rows of each microbatch under the count of both ranks'
    rows, the microbatches' gradients summed in order and divided by
    their number."""
    lm, tc = lm_of(case), train_config(case)
    n = tc.microbatches
    acc = [torch.zeros_like(p) for p in tree_leaves(params)]
    loss_sum = torch.zeros(())
    for i in range(n):
        micro = _rows(batch, n, i)
        mine = _rows(micro, WORLD, rank)
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, _ = lm.loss_fn(tree_unflatten(params, live), mine, dtype=torch.float32,
                                 remat=tc.remat, denom=micro["loss_mask"].sum(),
                                 shards=WORLD)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        for a, g in zip(acc, grads):
            if g is not None:
                a.add_(g)
        loss_sum = loss_sum + loss.detach()
    if n > 1:
        acc = [a.div_(torch.tensor(float(n))) for a in acc]
    return loss_sum, acc


def _quant_np(val: np.ndarray, bits: int = 8):
    """int8 error feedback on one float32 leaf, written out: (deq,
    val - deq)."""
    qmax = np.float32(2 ** (bits - 1) - 1)
    scale = np.maximum(np.abs(val).max() / qmax, np.float32(1e-12)).astype(np.float32)
    deq = (np.clip(np.rint(val / scale), -qmax, qmax) * scale).astype(np.float32)
    return deq, (val - deq).astype(np.float32)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_data_parallel_step_equals_single_process(dp):
    outs = dp["outs"]
    for tag in ("plain", "compressed"):
        single, ddp = outs[0][f"phi3/{tag}/single"], outs[0][f"phi3/{tag}/dp"]
        a, b = float(single["loss"]), float(ddp["loss"])
        assert abs(a - b) <= TOL_LOSS * abs(a), (tag, a, b)
        for r in outs[1:]:
            assert _same(ddp["state"]["params"], r[f"phi3/{tag}/dp"]["state"]["params"])
            assert float(r[f"phi3/{tag}/dp"]["loss"]) == b
        if tag == "plain":
            worst = max(float((x - y).abs().max()) for x, y in zip(
                tree_leaves(single["state"]["params"]), tree_leaves(ddp["state"]["params"])))
            assert worst <= TOL_PARAMS, worst
            assert abs(float(single["grad_norm"]) - float(ddp["grad_norm"])) <= (
                TOL_LOSS * float(single["grad_norm"]))


def test_data_parallel_step_matches_reference(dp):
    rnew, rm = dp["ref"]
    ddp = dp["outs"][0]["phi3/plain/dp"]
    for k in ("loss", "grad_norm"):
        r = float(rm[k])
        assert abs(float(ddp[k]) - r) <= TOL_LOSS * abs(r), (k, float(ddp[k]), r)
    for path, r, t in pairs(rnew["params"], ddp["state"]["params"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **REF_TOL, err_msg=str(path))


def test_compressed_data_parallel_step_equals_hand_composed(dp):
    state, batch = dp["states"]["phi3"], _batch("phi3")
    deqs, losses = [], []
    for rank in range(WORLD):
        loss, grads = _rank_grads("phi3", state["params"], batch, rank)
        losses.append(loss)
        res = tree_leaves(rank_residual(state["params"], rank))
        pairs_r = [_quant_np(g.numpy() + r.numpy()) for g, r in zip(grads, res)]
        deqs.append([d for d, _ in pairs_r])
        got = dp["outs"][rank]["phi3/compressed/dp"]["state"]["residual"]
        assert all(np.array_equal(res, t.numpy())
                   for (_, res), t in zip(pairs_r, tree_leaves(got))), rank
    summed = [torch.from_numpy(a + b) for a, b in zip(*deqs)]
    tc = train_config("phi3", compression=True)
    params, _, _ = adamw_update(tc.opt, state["params"],
                                tree_unflatten(state["params"], summed), state["opt"])
    for rank in range(WORLD):
        out = dp["outs"][rank]["phi3/compressed/dp"]
        assert _same(params, out["state"]["params"]), rank
        assert torch.equal(out["loss"], (losses[0] + losses[1]) / 2)


def test_moe_data_parallel_step_routes_per_rank(dp):
    state, batch = dp["states"]["llama4"], _batch("llama4")
    ranks = [_rank_grads("llama4", state["params"], batch, r) for r in range(WORLD)]
    summed = [a + b for a, b in zip(ranks[0][1], ranks[1][1])]
    tc = train_config("llama4")
    params, _, _ = adamw_update(tc.opt, state["params"],
                                tree_unflatten(state["params"], summed), state["opt"])
    loss = ranks[0][0] + ranks[1][0]
    for rank in range(WORLD):
        out = dp["outs"][rank]["llama4/plain/dp"]
        assert _same(params, out["state"]["params"]), rank
        assert torch.equal(out["loss"], loss), rank
    # the global batch's routing and aux give another loss
    lm = lm_of("llama4")
    whole, _ = lm.loss_fn(state["params"], batch, dtype=torch.float32, remat=tc.remat)
    assert not torch.equal(whole, loss), float(whole)
