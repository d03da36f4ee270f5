"""The port's train step against ``repro.training``: AdamW, the
schedule and int8 error-feedback compression on the same numpy trees;
five steps of ``make_train_step`` from the reference's initial state;
remat, microbatches and a retried step.

Tolerances: the optimizer and the compression, every leaf within 1e-6 of
its largest magnitude (float32 elementwise arithmetic written as the
reference writes it; the global norm sums in another order); the
schedule within 1e-6 relative; over five steps of the reference's
jitted step, each loss and ``lr`` within 1e-6 relative (measured at most
2.2e-7) and the ``grad_norm`` within 1e-6 (measured 3.2e-7), but within
1e-4 with compression on (measured 1.4e-5): where an element of
``grad + residual`` falls within rounding of a half step of the int8
grid, the two packages' last-bit differences round it to neighbouring
levels, a whole quantization step apart; microbatches 4 against 1 with the reference's own
``rtol=2e-4, atol=2e-5`` (``tests/test_training.py``); remat on and off,
and a retried step against an unfailed one, bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import ARCH_IDS
from repro.configs.base import get_arch as ref_get_arch
from repro.data.pipeline import PipelineConfig as RefPipelineConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.models.model_zoo import build_model as ref_build
from repro.training import AdamWConfig as RefAdamWConfig
from repro.training import CompressionConfig as RefCompressionConfig
from repro.training import TrainConfig as RefTrainConfig
from repro.training import init_train_state as ref_init_train_state
from repro.training import make_train_step as ref_make_train_step
from repro.training.compression import compress_grads as ref_compress_grads
from repro.training.optimizer import adamw_update as ref_adamw_update
from repro.training.optimizer import schedule as ref_schedule

from repro_torch.configs import get_arch
from repro_torch.core.convert import from_reference_train_state
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models.model_zoo import build_model
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.training import (
    AdamWConfig,
    CompressionConfig,
    TrainConfig,
    init_train_state,
    make_train_step,
)
from repro_torch.training import train_loop
from repro_torch.training.compression import compress_grads
from repro_torch.training.optimizer import adamw_update, schedule

from test_torch_models import pairs
from test_torch_train_grads import port_value_and_grad, same_batch

torch.set_num_threads(1)

LEAF_TOL, LOSS_RTOL, NORM_RTOL_INT8 = 1e-6, 1e-6, 1e-4
ACCUM = dict(rtol=2e-4, atol=2e-5)
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=100)


def tree_np(rng, scale=1.0):
    """A small parameter-shaped tree: matrices, a stacked ``(R, d)`` norm
    scale (decayed in both packages), a vector and a 3-D leaf."""
    return {"w": (rng.standard_normal((16, 8)) * scale).astype(np.float32),
            "stack": {"scale": (rng.standard_normal((3, 8)) * scale).astype(np.float32),
                      "wq": (rng.standard_normal((8, 2, 4)) * scale).astype(np.float32)},
            "bias": (rng.standard_normal((8,)) * scale).astype(np.float32)}


def as_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def assert_leaves_close(ref_tree, tree, tol=LEAF_TOL):
    assert len(jax.tree.leaves(ref_tree)) == len(tree_leaves(tree))
    for path, r, t in pairs(ref_tree, tree):
        r = np.asarray(r)
        assert r.dtype == t.numpy().dtype and r.shape == tuple(t.shape), path
        err = float(np.abs(t.numpy().astype(np.float64) - r).max())
        assert err <= tol * float(np.abs(r).max()), (path, err)


@pytest.mark.parametrize("step", [0, 1, 4])
def test_adamw_update_matches_reference(step):
    rng = np.random.default_rng(step)
    params, grads = tree_np(rng), tree_np(rng, scale=3.0)
    m, v = tree_np(rng, 0.1), jax.tree.map(np.abs, tree_np(rng, 0.01))
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=1.0)
    rp, rs, rm = ref_adamw_update(
        RefAdamWConfig(**cfg), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "step": jnp.int32(step)})
    tp, ts, tm = adamw_update(
        AdamWConfig(**cfg), as_torch(params), as_torch(grads),
        {"m": as_torch(m), "v": as_torch(v), "step": torch.tensor(step, dtype=torch.int32)})
    assert_leaves_close(rp, tp)
    assert_leaves_close(rs["m"], ts["m"])
    assert_leaves_close(rs["v"], ts["v"])
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == step + 1
    for k in ("grad_norm", "lr"):
        r = float(rm[k])
        assert abs(float(tm[k]) - r) <= LEAF_TOL * abs(r), k
    # the decay falls on every leaf with ndim >= 2 and on no vector
    no_decay = adamw_update(AdamWConfig(**cfg, weight_decay=0.0), as_torch(params),
                            as_torch(grads), {"m": as_torch(m), "v": as_torch(v),
                                              "step": torch.tensor(step, dtype=torch.int32)})[0]
    for path, a, b in pairs(no_decay, tp):
        assert torch.equal(a, b) == (a.ndim < 2), path


def test_schedule_matches_reference_around_warmup_and_end():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 9, 10, 11, 50, 99, 100, 101, 150):
        r = float(ref_schedule(RefAdamWConfig(**cfg), jnp.int32(step)))
        t = schedule(AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        assert t.dtype == torch.float32
        assert abs(float(t) - r) <= 1e-6 * max(abs(r), 1e-30), step


def test_compress_grads_matches_reference():
    rng = np.random.default_rng(7)
    grads, residual = tree_np(rng, 1e-3), tree_np(rng, 1e-5)
    cfg = dict(enable=True, bits=8)
    rd, rr = ref_compress_grads(jax.tree.map(jnp.asarray, grads),
                                jax.tree.map(jnp.asarray, residual),
                                RefCompressionConfig(**cfg))
    td, tr = compress_grads(as_torch(grads), as_torch(residual), CompressionConfig(**cfg))
    assert_leaves_close(rd, td)
    assert_leaves_close(rr, tr)
    # off: both trees come back as they were
    g, r = as_torch(grads), as_torch(residual)
    assert compress_grads(g, r, CompressionConfig()) == (g, r)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_on_equals_off_bitwise(arch):
    cfg = get_arch(arch).reduced()
    lm = build_model(cfg)
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    _, tb = same_batch(ref_get_arch(arch).reduced(), lm)
    l1, _, g1 = port_value_and_grad(lm, params, tb, remat=True)
    l0, _, g0 = port_value_and_grad(lm, params, tb, remat=False)
    assert torch.equal(l1, l0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)


def reference_setup(**tc):
    """The reference's yi-6b reduced model, train config and initial state
    (its ``tests/test_training.py`` setup), with the port's counterparts
    on the same state."""
    rcfg = ref_get_arch("yi_6b").reduced()
    rlm = ref_build(rcfg)
    rtc = RefTrainConfig(opt=RefAdamWConfig(**OPT), dtype="float32",
                         **{k: (RefCompressionConfig(**v) if k == "compression" else v)
                            for k, v in tc.items()})
    rstate = ref_init_train_state(rlm, jax.random.PRNGKey(0), rtc)
    cfg = get_arch("yi_6b").reduced()
    lm = build_model(cfg)
    ttc = TrainConfig(opt=AdamWConfig(**OPT), dtype="float32",
                      **{k: (CompressionConfig(**v) if k == "compression" else v)
                         for k, v in tc.items()})
    state = from_reference_train_state(jax.tree.map(np.asarray, rstate), cfg, device="cpu")
    return rlm, rtc, rstate, lm, ttc, state


@pytest.mark.parametrize("tc", [{}, {"compression": {"enable": True}},
                                {"microbatches": 2}],
                         ids=["plain", "compression", "microbatches"])
def test_five_steps_match_reference_jit(tc):
    rlm, rtc, rstate, lm, ttc, state = reference_setup(**tc)
    rstep = jax.jit(ref_make_train_step(rlm, rtc))
    step = make_train_step(lm, ttc)
    rpipe = RefTokenPipeline(RefPipelineConfig(vocab_size=lm.cfg.vocab, seq_len=16,
                                               global_batch=8))
    pipe = TokenPipeline(PipelineConfig(vocab_size=lm.cfg.vocab, seq_len=16, global_batch=8))
    for i in range(5):
        rb, tb = next(rpipe), next(pipe)
        assert all(np.array_equal(rb[k], tb[k]) for k in rb)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in rb.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in tb.items()})
        for k in ("loss", "grad_norm", "lr"):
            r = float(rm[k])
            tol = NORM_RTOL_INT8 if k == "grad_norm" and "compression" in tc else LOSS_RTOL
            assert abs(float(m[k]) - r) <= tol * abs(r), (i, k, float(m[k]), r)
    assert int(state["opt"]["step"]) == 5
    if "compression" in tc:
        assert sorted(state) == ["opt", "params", "residual"]


def test_microbatches_4_equal_1_within_reference_tolerance():
    _, _, _, lm, tc1, state = reference_setup(microbatches=1)
    tc4 = TrainConfig(opt=tc1.opt, dtype="float32", microbatches=4)
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(PipelineConfig(
        vocab_size=lm.cfg.vocab, seq_len=16, global_batch=8)).batch_at(0).items()}
    s1, m1 = make_train_step(lm, tc1)(state, batch)
    s4, m4 = make_train_step(lm, tc4)(state, batch)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s4["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **ACCUM)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), **ACCUM)


def test_retried_step_after_a_transient_gives_the_same_bits(monkeypatch):
    """A fault after the optimizer has built the new state: the state the
    step was given is untouched, and ``retrying`` runs the step again to
    the bits of a step that never failed."""
    from repro_torch.training.fault_tolerance import retrying

    _, _, _, lm, tc, state = reference_setup(compression={"enable": True})
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(PipelineConfig(
        vocab_size=lm.cfg.vocab, seq_len=16, global_batch=8)).batch_at(0).items()}
    before = [t.clone() for t in tree_leaves(state)]
    clean, clean_m = make_train_step(lm, tc)(state, batch)

    real, calls = train_loop.adamw_update, []

    def flaky(*args):
        out = real(*args)
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("simulated device loss after the update")
        return out

    monkeypatch.setattr(train_loop, "adamw_update", flaky)
    step = make_train_step(lm, tc)
    with pytest.raises(RuntimeError):
        step(state, batch)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))
    calls.clear()
    retried, m = retrying(step, max_retries=2)(state, batch)
    assert len(calls) == 2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(clean), tree_leaves(retried)))
    assert torch.equal(m["loss"], clean_m["loss"])
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))


def test_train_state_init_is_on_the_requested_device():
    lm = build_model(get_arch("yi_6b").reduced())
    tc = TrainConfig(compression=CompressionConfig(enable=True))
    state = init_train_state(lm, torch.Generator().manual_seed(0), tc, device="cpu")
    assert sorted(state) == ["opt", "params", "residual"]
    assert {t.device.type for t in tree_leaves(state)} == {"cpu"}
    assert state["opt"]["step"].dtype == torch.int32
    assert all(t.dtype == torch.float32 for t in tree_leaves(state["opt"]["m"]))
