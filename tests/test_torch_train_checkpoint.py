"""Checkpoints, resume, the launcher and the data pipeline of the port's
training against ``repro``'s.

A checkpoint is the reference's layout (``step_%09d/manifest.json``,
``arrays/<idx>.npy``, ``COMMIT`` last), its leaves numbered in
``jax.tree_util.tree_flatten``'s order: one written by either package
restores in the other bit for bit.  A resumed run gives the losses of an
uninterrupted one bitwise; ``run_training`` resumed from a checkpoint of
the reference's own launcher continues as the reference's resumed run
does (losses within 1e-6 relative, as in ``test_torch_train_step.py``).
The pipeline's batches are the reference's bit for bit.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import get_arch as ref_get_arch
from repro.data.pipeline import PipelineConfig as RefPipelineConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.launch.train import run_training as ref_run_training
from repro.models.model_zoo import build_model as ref_build
from repro.training import AdamWConfig as RefAdamWConfig
from repro.training import TrainConfig as RefTrainConfig
from repro.training import init_train_state as ref_init_train_state
from repro.training import restore_checkpoint as ref_restore
from repro.training import save_checkpoint as ref_save

from repro_torch.configs import get_arch
from repro_torch.core.convert import from_reference_train_state, train_state_to_numpy
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.train import run_training
from repro_torch.models.model_zoo import build_model
from repro_torch.models.tree import tree_flatten_sorted, tree_leaves, tree_map
from repro_torch.training import (
    AdamWConfig,
    CompressionConfig,
    TrainConfig,
    init_train_state,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.checkpoint import list_steps
from repro_torch.training.fault_tolerance import CheckpointPolicy, StragglerMonitor

from test_torch_models import pairs

torch.set_num_threads(1)

LOSS_RTOL = 1e-6


@pytest.fixture
def keep_sigterm():
    """``run_training`` installs a SIGTERM handler, as the reference's
    does; put the worker's own back."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def port_state(compression=False, seed=0):
    lm = build_model(get_arch("yi_6b").reduced())
    tc = TrainConfig(opt=AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=100),
                     dtype="float32", compression=CompressionConfig(enable=compression))
    return lm, tc, init_train_state(lm, torch.Generator().manual_seed(seed), tc, device="cpu")


def batches(lm, n, start=0):
    pipe = TokenPipeline(PipelineConfig(vocab_size=lm.cfg.vocab, seq_len=16, global_batch=8),
                         start_step=start)
    return [{k: torch.from_numpy(v) for k, v in next(pipe).items()} for _ in range(n)]


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_sorted_flatten_is_jax_order():
    """The checkpoint's leaf numbering is ``jax.tree_util.tree_flatten``'s
    on the same nesting: the reference's train state, carried across."""
    rlm = ref_build(ref_get_arch("yi_6b").reduced())
    init = jax.jit(lambda k: ref_init_train_state(rlm, k, RefTrainConfig(dtype="float32")))
    rstate = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    state = from_reference_train_state(rstate, get_arch("yi_6b").reduced(), device="cpu")
    ref_leaves = jax.tree_util.tree_flatten(rstate)[0]
    ours = tree_flatten_sorted(state)
    assert len(ref_leaves) == len(ours)
    for r, t in zip(ref_leaves, ours):
        assert np.array_equal(np.asarray(r), t.numpy())
    assert [tuple(t.shape) for t in ours] == [np.shape(r) for r in ref_leaves]
    # the port's own walk is in insertion order, another order
    assert [id(t) for t in tree_leaves(state)] != [id(t) for t in ours]


def test_round_trip_and_uncommitted_dir(tmp_path):
    lm, tc, state = port_state(compression=True)
    step = make_train_step(lm, tc)
    for b in batches(lm, 2):
        state, _ = step(state, b)
    pipe = TokenPipeline(PipelineConfig(vocab_size=lm.cfg.vocab, seq_len=16, global_batch=8),
                         start_step=2)
    save_checkpoint(str(tmp_path), 2, state, extra={"pipe": pipe.state_dict()})
    os.makedirs(tmp_path / "step_000000099")  # partial: no COMMIT
    assert latest_step(str(tmp_path)) == 2 and list_steps(str(tmp_path)) == [2]
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    restored, extra = restore_checkpoint(str(tmp_path), 2, like, device="cpu")
    assert_trees_equal(state, restored)
    assert list(restored) == list(state)  # the port's insertion order is kept
    assert extra["pipe"] == {"step": 2, "seed": 0}
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), 99, like, device="cpu")
    manifest = json.load(open(tmp_path / "step_000000002" / "manifest.json"))
    assert manifest["n_leaves"] == len(tree_leaves(state))


def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path):
    rlm = ref_build(ref_get_arch("yi_6b").reduced())
    rstate = jax.jit(lambda k: ref_init_train_state(rlm, k, RefTrainConfig(dtype="float32")))(
        jax.random.PRNGKey(3))
    rstate["opt"]["step"] = jnp.int32(7)
    rstate["opt"]["m"] = jax.tree.map(lambda p: p * 0.5, rstate["params"])
    ref_save(str(tmp_path), 7, rstate, extra={"note": "ref"})
    _, _, like = port_state()
    restored, extra = restore_checkpoint(str(tmp_path), 7, like, device="cpu")
    want = from_reference_train_state(jax.tree.map(np.asarray, rstate),
                                      get_arch("yi_6b").reduced(), device="cpu")
    assert_trees_equal(want, restored)
    assert extra == {"note": "ref"} and int(restored["opt"]["step"]) == 7


def test_port_checkpoint_restores_in_the_reference_bitwise(tmp_path):
    lm, tc, state = port_state(seed=5)
    state, _ = make_train_step(lm, tc)(state, batches(lm, 1)[0])
    save_checkpoint(str(tmp_path), 1, state, extra={"note": "port"})
    rlm = ref_build(ref_get_arch("yi_6b").reduced())
    like = jax.eval_shape(lambda: ref_init_train_state(
        rlm, jax.random.PRNGKey(0), RefTrainConfig(dtype="float32")))
    rstate, extra = ref_restore(str(tmp_path), 1, like)
    assert extra == {"note": "port"}
    numpy_state = train_state_to_numpy(state)
    for path, r, t in pairs(rstate, numpy_state):
        r = np.asarray(r)
        assert r.dtype == t.dtype and np.array_equal(r, t), path


def test_gc_keeps_last(tmp_path):
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), s, {"x": torch.zeros(3)})
    CheckpointPolicy(keep_last=2).gc(str(tmp_path))
    assert list_steps(str(tmp_path)) == [3, 4]


def test_structure_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3), "b": torch.ones(2)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.empty(3)}, device="cpu")
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.empty(4), "b": torch.empty(2)},
                           device="cpu")


def test_resume_gives_the_uninterrupted_losses_bitwise(tmp_path):
    lm, tc, state = port_state()
    step = make_train_step(lm, tc)
    data = batches(lm, 5)
    losses, s = [], state
    for b in data:
        s, m = step(s, b)
        losses.append(m["loss"])
        if len(losses) == 2:
            save_checkpoint(str(tmp_path), 2, s)
    resumed, _ = restore_checkpoint(str(tmp_path), 2, state, device="cpu")
    again = []
    for b in batches(lm, 3, start=2):
        resumed, m = step(resumed, b)
        again.append(m["loss"])
    assert all(torch.equal(a, b) for a, b in zip(losses[2:], again))
    assert_trees_equal(s, resumed)


def test_run_training_resumes_from_the_reference_launcher_checkpoint(tmp_path, capsys,
                                                                     keep_sigterm):
    """The reference's launcher trains 4 steps and checkpoints; each
    package's launcher resumes from that checkpoint for steps 4 and 5 on
    the same batches: the losses agree."""
    kw = dict(seq_len=16, global_batch=4, ckpt_every=4, log_every=100)
    ref_run_training("yi_6b", steps=4, ckpt_dir=str(tmp_path / "ref"), **kw)
    ref_state, ref_hist = ref_run_training("yi_6b", steps=6, ckpt_dir=str(tmp_path / "ref"),
                                           resume=True, **kw)
    os.rename(tmp_path / "ref" / "step_000000006", tmp_path / "ref_final")
    _, hist = run_training("yi_6b", steps=6, ckpt_dir=str(tmp_path / "ref"), resume=True,
                           device="cpu", **kw)
    assert "resumed from step 4" in capsys.readouterr().out
    assert len(hist) == len(ref_hist) == 2
    for a, b in zip(hist, ref_hist):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (hist, ref_hist)
    assert latest_step(str(tmp_path / "ref")) == 6  # the port's own final save


def test_run_training_with_resume(tmp_path, capsys, keep_sigterm):
    """The reference's launcher test with resume (``tests/test_launch.py``)
    on the port: train 8 steps with checkpoints every 4, the loss falls;
    resume to 10."""
    kw = dict(seq_len=16, global_batch=4, ckpt_dir=str(tmp_path), ckpt_every=4,
              device="cpu")
    _, hist = run_training("yi_6b", steps=8, **kw)
    assert hist[-1] < hist[0] and len(hist) == 8
    _, hist2 = run_training("yi_6b", steps=10, resume=True, **kw)
    assert "resumed from step 8" in capsys.readouterr().out
    assert len(hist2) == 2 and latest_step(str(tmp_path)) == 10


def test_run_training_without_a_card_raises(keep_sigterm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training("yi_6b", steps=1)


@pytest.mark.parametrize("cfg", [dict(vocab_size=1000, seq_len=32, global_batch=8, seed=7),
                                 dict(vocab_size=500, seq_len=16, global_batch=8, num_hosts=4,
                                      host_id=2)])
def test_pipeline_batches_equal_reference_bitwise(cfg):
    ref, port = RefTokenPipeline(RefPipelineConfig(**cfg)), TokenPipeline(PipelineConfig(**cfg))
    for step in range(3):
        a, b = next(ref), next(port)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert port.state_dict() == ref.state_dict()
    restored = TokenPipeline.restore(port.cfg, {"step": 1, "seed": port.cfg.seed})
    assert np.array_equal(next(restored)["tokens"], ref.batch_at(1)["tokens"])


def test_straggler_detection():
    mon = StragglerMonitor(window=20, threshold=3.0)
    for _ in range(15):
        assert not mon.observe(0.10)
    assert mon.observe(1.0)
    assert not mon.observe(0.11)
    assert mon.flags == [15]
