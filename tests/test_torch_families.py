"""Port parity of the MoE and recurrent stacks (``attn_moe``, ``rec``,
``mlstm``, ``slstm`` blocks) against ``repro``, at the ``reduced()``
configs of llama4-scout (MoE top-1, chunked + global attention), dbrx
(MoE top-2 at this size), recurrentgemma (RG-LRU, local attention, a
tail) and xlstm (mLSTM, sLSTM, a tail), on the reference's parameters
carried across bit for bit (helpers and tolerances from
``test_torch_models.py``):

  * ``train_logits`` with the summed MoE aux, ``prefill`` logits and
    caches, three ``decode_step``s at per-row positions;
  * a stack shorter than its pattern (llama4 at one layer: all tail);
  * decode ≡ the train forward inside the port (``capacity_factor=16``,
    so no pair is dropped, as the reference's own test does);
  * at the published widths, on the meta device (the reference through
    ``jax.eval_shape``): ``param_count`` and ``cache_bytes`` equal the
    reference's, nothing allocated;
  * a decode step returns new recurrent state tensors and leaves the
    states of the caches it was given as they were.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import repro.serving as RS
from repro.configs.base import get_arch as ref_get_arch
from repro.models.model_zoo import build_model as ref_build

import repro_torch.serving as TS
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.models.tree import tree_leaves, tree_map

from test_torch_models import FAMILY_ARCHS, check_forward_prefill_decode, reference_model

torch.set_num_threads(1)

RECURRENT_ARCHS = ("recurrentgemma_9b", "xlstm_125m")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    check_forward_prefill_decode(arch)


def test_a_stack_shorter_than_its_pattern_matches_reference():
    """llama4 at one layer: no full repetition of its 4-block pattern, so
    the rep-stacked leaves are ``(0, ...)`` and the layer is the tail, as
    in the reference (the smoke's card-vs-CPU check runs this stack)."""
    model = reference_model("llama4_scout_17b_a16e", n_layers=1)
    lm, p = model[2], model[3]
    assert (lm.stack.reps, lm.stack.n_tail) == (0, 1)
    assert p["stack"]["reps"][0]["moe"]["w_gate"].shape[0] == 0
    check_forward_prefill_decode(model)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_matches_train_forward_in_the_port(arch):
    """Prefill S tokens + decode token S == the full forward at position
    S, within 2e-4 of the largest logit (the reference's own property)."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), capacity_factor=16.0)
    lm = build_model(cfg)
    p = lm.init(torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 25))
                            .astype(np.int32))
    full, _ = lm.train_logits(p, {"tokens": toks}, dtype=torch.float32)
    caches = lm.init_caches(2, 64, torch.float32, device="cpu")
    _, caches = lm.prefill(p, {"tokens": toks[:, :24]}, caches, dtype=torch.float32)
    dec, _ = lm.decode_step(p, caches, toks[:, 24:], 24, dtype=torch.float32)
    ref = full[:, 24].numpy()
    assert np.abs(ref - dec[:, 0].numpy()).max() / np.abs(ref).max() < 2e-4


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_param_count_and_cache_bytes_equal_reference_at_published_widths(arch):
    rlm, lm = ref_build(ref_get_arch(arch)), build_model(get_arch(arch))
    want = jax.eval_shape(rlm.init, jax.random.PRNGKey(0))
    meta = lm.init(None)
    assert all(t.device.type == "meta" for t in tree_leaves(meta))
    assert lm.param_count(meta) == sum(x.size for x in jax.tree.leaves(want))
    for dtype in ("bfloat16", "float32"):
        n = TS.cache_bytes(lm, 4, 512, TS.CachePolicy(dtype))
        assert n == RS.cache_bytes(rlm, 4, 512, RS.CachePolicy(dtype))


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_decode_returns_new_states_and_keeps_the_old(arch):
    """Recurrent states come back as new tensors (rep-stacked states in
    fresh ``(R, B, ...)`` leaves); the caches the step was given keep
    their states bit for bit, while attention K/V is written in place."""
    cfg = get_arch(arch).reduced()
    lm = build_model(cfg)
    p = lm.init(torch.Generator().manual_seed(0), device="cpu")
    caches = lm.init_caches(2, 32, torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))
                            .astype(np.int32))
    _, caches = lm.prefill(p, {"tokens": toks[:, :8]}, caches, dtype=torch.float32)
    before = tree_map(lambda a: a.clone(), caches)
    _, new = lm.decode_step(p, caches, toks[:, 8:], 8, dtype=torch.float32)
    for i, bc in enumerate(lm.stack.pattern):
        old, got, was = caches["reps"][i], new["reps"][i], before["reps"][i]
        if bc.kind in T.STATE_KINDS:
            assert all(torch.equal(old[k], was[k]) for k in was)
            assert all(got[k].data_ptr() != old[k].data_ptr() for k in got)
            assert any(not torch.equal(got[k], was[k]) for k in got)
        else:
            assert got is old and not torch.equal(old["k"], was["k"])
    for i in range(lm.stack.n_tail):
        assert lm.stack.pattern[i].kind in T.STATE_KINDS
        old, got, was = caches["tail"][i], new["tail"][i], before["tail"][i]
        assert all(torch.equal(old[k], was[k]) for k in was)
        assert all(got[k].data_ptr() != old[k].data_ptr() for k in got)
