"""Port parity of gemma3's reduced config (five sliding-window layers
then a global one, window 16 and global cache cap 32 in the reduced
config, GeGLU with the tanh GELU, scaled embedding), with the helpers
and tolerances of ``test_torch_models.py``: forward, prefill and decode,
and ring-cache eviction past both caps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_models import F32, check_forward_prefill_decode, reference_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gemma():
    return reference_model("gemma3_4b")


def test_forward_prefill_decode_match_reference(gemma):
    check_forward_prefill_decode(gemma)


def test_ring_cache_eviction_matches_reference(gemma):
    """gemma3 reduced: local window 16, global cache cap 32.  A 40-token
    prompt and six decode steps wrap both rings; logits and every cache
    leaf (positions bitwise) stay the reference's.  (The capped global
    cache drops positions the full forward still sees, so decode is not
    held to the forward here; llava's window-only stack is, below.)"""
    rlm, rp, lm, p = gemma
    cfg = lm.cfg
    assert (cfg.local_window, cfg.global_cache_cap) == (16, 32)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (1, 46)).astype(np.int32)
    rc = rlm.init_caches(1, 64, jnp.float32)
    tc = lm.init_caches(1, 64, torch.float32, device="cpu")
    assert tc["reps"][0]["k"].shape[2] == 16 and tc["reps"][5]["k"].shape[2] == 32
    _, rc = rlm.prefill(rp, {"tokens": jnp.asarray(toks[:, :40])}, rc, dtype=jnp.float32)
    _, tc = lm.prefill(p, {"tokens": torch.from_numpy(toks[:, :40])}, tc,
                       dtype=torch.float32)
    for s in range(40, 46):
        tok = toks[:, s:s + 1]
        rld, rc = rlm.decode_step(rp, rc, jnp.asarray(tok), jnp.int32(s), dtype=jnp.float32)
        tld, tc = lm.decode_step(p, tc, torch.from_numpy(tok), s, dtype=torch.float32)
        np.testing.assert_allclose(tld.numpy(), np.asarray(rld), **F32)
    for i in range(len(tc["reps"])):
        np.testing.assert_array_equal(tc["reps"][i]["pos"].numpy(),
                                      np.asarray(rc["reps"][i]["pos"]))
