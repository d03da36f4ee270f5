"""Port parity of the dense LM stack, continued (helpers and tolerances
from ``test_torch_models.py``): llava (sliding window, the ``embed``
frontend) through forward, prefill and decode; the online-softmax path a
prompt over ``2·block_size`` takes; chunked attention; and decode == the
full forward inside the port.  gemma3 is in
``test_torch_models_gemma3.py``; the layer norm, the plain GELU MLP, bf16
activations and the padded vocab in ``test_torch_models_variants.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_models import F32, check_forward_prefill_decode, inputs, reference_model

torch.set_num_threads(1)


def test_llava_forward_prefill_decode_match_reference():
    check_forward_prefill_decode("llava_next_mistral_7b")


@pytest.mark.parametrize("pattern", [("global",), ("chunked",)])
def test_blocked_softmax_and_chunked_attention_match_reference(pattern):
    """A 150-token prompt is over ``2·block_size`` (64 in the reduced
    configs), so forward and prefill take ``_blocked_sdpa`` (three KV
    blocks, the last padded); ``chunked`` masks by 16-token chunks."""
    rlm, rp, lm, p = reference_model("yi_6b", pattern=pattern, chunk_size=16)
    assert lm.stack.pattern[0].attn.mode == pattern[0]
    rb, tb = inputs(lm.cfg, 1, 150, seed=4)
    rl, _ = rlm.train_logits(rp, rb, dtype=jnp.float32, remat=False)
    tl, _ = lm.train_logits(p, tb, dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **F32)
    rc, tc = rlm.init_caches(1, 192, jnp.float32), lm.init_caches(1, 192, torch.float32,
                                                                   device="cpu")
    rlp, rc = rlm.prefill(rp, rb, rc, dtype=jnp.float32)
    tlp, tc = lm.prefill(p, tb, tc, dtype=torch.float32)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(rlp), **F32)
    tok = np.array([[7]], np.int32)
    rld, _ = rlm.decode_step(rp, rc, jnp.asarray(tok), jnp.int32(150), dtype=jnp.float32)
    tld, _ = lm.decode_step(p, tc, torch.from_numpy(tok), 150, dtype=torch.float32)
    np.testing.assert_allclose(tld.numpy(), np.asarray(rld), **F32)


def test_decode_matches_train_forward_in_the_port():
    """Prefill S tokens + decode token S == the full forward at position S
    (the reference's own property, held inside the port)."""
    _, _, lm, p = reference_model("yi_6b", seed=1)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, lm.cfg.vocab, (2, 25))
                            .astype(np.int32))
    full, _ = lm.train_logits(p, {"tokens": toks}, dtype=torch.float32)
    caches = lm.init_caches(2, 64, torch.float32, device="cpu")
    _, caches = lm.prefill(p, {"tokens": toks[:, :24]}, caches, dtype=torch.float32)
    dec, _ = lm.decode_step(p, caches, toks[:, 24:], 24, dtype=torch.float32)
    ref = full[:, 24].numpy()
    assert np.abs(ref - dec[:, 0].numpy()).max() / np.abs(ref).max() < 2e-4
