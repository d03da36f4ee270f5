"""Port parity of the dense LM stack, variants (helpers and tolerances
from ``test_torch_models.py``; yi-6b's reduced config): the ``layer``
norm and the plain GELU MLP (no ported arch uses them yet), bf16
activations (max ``|port - reference|`` within 2% of the largest logit),
and the padded vocabulary's logits masked to -1e30.
"""

import numpy as np
import torch

import jax.numpy as jnp

from test_torch_models import F32, check_forward_prefill_decode, inputs, reference_model

torch.set_num_threads(1)


def test_layer_norm_and_plain_gelu_mlp_match_reference():
    """The ``layer`` norm and the plain GELU MLP (no ported arch uses
    them yet) on yi-6b's reduced stack."""
    check_forward_prefill_decode(reference_model("yi_6b", norm_kind="layer",
                                                 mlp_kind="gelu"))


def test_bf16_forward_and_decode_within_bf16_tolerance():
    rlm, rp, lm, p = reference_model("yi_6b")
    rb, tb = inputs(lm.cfg, 2, 24)
    rl, _ = rlm.train_logits(rp, rb, dtype=jnp.bfloat16, remat=False)
    tl, _ = lm.train_logits(p, tb, dtype=torch.bfloat16)
    assert tl.dtype == torch.float32  # logits are f32 whatever the activations
    ref = np.asarray(rl)
    assert np.abs(tl.numpy() - ref).max() <= 0.02 * np.abs(ref).max()
    rc = rlm.init_caches(2, 32, jnp.bfloat16)
    tc = lm.init_caches(2, 32, torch.bfloat16, device="cpu")
    _, rc = rlm.prefill(rp, rb, rc, dtype=jnp.bfloat16)
    _, tc = lm.prefill(p, tb, tc, dtype=torch.bfloat16)
    assert tc["reps"][0]["k"].dtype == torch.bfloat16
    tok = np.array([[3], [5]], np.int32)
    rld, _ = rlm.decode_step(rp, rc, jnp.asarray(tok), jnp.int32(24), dtype=jnp.bfloat16)
    tld, _ = lm.decode_step(p, tc, torch.from_numpy(tok), 24, dtype=torch.bfloat16)
    ref = np.asarray(rld)
    assert np.abs(tld.numpy() - ref).max() <= 0.02 * np.abs(ref).max()


def test_padded_vocab_logits_are_masked_like_the_reference():
    rlm, rp, lm, p = reference_model("yi_6b", vocab=250)  # padded_vocab 256
    assert lm.cfg.padded_vocab == 256
    rb, tb = inputs(lm.cfg, 2, 8)
    rl, _ = rlm.train_logits(rp, rb, dtype=jnp.float32, remat=False)
    tl, _ = lm.train_logits(p, tb, dtype=torch.float32)
    assert (tl[..., 250:] <= -1e29).all() and (tl[..., :250] > -1e29).all()
    np.testing.assert_array_equal(tl[..., 250:].numpy(), np.asarray(rl)[..., 250:])
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **F32)
