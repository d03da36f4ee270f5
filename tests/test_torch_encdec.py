"""Port parity of the encoder-decoder model (the ``encdec`` frontend of
``repro_torch.models.model_zoo.LM``: seamless) against ``repro`` on the
same parameters (the reference's, carried across bit for bit) and the
same inputs from ``np.random.default_rng``.

Checked: seamless's ``reduced()`` config through ``train_logits``,
``prefill`` and ``decode_step`` in float32, also on the blocked
online-softmax path; its caches' shapes, dtypes and bytes; the padded
vocabulary's mask; the parameter tree's crossing; and, inside the port,
decode after prefill == the full forward and rows that stay independent
of each other.  The blocks alone are in ``test_torch_encdec_blocks.py``,
bf16 in ``test_torch_encdec_bf16.py``.  Tolerance: float32 ``rtol=1e-4,
atol=1e-5``.  The reduced config's
source length equals its ``enc_seq`` (16): ``block_prefill`` replaces
``ck``/``cv`` with the memory's projection at the memory's own length, in
both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import get_arch as ref_get_arch
from repro.models.model_zoo import build_model as ref_build
from repro.serving import kv_cache as ref_kv

from repro_torch.configs import get_arch
from repro_torch.core.convert import from_reference_params
from repro_torch.models.model_zoo import build_model
from repro_torch.models.tree import tree_leaves
from repro_torch.serving import kv_cache

from test_torch_models import F32, assert_cache_close, pairs, reference_model

torch.set_num_threads(1)

ARCH = "seamless_m4t_medium"


def encdec_inputs(cfg, b, s, seed=0):
    """The same encdec batch for both packages: source frames (B, S_enc,
    d) standing in for the speech frontend, and decoder tokens."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return ({"src_frames": jnp.asarray(src), "tokens": jnp.asarray(toks)},
            {"src_frames": torch.from_numpy(src), "tokens": torch.from_numpy(toks)})


@pytest.fixture(scope="module")
def seamless():
    return reference_model(ARCH)


def test_seamless_forward_prefill_decode_match_reference(seamless):
    """seamless reduced (2 encoder + 2 decoder layers), float32: the
    forward, the prefill (encoder, memory projection, decoder prompt) and
    three decode steps at per-row positions, with the caches."""
    rlm, rp, lm, p = seamless
    cfg = lm.cfg
    assert (lm.enc_stack.n_layers, lm.dec_stack.n_layers) == (2, 2)
    b, s = 2, 12
    rb, tb = encdec_inputs(cfg, b, s)
    rl, _ = rlm.train_logits(rp, rb, dtype=jnp.float32, remat=False)
    tl, aux = lm.train_logits(p, tb, dtype=torch.float32)
    assert tl.shape == (b, s, cfg.padded_vocab) and aux == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **F32)

    rc = rlm.init_caches(b, 32, jnp.float32)
    tc = lm.init_caches(b, 32, torch.float32, device="cpu")
    rlp, rc = rlm.prefill(rp, rb, rc, dtype=jnp.float32)
    tlp, tc = lm.prefill(p, tb, tc, dtype=torch.float32)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(rlp), **F32)
    assert_cache_close(rc, tc)
    rng = np.random.default_rng(1)
    pos = np.array([s, s + 3], np.int32)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        rld, rc = rlm.decode_step(rp, rc, jnp.asarray(tok), jnp.asarray(pos + step),
                                  dtype=jnp.float32)
        tld, tc = lm.decode_step(p, tc, torch.from_numpy(tok),
                                 torch.from_numpy(pos + step), dtype=torch.float32)
        np.testing.assert_allclose(tld.numpy(), np.asarray(rld), **F32)
    assert_cache_close(rc, tc)


def test_seamless_on_the_blocked_softmax_matches_reference():
    """At ``attn_block_size`` 4 the encoder's self-attention, the
    decoder's and the cross-attention over the 16-frame memory all take
    the online softmax."""
    rlm, rp, lm, p = reference_model(ARCH, seed=5, attn_block_size=4)
    assert lm.dec_stack.pattern[0].cross.block_size == 4
    rb, tb = encdec_inputs(lm.cfg, 2, 10, seed=6)
    rl, _ = rlm.train_logits(rp, rb, dtype=jnp.float32, remat=False)
    tl, _ = lm.train_logits(p, tb, dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **F32)
    rc, tc = rlm.init_caches(2, 16, jnp.float32), lm.init_caches(2, 16, torch.float32,
                                                                 device="cpu")
    _, rc = rlm.prefill(rp, rb, rc, dtype=jnp.float32)
    _, tc = lm.prefill(p, tb, tc, dtype=torch.float32)
    tok = np.array([[3], [8]], np.int32)
    rld, _ = rlm.decode_step(rp, rc, jnp.asarray(tok), jnp.int32(10), dtype=jnp.float32)
    tld, _ = lm.decode_step(p, tc, torch.from_numpy(tok), 10, dtype=torch.float32)
    np.testing.assert_allclose(tld.numpy(), np.asarray(rld), **F32)


def test_decode_after_prefill_equals_the_full_forward(seamless):
    """Prefill S tokens + decode token S == the full forward at position S
    within 2e-4 of the largest logit (the reference's own yardstick,
    ``tests/test_models.py::test_decode_matches_train_forward``)."""
    _, _, lm, p = seamless
    _, tb = encdec_inputs(lm.cfg, 2, 25, seed=7)
    full, _ = lm.train_logits(p, tb, dtype=torch.float32)
    caches = lm.init_caches(2, 64, torch.float32, device="cpu")
    prompt = {"src_frames": tb["src_frames"], "tokens": tb["tokens"][:, :24]}
    _, caches = lm.prefill(p, prompt, caches, dtype=torch.float32)
    dec, _ = lm.decode_step(p, caches, tb["tokens"][:, 24:], 24, dtype=torch.float32)
    ref = full[:, 24].numpy()
    assert np.abs(ref - dec[:, 0].numpy()).max() / np.abs(ref).max() < 2e-4


def test_rows_are_independent_and_slots_insert_alone(seamless):
    """Changing one row's frames and tokens leaves every other row's
    prefill and decode logits bitwise the same; a batch-1 prefill
    inserted into slot 1 (``insert_slot_caches``, nested ``self`` /
    ``ck`` / ``cv``) decodes as that row of the batched prefill does."""
    _, _, lm, p = seamless
    _, tb = encdec_inputs(lm.cfg, 3, 8, seed=8)
    _, other = encdec_inputs(lm.cfg, 3, 8, seed=9)
    changed = {k: v.clone() for k, v in tb.items()}
    for k in changed:
        changed[k][1] = other[k][1]
    tok = torch.tensor([[1], [2], [3]], dtype=torch.int32)
    outs = []
    for batch in (tb, changed):
        caches = lm.init_caches(3, 16, torch.float32, device="cpu")
        first, caches = lm.prefill(p, batch, caches, dtype=torch.float32)
        step, caches = lm.decode_step(p, caches, tok, 8, dtype=torch.float32)
        outs.append((first, step, caches))
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert torch.equal(a[[0, 2]], b[[0, 2]]) and not torch.equal(a[1], b[1])
    caches = lm.init_caches(3, 16, torch.float32, device="cpu")
    _, caches = lm.prefill(p, tb, caches, dtype=torch.float32)
    one = lm.init_caches(1, 16, torch.float32, device="cpu")
    _, one = lm.prefill(p, {k: v[1:2] for k, v in changed.items()}, one, dtype=torch.float32)
    lm.insert_slot_caches(caches, one, 1)
    step, caches = lm.decode_step(p, caches, tok, 8, dtype=torch.float32)
    assert torch.equal(step[[0, 2]], outs[0][1][[0, 2]])
    torch.testing.assert_close(step[1], outs[1][1][1], rtol=1e-5, atol=1e-5)
    for got, want in zip(tree_leaves(caches), tree_leaves(outs[1][2])):
        if got.dtype == torch.int32:
            assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_shapes_dtypes_and_bytes_equal_reference(dtype):
    """The decoder's caches at seamless's full width and at its reduced
    config: the reference's tree (``self`` K/V and positions, ``ck``/``cv``
    of ``(R, B, enc_seq, KV, dh)``), shape for shape and dtype for dtype,
    and ``cache_bytes`` equal to the reference's."""
    for full in (True, False):
        rcfg = ref_get_arch(ARCH) if full else ref_get_arch(ARCH).reduced()
        cfg = get_arch(ARCH) if full else get_arch(ARCH).reduced()
        rlm, lm = ref_build(rcfg), build_model(cfg)
        want = jax.eval_shape(lambda: rlm.init_caches(4, 512, jnp.dtype(dtype)))
        got = kv_cache.cache_specs(lm, 4, 512, kv_cache.CachePolicy(dtype))
        assert len(jax.tree.leaves(want)) == len(tree_leaves(got)) == 5
        for path, leaf, node in pairs(want, got):
            assert node.device.type == "meta"
            assert tuple(node.shape) == tuple(leaf.shape), path
            assert str(node.dtype).removeprefix("torch.") == leaf.dtype.name, path
        assert got["reps"][0]["ck"].shape == (cfg.n_layers, 4, cfg.enc_seq, cfg.n_kv,
                                              cfg.head_dim)
        assert kv_cache.cache_bytes(lm, 4, 512, kv_cache.CachePolicy(dtype)) == \
            ref_kv.cache_bytes(rlm, 4, 512, ref_kv.CachePolicy(dtype))


def test_padded_vocab_logits_are_masked_like_the_reference():
    """vocab 250 pads to 256: the six padded columns hold -1e30 in both
    packages (the reference's ``test_vocab_padding_masks_logits``)."""
    rlm, rp, lm, p = reference_model(ARCH, vocab=250)
    assert lm.cfg.padded_vocab == 256
    rb, tb = encdec_inputs(lm.cfg, 2, 8)
    rl, _ = rlm.train_logits(rp, rb, dtype=jnp.float32, remat=False)
    tl, _ = lm.train_logits(p, tb, dtype=torch.float32)
    assert (tl[..., 250:] <= -1e29).all() and (tl[..., :250] > -1e29).all()
    np.testing.assert_array_equal(tl[..., 250:].numpy(), np.asarray(rl)[..., 250:])
    np.testing.assert_allclose(tl[..., :250].numpy(), np.asarray(rl)[..., :250], **F32)


def test_from_reference_params_checks_the_encdec_tree(seamless):
    """The encdec tree (``encoder``, ``enc_norm``, ``decoder`` with
    ``ln_cross`` / ``cross``) crosses bit for bit; a wrong shape or a
    missing key raises."""
    _, rp, lm, p = seamless
    assert {"encoder", "enc_norm", "decoder"} <= set(p) and "stack" not in p
    assert set(p["decoder"]["reps"][0]) == {"ln_attn", "attn", "ln_cross", "cross",
                                            "ln_mlp", "mlp"}
    for path, leaf, node in pairs(rp, p):
        assert np.array_equal(node.numpy(), np.asarray(leaf)), path
    bad = jax.tree.map(np.asarray, rp)
    bad["decoder"]["reps"][0]["cross"]["wk"] = bad["decoder"]["reps"][0]["cross"]["wk"][:-1]
    with pytest.raises(ValueError, match="cross/wk"):
        from_reference_params(bad, lm.cfg, device="cpu")
    missing = jax.tree.map(np.asarray, rp)
    del missing["enc_norm"]
    with pytest.raises(ValueError, match="keys"):
        from_reference_params(missing, lm.cfg, device="cpu")
