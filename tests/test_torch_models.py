"""Port parity of the dense LM stack (``repro_torch.configs`` /
``repro_torch.models``) against ``repro``: the reference's parameters,
drawn by ``jax.random`` and carried across as numpy arrays
(``from_reference_params``, bit for bit), run through both packages on
the same token inputs from ``np.random.default_rng``.

Checked for the ``attn_mlp`` archs' ``reduced()`` configs (yi-6b, phi3,
mistral-large here; gemma3 and llava, the blocked softmax, chunked
attention, ring eviction, bf16 and the padded vocab in
``test_torch_models_paths.py``; the MoE and recurrent archs in
``test_torch_families*.py``):
``train_logits`` and its aux (0.0 without MoE), ``prefill`` logits and
caches, and three ``decode_step`` logits at per-row positions.  The init
tree is held to the reference's for every arch (the encoder-decoder
model's parity is in ``test_torch_encdec*.py``).  Tolerances: float32 ``rtol=1e-4,
atol=1e-5`` (the two packages sum each product in another order); bf16
activations, max ``|port - reference|`` within 2% of the largest logit
(bf16 keeps 8 bits of mantissa, and the two round at other points).
Cache positions are bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import ARCH_IDS
from repro.configs.base import get_arch as ref_get_arch
from repro.models import transformer as RT
from repro.models.model_zoo import build_model as ref_build

from repro_torch.configs import get_arch
from repro_torch.core.convert import from_reference_params
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import LM, build_model
from repro_torch.models.tree import tree_leaves, tree_map

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
ATTN_MLP_ARCHS = ("yi_6b", "phi3_mini_3_8b", "mistral_large_123b", "gemma3_4b",
                  "llava_next_mistral_7b")
#: MoE and recurrent stacks (parity in ``test_torch_families*.py``).
FAMILY_ARCHS = ("llama4_scout_17b_a16e", "dbrx_132b", "recurrentgemma_9b", "xlstm_125m")
#: The encoder-decoder arch (parity in ``test_torch_encdec*.py``).
ENCDEC_ARCHS = tuple(a for a in ARCH_IDS if a not in ATTN_MLP_ARCHS + FAMILY_ARCHS)


class Jitted:
    """The reference LM's entry points, each jitted once (its eager layer
    scan would trace and compile again on every call)."""

    def __init__(self, rlm):
        self.cfg = rlm.cfg
        self.init_caches = rlm.init_caches
        self._train = jax.jit(rlm.train_logits, static_argnames=("dtype", "remat"))
        self._prefill = jax.jit(rlm.prefill, static_argnames=("dtype",))
        self._decode = jax.jit(rlm.decode_step, static_argnames=("dtype",))

    def train_logits(self, params, batch, *, dtype, remat=False):
        return self._train(params, batch, dtype=dtype, remat=remat)

    def prefill(self, params, batch, caches, *, dtype):
        return self._prefill(params, batch, caches, dtype=dtype)

    def decode_step(self, params, caches, tokens, pos, *, dtype):
        return self._decode(params, caches, tokens, pos, dtype=dtype)


def reference_model(arch, seed=0, **overrides):
    """(reference LM with jitted entry points, its params, the port's LM,
    the same params as the port's tree) for ``arch``'s reduced config."""
    rcfg = dataclasses.replace(ref_get_arch(arch).reduced(), **overrides)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **overrides)
    rlm = ref_build(rcfg)
    rparams = jax.jit(rlm.init)(jax.random.PRNGKey(seed))
    params = from_reference_params(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return Jitted(rlm), rparams, build_model(cfg), params


def inputs(cfg, b, s, seed=0):
    """The same batch for both packages: tokens, or embeddings for the
    ``embed`` frontend."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embed":
        emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(emb)}, {"embeds": torch.from_numpy(emb)}
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def pairs(ref_tree, tree):
    """(path, reference leaf, port leaf) triples, matched by key and
    position (JAX orders dict leaves by sorted key)."""
    def walk(path, node):
        if isinstance(node, dict):
            return [x for k in node for x in walk(path + (k,), node[k])]
        if isinstance(node, (list, tuple)):
            return [x for i, v in enumerate(node) for x in walk(path + (i,), v)]
        ref = ref_tree
        for k in path:
            ref = ref[k]
        return [(path, ref, node)]
    return walk((), tree)


def assert_cache_close(rcache, cache):
    assert len(jax.tree.leaves(rcache)) == len(tree_leaves(cache))
    for path, r, t in pairs(rcache, cache):
        r = np.asarray(r)
        assert r.shape == tuple(t.shape), path
        if r.dtype == np.int32:
            assert np.array_equal(r, t.numpy()), path
        else:
            np.testing.assert_allclose(t.float().numpy(), r.astype(np.float32), **F32)


def check_forward_prefill_decode(model):
    """``model``: an arch name, or :func:`reference_model`'s tuple."""
    rlm, rp, lm, p = reference_model(model) if isinstance(model, str) else model
    cfg = lm.cfg
    b, s = 2, 24
    rb, tb = inputs(cfg, b, s)
    rl, raux = rlm.train_logits(rp, rb, dtype=jnp.float32, remat=False)
    tl, aux = lm.train_logits(p, tb, dtype=torch.float32)
    assert tl.shape == (b, s, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **F32)
    np.testing.assert_allclose(float(aux), float(raux), **F32)  # MoE aux, else 0.0

    rc = rlm.init_caches(b, 48, jnp.float32)
    tc = lm.init_caches(b, 48, torch.float32, device="cpu")
    rlp, rc = rlm.prefill(rp, rb, rc, dtype=jnp.float32)
    tlp, tc = lm.prefill(p, tb, tc, dtype=torch.float32)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(rlp), **F32)
    assert_cache_close(rc, tc)

    rng = np.random.default_rng(1)
    pos = np.array([s, s + 3], np.int32)  # rows decode at their own positions
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        rld, rc = rlm.decode_step(rp, rc, jnp.asarray(tok), jnp.asarray(pos + step),
                                  dtype=jnp.float32)
        tld, tc = lm.decode_step(p, tc, torch.from_numpy(tok),
                                 torch.from_numpy(pos + step), dtype=torch.float32)
        np.testing.assert_allclose(tld.numpy(), np.asarray(rld), **F32)
    assert_cache_close(rc, tc)


@pytest.mark.parametrize("arch", ["yi_6b", "phi3_mini_3_8b", "mistral_large_123b"])
def test_forward_prefill_decode_match_reference(arch):
    check_forward_prefill_decode(arch)


def test_from_reference_params_is_bitwise_and_checks_the_tree():
    rlm, rp, lm, p = reference_model("yi_6b", seed=3)
    assert len(pairs(rp, p)) == len(jax.tree.leaves(rp))
    for path, leaf, node in pairs(rp, p):
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(leaf)), path
    assert lm.param_count(p) == sum(x.size for x in jax.tree.leaves(rp))
    assert isinstance(p["stack"]["reps"], tuple) and isinstance(p["stack"]["tail"], list)
    bad = jax.tree.map(np.asarray, rp)
    bad["stack"]["reps"][0]["mlp"]["w_up"] = bad["stack"]["reps"][0]["mlp"]["w_up"][:, :-1]
    with pytest.raises(ValueError, match="w_up"):
        from_reference_params(bad, lm.cfg, device="cpu")
    missing = jax.tree.map(np.asarray, rp)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        from_reference_params(missing, lm.cfg, device="cpu")


@pytest.mark.parametrize("arch", ATTN_MLP_ARCHS + FAMILY_ARCHS + ENCDEC_ARCHS)
def test_init_has_the_reference_tree(arch):
    """Names, nesting, shapes and dtypes of ``LM.init`` equal the
    reference's ``lm.init`` (its shapes from ``jax.eval_shape``); the meta
    init allocates nothing; a seeded generator draws the same tree twice."""
    cfg = get_arch(arch).reduced()
    rlm = ref_build(ref_get_arch(arch).reduced())
    want = jax.eval_shape(rlm.init, jax.random.PRNGKey(0))
    lm = build_model(cfg)
    meta = lm.init(None)
    assert len(jax.tree.leaves(want)) == len(tree_leaves(meta))
    for path, leaf, node in pairs(want, meta):
        assert node.device.type == "meta"
        assert tuple(node.shape) == tuple(leaf.shape) and node.dtype == torch.float32, path
    a = lm.init(torch.Generator().manual_seed(5), device="cpu")
    b = lm.init(torch.Generator().manual_seed(5), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_configs_are_the_reference_configs():
    for arch in ARCH_IDS:
        for full in (True, False):
            want = ref_get_arch(arch) if full else ref_get_arch(arch).reduced()
            got = get_arch(arch) if full else get_arch(arch).reduced()
            assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
            assert got.padded_vocab == want.padded_vocab
            assert got.sub_quadratic == want.sub_quadratic
    assert get_arch("yi-6b") is get_arch("yi_6b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_block_cfg_parses_every_block_type(arch):
    """Every block type of all ten archs parses to the reference's kind,
    attention, MoE and recurrent specs."""
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    for block_type in set(cfg.pattern) | ({"enc", "xattn"} if cfg.is_encdec else set()):
        got, want = T.make_block_cfg(cfg, block_type), RT.make_block_cfg(rcfg, block_type)
        assert got.kind == want.kind
        for name in ("attn", "cross", "moe", "mlstm", "slstm", "rglru"):
            g, w = getattr(got, name), getattr(want, name)
            assert (g is None) == (w is None)
            if g is not None:
                assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert (got.d_model, got.norm_kind, got.mlp_kind, got.d_ff) == (
            want.d_model, want.norm_kind, want.mlp_kind, want.d_ff)
    sc, rsc = T.make_stack_cfg(cfg, cfg.pattern, cfg.n_layers), RT.make_stack_cfg(
        rcfg, rcfg.pattern, rcfg.n_layers)
    assert (sc.reps, sc.n_tail, sc.n_layers) == (rsc.reps, rsc.n_tail, rsc.n_layers)


def test_entry_points_default_to_the_card():
    """Without a card, every entry point that allocates raises unless it
    is asked for the CPU (or the meta device, shapes only)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    lm = build_model(get_arch("yi_6b").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_caches(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference_params(tree_map(lambda t: np.zeros(t.shape, np.float32),
                                       lm.init(None)), lm.cfg)
    assert lm.init_caches(1, 8, device="meta")["reps"][0]["k"].device.type == "meta"
