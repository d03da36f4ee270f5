"""Port parity of the encoder-decoder blocks (``repro_torch.models``:
``attention.cross_kv`` / ``attend_cross`` and the ``enc`` / ``xattn``
blocks of ``transformer``) against ``repro``, on the reference's
parameters carried across bit for bit and inputs from
``np.random.default_rng``: cross-attention at a short memory and on the
blocked online-softmax path, and each block's train, prefill and decode.
The whole ``encdec`` model is in ``test_torch_encdec.py``.  Tolerance:
float32 ``rtol=1e-4, atol=1e-5``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import get_arch as ref_get_arch
from repro.models import attention as RA
from repro.models import transformer as RT

from repro_torch.configs import get_arch
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.tree import tree_map

from test_torch_models import F32, assert_cache_close, pairs

torch.set_num_threads(1)

ARCH = "seamless_m4t_medium"


def to_port(tree):
    """A reference pytree as the port's tree of CPU tensors (bit for bit)."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, tree))


def cross_spec(block_size):
    """seamless's reduced cross-attention spec (4 heads over 2 KV heads:
    the GQA repeat is exercised) at ``block_size``."""
    bc = RT.make_block_cfg(ref_get_arch(ARCH).reduced(), "xattn")
    return dataclasses.replace(bc.cross, block_size=block_size)


@pytest.mark.parametrize("block_size", [64, 4], ids=["direct", "blocked"])
def test_cross_attention_matches_reference(block_size):
    """``cross_kv`` then ``attend_cross`` over a 21-frame memory: directly
    at block 64, and at block 4 through the online softmax (six KV blocks,
    the last padded)."""
    rspec = cross_spec(block_size)
    spec = A.AttnSpec(**dataclasses.asdict(rspec))
    rp = RA.init_attention(jax.random.PRNGKey(1), rspec)
    p = to_port(rp)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, spec.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 21, spec.d_model)).astype(np.float32)
    rk, rv = RA.cross_kv(rp, jnp.asarray(mem), rspec)
    k, v = A.cross_kv(p, torch.from_numpy(mem), spec)
    assert tuple(k.shape) == rk.shape == (2, 21, spec.n_kv, spec.d_head)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), **F32)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), **F32)
    ry = RA.attend_cross(rp, jnp.asarray(x), rk, rv, rspec)
    y = A.attend_cross(p, torch.from_numpy(x), k, v, spec)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **F32)
    # the direct and the blocked softmax agree inside the port too
    other = dataclasses.replace(spec, block_size=64 if block_size == 4 else 4)
    np.testing.assert_allclose(A.attend_cross(p, torch.from_numpy(x), k, v, other).numpy(),
                               y.numpy(), **F32)


@pytest.mark.parametrize("kind", ["enc", "xattn"])
def test_blocks_train_prefill_decode_match_reference(kind):
    """One ``enc`` / ``xattn`` block: the train pass, the prefill (new
    cache: self K/V and, for ``xattn``, the memory's ``ck``/``cv``) and two
    decode steps at per-row positions."""
    rcfg = ref_get_arch(ARCH).reduced()
    rbc = RT.make_block_cfg(rcfg, kind)
    bc = T.make_block_cfg(get_arch(ARCH).reduced(), kind)
    rp = RT.init_block(jax.random.PRNGKey(2), rbc)
    p = to_port(rp)
    assert sorted(path for path, _, _ in pairs(rp, p)) == sorted(
        path for path, _, _ in pairs(rp, T.init_block(None, bc)))
    rng = np.random.default_rng(4)
    b, s = 2, 9
    x = rng.standard_normal((b, s, rcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((b, rcfg.enc_seq, rcfg.d_model)).astype(np.float32)
    rmem, tmem = (jnp.asarray(mem), torch.from_numpy(mem)) if kind == "xattn" else (None, None)
    ry, _ = RT.block_train(rp, jnp.asarray(x), rbc, rmem)
    y, aux = T.block_train(p, torch.from_numpy(x), bc, tmem)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **F32)
    assert aux == 0.0

    rc = RT.init_block_cache(rbc, b, 16, rcfg.enc_seq, jnp.float32)
    tc = T.init_block_cache(bc, b, 16, rcfg.enc_seq, torch.float32, device="cpu")
    ry, rc = RT.block_prefill(rp, jnp.asarray(x), rbc, rc, rmem)
    y, tc = T.block_prefill(p, torch.from_numpy(x), bc, tc, tmem)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **F32)
    assert_cache_close(rc, tc)
    pos = np.array([s, s + 2], np.int32)
    for step in range(2):
        xd = rng.standard_normal((b, 1, rcfg.d_model)).astype(np.float32)
        ry, rc = RT.block_decode(rp, jnp.asarray(xd), rbc, rc, jnp.asarray(pos + step))
        y, tc = T.block_decode(p, torch.from_numpy(xd), bc, tc, torch.from_numpy(pos + step))
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **F32)
    assert_cache_close(rc, tc)
