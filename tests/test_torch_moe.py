"""Port parity of the MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe``: the reference's parameters, drawn by
``jax.random`` and carried across as numpy arrays, and the same seeded
activations through both packages.  Output and aux within float32
tolerance (``rtol=1e-4, atol=1e-5``: the products and the combine sum in
another order), at top-1 and top-4, under a capacity that drops pairs
(the same pairs in both), and through the chunked dispatch.  The
combine adds each token's rows in ascending slot order, with no
atomics: a token's bits do not depend on its companions' order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import moe as RM

from repro_torch.models import moe as M

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)


def setup(t, *, seed=0, **kw):
    """(reference spec, port spec, reference params, port params, the
    activations (1, t, d) as numpy)."""
    spec = dict(d_model=32, d_ff=48, n_experts=4, top_k=2)
    spec.update(kw)
    rspec, tspec = RM.MoESpec(**spec), M.MoESpec(**spec)
    rp = RM.init_moe(jax.random.PRNGKey(seed), rspec)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = np.random.default_rng(seed).standard_normal((1, t, spec["d_model"])).astype(
        np.float32)
    return rspec, tspec, rp, tp, x


def run_both(rspec, tspec, rp, tp, x):
    ry, raux = jax.jit(RM.moe_ffn, static_argnums=2)(rp, jnp.asarray(x), rspec)
    ty, taux = M.moe_ffn(tp, torch.from_numpy(x), tspec)
    return np.asarray(ry), float(raux), ty.numpy(), float(taux)


def reference_keep(rp, x, rspec):
    """The reference's routing, as its ``_moe_tokens`` computes it: each
    (token, pick)'s expert and whether its rank is under capacity."""
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, rp["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, rspec.top_k)
    idx = np.asarray(idx)
    t, k = idx.shape
    flat = np.eye(rspec.n_experts, dtype=np.int64)[idx.reshape(-1)]
    rank = ((np.cumsum(flat, 0) - flat) * flat).sum(-1).reshape(t, k)
    return idx, rank < RM._capacity(t, rspec)


@pytest.mark.parametrize("top_k", [1, 4])
def test_moe_ffn_matches_reference(top_k):
    rspec, tspec, rp, tp, x = setup(24, top_k=top_k, n_experts=8)
    ry, raux, ty, taux = run_both(rspec, tspec, rp, tp, x)
    np.testing.assert_allclose(ty, ry, **F32)
    np.testing.assert_allclose(taux, raux, **F32)
    assert np.abs(ty).max() > 0


@pytest.mark.parametrize("top_k", [1, 2])
def test_capacity_drops_the_reference_pairs(top_k):
    """capacity_factor 0.25 over 32 tokens and 4 experts: capacity 4
    (``min_capacity``) against about 8 picks per expert, so pairs are
    dropped; the port keeps and drops the same pairs.  At top-1 a dropped
    token's output row is exactly zero in both."""
    rspec, tspec, rp, tp, x = setup(32, top_k=top_k, capacity_factor=0.25, seed=1)
    assert M._capacity(32, tspec) == 4
    idx, keep = reference_keep(rp, x, rspec)
    route = M._route(tp, torch.from_numpy(x[0]), tspec)
    assert np.array_equal(route.expert_idx.numpy(), idx)
    assert np.array_equal(route.keep.numpy(), keep)
    assert (~keep).sum() >= 8
    ry, raux, ty, taux = run_both(rspec, tspec, rp, tp, x)
    np.testing.assert_allclose(ty, ry, **F32)
    np.testing.assert_allclose(taux, raux, **F32)
    if top_k == 1:
        zero_rows = ~keep[:, 0]
        assert (ty[0][zero_rows] == 0).all() and (ry[0][zero_rows] == 0).all()
        assert (np.abs(ty[0][~zero_rows]).max(-1) > 0).all()


def test_chunked_dispatch_matches_reference():
    """token_chunk=8 over 32 tokens: four chunks, capacity per chunk, aux
    the mean over chunks; chunking changes the result (capacity binds
    differently), and both packages chunk alike."""
    rspec, tspec, rp, tp, x = setup(32, token_chunk=8, capacity_factor=0.5, seed=2)
    ry, raux, ty, taux = run_both(rspec, tspec, rp, tp, x)
    np.testing.assert_allclose(ty, ry, **F32)
    np.testing.assert_allclose(taux, raux, **F32)
    whole = M.moe_ffn(tp, torch.from_numpy(x), M.MoESpec(**{
        **tspec.__dict__, "token_chunk": 16_384}))[0].numpy()
    assert not np.allclose(whole, ty)


def test_combine_adds_in_slot_order_without_atomics():
    """``_combine`` equals the reference's scatter-add order: a zeroed
    row plus each kept slot's row in ascending slot order; dropped pairs
    (slot ``E·cap``) add nothing."""
    rng = np.random.default_rng(3)
    y_w = torch.from_numpy(rng.standard_normal((12, 5)).astype(np.float32))
    dest = torch.tensor([[7, 2], [12, 0], [12, 12], [3, 9]])
    out = M._combine(y_w, dest)
    want = torch.zeros((4, 5))
    for t in range(4):
        for s in sorted(dest[t].tolist()):
            if s < 12:
                want[t] = want[t] + y_w[s]
    assert torch.equal(out, want)
    assert torch.equal(out[2], torch.zeros(5))
