"""Port parity of the recurrent mixers (``repro_torch.models.recurrent``:
mLSTM, sLSTM, RG-LRU) against ``repro.models.recurrent``, on the
reference's parameters carried across as numpy arrays and the same
seeded activations.

For each mixer: the train pass from no state; a prefill from that
pass's state (a nonzero carried state: C/n/m, c/n/h/m or h, and the conv
state) with its new state; three decode steps from there.  Outputs and
states within float32 tolerance (``rtol=1e-4, atol=1e-5``): the products
sum in another order, and RG-LRU's recurrence runs in time order where
the reference's associative scan runs a tree.  The port's state updates
return new tensors and leave the state they were given as it was.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import recurrent as RR

from repro_torch.models import recurrent as R

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)

MIXERS = {
    # name: (spec kwargs, init, train, decode), the spec class by name
    "mlstm": (dict(d_model=32, n_heads=2, chunk=8), "MLSTMSpec", "init_mlstm",
              "mlstm_train", "mlstm_decode"),
    "slstm": (dict(d_model=32, n_heads=4), "SLSTMSpec", "init_slstm",
              "slstm_train", "slstm_decode"),
    "rglru": (dict(d_model=32), "RGLRUSpec", "init_rglru", "rglru_train",
              "rglru_decode"),
}


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def assert_state_close(rstate, tstate):
    assert set(rstate) == set(tstate)
    for k, v in rstate.items():
        v = np.asarray(v)
        assert tuple(tstate[k].shape) == v.shape and str(tstate[k].dtype)[6:] == v.dtype.name
        np.testing.assert_allclose(tstate[k].numpy(), v, **F32, err_msg=k)


@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_train_prefill_decode_match_reference(name):
    kw, spec_cls, init, train, decode = MIXERS[name]
    rspec, tspec = getattr(RR, spec_cls)(**kw), getattr(R, spec_cls)(**kw)
    rp = getattr(RR, init)(jax.random.PRNGKey(0), rspec)
    tp = to_torch(rp)
    rtrain = jax.jit(getattr(RR, train), static_argnums=2, static_argnames="return_state")
    rdecode = jax.jit(getattr(RR, decode), static_argnums=2)
    ttrain, tdecode = getattr(R, train), getattr(R, decode)
    rng = np.random.default_rng(0)
    b, d = 2, kw["d_model"]

    x = rng.standard_normal((b, 20, d)).astype(np.float32)
    ry, rstate = rtrain(rp, jnp.asarray(x), rspec, return_state=True)
    ty, tstate = ttrain(tp, torch.from_numpy(x), tspec, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **F32)
    assert_state_close(rstate, tstate)
    np.testing.assert_allclose(ttrain(tp, torch.from_numpy(x), tspec).numpy(),
                               np.asarray(ry), **F32)
    assert any(np.abs(np.asarray(v)).max() > 0 for v in rstate.values())

    # a prefill from the carried state (11 tokens: mLSTM pads to 16)
    x = rng.standard_normal((b, 11, d)).astype(np.float32)
    before = {k: v.clone() for k, v in tstate.items()}
    ry, rstate = rtrain(rp, jnp.asarray(x), rspec, rstate, return_state=True)
    ty, tstate2 = ttrain(tp, torch.from_numpy(x), tspec, tstate, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **F32)
    assert_state_close(rstate, tstate2)
    assert all(torch.equal(before[k], tstate[k]) for k in before)

    tstate = tstate2
    for _ in range(3):
        x = rng.standard_normal((b, 1, d)).astype(np.float32)
        before = {k: v.clone() for k, v in tstate.items()}
        ry, rstate = rdecode(rp, jnp.asarray(x), rspec, rstate)
        ty, new = tdecode(tp, torch.from_numpy(x), tspec, tstate)
        np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **F32)
        assert_state_close(rstate, new)
        assert all(torch.equal(before[k], tstate[k]) for k in before)  # not in place
        assert all(new[k].data_ptr() != tstate[k].data_ptr() for k in new)
        tstate = new


@pytest.mark.parametrize("name", list(MIXERS))
def test_init_and_state_match_reference_shapes(name):
    """``init_*`` has the reference's names, shapes and dtypes (meta
    device for ``None``, no allocation); the zero state equals the
    reference's, conv state in the cache dtype and the rest float32; the
    deterministic RG-LRU ``lam`` is the reference's within float32."""
    kw, spec_cls, init, _, _ = MIXERS[name]
    rspec, tspec = getattr(RR, spec_cls)(**kw), getattr(R, spec_cls)(**kw)
    want = jax.eval_shape(lambda k: getattr(RR, init)(k, rspec), jax.random.PRNGKey(0))
    meta = getattr(R, init)(None, tspec)
    assert set(meta) == set(want)
    for k, v in want.items():
        assert meta[k].device.type == "meta"
        assert tuple(meta[k].shape) == v.shape and meta[k].dtype == torch.float32, k
    rinit = getattr(RR, f"{name}_init_state")(rspec, 3, jnp.bfloat16)
    tinit = getattr(R, f"{name}_init_state")(tspec, 3, torch.bfloat16, device="cpu")
    for k, v in rinit.items():
        v = np.asarray(v)
        assert str(tinit[k].dtype)[6:] == v.dtype.name, k
        np.testing.assert_array_equal(tinit[k].float().numpy(), v.astype(np.float32))
    if name == "rglru":
        lam = R.init_rglru(torch.Generator().manual_seed(0), tspec)["lam"]
        np.testing.assert_allclose(
            lam.numpy(), np.asarray(RR.init_rglru(jax.random.PRNGKey(0), rspec)["lam"]),
            rtol=1e-5)


def test_rglru_softplus_stays_exact_above_twenty():
    """``jax.nn.softplus`` is log(1 + e^x) at every x; the port's form
    agrees where ``F.softplus`` would switch to x."""
    x = torch.tensor([-30.0, 0.0, 19.0, 21.0, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(R._softplus(x).numpy(), want)


def test_causal_conv_carries_the_trailing_inputs():
    """A conv over S tokens equals the conv over its first part then the
    rest from the carried state, in both packages."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    ry, rs = RR._causal_conv(jnp.asarray(x), jnp.asarray(w))
    ty, ts = R._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **F32)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    a, s = R._causal_conv(torch.from_numpy(x[:, :5]), torch.from_numpy(w))
    b, s2 = R._causal_conv(torch.from_numpy(x[:, 5:]), torch.from_numpy(w), s)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), ty.numpy(), **F32)
    assert torch.equal(s2, ts)
