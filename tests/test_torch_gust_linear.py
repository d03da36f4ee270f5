"""Port parity of ``GustLinear``: ``prune_by_magnitude`` is the
reference's bit for bit; the module's output is within f32 tolerance of
the reference's ``GustLinear`` on the same weight (about 96×160, density
0.1) for B ∈ {1, 3} and a 1-D input, on both layouts and int8 values;
``cycles`` and ``hardware_utilization`` are the reference's.

Tolerance ``rtol=1e-5, atol=1e-6``: the port sums each block before
adding it into the window, the reference's plain path scatters every
product into the window."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro
from repro.core.gust_linear import GustLinear as RefLinear
from repro.core.gust_linear import prune_by_magnitude as ref_prune

import repro_torch
from repro_torch.core.gust_linear import GustLinear, prune_by_magnitude

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _weight(seed, m=96, n=160):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32)


def test_prune_by_magnitude_matches_reference():
    for seed, density in ((0, 0.1), (1, 0.5), (2, 1.0), (3, 1e-4)):
        w = _weight(seed)
        got, want = prune_by_magnitude(w, density), ref_prune(w, density)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    w = np.round(_weight(4) * 2) / 2  # ties at the threshold keep them all
    assert np.array_equal(prune_by_magnitude(w, 0.3), ref_prune(w, 0.3))
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="density"):
            prune_by_magnitude(w, bad)


@pytest.mark.parametrize("kw", [dict(), dict(layout="ragged"),
                                dict(layout="padded", value_dtype="int8"),
                                dict(layout="auto", l=32, load_balance=False)])
def test_gust_linear_matches_reference(kw):
    w = _weight(5)
    ref = RefLinear(w, config=repro.PlanConfig(**dict(dict(layout="padded"), **kw)),
                    density=0.1, cache=None)
    cfg = repro_torch.PlanConfig(**dict(dict(layout="padded"), **kw)) if kw else None
    lin = GustLinear(w, config=cfg, density=0.1, cache=None, device="cpu")
    assert isinstance(lin, torch.nn.Module)
    assert lin.nnz == ref.nnz == round(w.size * 0.1)
    assert lin.cycles == ref.cycles
    assert lin.hardware_utilization == ref.hardware_utilization
    rng = np.random.default_rng(6)
    for b in (1, 3):
        x = rng.standard_normal((b, 160)).astype(np.float32)
        y = lin(torch.from_numpy(x))
        assert y.shape == (b, 96) and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(ref(jnp.asarray(x))), **TOL)
    x1 = rng.standard_normal(160).astype(np.float32)
    y1 = lin(torch.from_numpy(x1))
    assert y1.shape == (96,)
    np.testing.assert_allclose(y1.numpy(), np.asarray(ref(jnp.asarray(x1))), **TOL)
    # a 1-D input is the B=1 row, bit for bit
    assert torch.equal(y1, lin(torch.from_numpy(x1[None]))[0])


def test_gust_linear_takes_a_torch_weight_and_checks_its_rank():
    w = _weight(7)
    a = GustLinear(torch.from_numpy(w), device="cpu", cache=None)
    b = GustLinear(w, device="cpu", cache=None)
    x = torch.ones(2, 160)
    assert torch.equal(a(x), b(x))
    assert a.plan.device.type == "cpu" and "nnz=1536" in repr(a)
    with pytest.raises(ValueError, match="2-D"):
        GustLinear(w[0], device="cpu")
