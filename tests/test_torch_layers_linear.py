"""``repro_torch.models.layers.init_linear`` / ``linear`` against the
reference's ``repro.models.layers``.

The parameters are the reference's (``init_linear`` under a
``jax.random`` key), carried across as numpy: ``jax.random`` cannot be
reproduced in torch, so the port's own initializer is held to its
contract (shapes, dtype, zero bias, He scale) instead.

Tolerances: at float32 both sides accumulate the same f32 products in
their own order, so ``|port - ref| <= 1e-5 * max|ref|``.  At bfloat16
the f32 result is rounded to bf16 on each side, and two f32 sums that
differ in their last bits can round to neighbouring bf16 values, so
each element may differ by one bf16 spacing of its magnitude
(``2**-7 * |ref|``, bf16 keeping 8 significant bits) plus the f32
tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import layers as R

from repro_torch.models import layers as T

torch.set_num_threads(1)

D_IN, D_OUT = 96, 80


def _ref_params(bias: bool):
    p = R.init_linear(jax.random.PRNGKey(0), D_IN, D_OUT, bias=bias)
    if bias:  # a nonzero bias, so the addition is tested
        p["b"] = jnp.asarray(np.random.default_rng(1).standard_normal(D_OUT),
                             jnp.float32)
    return {k: np.array(v) for k, v in p.items()}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_matches_reference(bias, dtype):
    params = _ref_params(bias)
    x = np.random.default_rng(2).standard_normal((3, 5, D_IN)).astype(np.float32)
    ref = R.linear({k: jnp.asarray(v) for k, v in params.items()},
                   jnp.asarray(x, dtype=dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = T.linear({k: torch.from_numpy(v) for k, v in params.items()}, xt)
    assert got.dtype == xt.dtype and tuple(got.shape) == (3, 5, D_OUT)
    ref32 = np.asarray(ref.astype(jnp.float32))
    got32 = got.float().numpy()
    tol = 1e-5 * np.abs(ref32).max()
    if dtype == "bfloat16":
        tol = tol + 2.0 ** -7 * np.abs(ref32)
    assert np.all(np.abs(got32 - ref32) <= tol)


def test_linear_float32_accumulation_of_a_bf16_activation():
    """A bf16 activation meets the f32 weight unrounded: the product is
    the f32 product of the widened activation, cast to bf16 once."""
    params = _ref_params(False)
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal((4, D_IN)).astype(np.float32)
    ).to(torch.bfloat16)
    w = torch.from_numpy(params["w"])
    got = T.linear({"w": w}, x)
    assert torch.equal(got, (x.float() @ w).to(torch.bfloat16))


@pytest.mark.parametrize("bias", [False, True])
def test_init_linear_contract(bias):
    d_in, d_out = 512, 384
    p = T.init_linear(torch.Generator().manual_seed(0), d_in, d_out, bias=bias)
    assert sorted(p) == (["b", "w"] if bias else ["w"])
    assert p["w"].dtype == torch.float32 and tuple(p["w"].shape) == (d_in, d_out)
    if bias:
        assert p["b"].dtype == torch.float32 and tuple(p["b"].shape) == (d_out,)
        assert torch.count_nonzero(p["b"]) == 0
    # He scale: entries ~ N(0, 1/d_in).  Over n = 196,608 draws the sample
    # standard deviation's relative error has standard deviation
    # 1/sqrt(2n) = 0.0016, and the mean's (in units of the scale) 1/sqrt(n)
    # = 0.0023; the bounds are ten of those.
    w = p["w"].double()
    scale = 1.0 / np.sqrt(d_in)
    assert abs(w.std().item() / scale - 1.0) < 0.016
    assert abs(w.mean().item() / scale) < 0.023
    ref = R.init_linear(jax.random.PRNGKey(0), d_in, d_out, bias=bias)
    assert sorted(ref) == sorted(p)
    assert abs(float(np.asarray(ref["w"]).std()) / scale - 1.0) < 0.016


def test_init_linear_on_the_meta_device():
    p = T.init_linear(None, 8, 4, bias=True)
    assert p["w"].device.type == "meta" and p["b"].device.type == "meta"
    assert tuple(p["w"].shape) == (8, 4) and tuple(p["b"].shape) == (4,)
