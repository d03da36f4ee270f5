"""Port parity of training's loss and gradients (``LM.loss_fn``, autograd
through ``train_logits`` with ``remat``) against ``repro``'s
``jax.value_and_grad(lm.loss_fn)``: the reference's parameters carried
across bit for bit (``from_reference_params``), the same batch from each
package's ``launch.train._make_batch_fn`` (held bitwise equal), float32,
``reduced()`` configs.

This file holds the dense ``attn_mlp`` archs; the others, whose reference
gradient compiles longest, have a file each
(``test_torch_train_grads_*.py``).  Tolerances: the loss within 1e-6
relative, every gradient leaf within 1e-5 of that leaf's largest
magnitude (the two packages sum each product and reduction in another
order; measured at most 2.5e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.launch.train import _make_batch_fn as ref_batch_fn
from repro.models.model_zoo import build_model as ref_build

from repro_torch.launch.train import _make_batch_fn
from repro_torch.models.tree import tree_leaves, tree_map, tree_unflatten

from test_torch_models import pairs, reference_model

torch.set_num_threads(1)

LOSS_RTOL, GRAD_TOL = 1e-6, 1e-5


def same_batch(rlm_cfg, lm, seq_len=16, batch=2, seed=0, step=0):
    """The step's batch from each package's launcher, held bitwise equal:
    (reference batch of jnp arrays, port batch of CPU tensors)."""
    rb = ref_batch_fn(None, rlm_cfg, seq_len, batch, seed)(step)
    tb = _make_batch_fn(lm, lm.cfg, seq_len, batch, seed, device="cpu")(step)
    assert sorted(rb) == sorted(tb)
    for k in rb:
        assert np.array_equal(np.asarray(rb[k]), tb[k].numpy()), k
    return rb, tb


def port_value_and_grad(lm, params, batch, dtype=torch.float32, remat=True):
    """(loss, metrics, gradient tree) by autograd through ``LM.loss_fn``."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = lm.loss_fn(live, batch, dtype=dtype, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(tree_leaves(params), grads)]
    return loss.detach(), metrics, tree_unflatten(params, grads)


def check_grads(arch):
    jitted, rparams, lm, params = reference_model(arch)
    rlm = ref_build(jitted.cfg)
    rb, tb = same_batch(jitted.cfg, lm)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: rlm.loss_fn(p, b, dtype=jnp.float32, remat=True), has_aux=True))
    (rloss, rmet), rgrads = fn(rparams, rb)
    loss, met, grads = port_value_and_grad(lm, params, tb)
    rloss = float(rloss)
    assert np.isfinite(rloss)
    assert abs(float(loss) - rloss) <= LOSS_RTOL * abs(rloss), (float(loss), rloss)
    xent = float(met["xent"].detach())
    assert abs(xent - float(rmet["xent"])) <= LOSS_RTOL * abs(float(rmet["xent"]))
    assert len(jax.tree.leaves(rgrads)) == len(tree_leaves(grads))
    worst = 0.0
    for path, r, t in pairs(rgrads, grads):
        r = np.asarray(r)
        assert r.shape == tuple(t.shape) and t.dtype == torch.float32, path
        err = float(np.abs(t.numpy() - r).max()) if r.size else 0.0
        scale = float(np.abs(r).max()) if r.size else 0.0
        assert err <= GRAD_TOL * scale, (path, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    return worst


@pytest.mark.parametrize("arch", ["yi_6b", "phi3_mini_3_8b", "mistral_large_123b",
                                  "llava_next_mistral_7b"])
def test_loss_and_grads_match_reference(arch):
    check_grads(arch)
