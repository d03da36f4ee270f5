"""Training's loss and gradients with bf16 activations (yi-6b,
``reduced()``) against the reference run op by op (``jax.disable_jit``,
as ``test_torch_families_bf16.py`` runs its forward: under ``jit`` XLA
fuses the bf16 casts away).  Tolerances: the loss within 1e-3 relative
(measured equal) and every gradient leaf within 2% of that leaf's largest
magnitude, the bf16 forward tests' rule (bf16 keeps 8 bits of mantissa
and the two packages round at other points of the backward pass;
measured 0.76%, the embedding table's)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.models.model_zoo import build_model as ref_build

from test_torch_models import pairs, reference_model
from test_torch_train_grads import port_value_and_grad, same_batch

torch.set_num_threads(1)


def test_bf16_loss_and_grads_match_reference_op_by_op():
    jitted, rparams, lm, params = reference_model("yi_6b")
    rlm = ref_build(jitted.cfg)
    rb, tb = same_batch(jitted.cfg, lm)
    with jax.disable_jit():
        (rloss, _), rgrads = jax.value_and_grad(
            lambda p, b: rlm.loss_fn(p, b, dtype=jnp.bfloat16, remat=False),
            has_aux=True)(rparams, rb)
    loss, _, grads = port_value_and_grad(lm, params, tb, dtype=torch.bfloat16)
    assert abs(float(loss) - float(rloss)) <= 1e-3 * abs(float(rloss))
    for path, r, t in pairs(rgrads, grads):
        r = np.asarray(r)
        assert t.dtype == torch.float32 and r.shape == tuple(t.shape), path
        assert np.abs(t.numpy() - r).max() <= 0.02 * np.abs(r).max(), path
