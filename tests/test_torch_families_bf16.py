"""bf16 activations through the recurrent stacks (recurrentgemma here,
xlstm in ``test_torch_families_bf16_xlstm.py``; ``reduced()``), against ``repro`` on the same parameters
(helpers from ``test_torch_models.py``): the forward and a decode step
within the 2% rule (max ``|port - reference|`` within 2% of the largest
logit); conv states are bf16, the rest of every state float32.

The reference runs op by op here (``jax.disable_jit``).  Under ``jit``
XLA fuses the bf16 casts between ops away and keeps some intermediates
in float32, so the jitted reference's bf16 logits depend on its fusion
(2.1% of the largest logit from its own op-by-op result at
recurrentgemma's reduced size).  The port rounds where the reference's
code says to, so it is held against that code run as written.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import get_arch as ref_get_arch
from repro.models.model_zoo import build_model as ref_build

from test_torch_models import inputs, reference_model

torch.set_num_threads(1)


def check_bf16(arch):
    _, rp, lm, p = reference_model(arch)
    rlm = ref_build(ref_get_arch(arch).reduced())
    rb, tb = inputs(lm.cfg, 2, 24)
    tok = np.array([[3], [5]], np.int32)
    with jax.disable_jit():
        rl, _ = rlm.train_logits(rp, rb, dtype=jnp.bfloat16, remat=False)
        _, rc = rlm.prefill(rp, rb, rlm.init_caches(2, 32, jnp.bfloat16), dtype=jnp.bfloat16)
        rld, _ = rlm.decode_step(rp, rc, jnp.asarray(tok), jnp.int32(24),
                                 dtype=jnp.bfloat16)
    tl, _ = lm.train_logits(p, tb, dtype=torch.bfloat16)
    ref = np.asarray(rl)
    assert np.abs(tl.numpy() - ref).max() <= 0.02 * np.abs(ref).max()
    tc = lm.init_caches(2, 32, torch.bfloat16, device="cpu")
    _, tc = lm.prefill(p, tb, tc, dtype=torch.bfloat16)
    state = tc["reps"][0]
    assert state["conv"].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for k, v in state.items() if k != "conv")
    tld, _ = lm.decode_step(p, tc, torch.from_numpy(tok), 24, dtype=torch.bfloat16)
    ref = np.asarray(rld)
    assert np.abs(tld.numpy() - ref).max() <= 0.02 * np.abs(ref).max()


def test_bf16_forward_and_decode_within_bf16_tolerance():
    check_bf16("recurrentgemma_9b")
