"""bf16 activations and caches through the encoder-decoder model
(seamless's ``reduced()`` config), against ``repro`` on the same
parameters: the forward and a decode step after the prefill within 2% of
the largest logit.  The reference runs op by op here
(``jax.disable_jit``): under ``jit`` XLA fuses bf16 casts between ops
away, so its bf16 logits depend on its fusion.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import get_arch as ref_get_arch
from repro.models.model_zoo import build_model as ref_build

from test_torch_encdec import ARCH, encdec_inputs
from test_torch_models import reference_model

torch.set_num_threads(1)


def test_seamless_bf16_within_bf16_tolerance():
    """bf16 activations and caches: forward and a decode step after the
    prefill within 2% of the largest logit of the reference run op by op
    (under ``jit`` XLA fuses bf16 casts away)."""
    _, rp, lm, p = reference_model(ARCH)
    rlm = ref_build(ref_get_arch(ARCH).reduced())
    rb, tb = encdec_inputs(lm.cfg, 2, 12, seed=2)
    tok = np.array([[3], [5]], np.int32)
    with jax.disable_jit():
        rl, _ = rlm.train_logits(rp, rb, dtype=jnp.bfloat16, remat=False)
        _, rc = rlm.prefill(rp, rb, rlm.init_caches(2, 32, jnp.bfloat16), dtype=jnp.bfloat16)
        rld, _ = rlm.decode_step(rp, rc, jnp.asarray(tok), jnp.int32(12), dtype=jnp.bfloat16)
    tl, _ = lm.train_logits(p, tb, dtype=torch.bfloat16)
    assert tl.dtype == torch.float32
    ref = np.asarray(rl)
    assert np.abs(tl.numpy() - ref).max() <= 0.02 * np.abs(ref).max()
    tc = lm.init_caches(2, 32, torch.bfloat16, device="cpu")
    _, tc = lm.prefill(p, tb, tc, dtype=torch.bfloat16)
    assert {t.dtype for k, t in tc["reps"][0].items() if k != "self"} == {torch.bfloat16}
    tld, _ = lm.decode_step(p, tc, torch.from_numpy(tok), 12, dtype=torch.bfloat16)
    ref = np.asarray(rld)
    assert np.abs(tld.numpy() - ref).max() <= 0.02 * np.abs(ref).max()
