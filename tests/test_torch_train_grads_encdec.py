"""Training's loss and gradients against the reference (helpers and
tolerances in ``test_torch_train_grads.py``): seamless (the encoder, cross-attention, the tied table)."""

import pytest

from test_torch_train_grads import check_grads


@pytest.mark.parametrize("arch", ["seamless_m4t_medium"])
def test_loss_and_grads_match_reference(arch):
    check_grads(arch)
