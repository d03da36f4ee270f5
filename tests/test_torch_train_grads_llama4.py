"""Training's loss and gradients against the reference (helpers and
tolerances in ``test_torch_train_grads.py``): llama4-scout (MoE top-1, chunked attention)."""

import pytest

from test_torch_train_grads import check_grads


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e"])
def test_loss_and_grads_match_reference(arch):
    check_grads(arch)
