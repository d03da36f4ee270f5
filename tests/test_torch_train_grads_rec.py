"""Training's loss and gradients against the reference (helpers and
tolerances in ``test_torch_train_grads.py``): recurrentgemma (RG-LRU, local attention, the tail)."""

import pytest

from test_torch_train_grads import check_grads


@pytest.mark.parametrize("arch", ["recurrentgemma_9b"])
def test_loss_and_grads_match_reference(arch):
    check_grads(arch)
