"""Training's loss and gradients against the reference (helpers and
tolerances in ``test_torch_train_grads.py``): xlstm (mLSTM's chunkwise scan, sLSTM's time loop)."""

import pytest

from test_torch_train_grads import check_grads


@pytest.mark.parametrize("arch", ["xlstm_125m"])
def test_loss_and_grads_match_reference(arch):
    check_grads(arch)
