"""Training's loss and gradients against the reference (helpers and
tolerances in ``test_torch_train_grads.py``): gemma3 (local and global
attention) and dbrx (MoE top-4)."""

import pytest

from test_torch_train_grads import check_grads


@pytest.mark.parametrize("arch", ["gemma3_4b", "dbrx_132b"])
def test_loss_and_grads_match_reference(arch):
    check_grads(arch)
