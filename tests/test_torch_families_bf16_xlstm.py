"""bf16 activations through xlstm's mLSTM/sLSTM stack (``reduced()``)
against ``repro`` run op by op, within the 2% rule
(``test_torch_families_bf16.py``'s check)."""

import torch

from test_torch_families_bf16 import check_bf16

torch.set_num_threads(1)


def test_bf16_forward_and_decode_within_bf16_tolerance():
    check_bf16("xlstm_125m")
