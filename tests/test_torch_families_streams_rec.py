"""Greedy token streams of the recurrent stacks (recurrentgemma, xlstm at
their ``reduced()`` configs, float32, batch 4) through the port's
``ServeLoop`` equal ``repro``'s (``test_torch_families_streams.py``'s
check)."""

import pytest
import torch

from test_torch_families_streams import check_streams

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_125m"])
def test_greedy_streams_equal_reference(arch):
    check_streams(arch)
