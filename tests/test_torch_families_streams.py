"""Greedy token streams of the MoE stacks (llama4-scout, dbrx at their
``reduced()`` configs, float32, batch 4) through the port's
``ServeLoop`` equal ``repro``'s on the same parameters, with the same
loop counters (the recurrent stacks in
``test_torch_families_streams_rec.py``; model and helpers from
``test_torch_families_serving.py``).
"""

import pytest
import torch

import repro.serving as RS

import repro_torch.serving as TS

from test_torch_families_serving import model, serve
from test_torch_serving import configs, prompts

torch.set_num_threads(1)


def check_streams(arch):
    rlm, rp, lm, p = model(arch)
    rsc, tsc = configs(batch=4)
    ref, port = RS.ServeLoop(rlm, rp, rsc), TS.ServeLoop(lm, p, tsc)
    for loop in (ref, port):
        serve(loop, prompts(lm.cfg.vocab, (5, 9, 7, 9, 5, 7)))
    assert port.completed == ref.completed and len(port.completed) == 6
    assert port.stats == ref.stats


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "dbrx_132b"])
def test_greedy_streams_equal_reference(arch):
    check_streams(arch)
