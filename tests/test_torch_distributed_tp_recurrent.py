"""The sharded train step on the recurrent archs (``train_tp_case.py``,
program ``tp``), from seeded port states, on a (2, 2) mesh of 4 gloo
ranks: reduced xlstm (mLSTM, sLSTM) and reduced recurrentgemma (RG-LRU,
and local attention with 1 KV head, which the 2 model ranks' query heads
read whole).  The mixers gather their "model" shards before use and run
whole on every model rank (ROADMAP §3, departures); their attention and
MLP blocks run tensor parallel.

Two steps at microbatches 2 on a batch of 8 × 32, each giving the port's
single-process step the loss and ``grad_norm`` within 1e-5 relative and
every parameter within 1e-6; every rank holds ``local_shape`` of every
leaf, its parameter and optimizer bytes are ``tree_bytes_per_device``'s,
the shards gather back bit for bit, and no rank allocates a whole stacked
leaf.
"""

import pytest
import torch

from train_tp_case import check_shards, check_steps, run_cases, seeded_state, single_steps

torch.set_num_threads(1)

STEPS = 2
ARCHS = {"xlstm": "xlstm_125m", "recurrentgemma": "recurrentgemma_9b"}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    cases = {f"{a}/2x2": dict(arch=arch, mesh=(2, 2), state=seeded_state(arch),
                              microbatches=2, compression=False, steps=STEPS)
             for a, arch in ARCHS.items()}
    outs = run_cases(tmp_path_factory.mktemp("tp_rec"), cases, 4)
    single = {a: single_steps(arch, seeded_state(arch), STEPS) for a, arch in ARCHS.items()}
    return {"outs": outs, "single": single}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_step_equals_single_process(tp, arch):
    check_steps(tp["outs"][f"{arch}/2x2"], tp["single"][arch])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_each_rank_holds_only_its_shards(tp, arch):
    check_shards(tp["outs"][f"{arch}/2x2"])
