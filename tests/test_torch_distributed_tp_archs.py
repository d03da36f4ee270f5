"""The sharded train step on the MoE and encoder-decoder blocks
(``train_tp_case.py``, program ``tp``), from seeded port states: reduced
llama4 (the experts over "model", expert parallel; top-1 of 4 experts)
and reduced seamless (tensor parallel in the encoder's self-attention,
the decoder's self- and cross-attention and the MLPs), on (1, 2) over 2
gloo ranks and (2, 2) over 4.

Two steps at microbatches 2 on a batch of 8 × 32.  Each gives the port's
single-process step the loss and ``grad_norm`` within 1e-5 relative and
every parameter within 1e-6, except llama4 on (2, 2): there the two data
ranks route their own rows (the data-parallel departure of ROADMAP §3),
so it is held, at the same tolerances, to the whole state's data-parallel
step on the same mesh, which routes them the same way.  Every rank holds
``local_shape`` of every leaf, its parameter and optimizer bytes are
``tree_bytes_per_device``'s, the shards gather back to the state bit for
bit, and no rank allocates a whole stacked leaf.
"""

import pytest
import torch

from train_tp_case import check_shards, check_steps, run_cases, seeded_state, single_steps

torch.set_num_threads(1)

STEPS = 2
ARCHS = {"llama4": "llama4_scout_17b_a16e", "seamless": "seamless_m4t_medium"}
CASES = {"llama4/1x2": (1, 2), "seamless/1x2": (1, 2), "llama4/2x2": (2, 2),
         "seamless/2x2": (2, 2)}


def _case(name, mesh):
    return dict(arch=ARCHS[name.split("/")[0]], mesh=mesh,
                state=seeded_state(ARCHS[name.split("/")[0]]), microbatches=2,
                compression=False, steps=STEPS)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    outs = {}
    for world in (2, 4):
        cases = {n: _case(n, m) for n, m in CASES.items() if m[0] * m[1] == world}
        outs.update(run_cases(tmp_path_factory.mktemp(f"tp_{world}"), cases, world))
    single = {a: single_steps(arch, seeded_state(arch), STEPS) for a, arch in ARCHS.items()}
    return {"outs": outs, "single": single}


@pytest.mark.parametrize("name", ["llama4/1x2", "seamless/1x2", "seamless/2x2"])
def test_sharded_step_equals_single_process(tp, name):
    check_steps(tp["outs"][name], tp["single"][name.split("/")[0]])


def test_moe_on_two_data_ranks_equals_the_data_parallel_step(tp):
    ranks = tp["outs"]["llama4/2x2"]
    check_steps(ranks, ranks[0]["dp"])
    # and is not the single-process step: each data rank routes its own rows
    assert not torch.equal(ranks[0]["steps"][0]["loss"], tp["single"]["llama4"][0]["loss"])


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_only_its_shards(tp, name):
    check_shards(tp["outs"][name])
