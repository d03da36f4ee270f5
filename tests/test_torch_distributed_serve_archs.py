"""Sharded serving of the MoE, recurrent and encoder-decoder archs (the
checks of ``test_torch_distributed_serve.py``, on four gloo ranks, batch
4, a 14-token prompt and 4 teacher-forced decode steps):

* ``llama4`` on (1, 4) and (2, 2): expert parallel (one of its 4 experts
  a rank on (1, 4)), routing on each data rank's own rows; its chunked
  layers' 16-position ring split over "model" (4 a rank on (1, 4)), the
  decode positions 14-17 wrapping from the last rank's slots to the
  first's; its global layer's 30 positions whole on (1, 4), split on
  (2, 2);
* ``recurrentgemma`` on (2, 2) and (1, 4): one KV head (MQA: the K/V
  projections whole on every rank), the local window's ring split, the
  RG-LRU mixers gathered and run whole on their rows' states;
* ``xlstm`` on (2, 2): the mLSTM and sLSTM mixers gathered, the
  vocabulary split;
* ``seamless`` on (2, 2) and (1, 4): the encoder run head-parallel in the
  prefill, the memory's ``ck``/``cv`` split over "model" along its 16
  positions, decode's cross-attention a flash decode over them; at an
  ``enc_seq`` of 18 on (1, 4) the memory stays whole (18 does not divide
  4 ranks) and each rank's heads read it whole.
"""

import pytest
import torch

from serve_tp_case import check_logits, check_shards
from test_torch_distributed_serve import (BATCH, TOL, check_caches, check_reference,
                                          run_all)

torch.set_num_threads(1)

#: name -> (arch, config overrides, mesh, cache length, dtype, GUST config)
CASES = {
    "llama4-1x4": ("llama4_scout_17b_a16e", {}, (1, 4), 30, "float32", None),
    "llama4-2x2": ("llama4_scout_17b_a16e", {}, (2, 2), 30, "float32", None),
    "recurrentgemma-2x2": ("recurrentgemma_9b", {}, (2, 2), 30, "float32", None),
    "recurrentgemma-1x4": ("recurrentgemma_9b", {}, (1, 4), 30, "float32", None),
    "xlstm-2x2": ("xlstm_125m", {}, (2, 2), 30, "float32", None),
    "seamless-2x2": ("seamless_m4t_medium", {}, (2, 2), 30, "float32", None),
    "seamless-1x4": ("seamless_m4t_medium", {}, (1, 4), 30, "float32", None),
    "seamless-1x4-whole-memory": ("seamless_m4t_medium", {"enc_seq": 18}, (1, 4), 30,
                                  "float32", None),
}


@pytest.fixture(scope="module")
def serve(tmp_path_factory):
    return run_all(tmp_path_factory, CASES, "serve_archs")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_equals_whole_decode(serve, name):
    check_logits(serve["outs"][name], serve["wants"][name], BATCH, TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches_reference(serve, name):
    check_reference(serve["outs"][name], serve["cases"][name], serve["refs"][name])


@pytest.mark.parametrize("name", list(CASES))
def test_caches_gathered_equal_whole(serve, name):
    check_caches(serve["outs"][name], serve["wants"][name], serve["cases"][name])


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_only_its_shards(serve, name):
    check_shards(serve["outs"][name])


def test_cases_split_what_they_are_named_for(serve):
    """llama4 on (1, 4): each rank one expert, its chunked ring 4 slots a
    rank and the global layer's 30 whole; recurrentgemma's single KV head
    whole on every rank; seamless's memory 4 positions a rank on (1, 4),
    and whole at 18."""
    def local(name):
        return [loc for loc, _ in serve["outs"][name][0]["shapes"]]

    llama = local("llama4-1x4")
    assert (1, 1, 64, 128) in llama  # the rep-stacked experts' w_up (R, E/4, d, f)
    assert (1, 4, 4, 2, 16) in llama and (1, 4, 30, 2, 16) in llama  # K/V: chunked, global
    assert (1, 64, 1, 16) in local("recurrentgemma-2x2")  # wk (R, d, KV=1, dh) whole
    assert (2, 4, 4, 2, 16) in local("seamless-1x4")  # ck (R, B, 16/4, KV, dh)
    assert (2, 4, 18, 2, 16) in local("seamless-1x4-whole-memory")  # ck whole
