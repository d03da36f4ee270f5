"""Serving the MoE and recurrent stacks (llama4-scout, dbrx,
recurrentgemma, xlstm at their ``reduced()`` configs, float32, batch 4)
through the port's ``ServeLoop``, on the reference's parameters
(``from_reference_params``; the greedy streams against the reference's
``ServeLoop`` are in ``test_torch_families_streams*.py``):

  * one request served alone equals its stream in a concurrent run,
    bitwise, also when it is admitted mid-decode.  For MoE this holds at
    a batch of at most ``min_capacity`` (4): no expert can then receive
    more tokens than its capacity, so no pair is dropped and rows are
    independent (at a larger batch co-scheduled requests compete for
    capacity, in the reference too);
  * a decode step that fails at ``serve.decode``, or in the middle of
    the stack after earlier layers wrote K/V in place and returned new
    recurrent states, is retried to the bits of a fault-free run;
  * ``gustify`` refuses these stacks with the reference's message;
  * ``launch/serve.py --device cpu --arch <id>`` serves each arch.
"""

import json

import numpy as np
import pytest
import torch

import jax
import repro.serving as RS
from repro.configs.base import get_arch as ref_get_arch
from repro.models.model_zoo import build_model as ref_build

import repro_torch.models.transformer as T
import repro_torch.resilience.faults as tfaults
import repro_torch.serving as TS
from repro_torch.configs import get_arch
from repro_torch.core.convert import from_reference_params
from repro_torch.launch.serve import main
from repro_torch.models.model_zoo import build_model

from test_torch_models import FAMILY_ARCHS
from test_torch_serving import configs, prompts

torch.set_num_threads(1)

_MODELS = {}


def model(arch):
    """(reference LM, its params, the port's LM, the same params), built
    once per arch."""
    if arch not in _MODELS:
        rlm = ref_build(ref_get_arch(arch).reduced())
        rp = jax.jit(rlm.init)(jax.random.PRNGKey(0))
        cfg = get_arch(arch).reduced()
        _MODELS[arch] = (rlm, rp, build_model(cfg), from_reference_params(
            jax.tree.map(np.asarray, rp), cfg, device="cpu"))
    return _MODELS[arch]


def serve(loop, ps, max_new=6):
    for x in ps:
        loop.enqueue(x, max_new=max_new)
    loop.run_to_completion()


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_solo_equals_concurrent_bitwise(arch):
    _, _, lm, p = model(arch)
    ps = prompts(lm.cfg.vocab, (5, 11, 7, 9))
    solos = []
    for x in ps:
        loop = TS.ServeLoop(lm, p, configs(4)[1])
        rid = loop.submit(x, max_new=6)
        loop.run_to_completion()
        solos.append(loop.results[rid].tokens)
    loop = TS.ServeLoop(lm, p, configs(4)[1])
    rids = [loop.submit(ps[0], max_new=6)]
    for _ in range(3):  # the first request is now mid-decode
        loop.step()
    rids += [loop.submit(x, max_new=6) for x in ps[1:]]
    loop.run_to_completion()
    assert [loop.completed[r] for r in rids] == solos


@pytest.mark.parametrize("site", ["serve.decode", "mid_stack"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_failed_decode_step_is_retried_to_the_same_bits(arch, site, monkeypatch):
    """``mid_stack``: the third decode step fails after the middle block
    of the stack has run (earlier attention layers wrote their K/V in
    place, earlier recurrent layers returned new states); the loop keeps
    the caches of the step before, and the retried step gives the bits
    of a step that never failed."""
    _, _, lm, p = model(arch)
    ps = prompts(lm.cfg.vocab, (5, 9, 7))
    clean = TS.ServeLoop(lm, p, configs(4)[1])
    serve(clean, ps)
    loop = TS.ServeLoop(lm, p, configs(4)[1])
    if site == "serve.decode":
        plan = tfaults.FaultPlan([tfaults.FaultSpec("serve.decode", after=2, times=1)],
                                 seed=0)
        with tfaults.injected(plan):
            serve(loop, ps)
        assert len(plan.fired) == 1
    else:
        n, calls, block_decode = lm.stack.n_layers, [], T.block_decode

        def failing(params, x, bc, cache, pos):
            out = block_decode(params, x, bc, cache, pos)
            calls.append(bc.kind)
            if len(calls) == 2 * n + n // 2 + 1:
                raise RuntimeError("injected failure in the middle of the stack")
            return out

        monkeypatch.setattr(T, "block_decode", failing)
        serve(loop, ps)
        assert len(calls) == loop.stats["decode_steps"] * n + n // 2 + 1
    assert loop.stats["decode_retries"] == 1
    assert loop.completed == clean.completed


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_gustify_refuses_the_stack_as_the_reference_does(arch):
    rlm, rp, lm, p = model(arch)
    with pytest.raises(ValueError) as want:
        RS.gustify(rlm, rp, RS.GustServeConfig())
    with pytest.raises(ValueError) as got:
        TS.gustify(lm, p, TS.GustServeConfig())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cli_serves_each_arch_on_the_cpu(arch, capsys):
    main(["--arch", arch, "--device", "cpu", "--requests", "3", "--max-new", "3"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["resilience"]["done"] == 3 and stats["tokens_generated"] == 3 * 4
    assert stats["resilience"]["decode_retries"] == 0 and not stats["gust"]
