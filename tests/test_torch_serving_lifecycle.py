"""Serving parity, continued (fixture and helpers from
``test_torch_serving.py``; yi-6b reduced, float32):

  * EOS, SHED, deadlines and ``cancel`` give the reference's statuses,
    tokens, reasons and counters;
  * faults at ``serve.decode`` (the same ``FaultPlan`` in each package)
    give the reference's results, and the survivors' streams are bitwise
    a fault-free run's; a fault in the middle of a decode step, after
    earlier layers wrote their cache cells in place (at ``kernel.execute``
    in a GUST step, in a layer's MLP in a dense one), is retried to the
    same bits; faults at ``serve.admit`` and ``serve.slot`` fail one
    request only;
  * temperature sampling is reproducible by seed and independent of
    co-scheduling inside the port (it cannot equal ``jax.random``);
  * ``dryrun_specs`` and ``cache_specs`` (meta device) have the
    reference's shapes, dtypes and meta at yi-6b's full widths, and
    ``cache_bytes`` its totals, 123B included;
  * the CLI on the CPU prints the reference's stats keys; a plan store
    warm start colors nothing; the entry points default to the card.
"""

import dataclasses
import json

import pytest
import torch

import repro.resilience.faults as rfaults
import repro.serving as RS
from repro.configs.base import get_arch as ref_get_arch
from repro.launch.serve import run_serving as ref_run_serving
from repro.models.model_zoo import build_model as ref_build

import repro_torch.models.transformer as T
import repro_torch.resilience.faults as tfaults
import repro_torch.serving as TS
from repro_torch.configs import get_arch
from repro_torch.core.packing import clear_cache
from repro_torch.core.scheduler import sched_counters
from repro_torch.launch.serve import main, run_serving
from repro_torch.models.model_zoo import build_model

from test_torch_models import pairs
from test_torch_serving import GUST, configs, model, prompts, solo  # noqa: F401

torch.set_num_threads(1)


def test_lifecycle_statuses_match_reference(model):
    """One script of admissions, cancels, a full queue, an EOS token and a
    step deadline, run against both loops: every result (status, tokens,
    reason, steps) and counter is the reference's."""
    rlm, rp, lm, p = model
    ps = prompts(lm.cfg.vocab, (5, 7, 5, 7, 5, 7, 5), seed=3)
    eos = solo(lm, p, ps[2], 8, batch=2)[3]
    rsc, tsc = configs(2, None, eos_id=int(eos), queue_capacity=4,
                       max_steps_per_request=5)
    out = []
    for loop in (RS.ServeLoop(rlm, rp, rsc), TS.ServeLoop(lm, p, tsc)):
        rids = [loop.enqueue(x, max_new=8) for x in ps[:6]]  # the last two are shed
        assert loop.cancel(rids[3]) and not loop.cancel(99)  # frees a queue place
        loop.enqueue(ps[6], max_new=8, deadline_steps=2)
        loop.step()
        loop.step()
        assert loop.cancel(rids[0])  # active
        loop.run_to_completion()
        out.append((
            {rid: (str(r.status), r.tokens, r.reason, r.steps)
             for rid, r in loop.results.items()},
            loop.stats,
        ))
    (ref_results, ref_stats), (results, stats) = out
    assert results == ref_results
    assert stats == ref_stats
    statuses = sorted(s for s, *_ in results.values())
    assert statuses.count("SHED") == 2 and statuses.count("CANCELLED") == 2
    assert "DONE" in statuses and "TIMEOUT" in statuses


def serve(loop, ps, max_new=6):
    rids = [loop.enqueue(x, max_new=max_new) for x in ps]
    loop.run_to_completion()
    return rids


def test_decode_faults_match_reference_and_spare_survivors(model):
    rlm, rp, lm, p = model
    ps = prompts(lm.cfg.vocab, (5, 7, 6))
    clean = TS.ServeLoop(lm, p, configs(2)[1])
    serve(clean, ps)
    out = []
    for pkg, loop in ((rfaults, RS.ServeLoop(rlm, rp, configs(2)[0])),
                      (tfaults, TS.ServeLoop(lm, p, configs(2)[1]))):
        plan = pkg.FaultPlan([pkg.FaultSpec("serve.decode", rate=0.4, times=-1)], seed=3)
        with pkg.injected(plan):
            serve(loop, ps)
        out.append(({r: (str(x.status), x.tokens) for r, x in loop.results.items()},
                    loop.stats, list(plan.fired)))
    assert out[1] == out[0]
    assert out[1][1]["decode_retries"] > 0
    assert {r: t for r, (s, t) in out[1][0].items()} == clean.completed


@pytest.mark.parametrize("mode", ["dense", "padded"])
def test_fault_inside_a_decode_step_is_retried_to_the_same_bits(model, monkeypatch, mode):
    """The third decode step fails in layer 1's MLP, after both layers'
    attention wrote the step's K/V into the caches in place; the retried
    step writes the same values into the same cells, and every stream
    equals a fault-free run's."""
    _, _, lm, p = model
    gust = GUST[mode]
    ps = prompts(lm.cfg.vocab, (5, 9))
    clean = TS.ServeLoop(lm, p, configs(2, gust)[1])
    serve(clean, ps)
    loop = TS.ServeLoop(lm, p, configs(2, gust)[1])
    per_step = 3 * lm.stack.reps  # GUST products per decode step
    if gust is None:
        calls, ffn = [], T._ffn

        def failing_ffn(params, x, bc):
            if x.shape[1] == 1:  # decode
                calls.append(1)
                if len(calls) == 2 * lm.stack.reps + 2:
                    raise RuntimeError("injected MLP failure")
            return ffn(params, x, bc)

        monkeypatch.setattr(T, "_ffn", failing_ffn)
        serve(loop, ps)
    else:
        plan = tfaults.FaultPlan([tfaults.FaultSpec(
            "kernel.execute", after=2 * per_step + 3, times=1)], seed=0)
        with tfaults.injected(plan):
            serve(loop, ps)
        assert len(plan.fired) == 1
    assert loop.stats["decode_retries"] == 1
    assert loop.completed == clean.completed


def test_admit_and_slot_faults_fail_one_request(model):
    _, _, lm, p = model
    ps = prompts(lm.cfg.vocab, (5, 7, 6))
    clean = TS.ServeLoop(lm, p, configs(2)[1])
    rids = serve(clean, ps)
    for site in ("serve.admit", "serve.slot"):
        loop = TS.ServeLoop(lm, p, configs(2)[1])
        plan = tfaults.FaultPlan([tfaults.FaultSpec(site, tag=str(rids[1]))], seed=0)
        with tfaults.injected(plan):
            serve(loop, ps)
        assert str(loop.results[rids[1]].status) == "FAILED"
        assert {r: loop.completed[r] for r in (rids[0], rids[2])} == {
            r: clean.completed[r] for r in (rids[0], rids[2])}


def test_persistent_decode_faults_retire_the_active_set_failed(model):
    rlm, rp, lm, p = model
    ps = prompts(lm.cfg.vocab, (5, 7))
    out = []
    for pkg, loop in ((rfaults, RS.ServeLoop(rlm, rp, configs(2, max_step_failures=3)[0])),
                      (tfaults, TS.ServeLoop(lm, p, configs(2, max_step_failures=3)[1]))):
        with pkg.injected(pkg.FaultPlan([pkg.FaultSpec("serve.decode", times=-1)])):
            serve(loop, ps)
        out.append({r: (str(x.status), x.tokens, x.reason) for r, x in loop.results.items()})
    assert out[1] == out[0]
    assert all(s == "FAILED" for s, _, _ in out[1].values())


def test_temperature_sampling_is_keyed_and_reproducible(model):
    _, _, lm, p = model
    ps = prompts(lm.cfg.vocab, (5, 7, 6))
    runs = []
    for seed in (7, 7, 8):
        loop = TS.ServeLoop(lm, p, configs(2, temperature=0.8)[1], seed=seed)
        serve(loop, ps)
        runs.append(loop.completed)
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert all(0 <= t < lm.cfg.padded_vocab for toks in runs[0].values() for t in toks)
    # a request's draws do not depend on what shares its batch
    loop = TS.ServeLoop(lm, p, configs(2, temperature=0.8)[1], seed=7)
    rid = loop.submit(ps[0], max_new=6)
    loop.run_to_completion()
    assert loop.completed[rid] == runs[0][0]
    sampler = TS.make_sampler(1.0)
    logits = torch.tensor([[1000.0, 0.0, -500.0], [2000.0, 1970.0, 0.0]])
    for seed in range(8):
        out = sampler(logits, seed, [(0, 0), (1, 5)])
        assert out.dtype == torch.int32 and out.tolist() == [0, 0]
    assert TS.make_sampler(0.0)(torch.tensor([[1.0, 3.0, 3.0]]), 0, [(0, 0)]).tolist() == [1]


@pytest.mark.parametrize("mode", ["padded", "ragged", "compact"])
def test_dryrun_and_cache_specs_match_reference_at_full_width(mode):
    """yi-6b at its published widths, on the meta device: nothing is
    allocated."""
    rlm, lm = ref_build(ref_get_arch("yi_6b")), build_model(get_arch("yi_6b"))
    gcfg = dict(GUST[mode], density=0.1, gust_length=256)
    want = RS.dryrun_specs(rlm, RS.GustServeConfig(**gcfg))
    got = TS.dryrun_specs(lm, TS.GustServeConfig(**gcfg))
    for name, entry in want["mats"].items():
        assert tuple(got["mats"][name]["meta"]) == tuple(entry["meta"])
        for k, v in entry["leaves"].items():
            t = got["mats"][name]["leaves"][k]
            assert t.device.type == "meta"
            assert tuple(t.shape) == v.shape and str(t.dtype)[6:] == v.dtype.name, (name, k)
    for dtype in ("bfloat16", "float32"):
        want = RS.cache_specs(rlm, 4, 512, RS.CachePolicy(dtype))
        got = TS.cache_specs(lm, 4, 512, TS.CachePolicy(dtype))
        for path, v, t in pairs(want, got):
            assert t.device.type == "meta"
            assert tuple(t.shape) == v.shape and str(t.dtype)[6:] == v.dtype.name, path


def test_cache_bytes_equal_reference():
    for arch, batch, seq in (("yi_6b", 4, 512), ("mistral_large_123b", 8, 32_768)):
        rlm, lm = ref_build(ref_get_arch(arch)), build_model(get_arch(arch))
        for dtype in ("bfloat16", "float32"):
            n = TS.cache_bytes(lm, batch, seq, TS.CachePolicy(dtype))
            assert isinstance(n, int)
            assert n == RS.cache_bytes(rlm, batch, seq, RS.CachePolicy(dtype))
    assert n > 2**31  # the 123B case: past int32
    small = build_model(get_arch("yi_6b").reduced())
    assert TS.cache_bytes(small, 2, 64, TS.CachePolicy("float32")) > TS.cache_bytes(
        small, 2, 64, TS.CachePolicy("bfloat16"))


def test_cli_prints_the_reference_stats_keys(capsys):
    main(["--arch", "yi_6b", "--device", "cpu", "--gust", "--requests", "3",
          "--max-new", "3"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _, want = ref_run_serving("yi_6b", requests=3, max_new=3, gust=True)
    assert set(stats) == set(want)
    assert stats["resilience"].keys() == want["resilience"].keys()
    assert stats["gust_streamed_slots"].keys() == want["gust_streamed_slots"].keys()
    assert stats["resilience"]["done"] == 3 and stats["decode_steps"] > 0


def test_plan_store_warm_start_colors_nothing(model, tmp_path):
    _, _, lm, p = model
    gcfg = TS.GustServeConfig(density=0.5, gust_length=16, plan_store=str(tmp_path))
    cold = TS.gustify(lm, p, gcfg)
    before = dict(sched_counters)
    clear_cache()
    warm = TS.gustify(lm, p, gcfg)
    assert dict(sched_counters) == before
    assert warm["stats"]["plan_store"]["hits"] == 3 * lm.stack.reps
    for name, entry in cold["mats"].items():
        assert all(torch.equal(entry["leaves"][k], warm["mats"][name]["leaves"][k])
                   for k in entry["leaves"])
    clear_cache()
    verified = TS.gustify(lm, p, dataclasses.replace(gcfg, store_verify="load"))
    assert dict(sched_counters) == before  # verified warm loads color nothing either
    assert verified["stats"]["plan_store"]["hits"] == 3 * lm.stack.reps
    assert verified["stats"]["plan_store"]["corrupt"] == 0


def test_serving_entry_points_default_to_the_card(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    _, _, lm, p = model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serving("yi_6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.make_serve_fns(lm, configs(2)[1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "yi_6b"])
