"""Port parity of ``resilience``: the fault-site names, seeded ``fired``
sequences, backoff schedules, retry behaviour, lifecycle statuses and the
``resolve_fallback`` table are the reference's; and the port's departure
is pinned: a fault at ``kernel.execute`` or ``gather.local`` reaches the
caller of ``spmm`` (no kernel→plain or local→resident fallback), with
every fallback counter at 0."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.resilience as R

import repro_torch
import repro_torch.resilience as T
from repro_torch.core.formats import COOMatrix

torch.set_num_threads(1)


def test_known_sites_and_public_names_match_reference():
    assert T.KNOWN_SITES == R.KNOWN_SITES
    assert set(T.__all__) == set(R.__all__)
    assert [s.value for s in T.RequestStatus] == [s.value for s in R.RequestStatus]
    assert [f.name for f in dataclasses.fields(T.RequestResult)] == [
        f.name for f in dataclasses.fields(R.RequestResult)]


def _drive(mod, specs, seed, calls):
    """Trip ``calls`` (site, tag) under a plan of ``specs``; returns the
    fired record and the outcome of every call."""
    plan = mod.FaultPlan([mod.FaultSpec(**s) for s in specs], seed=seed)
    outcomes = []
    with mod.injected(plan):
        for site, tag in calls:
            try:
                got = mod.trip(site, tag=tag)
                outcomes.append("corrupt" if got is not None else "ok")
            except mod.FaultError:
                outcomes.append("error")
            except OSError:
                outcomes.append("oserror")
    assert not mod.enabled()
    return plan.fired, outcomes, plan.counts()


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fired_sequences_match_reference(seed):
    rng = np.random.default_rng(seed)
    specs = [
        dict(site="store.get", kind="error", times=3, rate=0.5, error=OSError),
        dict(site="store.get.corrupt", kind="corrupt", times=-1, rate=0.3),
        dict(site="kernel.execute", kind="error", times=2, after=4, rate=0.7, tag="cuda"),
        dict(site="gather.local", kind="delay", times=-1, rate=0.2, delay_s=0.0),
        dict(site="serve.slot", kind="error", times=5, rate=0.4),
    ]
    sites = [s for s in T.KNOWN_SITES]
    tags = [None, "cuda", "plain", "k1"]
    calls = [(sites[i], tags[j]) for i, j in zip(rng.integers(0, len(sites), 300),
                                                 rng.integers(0, len(tags), 300))]
    port = _drive(T, [dict(s, error=s.get("error", T.FaultError)) for s in specs], seed,
                  calls)
    ref = _drive(R, [dict(s, error=s.get("error", R.FaultError)) for s in specs], seed,
                 calls)
    assert port == ref
    assert port[0]  # something fired


def test_backoff_and_retry_match_reference():
    for seed in (0, 3, None):
        kw = dict(base_delay=0.01, max_delay=0.05, jitter=0.5, seed=seed)
        if seed is not None:
            assert T.backoff_schedule(6, **kw) == R.backoff_schedule(6, **kw)

    def run(mod, fail_times):
        log, sleeps, state = [], [], {"n": 0}

        def fn():
            state["n"] += 1
            if state["n"] <= fail_times:
                raise OSError(f"attempt {state['n']}")
            return state["n"]

        wrapped = mod.retrying(fn, max_retries=3, retry_on=(OSError,),
                               on_retry=lambda a, e: log.append((a, str(e))),
                               base_delay=0.01, seed=5, sleep=sleeps.append)
        try:
            return wrapped(), log, sleeps
        except RuntimeError as err:
            return str(err), log, sleeps

    for fails in (0, 2, 5):
        assert run(T, fails) == run(R, fails)


def test_resolve_fallback_matches_reference():
    for stage in ("kernel", "gather", "store"):
        for current in ("pallas", "jnp", "local", "resident", "stored", "fresh", "x"):
            assert T.resolve_fallback(stage, current) == R.resolve_fallback(stage, current)
    with pytest.raises(ValueError, match="unknown fallback stage"):
        T.resolve_fallback("nope", "x")
    before = T.reset_fallback_counters()
    assert set(before) == set(R.fallback_counters)
    assert T.record_fallback("store") == "stored_to_fresh"
    assert T.fallback_counters["stored_to_fresh"] == 1
    T.reset_fallback_counters()


def _plan(gather, layout="padded"):
    rng = np.random.default_rng(0)
    d = ((rng.random((64, 600)) < 0.02) * rng.standard_normal((64, 600))).astype(np.float32)
    r, c = np.nonzero(d)
    coo = COOMatrix(d.shape, r.astype(np.int64), c.astype(np.int64), d[r, c])
    return repro_torch.plan(coo, repro_torch.PlanConfig(l=4, gather=gather, layout=layout),
                            cache=None, device="cpu")


@pytest.mark.parametrize("site,gather", [("kernel.execute", "resident"),
                                         ("kernel.execute", "local"),
                                         ("gather.local", "local")])
@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_execution_faults_reach_the_caller(site, gather, layout):
    """The reference would retry a failed kernel on its jnp path and a
    failed local gather resident; the port raises and counts nothing."""
    p = _plan(gather, layout)
    x = torch.ones(p.shape[1], 2)
    want = p.spmm(x)
    T.reset_fallback_counters()
    plan = T.FaultPlan([T.FaultSpec(site, times=1)], seed=0)
    with T.injected(plan):
        with pytest.raises(T.FaultError, match=site):
            p.spmm(x)
        assert torch.equal(p.spmm(x), want)  # the spec fired once
    assert [f[1] for f in plan.fired] == [site]
    if site == "kernel.execute":
        assert plan.fired[0][2] == "plain"
    cost = p.cost()
    assert (cost.fallback_kernel, cost.fallback_gather, cost.fallback_store) == (0, 0, 0)
    assert cost.backend == "plain"
    assert set(T.fallback_counters.values()) == {0}


def test_gather_local_site_is_silent_on_the_resident_path():
    p = _plan("resident")
    plan = T.FaultPlan([T.FaultSpec("gather.local", times=-1)], seed=0)
    with T.injected(plan):
        p.spmm(torch.ones(p.shape[1], 1))
    assert plan.fired == []


def test_pack_materialize_fault_leaves_the_plan_lazy():
    p = _plan("resident")
    with T.injected(T.FaultPlan([T.FaultSpec("pack.materialize")], seed=0)):
        with pytest.raises(T.FaultError):
            p.artifact
    assert p._artifact is None
    assert p.spmv(torch.ones(p.shape[1])).shape == (p.shape[0],)
