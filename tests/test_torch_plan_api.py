"""Port parity of the rest of the plan API: ``PlanConfig.to_dict`` /
``from_dict``, ``to_spec`` / ``from_spec`` / ``from_artifact``,
``spec_for`` (meta-device leaves), ``GustPlan.stack`` (leaves bit for bit
the reference's), the full ``PlanCost`` field by field, ``tune`` on the
CPU (the reference's candidates, pruning and predicted bytes; a measured
choice; memoized), and the ``core/spmv`` and ``kernels/ops`` shims
(within f32 tolerance of the reference's)."""

import dataclasses
import importlib
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro
import repro.core.packing as RP
import repro.kernels.ops as rops
from repro.core.formats import COOMatrix as RefCOO
from repro.core.scheduler import schedule as ref_schedule

import repro_torch
import repro_torch.core.packing as TP
import repro_torch.core.spmv as tspmv
import repro_torch.kernels.ops as tops
from repro_torch.core.convert import to_numpy_leaves
from repro_torch.core.formats import COOMatrix as PortCOO
from repro_torch.core.scheduler import schedule as port_schedule

rspmv = importlib.import_module("repro.core.spmv")  # repro.core.spmv is also a function

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _args(seed, m=120, n=140, density=0.06, heavy=2):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)
    if heavy:
        d[rng.choice(m, heavy, replace=False)] = rng.standard_normal((heavy, n))
    r, c = np.nonzero(d)
    return (d.shape, r.astype(np.int64), c.astype(np.int64), d[r, c])


def _pair(args, cache=False, **kw):
    """The reference's plan (its plain jnp path on the CPU) and the port's,
    over the same matrix and knobs."""
    ref = repro.plan(RefCOO(*args), repro.PlanConfig(**kw),
                     cache=RP.ScheduleCache() if cache else None)
    port = repro_torch.plan(PortCOO(*args), repro_torch.PlanConfig(**kw),
                            cache=TP.ScheduleCache() if cache else None, device="cpu")
    return ref, port


def _ref_np(leaves):
    out = {}
    for k, v in leaves.items():
        a = np.asarray(v)
        out[k] = a.view(np.int16) if a.dtype.name == "bfloat16" else a
    return out


def _equal(ref_leaves, port_leaves):
    a, b = _ref_np(ref_leaves), to_numpy_leaves(port_leaves)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def test_config_dict_round_trip():
    for kw in (dict(), dict(l=64, layout="ragged", gather="local", pipeline="single",
                            value_dtype="int8", index_dtype="int16",
                            waste_threshold=1.5, load_balance=False)):
        port, ref = repro_torch.PlanConfig(**kw), repro.PlanConfig(**kw)
        assert port.to_dict() == ref.to_dict()
        assert repro_torch.PlanConfig.from_dict(port.to_dict()) == port
        # a reference config's Pallas/jnp choice has no port counterpart
        d = dataclasses.replace(ref, backend="jnp", interpret=True).to_dict()
        assert repro_torch.PlanConfig.from_dict(dict(d, extra=1)) == port


@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("bfloat16", "int16"),
                                     ("int8", "int32")])
@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_spec_round_trip_matches_reference(layout, vdt, idt):
    ref, port = _pair(_args(0), l=16, layout=layout, value_dtype=vdt, index_dtype=idt)
    rspec, pspec = ref.to_spec(), port.to_spec()
    _equal(rspec["leaves"], pspec["leaves"])
    assert tuple(rspec["meta"]) == tuple(pspec["meta"])
    assert rspec["config"] == pspec["config"]
    back = repro_torch.GustPlan.from_spec(pspec)
    assert back.sched is None and back.config == port.config and back.device == port.device
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((140, 3))
                         .astype(np.float32))
    assert torch.equal(back.spmm(x), port.spmm(x))
    # from_artifact reads layout, dtypes and (padded, unquantized) c_blk
    for c_blk in (None, 4):
        rcfg = repro.GustPlan.from_artifact(ref.artifact, c_blk=c_blk).config
        pcfg = repro_torch.GustPlan.from_artifact(port.artifact, c_blk=c_blk).config
        skip = {"backend", "interpret"}
        assert {k: v for k, v in rcfg.to_dict().items() if k not in skip} == {
            k: v for k, v in pcfg.to_dict().items() if k not in skip}


@pytest.mark.parametrize("layout", ["auto", "padded", "ragged"])
def test_spec_for_is_shape_only(layout):
    for vdt in ("float32", "int8"):
        kw = dict(l=64, layout=layout, value_dtype=vdt, index_dtype="int16")
        ref = repro.GustPlan.spec_for(1000, 2500, repro.PlanConfig(**kw), colors=13.2)
        port = repro_torch.GustPlan.spec_for(1000, 2500, repro_torch.PlanConfig(**kw),
                                             colors=13.2)
        assert port.device.type == "meta" and port.layout == ref.layout
        rl = (RP.ragged_leaves if ref.layout == "ragged" else RP.packed_leaves)(ref.artifact)
        pl = (TP.ragged_leaves if port.layout == "ragged" else TP.packed_leaves)(port.artifact)
        assert set(rl) == set(pl)
        for k in rl:
            assert pl[k].device.type == "meta"
            assert tuple(rl[k].shape) == tuple(pl[k].shape)
            assert jnp.dtype(rl[k].dtype).name == TP.dtype_name(pl[k].dtype)
        assert port.artifact.stream_bytes == ref.artifact.stream_bytes


@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("bfloat16", "int16"),
                                     ("int8", "int16")])
@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_stack_matches_reference(layout, vdt, idt):
    kw = dict(l=16, layout=layout, value_dtype=vdt, index_dtype=idt)
    pairs = [_pair(_args(s, density=d), load_balance=lb, **kw)
             for s, d, lb in ((2, 0.06, True), (3, 0.15, False), (4, 0.02, True))]
    rstack = repro.GustPlan.stack([r for r, _ in pairs])
    pstack = repro_torch.GustPlan.stack([p for _, p in pairs])
    _equal(rstack["leaves"], pstack["leaves"])
    assert tuple(rstack["meta"]) == tuple(pstack["meta"])
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((140, 2))
                         .astype(np.float32))
    for i, (_, p) in enumerate(pairs):
        sl = repro_torch.GustPlan.from_spec(
            {"leaves": {k: v[i] for k, v in pstack["leaves"].items()},
             "meta": pstack["meta"]})
        assert torch.equal(sl.spmm(x), p.spmm(x))
    with pytest.raises(ValueError, match="mixed"):
        other = "ragged" if layout == "padded" else "padded"
        repro_torch.GustPlan.stack([pairs[0][1], _pair(_args(2), l=16, layout=other)[1]])


def test_plan_cost_matches_reference_field_by_field():
    for kw in (dict(l=16), dict(l=16, layout="ragged", value_dtype="int8"),
               dict(l=8, gather="local", load_balance=False),
               dict(l=16, c_blk=4, index_dtype="int16")):
        ref, port = _pair(_args(6), cache=True, **kw)
        ref.artifact, port.artifact
        rc, pc = ref.cost().to_dict(), port.cost().to_dict()
        assert set(rc) == set(pc)
        assert pc.pop("backend") == "plain" and rc.pop("backend") == "jnp"
        assert pc.pop("pipeline") == "double" and rc.pop("pipeline") == "single"
        for k in rc:
            if isinstance(rc[k], float):
                assert pc[k] == pytest.approx(rc[k], rel=1e-12), k
            else:
                assert pc[k] == rc[k], k


def test_tune_matches_reference_candidates_and_is_memoized():
    args = _args(7, heavy=4)
    kw = dict(l=16, c_blk=8)
    ref, port = _pair(args, cache=True, **kw)
    x = np.random.default_rng(8).standard_normal((140, 2)).astype(np.float32)
    tkw = dict(c_blks=(4, 8), iters=1, warmup=1, prune_ratio=1.5)
    rt = ref.tune(jnp.asarray(x), **tkw).tuning
    tuned = port.tune(torch.from_numpy(x), **tkw)
    pt = tuned.tuning
    assert pt.baseline == rt.baseline
    assert pt.predicted_bytes == rt.predicted_bytes
    assert pt.pruned == rt.pruned and pt.pruned
    assert set(pt.measurements) == set(rt.measurements)
    assert pt.choice in pt.measurements
    assert all(t > 0 for t in pt.measurements.values())
    assert pt.improvement == pytest.approx(
        pt.measurements[pt.baseline] / pt.measurements[pt.choice])
    assert pt.choice == TP.resolve_tuning(pt.measurements, pt.baseline)
    cb, l, layout, gather = pt.choice
    c = tuned.config
    assert (c.c_blk, c.l, c.layout, c.gather) == (cb, l, layout, gather)
    assert repro_torch.TuneResult.from_dict(pt.to_dict()) == pt
    # memoized: the same sweep comes back without timing again
    hits = port.cache.stats()["hits"]
    again = port.tune(torch.from_numpy(x), **tkw)
    assert again.tuning is pt and port.cache.stats()["hits"] > hits
    y = again.spmm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(ref.spmm(jnp.asarray(x))), **TOL)
    with pytest.raises(ValueError, match="schedule"):
        repro_torch.GustPlan.from_artifact(port.artifact).tune(torch.from_numpy(x))


def test_spmv_shims_match_reference():
    args = _args(9)
    rs = ref_schedule(RefCOO(*args), 16)
    ps = port_schedule(PortCOO(*args), 16)
    rng = np.random.default_rng(10)
    v = rng.standard_normal(140).astype(np.float32)
    X = rng.standard_normal((140, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tspmv.spmv_scheduled(ps, torch.from_numpy(v), device="cpu").numpy(),
        np.asarray(rspmv.spmv_scheduled(rs, jnp.asarray(v))), **TOL)
    got = tspmv.spmm_scheduled(ps, torch.from_numpy(X), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(rspmv.spmm_scheduled(
        rs, jnp.asarray(X))), **TOL)
    assert tspmv.spmm_scheduled(ps, torch.from_numpy(X), device="cpu").shape == (120, 3)
    assert len([k for k in tspmv._SHIM_PLANS if k[0] == id(ps)]) == 1
    rr = RP.pack_ragged(rs, 8)
    pr = TP.pack_ragged(ps, 8, device="cpu")
    np.testing.assert_allclose(tspmv.spmm_ragged(pr, torch.from_numpy(X)).numpy(),
                               np.asarray(rspmv.spmm_ragged(rr, jnp.asarray(X))), **TOL)
    np.testing.assert_allclose(tops.gust_spmm(pr, torch.from_numpy(X)).numpy(),
                               np.asarray(rops.gust_spmm(rr, jnp.asarray(X),
                                                         use_kernel=False)), **TOL)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = np.asarray(rspmv.spmv(RefCOO(*args), jnp.asarray(v), l=16))
        with pytest.warns(DeprecationWarning):
            got = tspmv.spmv(PortCOO(*args), torch.from_numpy(v), l=16, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        want = np.asarray(rops.gust_spmm_auto(rs, jnp.asarray(X), use_kernel=False))
        with pytest.warns(DeprecationWarning):
            got = tops.gust_spmm_auto(ps, torch.from_numpy(X), device="cpu")
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    dense = np.zeros((120, 140), np.float32)
    dense[args[1], args[2]] = args[3]
    np.testing.assert_allclose(
        tspmv.spmv_dense_ref(torch.from_numpy(dense), torch.from_numpy(v)).numpy(),
        dense @ v, rtol=1e-5, atol=1e-5)


def test_spmv_scheduled_ignores_padding_at_an_infinite_x():
    """Padding slots add nothing even where x is infinite (the port's
    plain versions mask them; the reference's jnp oracle returns NaN)."""
    d = np.zeros((20, 40), np.float32)
    d[3, 5], d[7, 9], d[11, 2] = 1.0, 2.0, 3.0
    r, c = np.nonzero(d)
    ps = port_schedule(PortCOO(d.shape, r.astype(np.int64), c.astype(np.int64), d[r, c]), 8)
    v = torch.ones(40)
    v[0] = float("inf")  # column 0 is only ever a padding slot's lane
    y = tspmv.spmv_scheduled(ps, v, device="cpu")
    assert torch.isfinite(y).all() and torch.equal(y, torch.from_numpy(d @ np.ones(40, np.float32)))
