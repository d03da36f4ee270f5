"""Port parity of ``PlanStore``: the keys are the reference's, a store
written by either package loads in the other bit for bit (f32, bf16 and
int8 values, int32 and int16 indices, both layouts), the corrupt / stale
/ io_errors / io_retries counters move as the reference's under the same
``FaultPlan``s, a warm load colors nothing and revives the
``TuneResult``, and ``verify="load"`` refuses until the verifier is
ported."""

import json
import os

import numpy as np
import pytest
import torch

import repro
import repro.core.packing as RP
import repro.resilience as R
from repro.core.formats import COOMatrix as RefCOO

import repro_torch
import repro_torch.core.packing as TP
import repro_torch.resilience as T
from repro_torch.core.convert import to_numpy_leaves
from repro_torch.core.formats import COOMatrix as PortCOO
from repro_torch.core.scheduler import sched_counters

torch.set_num_threads(1)

DTYPES = [("float32", "int32"), ("float32", "int16"), ("bfloat16", "int32"),
          ("bfloat16", "int16"), ("int8", "int32"), ("int8", "int16")]


def _args(seed=0, m=80, n=100, density=0.07):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)
    r, c = np.nonzero(d)
    return (d.shape, r.astype(np.int64), c.astype(np.int64), d[r, c])


def _ref_np(art):
    leaves = RP.ragged_leaves(art) if isinstance(art, RP.RaggedSchedule) else (
        RP.packed_leaves(art))
    out = {}
    for k, v in leaves.items():
        a = np.asarray(v)
        out[k] = a.view(np.int16) if a.dtype.name == "bfloat16" else a
    return out


def _port_np(art):
    leaves = TP.ragged_leaves(art) if isinstance(art, TP.RaggedSchedule) else (
        TP.packed_leaves(art))
    return to_numpy_leaves(leaves)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _cfgs(layout, vdt, idt):
    kw = dict(l=16, c_blk=8, layout=layout, value_dtype=vdt, index_dtype=idt)
    return repro.PlanConfig(backend="jnp", **kw), repro_torch.PlanConfig(**kw)


def test_keys_match_reference():
    args = _args()
    mk = RP.ScheduleCache.matrix_key(RefCOO(*args))
    assert TP.ScheduleCache.matrix_key(PortCOO(*args)) == mk
    from repro_torch.core.plan_store import ARTIFACT_KNOBS, FORMAT_VERSION
    from repro.core.plan_store import ARTIFACT_KNOBS as RK, FORMAT_VERSION as RV

    assert (ARTIFACT_KNOBS, FORMAT_VERSION) == (RK, RV)
    for kw in (dict(), dict(l=32, layout="ragged"), dict(value_dtype="int8"),
               dict(load_balance=False, waste_threshold=1.5, index_dtype="int16"),
               dict(gather="local", pipeline="single")):  # execution knobs: no effect
        assert repro_torch.PlanStore.key(mk, repro_torch.PlanConfig(**kw)) == (
            repro.PlanStore.key(mk, repro.PlanConfig(**kw)))


@pytest.mark.parametrize("vdt,idt", DTYPES)
@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_stores_cross_load_bit_for_bit(tmp_path, layout, vdt, idt):
    args = _args(1)
    rcfg, pcfg = _cfgs(layout, vdt, idt)
    # the reference writes, the port loads
    rstore = repro.PlanStore(str(tmp_path / "ref"))
    ref = repro.plan(RefCOO(*args), rcfg, cache=None, store=rstore)
    ref.artifact
    assert rstore.writes == 1
    pstore = repro_torch.PlanStore(str(tmp_path / "ref"))
    warm = repro_torch.plan(PortCOO(*args), pcfg, cache=None, store=pstore, device="cpu")
    assert warm._store_loaded and warm.sched is None and pstore.hits == 1
    fresh = repro_torch.plan(PortCOO(*args), pcfg, cache=None, device="cpu")
    _equal(_port_np(warm.artifact), _port_np(fresh.artifact))
    _equal(_port_np(warm.artifact), _ref_np(ref.artifact))
    assert warm.layout == layout and warm.config.value_dtype == vdt
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((100, 3))
                         .astype(np.float32))
    assert torch.equal(warm.spmm(x), fresh.spmm(x))
    # the port writes, the reference loads
    pstore = repro_torch.PlanStore(str(tmp_path / "port"))
    cold = repro_torch.plan(PortCOO(*args), pcfg, cache=None, store=pstore, device="cpu")
    cold.artifact
    assert pstore.writes == 1 and len(pstore) == 1
    rstore = repro.PlanStore(str(tmp_path / "port"))
    rwarm = repro.plan(RefCOO(*args), rcfg, cache=None, store=rstore)
    assert rwarm._store_loaded and rstore.hits == 1
    _equal(_ref_np(rwarm.artifact), _ref_np(ref.artifact))
    assert pstore.keys() == rstore.keys()


def _scenario(mod, pkg, coo_cls, cfg, path, specs, device_kw):
    """Cold write, then a warm read under ``specs``: the store's counters
    and the warm plan's fallback_store."""
    args = _args(3)
    store = pkg.PlanStore(path, retry_base_s=0.0)
    p = pkg.plan(coo_cls(*args), cfg, cache=None, store=store, **device_kw)
    p.artifact
    reader = pkg.PlanStore(path, retry_base_s=0.0)
    plan = mod.FaultPlan([mod.FaultSpec(**s) for s in specs], seed=4)
    with mod.injected(plan):
        warm = pkg.plan(coo_cls(*args), cfg, cache=None, store=reader, **device_kw)
    stats = reader.stats()
    return stats, warm._store_loaded, warm._fallbacks["store"], len(plan.fired)


@pytest.mark.parametrize("case", ["corrupt", "io_errors", "io_retries", "put_fails"])
def test_counters_match_reference_under_faults(tmp_path, case):
    specs = {
        "corrupt": [dict(site="store.get.corrupt", kind="corrupt")],
        "io_errors": [dict(site="store.get", times=-1, error=OSError)],
        "io_retries": [dict(site="store.get", times=1, error=OSError)],
        "put_fails": [dict(site="store.put", times=-1)],
    }[case]
    rcfg, pcfg = _cfgs("ragged", "float32", "int32")
    if case == "put_fails":  # the cold write fails; the read misses
        def scenario(mod, pkg, coo_cls, cfg, path, kw):
            store = pkg.PlanStore(path, retry_base_s=0.0)
            plan = mod.FaultPlan([mod.FaultSpec(**s) for s in specs], seed=4)
            with mod.injected(plan):
                p = pkg.plan(coo_cls(*_args(3)), cfg, cache=None, store=store, **kw)
                p.artifact
            return store.stats(), p._store_loaded, len(plan.fired)

        port = scenario(T, repro_torch, PortCOO, pcfg, str(tmp_path / "p"),
                        dict(device="cpu"))
        ref = scenario(R, repro, RefCOO, rcfg, str(tmp_path / "r"), {})
    else:
        port = _scenario(T, repro_torch, PortCOO, pcfg, str(tmp_path / "p"), specs,
                         dict(device="cpu"))
        ref = _scenario(R, repro, RefCOO, rcfg, str(tmp_path / "r"), specs, {})
    assert port == ref
    if case == "io_errors":
        assert port[0]["io_errors"] == 1 and port[2] == 1  # stored -> fresh, counted


def test_stale_and_truncated_files_are_clean_misses(tmp_path):
    for pkg, coo_cls, cfg, kw, sub in (
        (repro_torch, PortCOO, _cfgs("padded", "float32", "int32")[1],
         dict(device="cpu"), "p"),
        (repro, RefCOO, _cfgs("padded", "float32", "int32")[0], {}, "r"),
    ):
        path = str(tmp_path / sub)
        store = pkg.PlanStore(path)
        pkg.plan(coo_cls(*_args(5)), cfg, cache=None, store=store, **kw).artifact
        (key,) = store.keys()
        f = os.path.join(path, f"{key}.gustplan")
        blob = open(f, "rb").read()
        hlen = int.from_bytes(blob[8:16], "little")
        header = json.loads(blob[16:16 + hlen])
        header["format_version"] = 99
        h2 = json.dumps(header, sort_keys=True).encode()
        open(f, "wb").write(blob[:8] + len(h2).to_bytes(8, "little") + h2
                            + blob[16 + hlen:])
        reader = pkg.PlanStore(path)
        assert reader.get(key) is None
        open(f, "wb").write(blob[: len(blob) // 2])
        assert reader.get(key) is None
        assert (reader.stale, reader.corrupt, reader.misses) == (1, 1, 2)


def test_warm_load_colors_nothing_and_keeps_the_tuning(tmp_path):
    args = _args(6, m=96, n=160)
    cfg = repro_torch.PlanConfig(l=16, c_blk=8)
    store = repro_torch.PlanStore(str(tmp_path))
    cold = repro_torch.plan(PortCOO(*args), cfg, store=store, device="cpu",
                            cache=TP.ScheduleCache())
    x = torch.ones(160, 2)
    tuned = cold.tune(x, c_blks=(8,), ls=(16,), iters=1)
    tuned.artifact  # written under the tuned config's key, with its sweep
    assert store.writes == 2
    before = dict(sched_counters)
    warm = repro_torch.plan(PortCOO(*args), tuned.config, store=repro_torch.PlanStore(
        str(tmp_path)), device="cpu", cache=TP.ScheduleCache())
    assert dict(sched_counters) == before
    assert warm._store_loaded and warm.tuning == tuned.tuning
    assert warm.summary["nnz"] == tuned.sched.nnz
    assert torch.equal(warm.spmm(x), tuned.spmm(x))
    with pytest.raises(ValueError, match="schedule"):
        warm.cost()


def test_verify_load_is_not_ported_yet(tmp_path):
    """The name is the one this test had while ``verify="load"`` raised;
    now the verifier is ported: a verifying store is built, serves a clean
    file as a hit, and an unknown mode still raises."""
    store = repro_torch.PlanStore(str(tmp_path), verify="load")
    assert store.verify == "load"
    args = _args()
    repro_torch.plan(PortCOO(*args), l=8, store=store, device="cpu",
                     cache=TP.ScheduleCache()).artifact
    assert store.get(store.keys()[0]) is not None and store.corrupt == 0
    with pytest.raises(ValueError):
        repro_torch.PlanStore(str(tmp_path), verify="sometimes")
