"""Port parity of incremental rescheduling: ``window_fingerprints`` and
``incremental_schedule`` against the reference's and a fresh schedule,
and ``reschedule`` against a fresh plan (bit for bit, on both layouts and
every value dtype) with the reference's ``RescheduleResult``.  A
load-balanced config rebuilds fresh and says so (``full_fallback``)."""

import numpy as np
import pytest
import torch

import repro
from repro.core.formats import COOMatrix as RefCOO
from repro.core.scheduler import incremental_schedule as ref_incremental
from repro.core.scheduler import schedule as ref_schedule
from repro.core.scheduler import window_fingerprints as ref_fingerprints

import repro_torch
import repro_torch.core.scheduler as port_sched
from repro_torch.core.formats import COOMatrix as PortCOO
from repro_torch.core.packing import packed_leaves, ragged_leaves

torch.set_num_threads(1)

L = 16
SCHED_FIELDS = ("m_sch", "row_sch", "col_sch", "window_starts", "row_perm", "valid")


def _dense(seed, m=150, n=130, density=0.06):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)
    d[rng.integers(0, m)] = rng.standard_normal(n)  # a heavy row
    return d


def _edit(dense, seed, windows, l=L, frac=0.2):
    """Rescale a share of the values of ``windows``' rows, drop two edges
    and add two, touching no other window."""
    rng = np.random.default_rng(seed)
    out = dense.copy()
    for w in windows:
        blk = out[w * l:(w + 1) * l]
        nz = np.argwhere(blk != 0)
        pick = nz[rng.random(len(nz)) < frac]
        blk[pick[:, 0], pick[:, 1]] *= np.float32(1.25)
        for r, c in nz[rng.choice(len(nz), 2, replace=False)]:
            blk[r, c] = 0.0
        z = np.argwhere(blk == 0)
        for r, c in z[rng.choice(len(z), 2, replace=False)]:
            blk[r, c] = np.float32(rng.standard_normal())
    return out


def _args(dense):
    r, c = np.nonzero(dense)
    return (dense.shape, r.astype(np.int64), c.astype(np.int64), dense[r, c])


def _assert_sched_equal(a, b):
    assert a.shape == b.shape and a.l == b.l and a.nnz == b.nnz
    for f in SCHED_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_window_fingerprints_match_reference():
    for seed in range(3):
        args = _args(_dense(seed))
        ref = ref_fingerprints(RefCOO(*args), L)
        port = port_sched.window_fingerprints(PortCOO(*args), L)
        assert ref.dtype == port.dtype and np.array_equal(ref, port)


@pytest.mark.parametrize("windows", [(0,), (1, 5), (2, 3, 8)])
def test_incremental_schedule_matches_reference_and_fresh(windows):
    old = _dense(1)
    new = _edit(old, 2, windows)
    rs = ref_schedule(RefCOO(*_args(old)), L, load_balance=False)
    ps = port_sched.schedule(PortCOO(*_args(old)), L, load_balance=False)
    port_sched.reset_sched_counters()
    ps2, pdirty, phashes = port_sched.incremental_schedule(
        ps, PortCOO(*_args(new)), old_coo=PortCOO(*_args(old)))
    counters = dict(port_sched.sched_counters)
    rs2, rdirty, rhashes = ref_incremental(
        rs, RefCOO(*_args(new)), old_coo=RefCOO(*_args(old)))
    assert np.array_equal(pdirty, rdirty) and tuple(pdirty) == windows
    assert np.array_equal(phashes, rhashes)
    _assert_sched_equal(ps2, rs2)
    _assert_sched_equal(ps2, port_sched.schedule(PortCOO(*_args(new)), L,
                                                 load_balance=False))
    assert counters["windows_recolored"] == len(windows)
    assert counters["windows_reused"] == ps.num_windows - len(windows)
    # the hashes chain: the next delta needs no old matrix
    newer = _edit(new, 3, (4,))
    ps3, d3, _ = port_sched.incremental_schedule(ps2, PortCOO(*_args(newer)),
                                                 old_hashes=phashes)
    assert tuple(d3) == (4,)
    _assert_sched_equal(ps3, port_sched.schedule(PortCOO(*_args(newer)), L,
                                                 load_balance=False))


def test_incremental_schedule_refuses_balanced_or_reshaped():
    d = _dense(2)
    ps = port_sched.schedule(PortCOO(*_args(d)), L, load_balance=True)
    with pytest.raises(ValueError, match="load_balance=False"):
        port_sched.incremental_schedule(ps, PortCOO(*_args(d)), old_coo=PortCOO(*_args(d)))
    ps = port_sched.schedule(PortCOO(*_args(d)), L, load_balance=False)
    with pytest.raises(ValueError, match="shape"):
        port_sched.incremental_schedule(ps, PortCOO(*_args(d[:-1])),
                                        old_coo=PortCOO(*_args(d)))


def _leaves(p):
    a = p.artifact
    return ragged_leaves(a) if p.layout == "ragged" else packed_leaves(a)


@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("bfloat16", "int16"),
                                     ("int8", "int32")])
@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_reschedule_equals_fresh_plan_and_reference(layout, vdt, idt):
    old, windows = _dense(3), (2, 6)
    new = _edit(old, 4, windows)
    kw = dict(l=L, c_blk=8, layout=layout, load_balance=False, value_dtype=vdt,
              index_dtype=idt)
    base = repro_torch.plan(PortCOO(*_args(old)), repro_torch.PlanConfig(**kw),
                            cache=None, device="cpu")
    base.artifact  # materialized: a ragged base splices
    p = repro_torch.reschedule(base, PortCOO(*_args(new)))
    fresh = repro_torch.plan(PortCOO(*_args(new)), repro_torch.PlanConfig(**kw),
                             cache=None, device="cpu")
    _assert_sched_equal(p.sched, fresh.sched)
    got, want = _leaves(p), _leaves(fresh)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((new.shape[1], 3))
                         .astype(np.float32))
    assert torch.equal(p.spmm(x), fresh.spmm(x))

    rbase = repro.plan(RefCOO(*_args(old)), repro.PlanConfig(backend="jnp", **kw),
                       cache=None)
    rbase.artifact
    rp = repro.reschedule(rbase, RefCOO(*_args(new)))
    assert p.resched.to_dict() == rp.resched.to_dict()
    assert p.resched.spliced == (layout == "ragged")
    assert p.resched.dirty_windows == len(windows)
    # chaining: the new plan carries its fingerprints
    p2 = repro_torch.reschedule(p, PortCOO(*_args(_edit(new, 6, (1,)))))
    assert p2.resched.dirty_windows == 1 and not p2.resched.full_fallback


def test_reschedule_load_balanced_rebuilds_fresh():
    old = _dense(7)
    new = _edit(old, 8, (3,))
    cfg = dict(l=L, layout="ragged", load_balance=True)
    base = repro_torch.plan(PortCOO(*_args(old)), repro_torch.PlanConfig(**cfg),
                            cache=None, device="cpu")
    p = repro_torch.reschedule(base, PortCOO(*_args(new)))
    rbase = repro.plan(RefCOO(*_args(old)), repro.PlanConfig(backend="jnp", **cfg),
                       cache=None)
    rp = repro.reschedule(rbase, RefCOO(*_args(new)))
    assert p.resched.full_fallback and not p.resched.spliced
    assert p.resched.to_dict() == rp.resched.to_dict()
    fresh = repro_torch.plan(PortCOO(*_args(new)), repro_torch.PlanConfig(**cfg),
                             cache=None, device="cpu")
    for k, v in _leaves(fresh).items():
        assert torch.equal(_leaves(p)[k], v), k
    with pytest.raises(ValueError, match="shape"):
        repro_torch.reschedule(base, PortCOO(*_args(old[:, :-1])))
    stored = repro_torch.GustPlan.from_artifact(base.artifact)
    with pytest.raises(ValueError, match="schedule"):
        repro_torch.reschedule(stored, PortCOO(*_args(new)))
