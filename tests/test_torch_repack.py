"""Port parity of the rest of ``core/packing``: repads (``repad_to``,
``repad_to_blocks``, ``repad_seg_to``), the incremental splice, the
shape-only specs (meta-device tensors for ``ShapeDtypeStruct``),
``stacked_leaf_specs``, ``pack_auto``, ``resolve_tuning``, ``window_ids``
and the ``ScheduleCache`` entries ``packed`` / ``ragged_packed`` /
``auto_for`` / ``memo``.  Every leaf is bitwise the reference's, at
f32/bf16/int8 values × int32/int16 indices, on both layouts; repads keep
the packers' int16 range check."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core.packing as RP
from repro.core.formats import COOMatrix as RefCOO
from repro.core.scheduler import incremental_schedule as ref_incremental
from repro.core.scheduler import schedule as ref_schedule

import repro_torch.core.packing as TP
import repro_torch.core.scheduler as port_sched
from repro_torch.core.convert import to_numpy_leaves
from repro_torch.core.formats import COOMatrix as PortCOO

torch.set_num_threads(1)

DTYPES = [(v, i) for v in ("float32", "bfloat16", "int8") for i in ("int32", "int16")]


def _matrix(seed, m=96, n=120, density=0.08, skew=False):
    rng = np.random.default_rng(seed)
    dense = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(
        np.float32
    )
    if skew:
        rows = rng.choice(m, 3, replace=False)
        dense[rows] = (rng.random((3, n)) < 0.7) * rng.standard_normal((3, n))
    r, c = np.nonzero(dense)
    return dense, ((m, n), r.astype(np.int64), c.astype(np.int64), dense[r, c])


def _both_schedules(args, l, load_balance=True):
    return (ref_schedule(RefCOO(*args), l, load_balance=load_balance),
            port_sched.schedule(PortCOO(*args), l, load_balance=load_balance))


def _ref_numpy(leaves):
    out = {}
    for k, v in leaves.items():
        a = np.asarray(v)
        out[k] = a.view(np.int16) if a.dtype.name == "bfloat16" else a
    return out


def _assert_same(ref_art, port_art):
    ragged = isinstance(ref_art, RP.RaggedSchedule)
    assert isinstance(port_art, TP.RaggedSchedule) == ragged
    ref_leaves = RP.ragged_leaves(ref_art) if ragged else RP.packed_leaves(ref_art)
    port_leaves = TP.ragged_leaves(port_art) if ragged else TP.packed_leaves(port_art)
    ref_np, port_np = _ref_numpy(ref_leaves), to_numpy_leaves(port_leaves)
    assert set(ref_np) == set(port_np)
    for k in ref_np:
        assert ref_np[k].dtype == port_np[k].dtype, k
        assert ref_np[k].shape == port_np[k].shape, k
        assert np.array_equal(ref_np[k], port_np[k]), k
    meta = RP.ragged_meta if ragged else RP.packed_meta
    pmeta = TP.ragged_meta if ragged else TP.packed_meta
    assert tuple(meta(ref_art)) == tuple(pmeta(port_art))


def _packs(rs, ps, layout, vdt, idt, c_blk=8):
    rfn = RP.pack_ragged if layout == "ragged" else RP.pack_schedule
    pfn = TP.pack_ragged if layout == "ragged" else TP.pack_schedule
    ref = rfn(rs, c_blk, value_dtype=jnp.dtype(vdt), index_dtype=jnp.dtype(idt))
    return ref, pfn(ps, c_blk, vdt, idt, device="cpu")


@pytest.mark.parametrize("vdt,idt", DTYPES)
@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_repads_match_reference(layout, vdt, idt):
    _, args = _matrix(0, skew=True)
    for l in (16,) if (vdt, idt) != ("float32", "int32") else (16, 32):
        rs, ps = _both_schedules(args, l)
        ref, port = _packs(rs, ps, layout, vdt, idt)
        if layout == "ragged":
            grows = [ref.num_blocks + 1, ref.num_blocks + 9]
            pairs = [(ref.repad_to_blocks(t), port.repad_to_blocks(t)) for t in grows]
        else:
            grows = [ref.c_pad + 8, ref.c_pad + 24]
            if vdt != "int8":  # a non-multiple of c_blk moves block bounds
                grows.append(ref.c_pad + 3)
            pairs = [(ref.repad_to(c), port.repad_to(c)) for c in grows]
        for r2, p2 in pairs:
            _assert_same(r2, p2)
            assert p2.m_blk.dtype == port.m_blk.dtype  # never promoted
            assert p2.col_blk.dtype == port.col_blk.dtype
            _assert_same(r2.repad_seg_to(r2.s_blk + 3), p2.repad_seg_to(p2.s_blk + 3))
        assert port.repad_seg_to(port.s_blk) is port
        with pytest.raises(ValueError, match="shrink"):
            port.repad_seg_to(port.s_blk - 1) if port.s_blk > 1 else (
                port.repad_to_blocks(port.num_blocks - 1) if layout == "ragged"
                else port.repad_to(port.c_pad - 1))


def test_quantized_repad_refuses_partial_blocks():
    _, args = _matrix(1)
    _, ps = _both_schedules(args, 16)
    port = TP.pack_schedule(ps, 8, "int8", "int32", device="cpu")
    with pytest.raises(ValueError, match="multiples of c_blk"):
        port.repad_to(port.c_pad + 3)


def _wide(n=40000, m=64, nnz=300, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    keys = np.unique(rows * n + cols)
    rows, cols = keys // n, keys % n
    return PortCOO((m, n), rows.astype(np.int64), cols.astype(np.int64),
                   rng.standard_normal(keys.size).astype(np.float32))


@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_repads_refuse_the_int16_range(layout):
    """A repad keeps the packers' range check: an int16 ``col_loc`` leaf
    beside a matrix wider than int16 holds raises, naming int32."""
    sched = port_sched.schedule(_wide(), 256, load_balance=False)
    fn = TP.pack_ragged if layout == "ragged" else TP.pack_schedule
    art = fn(sched, 8, "float32", "int32", device="cpu")
    narrow = dataclasses.replace(art, col_loc=art.col_loc.to(torch.int16))
    with pytest.raises(ValueError, match="int32"):
        if layout == "ragged":
            narrow.repad_to_blocks(art.num_blocks + 2)
        else:
            narrow.repad_to(art.c_pad + 8)
    # a matrix int16 holds still repads at int16
    ok = _wide(n=32768)
    art16 = fn(port_sched.schedule(ok, 256, load_balance=False), 8, "float32",
               "int16", device="cpu")
    grown = (art16.repad_to_blocks(art16.num_blocks + 2) if layout == "ragged"
             else art16.repad_to(art16.c_pad + 8))
    assert grown.col_loc.dtype == torch.int16


def _edited(dense, seed, windows, l):
    """A copy of ``dense`` with values rescaled, an edge dropped and one
    added inside the rows of ``windows`` only."""
    rng = np.random.default_rng(seed)
    out = dense.copy()
    for w in windows:
        rows = slice(w * l, min((w + 1) * l, out.shape[0]))
        blk = out[rows]
        nz = np.argwhere(blk != 0)
        blk[tuple(nz[0])] *= 1.5
        blk[tuple(nz[-1])] = 0.0
        z = np.argwhere(blk == 0)
        blk[tuple(z[rng.integers(len(z))])] = 2.0
    return out


def _coo_args(dense):
    r, c = np.nonzero(dense)
    return (dense.shape, r.astype(np.int64), c.astype(np.int64), dense[r, c])


@pytest.mark.parametrize("vdt,idt", DTYPES)
def test_splice_matches_reference_and_fresh_pack(vdt, idt):
    l = 16
    dense, args = _matrix(2, skew=True)
    new = _edited(dense, 3, windows=(1, 4), l=l)
    rs = ref_schedule(RefCOO(*args), l, load_balance=False)
    ps = port_sched.schedule(PortCOO(*args), l, load_balance=False)
    rs2, rdirty, _ = ref_incremental(rs, RefCOO(*_coo_args(new)), old_coo=RefCOO(*args))
    ps2, pdirty, _ = port_sched.incremental_schedule(
        ps, PortCOO(*_coo_args(new)), old_coo=PortCOO(*args))
    assert np.array_equal(rdirty, pdirty) and set(pdirty.tolist()) == {1, 4}
    ref_old, port_old = _packs(rs, ps, "ragged", vdt, idt)
    ref_new = RP.splice_ragged_blocks(ref_old, rs2, rdirty, value_dtype=jnp.dtype(vdt),
                                      index_dtype=jnp.dtype(idt))
    port_new = TP.splice_ragged_blocks(port_old, ps2, pdirty, value_dtype=vdt,
                                       index_dtype=idt)
    _assert_same(ref_new, port_new)
    fresh = TP.pack_ragged(port_sched.schedule(PortCOO(*_coo_args(new)), l,
                                               load_balance=False),
                           8, vdt, idt, device="cpu")
    for k, v in TP.ragged_leaves(fresh).items():
        assert torch.equal(v, TP.ragged_leaves(port_new)[k]), k
    with pytest.raises(ValueError, match="dtype|quantization"):
        other = "float32" if vdt != "float32" else "bfloat16"
        TP.splice_ragged_blocks(port_old, ps2, pdirty, value_dtype=other, index_dtype=idt)


def test_window_ids_match_reference():
    for seed, lb in ((0, True), (1, False)):
        _, args = _matrix(seed, skew=True)
        rs, ps = _both_schedules(args, 16, load_balance=lb)
        assert np.array_equal(RP.window_ids(rs), TP.window_ids(ps))


@pytest.mark.parametrize("vdt,idt", DTYPES)
def test_specs_match_reference(vdt, idt):
    for s_blk in (None, 5):
        ref = RP.packed_spec(1000, 3000, 64, 24, value_dtype=jnp.dtype(vdt),
                             index_dtype=jnp.dtype(idt), c_blk=8, s_blk=s_blk)
        port = TP.packed_spec(1000, 3000, 64, 24, value_dtype=vdt, index_dtype=idt,
                              c_blk=8, s_blk=s_blk)
        _assert_spec(RP.packed_leaves(ref), TP.packed_leaves(port))
        assert RP.packed_meta(ref) == TP.packed_meta(port)
        ref = RP.ragged_spec(1000, 3000, 64, 37, c_blk=8, value_dtype=jnp.dtype(vdt),
                             index_dtype=jnp.dtype(idt), s_blk=s_blk)
        port = TP.ragged_spec(1000, 3000, 64, 37, c_blk=8, value_dtype=vdt,
                              index_dtype=idt, s_blk=s_blk)
        _assert_spec(RP.ragged_leaves(ref), TP.ragged_leaves(port))
        assert RP.ragged_meta(ref) == TP.ragged_meta(port)
        _assert_spec(RP.stacked_leaf_specs(ref, 3), TP.stacked_leaf_specs(port, 3))
        assert port.stream_bytes == ref.stream_bytes


def _assert_spec(ref_leaves, port_leaves):
    assert set(ref_leaves) == set(port_leaves)
    for k, r in ref_leaves.items():
        p = port_leaves[k]
        assert p.device.type == "meta", k
        assert tuple(r.shape) == tuple(p.shape), k
        assert jnp.dtype(r.dtype).name == TP.dtype_name(p.dtype), k


def test_stacked_leaf_specs_of_real_artifacts():
    _, args = _matrix(4)
    rs, ps = _both_schedules(args, 16)
    for layout in ("padded", "ragged"):
        ref, port = _packs(rs, ps, layout, "bfloat16", "int16")
        _assert_spec(RP.stacked_leaf_specs(ref, 4), TP.stacked_leaf_specs(port, 4))


@pytest.mark.parametrize("skew", [False, True])
def test_pack_auto_matches_reference(skew):
    _, args = _matrix(5, skew=skew)
    rs, ps = _both_schedules(args, 16)
    for threshold in (None, 1.0, 50.0):
        ref = RP.pack_auto(rs, 8, waste_threshold=threshold,
                           value_dtype=jnp.int8, index_dtype=jnp.int16)
        port = TP.pack_auto(ps, 8, waste_threshold=threshold, value_dtype="int8",
                            index_dtype="int16", device="cpu")
        _assert_same(ref, port)


def test_resolve_tuning_matches_reference():
    rng = np.random.default_rng(6)
    keys = [(c, l, lay, g) for c in (4, 8) for l in (16, 32)
            for lay in ("padded", "ragged") for g in ("resident", "local")]
    for _ in range(50):
        meas = {k: float(t) for k, t in zip(keys, rng.uniform(1e-4, 2e-4, len(keys)))}
        base = keys[rng.integers(len(keys))]
        for margin in (None, 1.0, 1.2):
            assert TP.resolve_tuning(meas, base, margin) == RP.resolve_tuning(
                meas, base, margin)
    assert TP.DEFAULT_TUNE_IMPROVEMENT == RP.DEFAULT_TUNE_IMPROVEMENT
    with pytest.raises(ValueError, match="missing"):
        TP.resolve_tuning({keys[0]: 1.0}, keys[1])
    with pytest.raises(ValueError, match="positive"):
        TP.resolve_tuning({keys[0]: 0.0}, keys[0])


def test_schedule_cache_entries_match_reference():
    _, args = _matrix(7, skew=True)
    rc, pc = RP.ScheduleCache(), TP.ScheduleCache()
    for layout in ("padded", "ragged"):
        rroute = rc.ragged_packed if layout == "ragged" else rc.packed
        proute = pc.ragged_packed if layout == "ragged" else pc.packed
        for _ in range(2):
            rs, ref = rroute(RefCOO(*args), 16, c_blk=8, value_dtype=jnp.bfloat16,
                             index_dtype=jnp.int16)
            ps, port = proute(PortCOO(*args), 16, c_blk=8, value_dtype="bfloat16",
                              index_dtype="int16", device="cpu")
            _assert_same(ref, port)
            assert np.array_equal(rs.m_sch, ps.m_sch)
    # one schedule, two packs: the same counts as the reference's
    assert pc.stats() == rc.stats()
    rs = rc.schedule(RefCOO(*args), 16)
    ps = pc.schedule(PortCOO(*args), 16)
    for thr in (None, 1.0):
        _assert_same(rc.auto_for(rs, waste_threshold=thr),
                     pc.auto_for(ps, waste_threshold=thr, device="cpu"))
    assert pc.stats() == rc.stats()
    calls = []
    assert pc.memo(("tag", 1), lambda: calls.append(1) or "v") == "v"
    assert pc.memo(("tag", 1), lambda: calls.append(1) or "w") == "v"
    assert calls == [1]
    # the device is part of a pack's key
    pc.packed(PortCOO(*args), 16, device="cpu")
    assert pc.stats()["hits"] > rc.stats()["hits"]


def test_schedule_packed_and_clear_cache():
    import repro_torch.core.spmv as tspmv

    _, args = _matrix(8)
    rs, ref = RP.schedule_packed(RefCOO(*args), 16, c_blk=8, cache=None)
    ps, port = TP.schedule_packed(PortCOO(*args), 16, c_blk=8, cache=None, device="cpu")
    _assert_same(ref, port)
    TP.schedule_packed(PortCOO(*args), 16, device="cpu")
    tspmv.spmm_scheduled(ps, torch.zeros(ps.shape[1], 1), device="cpu")
    assert TP.default_cache.stats()["entries"] and tspmv._SHIM_PLANS
    TP.clear_cache()
    assert TP.default_cache.stats()["entries"] == 0 and not tspmv._SHIM_PLANS
