"""Port parity: packed leaves of ``repro_torch`` are bitwise equal to the
reference's ``packed_leaves`` / ``ragged_leaves`` (f32/int32,
bf16/int16, int8 with its scales), the carry-across codec round-trips,
and the layout/gather decision points decide as the reference does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core.packing as RP
from repro.core.formats import COOMatrix as RefCOO
from repro.core.scheduler import schedule as ref_schedule

import repro_torch.core.packing as TP
import repro_torch.core.scheduler as port_sched
from repro_torch.core.convert import from_reference_leaves, to_numpy_leaves
from repro_torch.core.formats import COOMatrix as PortCOO

DTYPES = [("float32", "int32"), ("bfloat16", "int16"), ("int8", "int32"),
          ("int8", "int16")]


def _matrix(seed, m=96, n=120, density=0.08, skew=False):
    rng = np.random.default_rng(seed)
    dense = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(
        np.float32
    )
    if skew:  # a few heavy rows: the ragged layout's regime
        rows = rng.choice(m, 3, replace=False)
        dense[rows] = (rng.random((3, n)) < 0.7) * rng.standard_normal((3, n))
    r, c = np.nonzero(dense)
    return (m, n), r.astype(np.int64), c.astype(np.int64), dense[r, c]


def _schedules(seed, l, load_balance=True, skew=False):
    args = _matrix(seed, skew=skew)
    ref = ref_schedule(RefCOO(*args), l, load_balance=load_balance)
    port = port_sched.schedule(PortCOO(*args), l, load_balance=load_balance)
    return ref, port


def _ref_numpy(leaves):
    out = {}
    for k, v in leaves.items():
        a = np.asarray(v)
        out[k] = a.view(np.int16) if a.dtype.name == "bfloat16" else a
    return out


def _ref_numpy_raw(leaves):
    """Reference leaves as numpy, bf16 kept as ml_dtypes' bfloat16."""
    return {k: np.asarray(v) for k, v in leaves.items()}


def _ref_pack(sched, layout, c_blk, vdt, idt):
    fn = RP.pack_ragged if layout == "ragged" else RP.pack_schedule
    art = fn(sched, c_blk, value_dtype=jnp.dtype(vdt), index_dtype=jnp.dtype(idt))
    if layout == "ragged":
        return art, RP.ragged_leaves(art), RP.ragged_meta(art)
    return art, RP.packed_leaves(art), RP.packed_meta(art)


def _port_pack(sched, layout, c_blk, vdt, idt):
    fn = TP.pack_ragged if layout == "ragged" else TP.pack_schedule
    art = fn(sched, c_blk, vdt, idt, device="cpu")
    if layout == "ragged":
        return art, TP.ragged_leaves(art), TP.ragged_meta(art)
    return art, TP.packed_leaves(art), TP.packed_meta(art)


def _assert_leaves_equal(ref_leaves, port_leaves):
    ref_np, port_np = _ref_numpy(ref_leaves), to_numpy_leaves(port_leaves)
    assert set(ref_np) == set(port_np)
    for k in ref_np:
        assert ref_np[k].dtype == port_np[k].dtype, k
        assert ref_np[k].shape == port_np[k].shape, k
        assert np.array_equal(ref_np[k], port_np[k]), k


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", DTYPES)
@pytest.mark.parametrize("l,c_blk,load_balance,skew", [
    (16, 8, True, False),
    (8, 4, False, True),
    (24, 3, True, True),
])
def test_pack_leaves_bitwise(layout, vdt, idt, l, c_blk, load_balance, skew):
    ref_s, port_s = _schedules(l, l, load_balance, skew)
    ref_art, ref_leaves, ref_meta = _ref_pack(ref_s, layout, c_blk, vdt, idt)
    port_art, port_leaves, port_meta = _port_pack(port_s, layout, c_blk, vdt, idt)
    assert tuple(ref_meta) == tuple(port_meta)
    _assert_leaves_equal(ref_leaves, port_leaves)
    assert port_art.quantized == ref_art.quantized == (vdt == "int8")
    assert port_art.stream_bytes == ref_art.stream_bytes
    assert port_art.seg_count == ref_art.seg_count
    if layout == "ragged":
        assert port_art.streamed_slots == ref_art.streamed_slots


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", DTYPES[:3])
def test_from_reference_leaves_round_trip(layout, vdt, idt):
    ref_s, _ = _schedules(7, 16)
    _, ref_leaves, ref_meta = _ref_pack(ref_s, layout, 8, vdt, idt)
    art = from_reference_leaves(_ref_numpy_raw(ref_leaves), ref_meta, device="cpu")
    assert isinstance(art, TP.RaggedSchedule if layout == "ragged" else TP.PackedSchedule)
    leaves = TP.ragged_leaves(art) if layout == "ragged" else TP.packed_leaves(art)
    meta = TP.ragged_meta(art) if layout == "ragged" else TP.packed_meta(art)
    assert tuple(meta) == tuple(ref_meta)
    assert art.m_blk.dtype == TP.VALUE_DTYPES[vdt]
    assert art.col_blk.dtype == TP.INDEX_DTYPES[idt]
    _assert_leaves_equal(ref_leaves, leaves)
    # and back through the port's own codec
    rebuilt = (TP.ragged_from_leaves if layout == "ragged" else TP.packed_from_leaves)(
        leaves, meta
    )
    again = TP.ragged_leaves(rebuilt) if layout == "ragged" else TP.packed_leaves(rebuilt)
    assert all(again[k] is leaves[k] for k in leaves)


def test_from_reference_leaves_needs_a_card_by_default(monkeypatch):
    ref_s, _ = _schedules(7, 16)
    _, ref_leaves, ref_meta = _ref_pack(ref_s, "padded", 8, "float32", "int32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference_leaves(_ref_numpy_raw(ref_leaves), ref_meta)


@pytest.mark.parametrize("c_blk", [1, 4, 8, 16])
@pytest.mark.parametrize("skew", [False, True])
def test_resolve_layout_and_waste_match(c_blk, skew):
    ref_s, port_s = _schedules(13, 8, skew=skew)
    assert TP.ragged_waste_ratio(port_s, c_blk) == RP.ragged_waste_ratio(ref_s, c_blk)
    for thr in (None, 1.0, 1.5, 2.0, 4.0):
        assert TP.resolve_layout(port_s, c_blk, thr) == RP.resolve_layout(
            ref_s, c_blk, thr
        )


def test_resolve_gather_matches_grid():
    assert TP.DEFAULT_LOCALITY_RATIO == RP.DEFAULT_LOCALITY_RATIO
    assert TP.DEFAULT_LOCAL_MIN_SEGS == RP.DEFAULT_LOCAL_MIN_SEGS
    assert TP.DEFAULT_WASTE_THRESHOLD == RP.DEFAULT_WASTE_THRESHOLD
    for seg_count in (1, 2, 64, 127, 128, 129, 300, 1024):
        for s_blk in (1, 8, 63, 64, 65, 150, 512, 1024):
            for ratio, mins in ((None, None), (0.25, 16), (0.9, 2)):
                assert TP.resolve_gather(s_blk, seg_count, ratio, mins) == \
                    RP.resolve_gather(s_blk, seg_count, ratio, mins)


def test_quantize_and_gather_tables_match():
    rng = np.random.default_rng(4)
    m_b = (rng.standard_normal((64, 16)) * (rng.random((64, 16)) < 0.5)).astype(
        np.float32
    )
    m_b[8:16] = 0  # an all-zero block: scale 1.0
    q_ref, s_ref = RP._quantize_stream(m_b, 8)
    q_port, s_port = TP._quantize_stream(m_b, 8)
    assert np.array_equal(q_ref, q_port) and np.array_equal(s_ref, s_port)
    col = rng.integers(0, 200, (60, 16)).astype(np.int32)  # not a block multiple
    for got, want in zip(TP._local_gather_tables(col, 16, 8, s_min=3),
                         RP._local_gather_tables(col, 16, 8, s_min=3)):
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_schedule_cache_schedules_once():
    cache = TP.ScheduleCache(maxsize=8)
    args = _matrix(21)
    coo = PortCOO(*args)
    before = port_sched.sched_counters["color_calls"]
    s1 = cache.schedule(coo, 16)
    s2 = cache.schedule(PortCOO(args[0], *(np.array(a) for a in args[1:])), 16)
    assert s1 is s2
    assert port_sched.sched_counters["color_calls"] == before + 1
    assert cache.matrix_key(coo) == RP.ScheduleCache.matrix_key(RefCOO(*args))
    p1 = cache.pack_for(s1, c_blk=8, device="cpu")
    assert cache.pack_for(s1, c_blk=8, value_dtype=torch.float32, device="cpu") is p1
    assert cache.ragged_for(s1, c_blk=8, device="cpu") is not p1
    assert cache.stats()["misses"] == 3 and cache.stats()["hits"] == 2
    with pytest.raises(ValueError, match="unsupported value dtype"):
        TP.pack_schedule(s1, 8, "float16", device="cpu")
