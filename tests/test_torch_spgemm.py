"""Port parity of the SpGEMM path on the CPU.

* ``condense_rows`` gives the reference's planes bitwise and
  ``spgemm_cost`` every field of the reference's.
* ``GustPlan.spgemm`` on the CPU (the plain version of the SpGEMM kernel)
  against the reference's ``plan(...).spgemm`` on its jnp path and on its
  Pallas kernel (``make_gust_spgemm``, interpret mode, as
  ``tests/test_spgemm_property.py`` runs it): on small-integer inputs
  bitwise, and bitwise to the dense product; on normal f32 inputs within
  ``rtol=1e-5, atol=1e-6`` (summation orders differ).
* Rectangular, empty and empty-row operands, a B with no column,
  ``other`` as a plan or a dense array, the validation messages and the
  int8 rejection.
* The ``gust_spgemm`` wrapper's CPU path against ``make_gust_spgemm`` on
  the reference's leaves carried across.

The CUDA kernel is held against the plain version by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro
import repro.core.packing as RP
import repro.core.scheduler as rsched
import repro.core.spgemm as rsp
from repro.core.formats import COOMatrix as RefCOO
from repro.core.formats import dense_from_coo as ref_dense
from repro.data import matrices as rmat
from repro.kernels.gust_spgemm import make_gust_spgemm

import repro_torch
import repro_torch.core.spgemm as tsp
import repro_torch.kernels.gust_spgemm as tk
from repro_torch.core.convert import from_reference_leaves
from repro_torch.core.formats import COOMatrix as PortCOO
from repro_torch.core.formats import dense_from_coo as port_dense
from repro_torch.core.plan import PlanConfig as PortConfig
from repro_torch.core.plan import plan as port_plan
from repro_torch.kernels.ref import gust_spgemm_ref

torch.set_num_threads(1)  # the suite runs several test processes at once

GENERATORS = {
    "uniform": lambda n, seed: rmat.synth_uniform(n, 0.08, seed=seed),
    "power_law": lambda n, seed: rmat.synth_power_law(n, 0.08, seed=seed),
    "k_regular": lambda n, seed: rmat.synth_k_regular(n, 0.08, seed=seed),
    "banded": lambda n, seed: rmat.synth_banded(n, int(n * n * 0.08), seed=seed),
    "block": lambda n, seed: rmat.synth_block_diagonal(
        n, int(n * n * 0.08), num_blocks=4, seed=seed),
}


def _valued(coo, seed, integers):
    """Same pattern, small-integer (exact arithmetic) or normal f32 values."""
    rng = np.random.default_rng(seed)
    if integers:
        vals = rng.integers(-4, 5, coo.nnz).astype(np.float32)
        vals[vals == 0] = 1.0
    else:
        vals = rng.standard_normal(coo.nnz).astype(np.float32)
    return RefCOO(coo.shape, coo.rows, coo.cols, vals)


def _port(coo):
    return PortCOO(coo.shape, coo.rows, coo.cols, coo.vals)


def _canonical(C):
    keys = C.rows * np.int64(C.shape[1]) + C.cols
    assert np.all(np.diff(keys) > 0)
    assert np.all(C.vals != 0)
    assert C.rows.dtype == C.cols.dtype == np.int64 and C.vals.dtype == np.float32


def _check(A, B, l, integers):
    want = ref_dense(A) @ ref_dense(B)
    for layout in ("padded", "ragged"):
        C = port_plan(_port(A), PortConfig(l=l, layout=layout), device="cpu").spgemm(_port(B))
        _canonical(C)
        got = port_dense(C)
        for backend in ("jnp", "pallas"):
            ref = repro.plan(A, repro.PlanConfig(l=l, layout=layout, backend=backend))
            R = ref.spgemm(B, interpret=True) if backend == "pallas" else ref.spgemm(B)
            if integers:
                assert np.array_equal(C.rows, R.rows) and np.array_equal(C.cols, R.cols)
                assert np.array_equal(C.vals, R.vals), (layout, backend)
            else:
                np.testing.assert_allclose(got, ref_dense(R), rtol=1e-5, atol=1e-6)
        if integers:
            assert np.array_equal(got, want), layout
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("integers", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_spgemm_matches_reference(gen, integers):
    A = _valued(GENERATORS[gen](24, seed=5), 6, integers)
    B = _valued(GENERATORS[gen](24, seed=7), 8, integers)
    _check(A, B, l=8, integers=integers)


def test_spgemm_rectangular_empty_and_empty_rows():
    rng = np.random.default_rng(0)
    da = ((rng.random((19, 13)) < 0.25) * rng.integers(1, 4, (19, 13))).astype(np.float32)
    db = ((rng.random((13, 31)) < 0.25) * rng.integers(1, 4, (13, 31))).astype(np.float32)
    _check(_coo(da), _coo(db), l=4, integers=True)
    A = _valued(rmat.synth_uniform(16, 0.1, seed=4), 5, True)
    empty = PortCOO((16, 9), np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float32))
    C = port_plan(_port(A), PortConfig(l=8), device="cpu").spgemm(empty)
    assert C.shape == (16, 9) and C.nnz == 0
    one_row = RefCOO((16, 6), np.array([3, 3], np.int64), np.array([0, 5], np.int64),
                     np.array([2.0, 3.0], np.float32))
    _check(A, one_row, l=8, integers=True)


def _coo(dense):
    r, c = np.nonzero(dense)
    return RefCOO(dense.shape, r.astype(np.int64), c.astype(np.int64), dense[r, c])


@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_spgemm_zero_column_b_matches_reference(layout):
    """A 40x70 at l=8 times a 70x0 B: the reference returns an empty
    (40, 0) COO, and so does the port; its plain SpGEMM returns the empty
    (W, l, 0) accumulator without touching B's padding plane."""
    rng = np.random.default_rng(3)
    A = _coo(((rng.random((40, 70)) < 0.2) * rng.integers(1, 4, (40, 70))).astype(np.float32))
    B = RefCOO((70, 0), np.zeros(0, np.int64), np.zeros(0, np.int64),
               np.zeros(0, np.float32))
    R = repro.plan(A, repro.PlanConfig(l=8, layout=layout)).spgemm(B)
    p = port_plan(_port(A), PortConfig(l=8, layout=layout), device="cpu")
    C = p.spgemm(_port(B))
    _canonical(C)
    assert C.shape == R.shape == (40, 0) and C.nnz == R.nnz == 0
    art = p.artifact
    cond = tsp.condense_rows(_port(B), 8, device="cpu")
    _, _, bs = tsp._stream_view(art)
    y = tk.gust_spgemm(bs, art.m_blk, art.col_blk, art.row_blk, cond.vals, cond.cols,
                       num_windows=art.num_windows, l=8, n_out=0, c_blk=art.c_blk)
    assert tuple(y.shape) == (art.num_windows, 8, 0)


def test_spgemm_other_as_plan_or_dense_and_chained():
    A = _valued(rmat.synth_power_law(24, 0.1, seed=2), 3, True)
    ref2 = ref_dense(A) @ ref_dense(A)
    p = port_plan(_port(A), PortConfig(l=8), device="cpu")
    assert np.array_equal(port_dense(p.spgemm(p)), ref2)
    dense = ref_dense(A)
    assert np.array_equal(port_dense(p.spgemm(dense)), ref2)
    assert np.array_equal(port_dense(p.spgemm(torch.from_numpy(dense))), ref2)
    AA = p.spgemm(_port(A))
    p2 = port_plan(AA, PortConfig(l=8), device="cpu")
    assert np.array_equal(port_dense(p2.spgemm(_port(A))), ref2 @ dense)
    from_sched = port_plan(p.sched, device="cpu")
    assert from_sched._source is None
    with pytest.raises(ValueError, match="source matrix"):
        p.spgemm(from_sched)
    assert np.array_equal(port_dense(from_sched.spgemm(_port(A))), ref2)


def test_spgemm_validation():
    A = _valued(rmat.synth_uniform(16, 0.1, seed=6), 7, True)
    ref = repro.plan(A, repro.PlanConfig(l=8))
    p = port_plan(_port(A), PortConfig(l=8), device="cpu")
    bad = PortCOO((9, 9), np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32))
    with pytest.raises(ValueError, match="shape mismatch") as port_err:
        p.spgemm(bad)
    with pytest.raises(ValueError) as ref_err:
        ref.spgemm(RefCOO(bad.shape, bad.rows, bad.cols, bad.vals))
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(TypeError, match="takes a COOMatrix"):
        p.spgemm("not a matrix")
    with pytest.raises(ValueError, match="dense B must be 2-D"):
        p.spgemm(np.ones(16, np.float32))
    p8 = port_plan(_port(A), PortConfig(l=8, value_dtype="int8"), device="cpu")
    ref8 = repro.plan(A, repro.PlanConfig(l=8, value_dtype="int8"))
    with pytest.raises(ValueError, match="quantized") as port_err:
        p8.spgemm(_port(A))
    with pytest.raises(ValueError) as ref_err:
        ref8.spgemm(A)
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="backend"):
        PortConfig(backend="pallas")


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_condense_rows_and_cost_match_reference(gen):
    A = _valued(GENERATORS[gen](32, seed=9), 10, False)
    # duplicate entries, one summing to zero, are merged as the reference merges them
    B = RefCOO(A.shape, np.concatenate([A.rows, A.rows[:5], A.rows[:1]]),
               np.concatenate([A.cols, A.cols[:5], A.cols[:1]]),
               np.concatenate([A.vals, A.vals[:5], -2 * A.vals[:1]]).astype(np.float32))
    for l in (4, 8):
        want = rsp.condense_rows(B, l)
        got = tsp.condense_rows(_port(B), l, device="cpu")
        assert (got.k_max, got.r_rows, got.shape) == (want.k_max, want.r_rows, want.shape)
        assert np.array_equal(got.vals.numpy(), np.asarray(want.vals))
        assert np.array_equal(got.cols.numpy(), np.asarray(want.cols))
        assert (got.condensed_bytes, got.dense_bytes) == (want.condensed_bytes,
                                                          want.dense_bytes)
        for layout in ("padded", "ragged"):
            ref = repro.plan(A, repro.PlanConfig(l=l, layout=layout))
            port = port_plan(_port(A), PortConfig(l=l, layout=layout), device="cpu")
            assert port.spgemm_cost(_port(B)).to_dict() == ref.spgemm_cost(B).to_dict()
            # a plan built from its schedule prices the product without its source
            ref_s = repro.plan(ref.sched, repro.PlanConfig(l=l, layout=layout))
            port_s = port_plan(port.sched, PortConfig(l=l, layout=layout), device="cpu")
            assert port_s.spgemm_cost(_port(B)).to_dict() == ref_s.spgemm_cost(B).to_dict()
    empty = RefCOO((32, 5), np.zeros(0, np.int64), np.zeros(0, np.int64),
                   np.zeros(0, np.float32))
    got, want = tsp.condense_rows(_port(empty), 8, device="cpu"), rsp.condense_rows(empty, 8)
    assert np.array_equal(got.vals.numpy(), np.asarray(want.vals)) and got.k_max == 1


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("bfloat16", "int16")])
def test_wrapper_cpu_path_matches_pallas_kernel(layout, vdt, idt):
    """The wrapper on CPU tensors (the plain version, no launch) against
    ``make_gust_spgemm`` in interpret mode on the same leaves: bitwise on
    small-integer values, and the plain version's own oracle form (the
    reference's ``window`` argument) agrees."""
    A = _valued(rmat.synth_power_law(20, 0.15, seed=3), 4, True)
    B = _valued(rmat.synth_uniform(20, 0.2, seed=5), 6, True)
    sched = rsched.schedule(A, 8)
    if layout == "ragged":
        art = RP.pack_ragged(sched, 4, value_dtype=jnp.dtype(vdt), index_dtype=jnp.dtype(idt))
        leaves, meta = RP.ragged_leaves(art), RP.ragged_meta(art)
    else:
        art = RP.pack_schedule(sched, 4, value_dtype=jnp.dtype(vdt),
                               index_dtype=jnp.dtype(idt))
        leaves, meta = RP.packed_leaves(art), RP.packed_meta(art)
    port = from_reference_leaves({k: np.asarray(v) for k, v in leaves.items()}, meta,
                                 device="cpu")
    cond = rsp.condense_rows(B, 8)
    num_blocks, bw, bs = rsp._stream_view(art)
    want = make_gust_spgemm(num_blocks, art.num_windows, 8, cond.r_rows, cond.k_max, 20,
                            c_blk=4, interpret=True)(
        bw, bs, art.m_blk, art.col_blk, art.row_blk, cond.vals, cond.cols)
    nb, pbw, pbs = tsp._stream_view(port)
    assert nb == num_blocks and np.array_equal(pbs.numpy(), np.asarray(bs))
    assert np.array_equal(pbw.numpy(), np.asarray(bw))
    vals, cols = torch.tensor(np.asarray(cond.vals)), torch.tensor(np.asarray(cond.cols))
    before = tk.launches
    got = tk.gust_spgemm(pbs, port.m_blk, port.col_blk, port.row_blk, vals, cols,
                         num_windows=port.num_windows, l=8, n_out=20, c_blk=4)
    assert tk.launches == before
    assert np.array_equal(got.numpy(), np.asarray(want))
    window = tsp.row_windows(pbs, 4)
    assert torch.equal(window, pbw.repeat_interleave(4))
    plain = gust_spgemm_ref(port.m_blk, port.col_blk, port.row_blk, window, vals, cols,
                            num_windows=port.num_windows, l=8, n_out=20)
    assert torch.equal(plain, got)


def test_plain_version_chunks_give_the_same_bits(monkeypatch):
    """The plain version's memory cap splits the stream into chunks; the
    result does not depend on where it splits."""
    A = _valued(rmat.synth_power_law(40, 0.1, seed=8), 9, False)
    p = port_plan(_port(A), PortConfig(l=8), device="cpu")
    whole = tsp.spgemm_dense(p, _port(A))
    import repro_torch.kernels.ref as tref

    monkeypatch.setattr(tref, "SPGEMM_REF_CHUNK", 1)  # one slot per chunk
    assert torch.equal(tsp.spgemm_dense(p, _port(A)), whole)


def test_public_names():
    for name in ("spgemm", "SpgemmCost", "triangle_count", "pagerank",
                 "feature_propagation", "PageRankResult", "TriangleCountResult"):
        assert getattr(repro_torch, name) is not None
    assert repro_torch.graph.triangle_count is repro_torch.triangle_count
