"""B by row offsets and the slot grouping on the SpGEMM path, on the CPU.

* ``row_offsets`` builds B's rows on the plan's device from the COO; row
  by row they are the real prefixes of ``condense_rows``'s planes, bit
  for bit: duplicates (three terms on one cell among them, and a cell of
  thousands of terms), entries that cancel to 0, -0.0 values, empty rows,
  a B with no entry and a B with no column.
* The plain SpGEMM sums each cell's terms in stream order, the order the
  kernel's pre-pass keeps within an adder row: bitwise a sequential sum
  over the stream, on values where another order gives other bits.
* The ``gust_spgemm`` wrapper's CPU path (the plain version) gives the
  same bits with B by row offsets as with the planes, on normal f32
  values, both layouts and every leaf dtype, and on small-integer values
  equals the reference's ``make_gust_spgemm`` (interpret mode).
* ``spgemm`` builds no planes, and ``triangle_count`` copies no ``A·A`` to
  the host; both still equal the reference.
* The CPU's ``index_add_`` sums a cell's terms in index order: the order
  the plain version relies on to give the kernel's bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro
import repro.core.packing as RP
import repro.core.scheduler as rsched
import repro.core.spgemm as rsp
import repro.graph.analytics as rg
from repro.core.formats import COOMatrix as RefCOO
from repro.data import matrices as rmat
from repro.kernels.gust_spgemm import make_gust_spgemm

import repro_torch.core.spgemm as tsp
import repro_torch.graph.analytics as tg
import repro_torch.kernels.gust_spgemm as tk
import repro_torch.kernels.ref as tref
from repro_torch.core.convert import from_reference_leaves
from repro_torch.core.formats import COOMatrix as PortCOO
from repro_torch.core.formats import coo_from_dense as port_coo
from repro_torch.core.formats import dense_from_coo as port_dense
from repro_torch.core.plan import PlanConfig, plan

torch.set_num_threads(1)  # the suite runs several test processes at once


def _port(coo):
    return PortCOO(coo.shape, coo.rows, coo.cols, coo.vals)


def _messy_b(seed, k, n, density):
    """A k x n B with normal values, duplicate entries (three terms on one
    cell, one pair summing to exactly 0, one entry of -0.0), and a few
    empty rows, in no order."""
    rng = np.random.default_rng(seed)
    d = ((rng.random((k, n)) < density) * rng.standard_normal((k, n))).astype(np.float32)
    d[rng.choice(k, size=3, replace=False)] = 0.0  # empty rows
    r, c = np.nonzero(d)
    rows, cols, vals = list(r), list(c), list(d[r, c])
    for i in rng.choice(r.size, size=min(6, r.size), replace=False):  # duplicates
        rows.append(r[i]), cols.append(c[i]), vals.append(np.float32(rng.standard_normal()))
    for _ in range(2):  # the cell r[2], c[2] has three terms
        rows.append(r[2]), cols.append(c[2]), vals.append(np.float32(rng.standard_normal()))
    rows.append(r[0]), cols.append(c[0]), vals.append(-d[r[0], c[0]])  # cancels r[0], c[0]
    rows.append(r[1]), cols.append(c[1]), vals.append(np.float32(-0.0))
    perm = rng.permutation(len(rows))
    return RefCOO((k, n), np.asarray(rows, np.int64)[perm], np.asarray(cols, np.int64)[perm],
                  np.asarray(vals, np.float32)[perm])


#: B cases of the row-offsets builder: name -> (B, plan length l).
B_CASES = {
    "messy_l4": lambda: (_messy_b(0, 30, 21, 0.2), 4),
    "messy_l8": lambda: (_messy_b(0, 30, 21, 0.2), 8),
    "no_entry": lambda: (RefCOO((13, 9), np.zeros(0, np.int64), np.zeros(0, np.int64),
                                np.zeros(0, np.float32)), 8),
    "no_column": lambda: (RefCOO((13, 0), np.zeros(0, np.int64), np.zeros(0, np.int64),
                                 np.zeros(0, np.float32)), 8),
}


@pytest.mark.parametrize("case", sorted(B_CASES))
def test_offsets_are_the_planes_without_padding(case):
    B, l = B_CASES[case]()
    planes = tsp.condense_rows(_port(B), l, device="cpu")
    want = rsp.condense_rows(B, l)
    assert np.array_equal(planes.vals.numpy(), np.asarray(want.vals))
    offs = tsp.row_offsets(_port(B), l, device="cpu")
    assert offs.r_rows == planes.r_rows and offs.ptr.dtype == torch.int64
    assert offs.vals.dtype == torch.float32 and offs.cols.dtype == torch.int32
    ptr = offs.ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == offs.vals.numel() == offs.cols.numel()
    for j in range(offs.r_rows):
        n = ptr[j + 1] - ptr[j]
        got_v = offs.vals.numpy()[ptr[j]:ptr[j + 1]]
        assert np.array_equal(got_v.view(np.int32), planes.vals.numpy()[j, :n].view(np.int32))
        assert np.array_equal(offs.cols.numpy()[ptr[j]:ptr[j + 1]], planes.cols.numpy()[j, :n])
        assert not planes.vals.numpy()[j, n:].any()  # the rest of the plane is padding
    assert max((ptr[1:] - ptr[:-1]).max(), 1) == planes.k_max


def test_offsets_of_merged_b_are_a_fixed_point():
    """Rebuilding from the offsets' own entries (canonical: one term a
    cell) gives the same bits, and a lone -0.0 becomes +0 as in
    ``np.add.at``."""
    B = _messy_b(1, 25, 17, 0.3)
    offs = tsp.row_offsets(_port(B), 8, device="cpu")
    ptr = offs.ptr.numpy()
    rows = np.repeat(np.arange(offs.r_rows), ptr[1:] - ptr[:-1])
    again = tsp.row_offsets(PortCOO(B.shape, rows, offs.cols.numpy().astype(np.int64),
                                    offs.vals.numpy()), 8, device="cpu")
    assert torch.equal(again.ptr, offs.ptr) and torch.equal(again.cols, offs.cols)
    assert torch.equal(again.vals.view(torch.int32), offs.vals.view(torch.int32))
    neg_zero = PortCOO((2, 2), np.array([0, 1]), np.array([1, 0]),
                       np.array([-0.0, 2.0], np.float32))
    assert tsp.row_offsets(neg_zero, 2, device="cpu").vals.view(torch.int32)[0] == 0


def test_offsets_sum_a_cell_of_thousands_of_terms_in_order():
    """One cell of 3,000 terms (and cells of 1-3 beside it), in no order:
    bitwise ``condense_rows``, whose ``np.add.at`` sums them in turn."""
    rng = np.random.default_rng(11)
    rows = np.concatenate([np.full(3000, 4), rng.integers(0, 12, 40)])
    cols = np.concatenate([np.full(3000, 6), rng.integers(0, 9, 40)])
    vals = (rng.standard_normal(rows.size) * 10.0 ** rng.integers(-2, 9, rows.size)).astype(
        np.float32)
    perm = rng.permutation(rows.size)
    B = PortCOO((12, 9), rows[perm].astype(np.int64), cols[perm].astype(np.int64), vals[perm])
    planes = tsp.condense_rows(B, 4, device="cpu")
    offs = tsp.row_offsets(B, 4, device="cpu")
    ptr = offs.ptr.numpy()
    for j in range(offs.r_rows):
        n = ptr[j + 1] - ptr[j]
        assert np.array_equal(offs.vals.numpy()[ptr[j]:ptr[j + 1]].view(np.int32),
                              planes.vals.numpy()[j, :n].view(np.int32)), j
        assert np.array_equal(offs.cols.numpy()[ptr[j]:ptr[j + 1]], planes.cols.numpy()[j, :n])
    backwards = np.float32(0)  # the hub cell's terms summed in the other order
    for v in vals[perm][(rows[perm] == 4) & (cols[perm] == 6)][::-1]:
        backwards = np.float32(backwards + v)
    at = list(planes.cols.numpy()[4]).index(6)
    assert backwards != planes.vals.numpy()[4, at]


def _stream_order_sums(art, b, n_out, backwards=False):
    """Every cell of the window accumulators as a sequential f32 sum over
    the stream's real slots, in stream order (or ``backwards``), from +0:
    the oracle of the order in which the kernel sums each adder row."""
    _, _, bs = tsp._stream_view(art)
    window = tsp.row_windows(bs, art.c_blk).numpy()
    m = art.m_blk.float().reshape(-1).numpy()
    col, row = art.col_blk.reshape(-1).numpy(), art.row_blk.reshape(-1).numpy()
    ptr, bv, bc = b.ptr.numpy(), b.vals.numpy(), b.cols.numpy()
    y = np.zeros((art.num_windows * art.l, n_out), np.float32)
    for s in np.flatnonzero(m)[::-1 if backwards else 1]:
        cell = window[s // art.l] * art.l + row[s]
        for e in range(ptr[col[s]], ptr[col[s] + 1]):
            y[cell, bc[e]] = np.float32(y[cell, bc[e]] + np.float32(m[s] * bv[e]))
    return y.reshape(art.num_windows, art.l, n_out)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_plain_sums_each_row_in_stream_order(layout):
    """A hub row of 60 entries whose values span ten orders of magnitude,
    over a B whose every row has column 2: the plain version's window
    accumulators equal the sequential stream-order sums bitwise, and the
    sums in the other order differ from them (so the order is tested)."""
    rng = np.random.default_rng(3)
    a = rmat.synth_power_law(40, 0.1, seed=2)
    keep = a.rows != 5
    rows = np.concatenate([a.rows[keep], np.full(60, 5)])
    cols = np.concatenate([a.cols[keep], rng.choice(80, 60, replace=False)])
    vals = (rng.standard_normal(rows.size) * 10.0 ** rng.integers(-2, 9, rows.size)).astype(
        np.float32)
    A = PortCOO((40, 80), rows.astype(np.int64), cols.astype(np.int64), vals)
    bd = ((rng.random((80, 7)) < 0.3) * rng.standard_normal((80, 7))).astype(np.float32)
    bd[:, 2] = rng.standard_normal(80).astype(np.float32)
    offs = tsp.row_offsets(port_coo(bd), 8, device="cpu")
    art = plan(A, PlanConfig(l=8, c_blk=4, layout=layout), device="cpu").artifact
    got = tsp.window_product(art, offs, 7)
    want = _stream_order_sums(art, offs, 7)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert not np.array_equal(_stream_order_sums(art, offs, 7, backwards=True), want)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("float32", "int16"),
                                     ("bfloat16", "int32"), ("bfloat16", "int16")])
def test_wrapper_offsets_carrier_equals_planes(layout, vdt, idt):
    rng = np.random.default_rng(2)
    a = rmat.synth_power_law(28, 0.15, seed=4)
    A = RefCOO(a.shape, a.rows, a.cols, rng.standard_normal(a.nnz).astype(np.float32))
    B = _messy_b(3, 28, 19, 0.25)
    cfg = PlanConfig(l=8, c_blk=4, layout=layout, value_dtype=vdt, index_dtype=idt)
    art = plan(_port(A), cfg, device="cpu").artifact
    _, _, bs = tsp._stream_view(art)
    kw = dict(num_windows=art.num_windows, l=8, n_out=19, c_blk=4)
    planes = tsp.condense_rows(_port(B), 8, device="cpu")
    offs = tsp.row_offsets(_port(B), 8, device="cpu")
    before = tk.launches
    y_planes = tk.gust_spgemm(bs, art.m_blk, art.col_blk, art.row_blk, planes.vals,
                              planes.cols, **kw)
    y_offs = tk.gust_spgemm(bs, art.m_blk, art.col_blk, art.row_blk, offs.vals, offs.cols,
                            b_ptr=offs.ptr, **kw)
    assert tk.launches == before
    assert torch.equal(y_planes, y_offs)
    assert torch.equal(y_planes.view(torch.int32), y_offs.view(torch.int32))
    assert torch.equal(tsp.window_product(art, offs, 19), y_offs)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_wrapper_offsets_carrier_equals_pallas_kernel(layout):
    """Small-integer values: the offsets carrier through the wrapper's CPU
    path equals ``make_gust_spgemm`` in interpret mode on the planes."""
    rng = np.random.default_rng(5)
    a = rmat.synth_power_law(20, 0.15, seed=3)
    A = RefCOO(a.shape, a.rows, a.cols, rng.integers(1, 4, a.nnz).astype(np.float32))
    b = rmat.synth_uniform(20, 0.2, seed=5)
    B = RefCOO(b.shape, b.rows, b.cols, rng.integers(-3, 4, b.nnz).astype(np.float32))
    sched = rsched.schedule(A, 8)
    if layout == "ragged":
        art = RP.pack_ragged(sched, 4, value_dtype=jnp.float32, index_dtype=jnp.int32)
        leaves, meta = RP.ragged_leaves(art), RP.ragged_meta(art)
    else:
        art = RP.pack_schedule(sched, 4, value_dtype=jnp.float32, index_dtype=jnp.int32)
        leaves, meta = RP.packed_leaves(art), RP.packed_meta(art)
    cond = rsp.condense_rows(B, 8)
    num_blocks, bw, bs = rsp._stream_view(art)
    want = make_gust_spgemm(num_blocks, art.num_windows, 8, cond.r_rows, cond.k_max, 20,
                            c_blk=4, interpret=True)(
        bw, bs, art.m_blk, art.col_blk, art.row_blk, cond.vals, cond.cols)
    port = from_reference_leaves({k: np.asarray(v) for k, v in leaves.items()}, meta,
                                 device="cpu")
    offs = tsp.row_offsets(_port(B), 8, device="cpu")
    got = tsp.window_product(port, offs, 20)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_spgemm_builds_no_planes_and_matches_reference(monkeypatch):
    rng = np.random.default_rng(7)
    a = rmat.synth_power_law(24, 0.12, seed=6)
    A = RefCOO(a.shape, a.rows, a.cols, rng.integers(-3, 4, a.nnz).astype(np.float32))
    B = _messy_b(8, 24, 15, 0.2)
    B = RefCOO(B.shape, B.rows, B.cols, np.rint(B.vals * 2).astype(np.float32))
    want = {lay: repro.plan(A, repro.PlanConfig(l=8, layout=lay)).spgemm(B)
            for lay in ("padded", "ragged")}

    def no_planes(*args, **kw):
        raise AssertionError("spgemm built the condensed planes")

    monkeypatch.setattr(tsp, "condense_rows", no_planes)
    for lay, R in want.items():
        C = plan(_port(A), PlanConfig(l=8, layout=lay), device="cpu").spgemm(_port(B))
        assert np.array_equal(C.rows, R.rows) and np.array_equal(C.cols, R.cols)
        assert np.array_equal(C.vals, R.vals), lay


@pytest.mark.parametrize("gen", ["power_law", "uniform", "banded"])
def test_triangle_count_masks_on_the_device(gen, monkeypatch):
    """No host copy of A·A: the COO result is never built."""
    make = {"power_law": lambda: rmat.synth_power_law(60, 0.1, seed=2),
            "uniform": lambda: rmat.synth_uniform(60, 0.1, seed=3),
            "banded": lambda: rmat.synth_banded(60, 500, seed=4)}[gen]
    adj = make()
    want = rg.triangle_count(adj, config=repro.PlanConfig(l=8))

    def no_host_copy(*args, **kw):
        raise AssertionError("triangle_count copied A·A to the host")

    monkeypatch.setattr(tsp, "to_host", no_host_copy)
    got = tg.triangle_count(_port(adj), config=PlanConfig(l=8), device="cpu")
    assert got.triangles == want.triangles and got.spgemm_nnz == want.spgemm_nnz
    assert np.array_equal(got.per_node, want.per_node)
    assert got.clustering_coefficient == want.clustering_coefficient
    p = plan(tg._pattern(_port(adj), symmetrize=True, drop_diagonal=True), PlanConfig(l=8),
             device="cpu")
    assert tsp.spgemm_dense(p, p).count_nonzero() == got.spgemm_nnz


def test_cpu_index_add_sums_in_index_order():
    """Many terms on few cells, at several threads: bitwise the sequential
    sums of ``np.add.at``."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 40, 400_000)
    vals = (rng.standard_normal(idx.size) * 1e3).astype(np.float32)
    want = np.zeros(40, np.float32)
    np.add.at(want, idx, vals)
    threads = torch.get_num_threads()
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            got = torch.zeros(40).index_add_(0, torch.from_numpy(idx), torch.from_numpy(vals))
            assert np.array_equal(got.numpy(), want), n
    finally:
        torch.set_num_threads(threads)


def test_dense_product_unchanged():
    """``spgemm_dense`` (offsets) on exact inputs equals the dense product."""
    rng = np.random.default_rng(9)
    a = ((rng.random((33, 27)) < 0.2) * rng.integers(-3, 4, (33, 27))).astype(np.float32)
    b = ((rng.random((27, 41)) < 0.2) * rng.integers(-3, 4, (27, 41))).astype(np.float32)
    for layout in ("padded", "ragged"):
        p = plan(a, PlanConfig(l=8, layout=layout), device="cpu")
        assert np.array_equal(tsp.spgemm_dense(p, b).numpy(), a @ b), layout
        assert np.array_equal(port_dense(p.spgemm(b)), a @ b), layout


def test_spgemm_sweep_edits_apply_to_the_source():
    """Every edit of the SpGEMM sweep's variants finds its text in
    ``gust_spgemm.cu`` (the grid and tile-width edits exactly once), so a
    change to the kernel cannot leave a variant timing the unedited
    kernel; the tile widths are 512 and 2,048 beside the source's 1,024."""
    from repro_torch.kernels import _build, _sweep, spgemm_sweep

    name = _build.SOURCES["gust_spgemm"]
    text = (_build.CSRC / name).read_text()
    for variant, (edits, bitwise) in spgemm_sweep.VARIANTS.items():
        assert bitwise == (not variant.startswith("diag_")), variant
        for old, _ in edits:
            count = text.count(old)
            once = variant.startswith(("grid_", "tile_"))
            assert count == 1 if once else count > 0, (variant, old)
        assert _sweep.edited(text, edits, name) != text, variant
    for width in (512, 2048):
        edits, _ = spgemm_sweep.VARIANTS[f"tile_{width}"]
        assert f"constexpr int kTileCols = {width};" in _sweep.edited(text, edits, name)
    assert "constexpr int kTileCols = 1024;" in text
    with pytest.raises(RuntimeError, match=name):
        _sweep.edited(text, [("no such text", "")], name)
    assert set(spgemm_sweep.PARENT_SIGNATURES) == {"gust_spgemm", "gather_fill"}
