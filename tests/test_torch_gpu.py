"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test decides inside itself whether a card is
present and skips without one.  Imports neither ``jax`` nor ``repro``, so
it runs on a machine that has only the port's requirements:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Against the plain version run on the card (``index_add_`` with atomics,
so its order varies) the tolerance is ``rtol=1e-5, atol=1e-5``; against
the plain version run on the CPU (the kernel's own order) the results
must be bitwise equal.  The double-buffered and segment-local kernels
must also equal the single-buffered resident kernel of their layout
(kernel 1 padded, 2 ragged) bitwise on the same artifact
(``torch.equal``, which takes +0 == -0); kernels 1/2 are held to the
plain version on the CPU and to the other pipeline (5/7).  Every SpMV
kernel is an instance of one template that spreads the stream's blocks
over the card's CTAs: kernels 3/4 and 6/8 are also run where CTAs hold
several blocks, a window spans many CTAs, a block references more x
tiles than their stage holds, and a window is empty; so are the resident
kernels 1, 2, 5 and 7, with kernels 5/7's bulk-copy stream ring where a
CTA's run holds fewer chunks than the ring has stages, where a block's
last chunk is short, in int8 and int16, and where a leaf's alignment
turns the ring off.  The SpGEMM kernel is held bitwise to its plain
version on the CPU (on normal values too, at every tile width, with B by
row offsets built on the card and as planes, on a hub row whose slots span
hundreds of cycles, an empty window, one output column and empty B rows)
and, on small-integer values, to the dense product; the Buffer Filler
bitwise to ``x[col]`` on each of its paths, from an x off 16-byte
alignment too.  An infinite x at a column that only padding slots point at
leaves every kernel's rows finite and equal to the plain version's.  An
int16 pack that cannot hold a column raises before any launch, and
``spmm`` with an x of no column launches nothing.  Repadded and stacked
artifacts (a longer stream, a segment table widened past the kernels'
16 staged tiles) run through kernels 1-8 bit for bit as the unpadded
artifact; a store round trip, a rescheduled plan and ``GustLinear`` equal
their fresh or plain counterparts bit for bit; a fault at
``kernel.execute`` reaches the caller with no fallback.  A reduced yi-6b
``ServeLoop`` on the card (dense, GUST padded and ragged) gives the CPU
path's greedy streams, launches kernel 5 or 7 once per GUST product, and
serves one request alone as in the mixed run, bit for bit.  The MoE
and recurrent stacks (reduced dbrx, llama4, recurrentgemma, xlstm)
decode on the card within 1e-4 of the largest logit of the CPU path;
dbrx's top-2 ``moe_ffn`` and decode give the same bits twice; a decode
step that fails in the middle of the stack is retried to the same bits.
Reduced seamless (the encoder-decoder blocks) runs the forward, prefill
and decode on the card as on the CPU, directly and on the blocked
softmax.  The artifact verifier finds nothing on card artifacts of every
layout and dtype and fires GUST-P14 on a seeded collision; the Hopper
resource audit finds nothing in the built libraries and their launch
plans.  Training: a reduced yi-6b step on the card agrees with the CPU's
(``chip_smoke.step_agreement``); under deterministic algorithms a run
resumed from a checkpoint (restored on the card, and saved from a CPU
restore) gives the uninterrupted losses and state bit for bit for
yi-6b, xlstm and llama4's MoE; a card that does not exist raises.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro_torch.kernels.gather_fill as k_fill
import repro_torch.kernels.gust_spgemm as k_gemm
import repro_torch.kernels.gust_spmv as k_pad
import repro_torch.kernels.gust_spmv_ragged as k_rag
import repro_torch.kernels.ref as tref
import repro_torch.resilience as resilience
from repro_torch.core.formats import COOMatrix, dense_from_coo
from repro_torch.core.gust_linear import GustLinear
from repro_torch.core.plan import GustPlan, reschedule
from repro_torch.core.plan_store import PlanStore
from repro_torch.core.packing import pack_ragged, pack_schedule
from repro_torch.core.plan import PlanConfig, plan
from repro_torch.core.scheduler import schedule
from repro_torch.core.spgemm import _stream_view, condense_rows, row_offsets, row_windows
from repro_torch.kernels.ref import _local_columns
from repro_torch.kernels.ops import _prep_x

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _coo(dense):
    r, c = np.nonzero(dense)
    return COOMatrix(dense.shape, r.astype(np.int64), c.astype(np.int64), dense[r, c])


def _dense(seed, m, n, density):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)
    d[rng.integers(0, m)] = rng.standard_normal(n)  # a heavy row: padded windows
    return d


def _run(art, xp):
    if hasattr(art, "block_starts"):
        return k_rag.gust_spmv_ragged(
            art.m_blk, art.col_blk, art.row_blk, art.block_window,
            art.block_starts, xp, num_windows=art.num_windows, l=art.l,
            c_blk=art.c_blk, scale_blk=art.scale_blk,
        )
    return k_pad.gust_spmv(
        art.m_blk, art.col_blk, art.row_blk, xp, num_windows=art.num_windows,
        l=art.l, c_blk=art.c_blk, scale_blk=art.scale_blk,
    )


def _plain(art, xp):
    """The plain version on the artifact's own device."""
    if hasattr(art, "block_starts"):
        return tref.gust_spmv_ragged_ref(
            art.m_blk, art.col_blk, art.row_blk, art.block_window, xp,
            num_windows=art.num_windows, l=art.l, c_blk=art.c_blk,
            scale_blk=art.scale_blk,
        )
    return tref.gust_spmv_ref(
        art.m_blk, art.col_blk, art.row_blk, xp, num_windows=art.num_windows,
        l=art.l, c_blk=art.c_blk, scale_blk=art.scale_blk,
    )


def _run_db(art, xp, local):
    """Kernel 5/7 (resident, the bulk-copy stream ring at B > 1 where the
    leaves allow it) or 6/8 (segment-local) on one artifact."""
    kw = dict(num_windows=art.num_windows, l=art.l, c_blk=art.c_blk,
              scale_blk=art.scale_blk)
    if hasattr(art, "block_starts"):
        blocks = (art.block_window, art.block_starts)
        if local:
            return k_rag.gust_spmv_ragged_local_db(
                art.m_blk, art.col_loc, art.row_blk, art.seg_blk, *blocks, xp, **kw)
        return k_rag.gust_spmv_ragged_db(
            art.m_blk, art.col_blk, art.row_blk, *blocks, xp, **kw)
    if local:
        return k_pad.gust_spmv_local_db(
            art.m_blk, art.col_loc, art.row_blk, art.seg_blk, xp, **kw)
    return k_pad.gust_spmv_db(art.m_blk, art.col_blk, art.row_blk, xp, **kw)


def _run_local_single(art, xp):
    """Kernel 3/4 (segment-local, single-buffered) on one artifact."""
    kw = dict(num_windows=art.num_windows, l=art.l, c_blk=art.c_blk,
              scale_blk=art.scale_blk)
    if hasattr(art, "block_starts"):
        return k_rag.gust_spmv_ragged_local(
            art.m_blk, art.col_loc, art.row_blk, art.seg_blk, art.block_window,
            art.block_starts, xp, **kw)
    return k_pad.gust_spmv_local(art.m_blk, art.col_loc, art.row_blk, art.seg_blk, xp, **kw)


def shuffle_segment_table(art, seed):
    """``art`` with each block's segment-table row in a random order and
    ``col_loc`` remapped to match: the same matrix, through rows that are
    not strictly increasing, which the packer never writes."""
    seg = art.seg_blk.cpu().numpy()
    perm = np.argsort(np.random.default_rng(seed).random(seg.shape), axis=1)
    inv = np.argsort(perm, axis=1)  # old position -> new position
    cl = art.col_loc.cpu().numpy().astype(np.int64)
    t = np.arange(cl.shape[0])[:, None] // art.c_blk
    new_cl = inv[t, cl // art.l] * art.l + cl % art.l
    dev = art.seg_blk.device
    return dataclasses.replace(
        art,
        seg_blk=torch.from_numpy(np.take_along_axis(seg, perm, axis=1)).to(dev),
        col_loc=torch.from_numpy(new_cl).to(art.col_loc.dtype).to(dev),
    )


CASES = [  # (m, n, l, c_blk, b)
    (200, 300, 32, 8, 1),
    (130, 90, 12, 3, 9),  # l not a power of two, B across two column tiles
    (64, 20, 64, 16, 8),  # n < l, c_blk above the kernel's load stage
    (700, 700, 256, 8, 3),
    (50, 40, 7, 1, 2),  # 7-byte int8 blocks: no 4-byte-aligned copy
]


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("bfloat16", "int16"),
                                     ("int8", "int32"), ("int8", "int16")])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_matches_plain(cuda, layout, vdt, idt, case):
    m, n, l, c_blk, b = CASES[case]
    sched = schedule(_coo(_dense(case, m, n, 0.05)), l)
    pack = pack_ragged if layout == "ragged" else pack_schedule
    art_gpu = pack(sched, c_blk, vdt, idt, device=cuda)
    art_cpu = pack(sched, c_blk, vdt, idt, device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((n, b)).astype(np.float32))
    xp_cpu = _prep_x(x, n, l)
    xp = xp_cpu.to(cuda)
    counter = k_rag if layout == "ragged" else k_pad
    before = counter.launches
    y = _run(art_gpu, xp)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    torch.testing.assert_close(y, _plain(art_gpu, xp), rtol=1e-5, atol=1e-5)
    plain_cpu = _run(art_cpu, xp_cpu)
    assert torch.equal(y.cpu(), plain_cpu)


@pytest.mark.parametrize("local", [False, True], ids=["db", "local_db"])
@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("bfloat16", "int16"),
                                     ("int8", "int32"), ("int8", "int16")])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_db_kernel_matches_plain_and_single(cuda, local, layout, vdt, idt, case):
    """Kernels 5-8: against the plain version (card: tolerance; CPU:
    bitwise, the yardstick at B=1) and bitwise against kernel 1/2, the
    resident single-buffered kernel, on the same artifact.  CASES hold an
    l of 12 (rows of 12 int8/int16 values are not 16-byte runs: kernels
    5/7 run without their stream ring), c_blk above the 8-cycle chunk,
    and B across two column tiles."""
    m, n, l, c_blk, b = CASES[case]
    sched = schedule(_coo(_dense(case, m, n, 0.05)), l)
    pack = pack_ragged if layout == "ragged" else pack_schedule
    art_gpu = pack(sched, c_blk, vdt, idt, device=cuda)
    art_cpu = pack(sched, c_blk, vdt, idt, device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((n, b)).astype(np.float32))
    xp_cpu = _prep_x(x, n, l)
    xp = xp_cpu.to(cuda)
    counter = k_rag if layout == "ragged" else k_pad
    name = "local_db_launches" if local else "db_launches"
    before = getattr(counter, name)
    y = _run_db(art_gpu, xp, local)
    torch.cuda.synchronize()
    assert getattr(counter, name) == before + 1
    torch.testing.assert_close(y, _plain(art_gpu, xp), rtol=1e-5, atol=1e-5)
    assert torch.equal(y.cpu(), _run_db(art_cpu, xp_cpu, local))
    assert torch.equal(y, _run(art_gpu, xp))


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt", ["float32", "int8"])
@pytest.mark.parametrize("case", [0, 1, 3, 4])  # case 2: one segment, nothing to shuffle
def test_local_kernel_takes_unordered_segment_tables(cuda, layout, vdt, case):
    """Kernels 6/8 stream only the strictly increasing prefix of a table
    row; a slot past it must still get its x value (read directly), so a
    shuffled table gives the same bits as kernel 1/2 and as the plain
    version on the CPU."""
    m, n, l, c_blk, b = CASES[case]
    sched = schedule(_coo(_dense(case, m, n, 0.05)), l)
    pack = pack_ragged if layout == "ragged" else pack_schedule
    art_gpu = pack(sched, c_blk, vdt, "int32", device=cuda)
    shuffled = shuffle_segment_table(art_gpu, seed=case)
    assert not torch.equal(shuffled.seg_blk, art_gpu.seg_blk)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((n, b)).astype(np.float32))
    xp_cpu = _prep_x(x, n, l)
    xp = xp_cpu.to(cuda)
    y = _run_db(shuffled, xp, local=True)
    assert torch.equal(y, _run(art_gpu, xp))
    shuffled_cpu = dataclasses.replace(shuffled, **{
        f.name: getattr(shuffled, f.name).cpu() for f in dataclasses.fields(shuffled)
        if isinstance(getattr(shuffled, f.name), torch.Tensor)})
    assert torch.equal(y.cpu(), _run_db(shuffled_cpu, xp_cpu, local=True))


def test_row0_padding_collision(cuda):
    dense = np.zeros((8, 8), np.float32)
    dense[0, 1] = 3.0  # window 0: one real slot, on row 0
    dense[4:8, :] = np.arange(1, 33, dtype=np.float32).reshape(4, 8)
    x = np.arange(1, 9, dtype=np.float32)[:, None] - 4.0
    for layout in ("padded", "ragged"):
        for gather, pipeline in (("resident", "single"), ("resident", "double"),
                                 ("local", "double")):
            p = plan(dense, PlanConfig(l=4, c_blk=4, load_balance=False, layout=layout,
                                       gather=gather, pipeline=pipeline), device=cuda)
            y = p.spmm(x)
            assert np.array_equal(y.cpu().numpy(), dense @ x), (layout, gather, pipeline)


def test_plan_on_card_and_launch_errors(cuda):
    dense = _dense(1, 300, 260, 0.03)
    cfg = PlanConfig(l=32, gather="resident", pipeline="single")
    v = np.random.default_rng(3).standard_normal(260).astype(np.float32)
    before = (k_pad.launches, k_rag.launches)
    y_pad = plan(dense, cfg, layout="padded", device=cuda).spmv(v)
    y_rag = plan(dense, cfg, layout="ragged", device=cuda).spmv(v)
    assert (k_pad.launches, k_rag.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y_pad, y_rag)
    np.testing.assert_allclose(y_pad.cpu().numpy(), dense @ v, rtol=1e-4, atol=1e-4)
    # the default config runs on the card, through a double-buffered kernel
    p = plan(dense, PlanConfig(l=32), device=cuda)
    counter = k_rag if p.layout == "ragged" else k_pad
    name = "local_db_launches" if p.gather_mode == "local" else "db_launches"
    before = getattr(counter, name)
    assert torch.equal(p.spmv(v), y_pad)
    assert getattr(counter, name) == before + 1
    art = plan(dense, cfg, layout="padded", device=cuda).artifact
    xp = torch.zeros(2, 288, device=cuda).T  # (S*l, 2), not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        k_pad.gust_spmv(art.m_blk, art.col_blk, art.row_blk, xp,
                        num_windows=art.num_windows, l=32, c_blk=art.c_blk)
    with pytest.raises(ValueError, match="tensors on"):
        k_pad.gust_spmv(art.m_blk, art.col_blk, art.row_blk, xp.cpu(),
                        num_windows=art.num_windows, l=32, c_blk=art.c_blk)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_local_single_runs_through_plan(cuda, layout):
    """``gather="local", pipeline="single"`` runs kernel 3/4 on the card and
    gives the bits of the resident single-buffered plan."""
    dense = _dense(2, 200, 300, 0.05)
    v = np.random.default_rng(6).standard_normal(300).astype(np.float32)
    p = plan(dense, PlanConfig(l=16, layout=layout, gather="local", pipeline="single"),
             device=cuda)
    counter = k_rag if layout == "ragged" else k_pad
    before = counter.local_launches
    y = p.spmv(v)
    assert counter.local_launches == before + 1
    resident = plan(dense, PlanConfig(l=16, layout=layout, gather="resident",
                                      pipeline="single"), device=cuda)
    assert torch.equal(y, resident.spmv(v))
    np.testing.assert_allclose(y.cpu().numpy(), dense @ v, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("bfloat16", "int16"),
                                     ("int8", "int32"), ("int8", "int16")])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_local_single_kernel_matches_plain_and_other_kernels(cuda, layout, vdt, idt, case):
    """Kernels 3/4: against the plain version (card: tolerance; CPU:
    bitwise), and bitwise against kernel 1/2 and kernel 6/8 on the same
    artifact."""
    m, n, l, c_blk, b = CASES[case]
    sched = schedule(_coo(_dense(case, m, n, 0.05)), l)
    pack = pack_ragged if layout == "ragged" else pack_schedule
    art_gpu = pack(sched, c_blk, vdt, idt, device=cuda)
    art_cpu = pack(sched, c_blk, vdt, idt, device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((n, b)).astype(np.float32))
    xp_cpu = _prep_x(x, n, l)
    xp = xp_cpu.to(cuda)
    counter = k_rag if layout == "ragged" else k_pad
    before = counter.local_launches
    y = _run_local_single(art_gpu, xp)
    torch.cuda.synchronize()
    assert counter.local_launches == before + 1
    torch.testing.assert_close(y, _plain(art_gpu, xp), rtol=1e-5, atol=1e-5)
    assert torch.equal(y.cpu(), _run_local_single(art_cpu, xp_cpu))
    assert torch.equal(y, _run(art_gpu, xp))
    assert torch.equal(y, _run_db(art_gpu, xp, local=True))


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt", ["float32", "int8"])
@pytest.mark.parametrize("case", [0, 1, 3, 4])  # case 2: one segment, nothing to shuffle
def test_local_single_kernel_takes_unordered_segment_tables(cuda, layout, vdt, case):
    """Kernels 3/4 stage only the strictly increasing prefix of a table
    row; a slot past it reads x directly, so a shuffled table gives the
    bits of kernel 1/2 and of the plain version on the CPU."""
    m, n, l, c_blk, b = CASES[case]
    sched = schedule(_coo(_dense(case, m, n, 0.05)), l)
    pack = pack_ragged if layout == "ragged" else pack_schedule
    art_gpu = pack(sched, c_blk, vdt, "int32", device=cuda)
    shuffled = shuffle_segment_table(art_gpu, seed=case)
    assert not torch.equal(shuffled.seg_blk, art_gpu.seg_blk)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((n, b)).astype(np.float32))
    xp_cpu = _prep_x(x, n, l)
    xp = xp_cpu.to(cuda)
    y = _run_local_single(shuffled, xp)
    assert torch.equal(y, _run(art_gpu, xp))
    shuffled_cpu = dataclasses.replace(shuffled, **{
        f.name: getattr(shuffled, f.name).cpu() for f in dataclasses.fields(shuffled)
        if isinstance(getattr(shuffled, f.name), torch.Tensor)})
    assert torch.equal(y.cpu(), _run_local_single(shuffled_cpu, xp_cpu))


def _spgemm_operands(seed, m, k, n_out, density, integers):
    rng = np.random.default_rng(seed)
    vals = (lambda shape: rng.integers(-3, 4, shape)) if integers else rng.standard_normal
    a = ((rng.random((m, k)) < density) * vals((m, k))).astype(np.float32)
    a[rng.integers(0, m)] = vals(k)  # a heavy row: many padding slots elsewhere
    bm = ((rng.random((k, n_out)) < density) * vals((k, n_out))).astype(np.float32)
    bm[:, 0] = vals(k)  # real work on B's column 0, where B's padding points
    return a, bm


def _run_spgemm(art, cond, n_out):
    _, _, bs = _stream_view(art)
    return k_gemm.gust_spgemm(bs, art.m_blk, art.col_blk, art.row_blk, cond.vals, cond.cols,
                              num_windows=art.num_windows, l=art.l, n_out=n_out,
                              c_blk=art.c_blk)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("float32", "int16"),
                                     ("bfloat16", "int32"), ("bfloat16", "int16")])
@pytest.mark.parametrize("l", [7, 32, 256])
def test_spgemm_kernel_matches_plain_and_dense(cuda, layout, vdt, idt, l):
    """Kernel 9: on small-integer values bitwise equal to its plain version
    (card and CPU) and to the dense product; on normal values bitwise to
    the plain version on the CPU (the kernel's order) and within
    ``1e-5 * (|A|·|B|)`` per element of the plain version on the card."""
    pack = pack_ragged if layout == "ragged" else pack_schedule
    for integers in (True, False):
        a, bm = _spgemm_operands(l, 3 * l + 5, 2 * l + 3, 40, 0.08, integers)
        sched = schedule(_coo(a), l)
        art_gpu = pack(sched, 4, vdt, idt, device=cuda)
        art_cpu = pack(sched, 4, vdt, idt, device="cpu")
        cond_gpu = condense_rows(_coo(bm), l, device=cuda)
        cond_cpu = condense_rows(_coo(bm), l, device="cpu")
        before = k_gemm.launches
        y = _run_spgemm(art_gpu, cond_gpu, 40)
        torch.cuda.synchronize()
        assert k_gemm.launches == before + 1
        assert torch.equal(y.cpu(), _run_spgemm(art_cpu, cond_cpu, 40))
        window = row_windows(_stream_view(art_gpu)[2], art_gpu.c_blk)
        plain = tref.gust_spgemm_ref(art_gpu.m_blk, art_gpu.col_blk, art_gpu.row_blk, window,
                                     cond_gpu.vals, cond_gpu.cols,
                                     num_windows=art_gpu.num_windows, l=l, n_out=40)
        if integers:
            assert torch.equal(y, plain)
            p = plan(a, PlanConfig(l=l, c_blk=4, layout=layout, value_dtype=vdt,
                                   index_dtype=idt), device=cuda)
            c = p.spgemm(bm)
            want = a.astype(np.float64) @ bm.astype(np.float64)
            assert np.array_equal(dense_from_coo(c), want.astype(np.float32))
        else:
            mag = tref.gust_spgemm_ref(art_gpu.m_blk.abs(), art_gpu.col_blk, art_gpu.row_blk,
                                       window, cond_gpu.vals.abs(), cond_gpu.cols,
                                       num_windows=art_gpu.num_windows, l=l, n_out=40)
            assert bool(((y - plain).abs() <= 1e-5 * mag).all())


def test_spgemm_row0_column0_padding_collision(cuda):
    """Window 0 has one real slot, on adder row 0, in cycles full of padding
    slots (row 0, value 0), and B's real entries sit in column 0 beside
    B's padding entries (column 0, value 0): nothing may be lost."""
    a = np.zeros((8, 8), np.float32)
    a[0, 1] = 3.0  # window 0: one real slot, on row 0
    a[4:8, :] = np.arange(1, 33, dtype=np.float32).reshape(4, 8)
    bm = np.zeros((8, 5), np.float32)
    bm[:, 0] = np.arange(1, 9)
    bm[1, 4] = 2.0
    bm[5, 0:5] = 1.0  # one long row: every other row is padded to it
    want = a @ bm
    for layout in ("padded", "ragged"):
        p = plan(a, PlanConfig(l=4, c_blk=4, load_balance=False, layout=layout), device=cuda)
        assert np.array_equal(dense_from_coo(p.spgemm(bm)), want), layout


@pytest.mark.parametrize("idt", ["int32", "int16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_gather_fill_matches_plain(cuda, idt, case):
    """Kernel 10: bitwise equal to its plain version and to ``x[col]``."""
    m, n, l, c_blk, _ = CASES[case]
    art = pack_schedule(schedule(_coo(_dense(case, m, n, 0.05)), l), c_blk, "float32", idt,
                        device=cuda)
    for b in (1, 3, 8):
        x = torch.from_numpy(np.random.default_rng(b).standard_normal((n, b)).astype(np.float32))
        xp = _prep_x(x, n, l).to(cuda)
        before = k_fill.launches
        g = k_fill.gather_fill(art.col_blk, xp)
        torch.cuda.synchronize()
        assert k_fill.launches == before + 1
        assert torch.equal(g, tref.gather_fill_ref(art.col_blk, xp))
        assert torch.equal(g, xp[art.col_blk.long()])


@pytest.mark.parametrize("vdt", ["float32", "int8"])
@pytest.mark.parametrize("load_balance", [True, False])
def test_default_plans_agree_across_layouts_gathers_pipelines(cuda, vdt, load_balance):
    """Every (layout, gather, pipeline) the card runs gives the same bits
    on one matrix: padded == ragged, resident == local, single == double."""
    dense = _dense(4, 300, 900, 0.02)
    X = np.random.default_rng(5).standard_normal((900, 3)).astype(np.float32)
    ys = []
    for layout in ("padded", "ragged"):
        for gather, pipeline in (("resident", "single"), ("resident", "double"),
                                 ("local", "double"), ("auto", "auto")):
            cfg = PlanConfig(l=16, layout=layout, gather=gather, pipeline=pipeline,
                             load_balance=load_balance, value_dtype=vdt)
            ys.append(plan(dense, cfg, device=cuda).spmm(X))
    for y in ys[1:]:
        assert torch.equal(y, ys[0])
    if vdt == "float32":
        np.testing.assert_allclose(ys[0].cpu().numpy(), dense @ X, rtol=1e-4, atol=1e-4)


def _run_family(family, art, xp):
    """Kernel 1/2, 3/4, 5/7 or 6/8 of the artifact's layout."""
    if family == "single":
        return _run(art, xp)
    if family == "local_single":
        return _run_local_single(art, xp)
    return _run_db(art, xp, local=family == "local_db")


def _inf_case():
    """64x64 of small integers whose column 3 holds no entry; x = 1 except
    x[3] = inf, where padding slots of lane 3 point at l=8."""
    rng = np.random.default_rng(41)
    dense = ((rng.random((64, 64)) < 0.15) * rng.integers(-3, 4, (64, 64))).astype(np.float32)
    dense[:, 3] = 0
    x = np.ones((64, 1), np.float32)
    x[3] = np.inf
    return dense, x


@pytest.mark.parametrize("family", ["single", "local_single", "db", "local_db"])
@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt", ["float32", "int8"])
def test_kernels_skip_padding_at_an_infinite_x(cuda, family, layout, vdt):
    """Every SpMV kernel skips zero-valued slots, and so does its plain
    version: with an inf at a column only padding points at, the rows are
    finite and bitwise equal to the plain version on the CPU (B=1)."""
    dense, x = _inf_case()
    sched = schedule(_coo(dense), 8)
    pack = pack_ragged if layout == "ragged" else pack_schedule
    art_gpu = pack(sched, 4, vdt, "int32", device=cuda)
    art_cpu = pack(sched, 4, vdt, "int32", device="cpu")
    cols = art_cpu.col_blk if "local" not in family else _local_columns(
        art_cpu.col_loc, art_cpu.seg_blk, l=8, c_blk=4)
    assert bool(((art_cpu.m_blk == 0) & (cols == 3)).any())  # padding reads the inf
    xp_cpu = _prep_x(torch.from_numpy(x), 64, 8)
    y = _run_family(family, art_gpu, xp_cpu.to(cuda))
    assert bool(torch.isfinite(y).all())
    assert torch.equal(y.cpu(), _run_family(family, art_cpu, xp_cpu))


@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_plans_at_an_infinite_x_equal_m_x(cuda, layout):
    dense, x = _inf_case()
    keep = np.arange(64) != 3
    want = (dense[:, keep].astype(np.float64) @ x[keep].astype(np.float64)).astype(np.float32)
    for gather, pipeline in (("resident", "single"), ("local", "single"),
                             ("resident", "double"), ("local", "double")):
        p = plan(dense, PlanConfig(l=8, c_blk=4, layout=layout, gather=gather,
                                   pipeline=pipeline), device=cuda)
        y = p.spmm(x)
        assert np.array_equal(y.cpu().numpy(), want), (gather, pipeline)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_spgemm_zero_column_b_on_card(cuda, layout):
    """B with no column: an empty (m, 0) product, as the reference gives."""
    rng = np.random.default_rng(3)
    a = ((rng.random((40, 70)) < 0.2) * rng.integers(1, 4, (40, 70))).astype(np.float32)
    empty = COOMatrix((70, 0), np.zeros(0, np.int64), np.zeros(0, np.int64),
                      np.zeros(0, np.float32))
    c = plan(a, PlanConfig(l=8, layout=layout), device=cuda).spgemm(empty)
    assert c.shape == (40, 0) and c.nnz == 0


def _heavy_window(seed, l, windows, n, heavy_deg, deg):
    """``l * windows`` rows over ``n`` columns: window 0's rows hold
    ``heavy_deg`` entries each, the others ``deg``, so that without load
    balancing window 0 has many times the blocks of any other window."""
    rng = np.random.default_rng(seed)
    m = l * windows
    cols = [np.sort(rng.choice(n, size=heavy_deg if r < l else deg, replace=False))
            for r in range(m)]
    rows = np.repeat(np.arange(m), [c.size for c in cols])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return COOMatrix((m, n), rows.astype(np.int64), np.concatenate(cols).astype(np.int64), vals)


def _empty_window(seed):
    """96x120 at l=32 whose second window (rows 32..63) is empty."""
    d = _dense(seed, 96, 120, 0.08)
    d[32:64] = 0
    return _coo(d)


#: Matrices of the spread cases: name -> (function that makes it, l).
SPREAD_MATRICES = {
    "heavy256": (lambda: _heavy_window(0, 256, 16, 2000, 900, 60), 256),
    "heavy128": (lambda: _heavy_window(1, 128, 96, 1500, 700, 40), 128),
    "many_segments_a": (lambda: _coo(_dense(7, 64, 400, 0.1)), 4),
    "many_segments_b": (lambda: _coo(_dense(8, 64, 600, 0.1)), 4),
    "empty_window": (lambda: _empty_window(5), 32),
    "odd_l": (lambda: _coo(_dense(6, 150, 200, 0.05)), 7),
    "l1024": (lambda: _coo(_dense(9, 2048, 3000, 0.01)), 1024),
    "few_blocks": (lambda: _coo(_dense(10, 96, 120, 0.08)), 32),
}
#: name -> (matrix, c_blk, B, values, indices, what it exercises)
SPREAD_CASES = {
    "heavy_window_b1": ("heavy256", 1, 1, "float32", "int32", "blocks_per_cta"),
    "heavy_window_b8_bf16_int16": ("heavy256", 1, 8, "bfloat16", "int16", "blocks_per_cta"),
    "heavy_window_b3_int8": ("heavy128", 1, 3, "int8", "int32", "blocks_per_cta"),
    "heavy_window_b8_int8_int16": ("heavy256", 1, 8, "int8", "int16", "blocks_per_cta"),
    "over_cap_b8": ("many_segments_a", 8, 8, "float32", "int32", "over_cap"),
    "over_cap_b1_int8_int16": ("many_segments_b", 8, 1, "int8", "int16", "over_cap"),
    "empty_window_b3_int8": ("empty_window", 4, 3, "int8", "int32", "empty_window"),
    "odd_l_b3_bf16_int16": ("odd_l", 3, 3, "bfloat16", "int16", "odd_l"),
    "l1024_b1": ("l1024", 4, 1, "float32", "int32", "l1024"),
    "l1024_b8_int8": ("l1024", 4, 8, "int8", "int32", "l1024"),
    "few_chunks_b8": ("few_blocks", 4, 8, "float32", "int32", "few_chunks"),
    "c_blk3_b8_int8_int16": ("heavy256", 3, 8, "int8", "int16", "short_block"),
    "c_blk6_b8": ("heavy256", 6, 8, "float32", "int32", "short_chunk"),
    "c_blk12_b1_bf16": ("heavy256", 12, 1, "bfloat16", "int32", "short_chunk"),
}
_SPREAD_SCHEDULES = {}


def _run_local(pipeline, art, xp):
    """Kernel 3/4 (``"single"``) or 6/8 (``"double"``) on one artifact."""
    return _run_local_single(art, xp) if pipeline == "single" else _run_db(art, xp, local=True)


def _spread_case(case, layout, device):
    """One spread case: (its spec, the artifact on the card and on the CPU,
    x padded on the card and on the CPU, T_blk, each window's blocks)."""
    matrix, c_blk, b, vdt, idt, what = SPREAD_CASES[case]
    build, l = SPREAD_MATRICES[matrix]
    if matrix not in _SPREAD_SCHEDULES:
        _SPREAD_SCHEDULES[matrix] = schedule(build(), l, load_balance=False, workers=1)
    sched = _SPREAD_SCHEDULES[matrix]
    pack = pack_ragged if layout == "ragged" else pack_schedule
    art_gpu = pack(sched, c_blk, vdt, idt, device=device)
    art_cpu = pack(sched, c_blk, vdt, idt, device="cpu")
    n = sched.shape[1]
    x = torch.from_numpy(np.random.default_rng(b).standard_normal((n, b)).astype(np.float32))
    xp_cpu = _prep_x(x, n, l)
    t_blk = art_cpu.m_blk.shape[0] // c_blk
    blocks_of = (np.diff(art_cpu.block_starts.numpy()) if layout == "ragged"
                 else np.full(art_cpu.num_windows, t_blk // art_cpu.num_windows))
    return art_gpu, art_cpu, xp_cpu.to(device), xp_cpu, t_blk, blocks_of


@pytest.mark.parametrize("pipeline", ["single", "double"])
@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("case", sorted(SPREAD_CASES))
def test_local_db_spread_over_ctas(cuda, case, layout, pipeline):
    """Kernels 3/4 (one x-tile stage) and 6/8 (two) spread the stream's
    blocks over the card's CTAs and fold each window's block tiles in
    stream order: bitwise equal to kernels 1/2 (the resident
    single-buffered kernels), to the kernels of the other pipeline on the
    same artifact and to the plain version on the CPU,
    where each CTA holds several blocks and window 0 spans many CTAs,
    where a block references more x tiles than the stage holds, where a
    ragged window is empty (one all-padding block) and a padded window is
    mostly all-padding blocks, at an odd l, at l=1024, in every value and
    index type and at B = 1, 3 and 8."""
    _, c_blk, _, _, _, what = SPREAD_CASES[case]
    art_gpu, art_cpu, xp, xp_cpu, t_blk, blocks_of = _spread_case(case, layout, cuda)
    l = art_cpu.l
    launch = k_pad.spread_launch_plan(art_gpu.m_blk, art_gpu.col_loc, art_gpu.row_blk, xp,
                                      l=l, c_blk=c_blk, gather="local", pipeline=pipeline)
    assert launch["stream_stages"] == 0
    seg = art_cpu.seg_blk.numpy()
    tiles = 1 + (seg[:, 1:] > seg[:, :-1]).sum(axis=1)
    if what in ("blocks_per_cta", "l1024"):
        assert launch["grid_x"] < t_blk / 2  # CTAs run several blocks each
    if what == "blocks_per_cta" and layout == "ragged":
        assert blocks_of[0] > 5 * np.median(blocks_of[1:])
        assert blocks_of[0] > 4 * t_blk / launch["grid_x"]  # window 0 spans many CTAs
    if what == "over_cap":
        assert tiles.max() > launch["stage_tiles"]
    if what == "empty_window" and layout == "ragged":
        t0 = int(art_cpu.block_starts[1])
        assert blocks_of[1] == 1
        assert not bool(art_cpu.m_blk[t0 * c_blk:(t0 + 1) * c_blk].any())
    if layout == "padded":  # windows padded to the longest: all-padding blocks
        blk = art_cpu.m_blk.reshape(t_blk, -1)
        assert not bool(blk.any(dim=1).all())
    counter = k_rag if layout == "ragged" else k_pad
    attr = "local_launches" if pipeline == "single" else "local_db_launches"
    before = getattr(counter, attr)
    y = _run_local(pipeline, art_gpu, xp)
    torch.cuda.synchronize()
    assert getattr(counter, attr) == before + 1
    assert torch.equal(y, _run(art_gpu, xp))
    other = "double" if pipeline == "single" else "single"
    assert torch.equal(y, _run_local(other, art_gpu, xp))
    assert torch.equal(y.cpu(), _run_local(pipeline, art_cpu, xp_cpu))


#: Kernel -> (layout, pipeline) of the resident spread kernels.
_RESIDENT_SPREAD = {1: ("padded", "single"), 2: ("ragged", "single"),
                    5: ("padded", "double"), 7: ("ragged", "double")}


def _run_resident(pipeline, art, xp):
    """Kernel 1/2 (``"single"``) or 5/7 (``"double"``) on one artifact."""
    return _run(art, xp) if pipeline == "single" else _run_db(art, xp, local=False)


def _ring_fits(art, b):
    """Whether kernels 5/7 take the bulk-copy ring: at B > 1, where the
    leaves' rows are whole 16-byte runs (beside the base pointers'
    alignment, which the packer's tensors have)."""
    return b > 1 and all(art.l * t.element_size() % 16 == 0
                         for t in (art.m_blk, art.col_blk, art.row_blk))


@pytest.mark.parametrize("kernel", sorted(_RESIDENT_SPREAD))
@pytest.mark.parametrize(
    "case", sorted(c for c, spec in SPREAD_CASES.items() if spec[5] != "over_cap"))
def test_resident_spread_over_ctas(cuda, case, kernel):
    """Kernels 1, 2 (register prefetch), 5 and 7 (the bulk-copy stream
    ring at B > 1 where the leaves' rows are 16-byte runs), the resident
    instances
    of the spread template, spread the stream's blocks over the card's
    CTAs (several blocks to a CTA, window 0 over many CTAs; or one block
    of one chunk to a CTA, fewer chunks than the ring's two stages) and
    fold each window's block tiles in stream order: an empty ragged window
    gives zero rows, and at an odd l, at l=1024, with a block's last chunk
    short, in every value and index type and at B = 1, 3 and 8 the result
    is bitwise equal to the plain version on the CPU (the yardstick), to
    the kernel of the other pipeline on the same artifact, to the kernel
    of the same pipeline and the other layout on its artifact, and to the
    segment-local kernels 3/4 and 6/8."""
    _, c_blk, b, _, _, what = SPREAD_CASES[case]
    layout, pipeline = _RESIDENT_SPREAD[kernel]
    art_gpu, art_cpu, xp, xp_cpu, t_blk, blocks_of = _spread_case(case, layout, cuda)
    l = art_cpu.l
    launch = k_pad.spread_launch_plan(art_gpu.m_blk, art_gpu.col_blk, art_gpu.row_blk, xp,
                                      l=l, c_blk=c_blk, gather="resident", pipeline=pipeline)
    assert launch["stage_tiles"] == 0
    ring = pipeline == "double" and _ring_fits(art_gpu, b)
    assert launch["stream_stages"] == (2 if ring else 0)
    if l in (256, 1024):
        assert launch["stream_stages"] == (2 if pipeline == "double" and b > 1 else 0)
    if what == "odd_l":
        assert launch["stream_stages"] == 0
    if what in ("blocks_per_cta", "l1024"):
        assert launch["grid_x"] < t_blk / 2  # CTAs run several blocks each
    if what == "blocks_per_cta" and layout == "ragged":
        assert blocks_of[0] > 5 * np.median(blocks_of[1:])
        assert blocks_of[0] > 4 * t_blk / launch["grid_x"]  # window 0 spans many CTAs
    if what == "few_chunks":  # one block of one chunk per CTA: fewer chunks than stages
        assert launch["grid_x"] == t_blk and launch["chunk_cycles"] >= c_blk
    if what == "short_chunk":  # a block's last chunk holds fewer cycles than the others
        assert c_blk > launch["chunk_cycles"] and c_blk % launch["chunk_cycles"]
    counter = k_pad if layout == "padded" else k_rag
    attr = "launches" if pipeline == "single" else "db_launches"
    before = getattr(counter, attr)
    y = _run_resident(pipeline, art_gpu, xp)
    torch.cuda.synchronize()
    assert getattr(counter, attr) == before + 1
    if what == "empty_window" and layout == "ragged":
        assert blocks_of[1] == 1 and not bool(y[1].any())
    assert torch.equal(y.cpu(), _run(art_cpu, xp_cpu))
    other = "double" if pipeline == "single" else "single"
    assert torch.equal(y, _run_resident(other, art_gpu, xp))
    art_other = _spread_case(case, "ragged" if layout == "padded" else "padded", cuda)[0]
    assert torch.equal(y, _run_resident(pipeline, art_other, xp))
    assert torch.equal(y, _run_local_single(art_gpu, xp))
    assert torch.equal(y, _run_db(art_gpu, xp, local=True))


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("case", ["c_blk6_b8", "heavy_window_b8_int8_int16"])
def test_stream_ring_follows_the_leaves_alignment(cuda, layout, case):
    """Kernels 5/7 take the bulk-copy ring only where every leaf's base
    pointer is 16-byte aligned: a value leaf moved one element off its
    alignment (the same values, contiguous) turns the ring off in the
    launch plan and in the launch, and the result keeps its bits (the
    plain version on the CPU, and kernel 1/2 on the same artifact)."""
    art_gpu, art_cpu, xp, xp_cpu, _, _ = _spread_case(case, layout, cuda)
    flat = torch.empty(art_gpu.m_blk.numel() + 1, dtype=art_gpu.m_blk.dtype, device=cuda)
    flat[1:].copy_(art_gpu.m_blk.flatten())
    shifted = dataclasses.replace(art_gpu, m_blk=flat[1:].view(art_gpu.m_blk.shape))
    assert shifted.m_blk.is_contiguous() and shifted.m_blk.data_ptr() % 16
    plans = [k_pad.spread_launch_plan(a.m_blk, a.col_blk, a.row_blk, xp, l=a.l, c_blk=a.c_blk,
                                      gather="resident", pipeline="double")
             for a in (art_gpu, shifted)]
    assert [p["stream_stages"] for p in plans] == [2, 0]
    counter = k_pad if layout == "padded" else k_rag
    before = counter.db_launches
    y_ring = _run_db(art_gpu, xp, local=False)
    y_regs = _run_db(shifted, xp, local=False)
    torch.cuda.synchronize()
    assert counter.db_launches == before + 2
    assert torch.equal(y_ring, y_regs)
    assert torch.equal(y_ring, _run(art_gpu, xp))
    assert torch.equal(y_ring.cpu(), _run(art_cpu, xp_cpu))


def _skewed_spgemm(seed, n_out, l=32, b_row=4.0, empty_window=False):
    """A (hub row of 600 entries among rows of ~8: its slots span hundreds of
    cycles; with ``empty_window`` its second window, rows l..2l-1, holds no
    entry) and B (k x n_out, ``b_row`` entries a row on average, some rows
    empty), both with normal f32 values."""
    rng = np.random.default_rng(seed)
    m, k = 3 * l, 800

    def degree(r):
        return 600 if r == 5 else 0 if empty_window and l <= r < 2 * l else 8

    cols = [np.sort(rng.choice(k, size=degree(r), replace=False)) for r in range(m)]
    rows = np.repeat(np.arange(m), [c.size for c in cols])
    a = COOMatrix((m, k), rows.astype(np.int64), np.concatenate(cols).astype(np.int64),
                  rng.standard_normal(rows.size).astype(np.float32))
    bd = ((rng.random((k, n_out)) < min(1.0, b_row / n_out))
          * rng.standard_normal((k, n_out))).astype(np.float32)
    bd[rng.choice(k, size=k // 10, replace=False)] = 0.0  # empty B rows
    bd[0, :] = rng.standard_normal(n_out)  # a full row: every tile of every A row 0 hits
    return a, _coo(bd)


#: case -> (n_out, B's mean entries a row, whether A has an empty window):
#: a slot's entries in a tile take one round of the kernel when few, many
#: rounds when hundreds.
SPGEMM_CARD_CASES = {"skewed": (2100, 4.0, False), "n_out_1": (1, 4.0, False),
                     "n_out_1030": (1030, 4.0, False), "dense_b": (700, 350.0, False),
                     "empty_window": (1030, 4.0, True)}


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("float32", "int16"),
                                     ("bfloat16", "int32"), ("bfloat16", "int16")])
@pytest.mark.parametrize("case", sorted(SPGEMM_CARD_CASES))
def test_spgemm_kernel_bitwise_on_normal_values(cuda, case, layout, vdt, idt):
    """Kernel 9 on normal f32 values, bitwise against its plain version on
    the CPU (which sums each cell in stream order), with B by row offsets
    (built on the card, bitwise as on the CPU) and as planes, its copy of
    A's real slots sized by the stream or by A's nonzeros: a hub row whose
    slots span hundreds of cycles, ``n_out`` of 1 and of no multiple of the
    tile width, empty B rows, B rows of hundreds of entries (several rounds
    a slot) and an empty window (its rows' tiles are zeros)."""
    n_out, b_row, empty_window = SPGEMM_CARD_CASES[case]
    a, b = _skewed_spgemm(len(case), n_out, b_row=b_row, empty_window=empty_window)
    sched = schedule(a, 32, workers=1)
    pack = pack_ragged if layout == "ragged" else pack_schedule
    art_gpu, art_cpu = (pack(sched, 4, vdt, idt, device=d) for d in (cuda, "cpu"))
    assert int(sched.colors_per_window.max()) >= 600  # the hub row's cycles
    want = _run_spgemm(art_cpu, condense_rows(b, 32, device="cpu"), n_out)
    carriers = {"planes": condense_rows(b, 32, device=cuda), "offsets": row_offsets(b, 32,
                                                                                   device=cuda)}
    offs_cpu = row_offsets(b, 32, device="cpu")
    for name in ("ptr", "vals", "cols"):  # the builder on the card: the CPU's bits
        got = getattr(carriers["offsets"], name).cpu()
        assert torch.equal(got, getattr(offs_cpu, name)), name
    if empty_window:  # a window of the stream holds no real slot: its tiles are zeros
        bs_cpu = _stream_view(art_cpu)[2].tolist()
        blocks = art_cpu.m_blk.reshape(-1, 4 * 32)
        empty = [w for w in range(art_cpu.num_windows)
                 if not bool((blocks[bs_cpu[w]:bs_cpu[w + 1]] != 0).any())]
        assert empty and not bool(want[empty].any())
    _, _, bs = _stream_view(art_gpu)
    for real_slots in (None, a.nnz):
        for name, carrier in carriers.items():
            before = k_gemm.launches
            y = k_gemm.gust_spgemm(
                bs, art_gpu.m_blk, art_gpu.col_blk, art_gpu.row_blk, carrier.vals,
                carrier.cols, b_ptr=getattr(carrier, "ptr", None), real_slots=real_slots,
                num_windows=art_gpu.num_windows, l=32, n_out=n_out, c_blk=4)
            torch.cuda.synchronize()
            assert k_gemm.launches == before + 1
            assert torch.equal(y.cpu(), want), (real_slots, name)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_spgemm_kernel_sums_each_row_in_stream_order(cuda, layout):
    """A hub row of 60 entries whose values span ten orders of magnitude,
    over a B whose every row has column 2 (so the hub's cell sums 60 terms,
    where the order of the sum shows in its bits): bitwise the plain
    version on the CPU, which sums in stream order."""
    rng = np.random.default_rng(3)
    rows = np.concatenate([rng.integers(0, 40, 120), np.full(60, 5)])
    cols = np.concatenate([rng.integers(0, 80, 120), rng.choice(80, 60, replace=False)])
    key = np.unique(rows * 80 + cols)
    vals = (rng.standard_normal(key.size) * 10.0 ** rng.integers(-2, 9, key.size)).astype(
        np.float32)
    a = COOMatrix((40, 80), key // 80, key % 80, vals)
    bd = ((rng.random((80, 7)) < 0.3) * rng.standard_normal((80, 7))).astype(np.float32)
    bd[:, 2] = rng.standard_normal(80).astype(np.float32)
    b = _coo(bd)
    pack = pack_ragged if layout == "ragged" else pack_schedule
    sched = schedule(a, 8, workers=1)
    art_gpu, art_cpu = (pack(sched, 4, "float32", "int32", device=d) for d in (cuda, "cpu"))
    want = _run_spgemm(art_cpu, condense_rows(b, 8, device="cpu"), 7)
    offs = row_offsets(b, 8, device=cuda)
    y = k_gemm.gust_spgemm(_stream_view(art_gpu)[2], art_gpu.m_blk, art_gpu.col_blk,
                           art_gpu.row_blk, offs.vals, offs.cols, b_ptr=offs.ptr,
                           real_slots=a.nnz, num_windows=art_gpu.num_windows, l=8, n_out=7,
                           c_blk=4)
    assert torch.equal(y.cpu().view(torch.int32), want.view(torch.int32))


def test_spgemm_real_slots_bounds_the_slot_copy(cuda):
    """``real_slots`` sizes the kernel's copy of A's real slots; slots past
    it are dropped, never written past the copy: at 0 every cell is 0."""
    a, b = _skewed_spgemm(1, 300)
    art = pack_ragged(schedule(a, 32, workers=1), 4, "float32", "int32", device=cuda)
    offs = row_offsets(b, 32, device=cuda)
    call = functools.partial(
        k_gemm.gust_spgemm, _stream_view(art)[2], art.m_blk, art.col_blk, art.row_blk,
        offs.vals, offs.cols, b_ptr=offs.ptr, num_windows=art.num_windows, l=32, n_out=300,
        c_blk=4)
    assert bool(call(real_slots=a.nnz).any())
    assert not bool(call(real_slots=0).any())
    with pytest.raises(ValueError, match="negative"):
        call(real_slots=-1)


def test_spgemm_launch_plan_and_longest_unit(cuda):
    """The row-tile kernel's persistent grid fills every SM, and a call can
    report its longest unit."""
    props = torch.cuda.get_device_properties(cuda)
    p = k_gemm.spgemm_launch_plan(cuda)
    assert p["ctas_per_sm"] >= 1 and p["grid"] == p["ctas_per_sm"] * props.multi_processor_count
    assert p["n_t"] == 1024 and p["smem_bytes"] == p["warps_per_cta"] * p["n_t"] * 4
    a, b = _skewed_spgemm(0, 300)
    art = pack_ragged(schedule(a, 32, workers=1), 4, "float32", "int32", device=cuda)
    offs = row_offsets(b, 32, device=cuda)
    stats = {}
    k_gemm.gust_spgemm(_stream_view(art)[2], art.m_blk, art.col_blk, art.row_blk, offs.vals,
                       offs.cols, b_ptr=offs.ptr, num_windows=art.num_windows, l=32,
                       n_out=300, c_blk=4, stats=stats)
    per_cta = stats["cta_longest_unit_cycles"]
    assert len(per_cta) == k_gemm.spgemm_launch_plan(cuda)["grid"]
    assert stats["longest_unit_cycles"] == max(per_cta) > 0


@pytest.mark.parametrize("idt", ["int32", "int16"])
@pytest.mark.parametrize("b", [1, 3, 4, 8, 17])
def test_gather_fill_16_byte_paths(cuda, idt, b):
    """Kernel 10 on each of its paths (B = 1: 16 bytes of columns a thread;
    B % 4 == 0: 16-byte runs; else rows), at slot counts that are no
    multiple of 4 or 8, from a column view off 16-byte alignment and from
    an x off 16-byte alignment (B % 4 == 0 then takes the rows path):
    bitwise its plain version and ``x[col]``."""
    rng = np.random.default_rng(b)
    n = 500
    flat = torch.from_numpy(rng.standard_normal(n * b + 1).astype(np.float32)).to(cuda)
    aligned = flat[:n * b].view(n, b)
    off = flat[1:].view(n, b)  # 4 bytes past a 16-byte boundary
    assert off.data_ptr() % 16 == 4
    for xp in (aligned, off):
        for rows, l in ((5, 7), (1000, 37), (64, 32)):
            col = torch.from_numpy(rng.integers(0, n, (rows + 1, l))).to(
                getattr(torch, idt)).to(cuda)
            for c in (col[:rows].contiguous(), col[1:]):  # col[1:] is off alignment at odd l
                before = k_fill.launches
                g = k_fill.gather_fill(c, xp)
                torch.cuda.synchronize()
                assert k_fill.launches == before + 1
                assert torch.equal(g, tref.gather_fill_ref(c, xp))
                assert torch.equal(g, xp[c.long()])


@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_int16_plan_refuses_wide_matrix_before_any_launch(cuda, layout):
    """64 x 40000 at int16: the pack raises before a leaf reaches the card."""
    rng = np.random.default_rng(0)
    key = rng.choice(64 * 40000, size=300, replace=False)
    coo = COOMatrix((64, 40000), key // 40000, key % 40000,
                    rng.standard_normal(300).astype(np.float32))
    names = ("launches", "local_launches", "db_launches", "local_db_launches")
    counts = [(mod, name, getattr(mod, name)) for mod in (k_pad, k_rag) for name in names]
    for gather in ("resident", "local"):
        p = plan(coo, PlanConfig(l=256, layout=layout, gather=gather, index_dtype="int16"),
                 device=cuda)
        with pytest.raises(ValueError, match="int32"):
            p.spmv(np.ones(40000, np.float32))
    assert all(getattr(mod, name) == count for mod, name, count in counts)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("transpose_io", [False, True])
def test_spmm_with_no_column_on_card(cuda, layout, transpose_io):
    rng = np.random.default_rng(4)
    d = ((rng.random((20, 30)) < 0.3) * rng.standard_normal((20, 30))).astype(np.float32)
    p = plan(d, PlanConfig(l=8, layout=layout), device=cuda)
    p.artifact  # packed before the counts are read
    before = (k_pad.launches, k_pad.db_launches, k_rag.launches, k_rag.db_launches)
    x = torch.zeros((0, 30) if transpose_io else (30, 0), device=cuda)
    y = p.spmm(x, transpose_io=transpose_io)
    assert tuple(y.shape) == ((0, 20) if transpose_io else (20, 0))
    assert y.device.type == "cuda" and y.dtype == torch.float32
    assert (k_pad.launches, k_pad.db_launches, k_rag.launches, k_rag.db_launches) == before


def _grown(art, seg_extra):
    """``art`` with a longer stream (two more blocks per padded window, five
    more ragged blocks) and its segment table widened by ``seg_extra``."""
    if hasattr(art, "block_starts"):
        grown = art.repad_to_blocks(art.num_blocks + 5)
    else:
        grown = art.repad_to(art.c_pad + 2 * art.c_blk)
    return grown.repad_seg_to(grown.s_blk + seg_extra)


@pytest.mark.parametrize("family", ["single", "local_single", "db", "local_db"])
@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt", ["float32", "int8"])
def test_repadded_and_stacked_artifacts_run_bitwise(cuda, family, layout, vdt):
    """A repadded artifact and each layer's slice of a stack give the
    unpadded artifact's bits through every SpMV kernel; the widened
    segment table repeats segment 0 past its increasing prefix, beyond the
    16 tiles a block stages."""
    cfg = PlanConfig(l=32, c_blk=8, layout=layout, value_dtype=vdt)
    plans = [plan(_dense(s, 300, 900, d), cfg, device=cuda)
             for s, d in ((11, 0.02), (12, 0.05))]
    stacked = GustPlan.stack(plans)
    X = torch.from_numpy(np.random.default_rng(13).standard_normal((900, 8))
                         .astype(np.float32)).to(cuda)
    for i, p in enumerate(plans):
        art = p.artifact
        grown = _grown(art, seg_extra=20)
        assert grown.s_blk > 16 and grown.m_blk.dtype == art.m_blk.dtype
        sl = GustPlan.from_spec({"leaves": {k: v[i] for k, v in stacked["leaves"].items()},
                                 "meta": stacked["meta"]}).artifact
        for b in (1, 8):
            xp = _prep_x(X[:, :b], 900, 32)
            want = _run_family(family, art, xp)
            assert torch.equal(_run_family(family, grown, xp), want)
            assert torch.equal(_run_family(family, sl, xp), want)
            if b == 1:
                cpu = _run_family("single", _to_cpu(art), xp.cpu())
                assert torch.equal(want.cpu(), cpu)


def _to_cpu(art):
    return dataclasses.replace(art, **{
        f.name: getattr(art, f.name).cpu() for f in dataclasses.fields(art)
        if isinstance(getattr(art, f.name), torch.Tensor)})


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("bfloat16", "int16"),
                                     ("int8", "int32")])
def test_store_round_trip_on_card(cuda, tmp_path, layout, vdt, idt):
    coo = _coo(_dense(14, 300, 500, 0.03))
    cfg = PlanConfig(l=32, layout=layout, value_dtype=vdt, index_dtype=idt)
    cold = plan(coo, cfg, cache=None, store=PlanStore(str(tmp_path)), device=cuda)
    cold.artifact
    warm = plan(coo, cfg, cache=None, store=PlanStore(str(tmp_path)), device=cuda)
    assert warm._store_loaded and warm.artifact.m_blk.device.type == cuda.type
    X = np.random.default_rng(15).standard_normal((500, 8)).astype(np.float32)
    for b in (1, 8):
        assert torch.equal(warm.spmm(X[:, :b]), cold.spmm(X[:, :b]))


@pytest.mark.parametrize("vdt", ["float32", "int8"])
def test_reschedule_equals_fresh_plan_on_card(cuda, vdt):
    dense = _dense(16, 400, 600, 0.03)
    edited = dense.copy()
    rng = np.random.default_rng(17)
    for w in (2, 9):  # l=32: rows 64..95 and 288..319
        blk = edited[w * 32:(w + 1) * 32]
        nz = np.argwhere(blk != 0)
        blk[nz[0][0], nz[0][1]] = 0.0
        blk[nz[-1][0], nz[-1][1]] *= 2.0
        blk[rng.integers(32), rng.integers(600)] = 1.5
    cfg = PlanConfig(l=32, layout="ragged", load_balance=False, value_dtype=vdt)
    base = plan(_coo(dense), cfg, cache=None, device=cuda)
    base.artifact
    p = reschedule(base, _coo(edited))
    fresh = plan(_coo(edited), cfg, cache=None, device=cuda)
    assert p.resched.spliced and p.resched.dirty_windows == 2
    assert p.artifact.m_blk.device.type == cuda.type
    for k in ("m_blk", "col_blk", "row_blk", "seg_blk", "col_loc", "block_starts"):
        assert torch.equal(getattr(p.artifact, k), getattr(fresh.artifact, k)), k
    v = np.random.default_rng(18).standard_normal(600).astype(np.float32)
    assert torch.equal(p.spmv(v), fresh.spmv(v))


@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_gust_linear_equals_its_plain_version(cuda, layout):
    w = np.random.default_rng(19).standard_normal((200, 320)).astype(np.float32)
    cfg = PlanConfig(l=64, layout=layout)
    lin = GustLinear(w, config=cfg, density=0.1, cache=None, device=cuda)
    plain = GustLinear(w, config=cfg, density=0.1, cache=None, device="cpu")
    x = torch.from_numpy(np.random.default_rng(20).standard_normal((8, 320))
                         .astype(np.float32))
    y = lin(x.to(cuda))
    assert y.device.type == cuda.type and y.shape == (8, 200)
    assert torch.equal(lin(x[:1].to(cuda)).cpu(), plain(x[:1]))
    for k in range(8):
        assert torch.equal(y[k:k + 1], lin(x[k:k + 1].to(cuda)))
    np.testing.assert_allclose(y.cpu().numpy(), plain(x).numpy(), rtol=1e-5, atol=1e-5)
    assert lin(x[0].to(cuda)).shape == (200,)


@pytest.mark.parametrize("site,gather", [("kernel.execute", "auto"),
                                         ("gather.local", "local")])
def test_execution_fault_reaches_the_caller_on_card(cuda, site, gather):
    p = plan(_dense(21, 200, 300, 0.05), PlanConfig(l=32, gather=gather), device=cuda)
    v = np.ones(300, np.float32)
    want = p.spmv(v)
    names = ("launches", "local_launches", "db_launches", "local_db_launches")
    before = [getattr(mod, n) for mod in (k_pad, k_rag) for n in names]
    resilience.reset_fallback_counters()
    fp = resilience.FaultPlan([resilience.FaultSpec(site)], seed=0)
    with resilience.injected(fp):
        with pytest.raises(resilience.FaultError):
            p.spmv(v)
    assert [getattr(mod, n) for mod in (k_pad, k_rag) for n in names] == before
    if site == "kernel.execute":
        assert fp.fired[0][2] == "cuda"
    cost = p.cost()
    assert (cost.fallback_kernel, cost.fallback_gather, cost.backend) == (0, 0, "cuda")
    assert not any(resilience.fallback_counters.values())
    assert torch.equal(p.spmv(v), want)


@pytest.mark.parametrize("mode", ["dense", "padded", "ragged"])
def test_serve_loop_on_card_equals_the_cpu_path(cuda, mode):
    """yi-6b reduced, float32: the same weights served on the card and on
    the CPU (plain versions) give the same greedy streams; on the card
    every GUST product of every decode step launches kernel 5 (padded) or
    7 (ragged), and a request served alone equals its stream in the mixed
    run bitwise."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.tree import tree_map
    from repro_torch.serving import GustServeConfig, ServeConfig, ServeLoop

    lm = build_model(get_arch("yi_6b").reduced())
    p_cpu = lm.init(torch.Generator().manual_seed(0), device="cpu")
    p_card = tree_map(lambda t: t.to(cuda), p_cpu)
    gcfg = None if mode == "dense" else GustServeConfig(
        density=0.5, gust_length=16, ragged=mode == "ragged")
    sc = ServeConfig(batch=2, seq_len=64, dtype="float32", gust=gcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, lm.cfg.vocab, n).astype(np.int32) for n in (5, 11, 7)]
    counter = (k_rag, "db_launches") if mode == "ragged" else (k_pad, "db_launches")
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_card)):
        loop = ServeLoop(lm, params, sc)
        before = getattr(*counter)
        rids = [loop.enqueue(x, max_new=6) for x in prompts]
        loop.run_to_completion()
        out[dev] = [loop.completed[r] for r in rids]
        launched = getattr(*counter) - before
    assert out["cuda"] == out["cpu"]
    if gcfg is not None:
        assert launched == 3 * lm.stack.reps * loop.stats["decode_steps"]
    solo = ServeLoop(lm, p_card, sc)
    rid = solo.submit(prompts[1], max_new=6)
    solo.run_to_completion()
    assert solo.completed[rid] == out["cuda"][1]


def test_temperature_sampling_on_card_is_keyed(cuda):
    """The Gumbel-max sampler draws from card generators keyed by (seed,
    request, token): the same seed gives the same draws, a request's draw
    does not depend on its row, and a dominant logit wins."""
    from repro_torch.serving import make_sampler

    sampler = make_sampler(0.8)
    logits = torch.randn(3, 1000, generator=torch.Generator().manual_seed(0)).to(cuda)
    keys = [(5, 0), (6, 3), (7, 9)]
    first = sampler(logits, 11, keys)
    assert first.device.type == "cuda" and first.dtype == torch.int32
    assert torch.equal(first, sampler(logits, 11, keys))
    alone = sampler(logits[1:2], 11, keys[1:2])
    assert int(alone[0]) == int(first[1])
    big = torch.tensor([[1000.0, 0.0, -500.0]], device=cuda)
    assert sampler(big, 0, [(0, 0)]).tolist() == [0]


def _family_model(arch, cuda, **overrides):
    """(LM, its params on the CPU, the same params on the card) for
    ``arch``'s reduced config, drawn from a seeded CPU generator."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.tree import tree_map

    lm = build_model(dataclasses.replace(get_arch(arch).reduced(), **overrides))
    p_cpu = lm.init(torch.Generator().manual_seed(0), device="cpu")
    return lm, p_cpu, tree_map(lambda t: t.to(cuda), p_cpu)


def _decode_steps(lm, params, dev, steps=3):
    """Prefill 8 tokens on 4 rows, then ``steps`` decode steps at per-row
    positions; the logits of every step, on the host."""
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, lm.cfg.vocab, (4, 8 + steps)).astype(np.int32))
    caches = lm.init_caches(4, 32, torch.float32, device=dev)
    _, caches = lm.prefill(params, {"tokens": toks[:, :8].to(dev)}, caches,
                           dtype=torch.float32)
    out = []
    for s in range(steps):
        logits, caches = lm.decode_step(params, caches, toks[:, 8 + s:9 + s].to(dev),
                                        torch.full((4,), 8 + s, device=dev),
                                        dtype=torch.float32)
        out.append(logits.cpu())
    return torch.stack(out)


def _close_to_cpu(got, want, tol=1e-4):
    """Card vs CPU float32 (products summed in another order): within
    ``tol`` of the largest |value|."""
    err = float((got - want).abs().max())
    assert np.isfinite(err) and err <= tol * float(want.abs().max()), err


def test_moe_combine_is_deterministic_on_card(cuda):
    """Reduced dbrx (top-2 of 4 experts): ``moe_ffn`` and the decode
    steps run twice on the card give the same bits (the combine adds each
    token's rows in slot order, with no atomics), and agree with the CPU."""
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.tree import tree_map

    lm, p_cpu, p_card = _family_model("dbrx_132b", cuda)
    spec = lm.stack.pattern[0].moe
    assert spec.top_k == 2
    moe_cpu = tree_map(lambda a: a[0], p_cpu["stack"]["reps"][0]["moe"])
    moe_card = tree_map(lambda a: a.to(cuda), moe_cpu)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 24, lm.cfg.d_model)).astype(np.float32))
    y1, a1 = moe_ffn(moe_card, x.to(cuda), spec)
    y2, a2 = moe_ffn(moe_card, x.to(cuda), spec)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    y, a = moe_ffn(moe_cpu, x, spec)
    _close_to_cpu(y1.cpu(), y)
    _close_to_cpu(a1.cpu()[None], a[None])
    first = _decode_steps(lm, p_card, cuda)
    assert torch.equal(first, _decode_steps(lm, p_card, cuda))
    _close_to_cpu(first, _decode_steps(lm, p_cpu, "cpu"))


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_125m",
                                  "llama4_scout_17b_a16e"])
def test_family_decode_on_card_equals_the_cpu_path(cuda, arch):
    """Prefill and three decode steps of reduced recurrentgemma (RG-LRU),
    xlstm (mLSTM, sLSTM) and llama4 (MoE top-1) on the card agree with
    the CPU's plain path."""
    lm, p_cpu, p_card = _family_model(arch, cuda)
    _close_to_cpu(_decode_steps(lm, p_card, cuda), _decode_steps(lm, p_cpu, "cpu"))


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "dbrx_132b",
                                  "recurrentgemma_9b", "xlstm_125m"])
def test_failed_decode_step_on_card_is_retried_to_the_same_bits(cuda, arch, monkeypatch):
    """A decode step that fails in the middle of the stack on the card
    (after earlier layers wrote K/V in place and returned new recurrent
    states) is retried by ``ServeLoop`` to the bits of a run with no
    failure."""
    import repro_torch.models.transformer as T
    from repro_torch.serving import ServeConfig, ServeLoop

    lm, _, p_card = _family_model(arch, cuda)
    sc = ServeConfig(batch=4, seq_len=64, dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, lm.cfg.vocab, n).astype(np.int32) for n in (5, 9, 7)]

    def serve(loop):
        rids = [loop.enqueue(x, max_new=6) for x in prompts]
        loop.run_to_completion()
        return [loop.completed[r] for r in rids]

    clean = serve(ServeLoop(lm, p_card, sc))
    n, calls, block_decode = lm.stack.n_layers, [], T.block_decode

    def failing(params, x, bc, cache, pos):
        out = block_decode(params, x, bc, cache, pos)
        calls.append(1)
        if len(calls) == 2 * n + n // 2 + 1:
            raise RuntimeError("injected failure in the middle of the stack")
        return out

    monkeypatch.setattr(T, "block_decode", failing)
    loop = ServeLoop(lm, p_card, sc)
    assert serve(loop) == clean
    assert loop.stats["decode_retries"] == 1


def _encdec_run(lm, params, dev, frames, toks, steps=3):
    """Forward logits, then a prefill of 8 tokens and ``steps`` decode
    steps, of the encoder-decoder model; every logit on the host."""
    batch = {"src_frames": frames.to(dev), "tokens": toks.to(dev)}
    full, _ = lm.train_logits(params, batch, dtype=torch.float32)
    caches = lm.init_caches(toks.shape[0], 32, torch.float32, device=dev)
    first, caches = lm.prefill(params, {"src_frames": frames.to(dev),
                                        "tokens": toks[:, :8].to(dev)}, caches,
                               dtype=torch.float32)
    out = [first.cpu()]
    for s in range(steps):
        logits, caches = lm.decode_step(params, caches, toks[:, 8 + s:9 + s].to(dev),
                                        8 + s, dtype=torch.float32)
        out.append(logits.cpu())
    return full.cpu(), torch.cat(out, dim=1)


@pytest.mark.parametrize("block", [64, 4], ids=["direct", "blocked"])
def test_encdec_on_card_equals_the_cpu_path(cuda, block):
    """Reduced seamless (2 encoder + 2 decoder layers, 16 source frames):
    the forward, the prefill and three decode steps on the card agree with
    the CPU's plain path; at block 4 every attention takes the online
    softmax.  Decode after the prefill equals the forward on the card."""
    lm, p_cpu, p_card = _family_model("seamless_m4t_medium", cuda, attn_block_size=block)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((3, lm.cfg.enc_seq, lm.cfg.d_model))
                              .astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, lm.cfg.vocab, (3, 11)).astype(np.int32))
    full, steps = _encdec_run(lm, p_card, cuda, frames, toks)
    full_cpu, steps_cpu = _encdec_run(lm, p_cpu, "cpu", frames, toks)
    _close_to_cpu(full, full_cpu)
    _close_to_cpu(steps, steps_cpu)
    _close_to_cpu(steps[:, 1:], full[:, 8:11], tol=2e-4)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("bfloat16", "int32"),
                                     ("int8", "int32"), ("float32", "int16"),
                                     ("bfloat16", "int16"), ("int8", "int16")])
def test_verify_card_artifacts_have_no_finding(cuda, layout, vdt, idt):
    """The artifact verifier on artifacts whose leaves live on the card
    (copied to the host once per call): no finding, as on the CPU copy;
    a seeded collision on a copy fires exactly GUST-P14."""
    from repro_torch.analysis.verify import verify

    rng = np.random.default_rng(1)
    d = ((rng.random((300, 260)) < 0.05) * rng.standard_normal((300, 260))).astype(np.float32)
    cfg = PlanConfig(l=32, layout=layout, value_dtype=vdt, index_dtype=idt)
    p = plan(d, cfg, cache=None, device=cuda)
    assert p.artifact.m_blk.device.type == "cuda"
    assert p.verify() == [] and verify(p.to_spec()["leaves"], p.to_spec()["meta"]) == []
    art = p.artifact
    real = (art.m_blk != 0)
    r = int(torch.nonzero(real.sum(dim=1) >= 2)[0, 0])
    j1, j2 = (int(j) for j in torch.nonzero(real[r])[:2, 0])
    row = art.row_blk.clone()
    row[r, j2] = row[r, j1]
    assert {f.rule for f in verify(dataclasses.replace(art, row_blk=row))} == {"GUST-P14"}


def test_ring_audit_has_no_finding(cuda):
    """GUST-H07 over the sources the card built from: every asynchronous
    copy of the spread template waited on before it is read."""
    from repro_torch.analysis.kernel_audit import audit_rings

    result = audit_rings()
    assert result.findings == [], result.report()
    assert "4 instances" in result.checked["gust_spread.cuh"]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_on_card_matches_cpu(cuda, bias, dtype):
    """``layers.linear`` on the card against the same call on the CPU:
    float32 products (TF32 off) within 1e-5 of the largest output, and at
    bf16 one bf16 spacing of each output more."""
    from repro_torch.models.layers import init_linear, linear

    p = init_linear(torch.Generator(device=cuda).manual_seed(0), 256, 192, bias=bias)
    assert all(v.device.type == "cuda" for v in p.values())
    if bias:
        p["b"] = torch.randn(192, generator=torch.Generator(device=cuda).manual_seed(1),
                             device=cuda)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 7, 256))
                         .astype(np.float32)).to(dtype)
    want = linear({k: v.cpu() for k, v in p.items()}, x).float()
    got = linear(p, x.to(cuda))
    assert got.dtype == dtype and got.device.type == "cuda"
    tol = 1e-5 * want.abs().max()
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.abs()
    assert torch.all((got.float().cpu() - want).abs() <= tol)


def test_resource_audit_has_no_finding(cuda):
    """Every library's ptxas report and the launch plans of every spread
    library (each value type, int16 indices, B = 1 and 8) and of the
    SpGEMM kernel: no ``GUST-Hxx`` finding."""
    from repro_torch.analysis.kernel_audit import audit_kernels, default_plans

    result = audit_kernels(plans=default_plans(cuda))
    assert result.findings == [], result.report()
    assert {r.library for r in result.reports} == set(k_pad._SPREAD_LIBS.values()) | {
        "gust_spgemm", "gather_fill"}
    assert len(result.plans) == 4 * 2 * 4 + 1


def _train_setup(dev, seed=0, arch="yi_6b"):
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.training import AdamWConfig, TrainConfig, init_train_state

    lm = build_model(get_arch(arch).reduced())
    tc = TrainConfig(opt=AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=100),
                     dtype="float32")
    return lm, tc, init_train_state(lm, torch.Generator().manual_seed(seed), tc, device=dev)


def _train_batches(lm, n, dev, start=0):
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

    pipe = TokenPipeline(PipelineConfig(vocab_size=lm.cfg.vocab, seq_len=16, global_batch=8))
    return [{k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(start + i).items()}
            for i in range(n)]


def test_train_step_on_card_equals_the_cpu_path(cuda):
    """One reduced yi-6b train step from the same state on the card and on
    the CPU, held by ``chip_smoke.step_agreement``: loss and gradient norm
    within 1e-5 relative, m within 1e-5 of each leaf's largest, every
    parameter within the reference's accumulation tolerance plus what the
    first AdamW step's ``1 / eps`` slope makes of the gradients'
    difference."""
    import chip_smoke
    from repro_torch.models.tree import tree_map
    from repro_torch.training import make_train_step

    lm, tc, host = _train_setup("cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    batch = _train_batches(lm, 1, "cpu")[0]
    step = make_train_step(lm, tc)
    host, mh = step(host, batch)
    card, mc = step(card, {k: v.to(cuda) for k, v in batch.items()})
    assert card["params"]["embed"]["table"].device.type == "cuda"
    chip_smoke.step_agreement(host, card, mh, mc, float(mc["lr"]), tc.opt.eps, tc.opt.b1,
                              "reduced yi-6b")


@pytest.fixture
def deterministic(monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("arch", ["yi_6b", "xlstm_125m", "llama4_scout_17b_a16e"])
def test_train_resume_on_card_is_bitwise(cuda, deterministic, tmp_path, arch):
    """Under deterministic algorithms: two steps, a checkpoint, two more;
    restored from the checkpoint (on the card, and through the CPU), the
    last two steps give the same losses and state bit for bit.  The
    checkpoint restores on the CPU bit for bit too."""
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.training import make_train_step, restore_checkpoint, save_checkpoint

    lm, tc, state = _train_setup(cuda, arch=arch)
    step = make_train_step(lm, tc)
    batches = _train_batches(lm, 4, cuda)
    losses = []
    for i, b in enumerate(batches):
        state, m = step(state, b)
        losses.append(m["loss"])
        if i == 1:
            save_checkpoint(str(tmp_path), 2, state)
            saved = [t.cpu() for t in tree_leaves(state)]
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    on_cpu, _ = restore_checkpoint(str(tmp_path), 2, like, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(saved, tree_leaves(on_cpu)))
    save_checkpoint(str(tmp_path / "from_cpu"), 2, on_cpu)
    for resumed in (restore_checkpoint(str(tmp_path), 2, like, device=cuda)[0],
                    restore_checkpoint(str(tmp_path / "from_cpu"), 2, like, device=cuda)[0]):
        again = []
        for b in batches[2:]:
            resumed, m = step(resumed, b)
            again.append(m["loss"])
        assert all(torch.equal(a, b) for a, b in zip(losses[2:], again))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state), tree_leaves(resumed)))


def test_training_on_a_card_that_does_not_exist_raises(cuda):
    from repro_torch.launch.train import run_training

    with pytest.raises(RuntimeError, match="CUDA device"):
        run_training("yi_6b", steps=1, device=f"cuda:{torch.cuda.device_count()}")


# -- the multi-device layer on one card ---------------------------------------


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL process group (file rendezvous, 60 s timeout) and its
    1-D ``data`` mesh; the group is destroyed after the test."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


SHARD_CFGS = {"resident-single": dict(gather="resident", pipeline="single"),
              "resident-double": dict(gather="resident", pipeline="double"),
              "local-single": dict(load_balance=False, gather="local", pipeline="single"),
              "local-double": dict(load_balance=False, gather="local", pipeline="double")}


def _shard_plan(dev, name, vdt="float32"):
    dense = _dense(11, 700, 500, 0.03)
    cfg = PlanConfig(l=32, c_blk=8, layout="ragged", value_dtype=vdt, **SHARD_CFGS[name])
    v = torch.from_numpy(np.random.default_rng(12).standard_normal(500).astype(np.float32))
    return plan(dense, cfg, cache=None, device=dev), v.to(dev)


@pytest.mark.parametrize("name", list(SHARD_CFGS))
def test_sharded_plan_under_one_rank_nccl_group_is_bitwise(cuda, nccl_mesh, name):
    """``plan.shard(mesh).spmv`` (its rank's artifact through kernel 2, 7, 4
    or 8, the all-gather over NCCL) equals the unsharded plan's kernel
    result bitwise."""
    p, v = _shard_plan(cuda, name)
    assert torch.equal(p.shard(nccl_mesh).spmv(v), p.spmv(v))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("vdt", ["float32", "int8"])
@pytest.mark.parametrize("name", list(SHARD_CFGS))
def test_emulated_ranks_reassemble_bitwise(cuda, name, vdt, k):
    """Each of k ranks' artifacts, verified and run one after another on the
    card (``chip_smoke.emulated_ranks``), reassembles to the unsharded
    plan's kernel result bitwise."""
    import chip_smoke
    from repro_torch.analysis.verify import verify

    p, v = _shard_plan(cuda, name, vdt)
    y, arts, lay = chip_smoke.emulated_ranks(p, v, k)
    assert all(verify(a) == [] for a in arts if a is not None)
    assert sum(a.num_blocks for a in arts if a is not None) == p.artifact.num_blocks
    assert torch.equal(y, p.spmv(v))


def test_data_parallel_step_at_world_one_is_bitwise(cuda, nccl_mesh, deterministic):
    """A reduced yi-6b step through ``make_train_step(lm, tc, mesh)`` on a
    one-rank NCCL group (the DP batch split, the masked-sum loss, the
    gradient ring, the collectives on the card) equals the plain step bit
    for bit, with and without compression."""
    import dataclasses

    from repro_torch.models.tree import tree_leaves
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.compression import CompressionConfig

    lm, tc, _ = _train_setup(cuda)
    batch = _train_batches(lm, 1, cuda)[0]
    for comp in (CompressionConfig(), CompressionConfig(enable=True)):
        tcc = dataclasses.replace(tc, compression=comp, microbatches=2)
        state = init_train_state(lm, torch.Generator().manual_seed(0), tcc, device=cuda)
        plain, mp = make_train_step(lm, tcc)(state, batch)
        dp, md = make_train_step(lm, tcc, nccl_mesh)(state, batch)
        assert torch.equal(mp["loss"], md["loss"])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(plain), tree_leaves(dp)))


@pytest.mark.parametrize("arch", ["yi_6b", "llama4_scout_17b_a16e", "xlstm_125m"])
def test_sharded_step_at_world_one_is_bitwise(cuda, nccl_mesh, deterministic, arch):
    """A reduced model's state cut by ``shard_train_state`` over a (1, 1)
    ``("data", "model")`` mesh of the one-rank NCCL group (every leaf its
    own shard: no axis has two ranks), stepped by ``make_train_step(lm,
    tc, mesh)`` (the placement read by every block, the clip's norm over
    the shards, the sums of the sharded step, with and without
    compression), equals the whole state's plain step bit for bit, and
    gathers back to it."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.tree import tree_leaves
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.compression import CompressionConfig
    from repro_torch.training.train_loop import gather_train_state, shard_train_state

    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    lm, tc, _ = _train_setup(cuda, arch=arch)
    batch = _train_batches(lm, 1, cuda)[0]
    for comp in (CompressionConfig(), CompressionConfig(enable=True)):
        tcc = dataclasses.replace(tc, compression=comp, microbatches=2)
        state = init_train_state(lm, torch.Generator().manual_seed(0), tcc, device=cuda)
        plain, mp = make_train_step(lm, tcc)(state, batch)
        sharded, ms = make_train_step(lm, tcc, mesh)(shard_train_state(state, mesh), batch)
        assert type(sharded).__name__ == "ShardedTrainState"
        assert torch.equal(mp["loss"], ms["loss"])
        assert torch.equal(mp["grad_norm"], ms["grad_norm"])
        whole = gather_train_state(sharded)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(plain), tree_leaves(whole)))


@pytest.mark.parametrize("mode", ["dense", "gust"])
def test_sharded_decode_at_world_one_is_bitwise(cuda, nccl_mesh, mode):
    """Reduced yi-6b's parameters and fresh caches sharded by
    ``init_serve_state`` over a (1, 1) ``("data", "model")`` mesh of the
    one-rank NCCL group (every leaf its own shard), then a prefill and three decode steps with
    ``place=`` (``LM.decode_step``, or ``decode_step_gust`` through kernel
    5 on card plans), equal the whole decode bit for bit: logits and
    caches."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.tree import tree_leaves
    from repro_torch.serving import (GustServeConfig, decode_step_gust, gather_serve_state,
                                     gustify, init_serve_state)

    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    lm = build_model(get_arch("yi_6b").reduced())
    params = lm.init(torch.Generator().manual_seed(0), device=cuda)
    gust = gustify(lm, params, GustServeConfig(density=0.5, gust_length=16)) \
        if mode == "gust" else None
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, lm.cfg.vocab, (2, 9)).astype(np.int32)).to(cuda)
    toks = torch.from_numpy(rng.integers(0, lm.cfg.vocab, (3, 2, 1)).astype(np.int32)).to(cuda)

    def run(p, caches, place):
        out, caches = lm.prefill(p, {"tokens": prompt}, caches, dtype=torch.float32,
                                 place=place)
        outs = [out]
        for t in range(3):
            if gust is None:
                lg, caches = lm.decode_step(p, caches, toks[t], 9 + t, dtype=torch.float32,
                                            place=place)
            else:
                lg, caches = decode_step_gust(lm, p, gust, caches, toks[t], 9 + t,
                                              dtype=torch.float32, place=place)
            outs.append(lg)
        return outs, caches

    caches = lm.init_caches(2, 24, torch.float32, device=cuda)
    want, want_caches = run(params, caches, None)
    state = init_serve_state(lm, params, mesh, 2, 24, torch.float32)
    got, state.caches = run(state.params, state.caches, state.place)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _, whole = gather_serve_state(state)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(whole), tree_leaves(want_caches)))
