"""Port parity of the SpMV kernels' plain versions and wrappers on the CPU.

* ``repro_torch.kernels.ref`` against ``repro.kernels.ref`` on one
  artifact (the reference's leaves carried across): within
  ``rtol=1e-5, atol=1e-6`` on normal f32 inputs, since the port sums
  within each block before adding into the window and the reference
  scatters every product straight into the window; bitwise on
  small-integer inputs, where every order gives the same sum.
* One tiny geometry against the Pallas kernels themselves
  (``make_gust_spmv``, ``make_gust_spmv_ragged``), run as the
  reference's own tests run them here, in interpret mode.
* The wrappers take the plain path for CPU tensors and launch nothing;
  padded and ragged streams agree bitwise; padding slots that share row
  0 with a real slot in one cycle add nothing.

The CUDA kernels themselves are held against these plain versions by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core.packing as RP
import repro.kernels.ref as jref
from repro.core.formats import COOMatrix as RefCOO
from repro.core.scheduler import schedule as ref_schedule
from repro.kernels.gust_spmv import make_gust_spmv
from repro.kernels.gust_spmv_ragged import make_gust_spmv_ragged

import repro_torch.kernels.gust_spmv as k_pad
import repro_torch.kernels.gust_spmv_ragged as k_rag
import repro_torch.kernels.ref as tref
from repro_torch.core.convert import from_reference_leaves
from repro_torch.kernels.ops import _prep_x, execute_spmm

torch.set_num_threads(1)  # the suite runs several test processes at once


def _dense(rng, m, n, density, integers=False):
    mask = rng.random((m, n)) < density
    vals = rng.integers(-3, 4, (m, n)) if integers else rng.standard_normal((m, n))
    return (mask * vals).astype(np.float32)


def _coo(dense):
    r, c = np.nonzero(dense)
    return RefCOO(dense.shape, r.astype(np.int64), c.astype(np.int64), dense[r, c])


def _artifacts(dense, l, c_blk, layout, vdt="float32", idt="int32",
               load_balance=True):
    """The reference's artifact and the same artifact carried into the port."""
    sched = ref_schedule(_coo(dense), l, load_balance=load_balance)
    if layout == "ragged":
        art = RP.pack_ragged(sched, c_blk, value_dtype=jnp.dtype(vdt),
                             index_dtype=jnp.dtype(idt))
        leaves, meta = RP.ragged_leaves(art), RP.ragged_meta(art)
    else:
        art = RP.pack_schedule(sched, c_blk, value_dtype=jnp.dtype(vdt),
                               index_dtype=jnp.dtype(idt))
        leaves, meta = RP.packed_leaves(art), RP.packed_meta(art)
    port = from_reference_leaves(
        {k: np.asarray(v) for k, v in leaves.items()}, meta, device="cpu"
    )
    return art, port


def _run_ref(art, xp):
    kw = {"scale_blk": art.scale_blk} if art.scale_blk is not None else {}
    if isinstance(art, RP.RaggedSchedule):
        return np.asarray(jref.gust_spmv_ragged_ref(
            art.m_blk, art.col_blk, art.row_blk, art.block_window, jnp.asarray(xp),
            num_windows=art.num_windows, l=art.l, c_blk=art.c_blk, **kw))
    return np.asarray(jref.gust_spmv_ref(
        art.m_blk, art.col_blk, art.row_blk, jnp.asarray(xp),
        num_windows=art.num_windows, l=art.l, c_blk=art.c_blk, **kw))


def _run_port(p, xp):
    xp = torch.from_numpy(xp)
    if p.__class__.__name__ == "RaggedSchedule":
        return tref.gust_spmv_ragged_ref(
            p.m_blk, p.col_blk, p.row_blk, p.block_window, xp,
            num_windows=p.num_windows, l=p.l, c_blk=p.c_blk, scale_blk=p.scale_blk,
        ).numpy()
    return tref.gust_spmv_ref(
        p.m_blk, p.col_blk, p.row_blk, xp, num_windows=p.num_windows, l=p.l,
        c_blk=p.c_blk, scale_blk=p.scale_blk,
    ).numpy()


def _xp(rng, n, l, b, integers=False):
    seg = -(-n // l)
    x = np.zeros((seg * l, b), np.float32)
    x[:n] = rng.integers(-3, 4, (n, b)) if integers else rng.standard_normal((n, b))
    return x


CASES = [  # (m, n, l, c_blk, b, density)
    (64, 80, 16, 8, 1, 0.1),
    (100, 130, 32, 4, 3, 0.05),
    (33, 7, 8, 3, 2, 0.5),  # n < l: padding gathers beyond n
    (96, 96, 12, 16, 9, 0.12),  # l not a power of two
]


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("bfloat16", "int16"),
                                     ("int8", "int32")])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_matches_reference_oracle(layout, vdt, idt, case):
    m, n, l, c_blk, b, density = CASES[case]
    rng = np.random.default_rng(case)
    art, port = _artifacts(_dense(rng, m, n, density), l, c_blk, layout, vdt, idt)
    xp = _xp(rng, n, l, b)
    np.testing.assert_allclose(_run_port(port, xp), _run_ref(art, xp),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_bitwise_on_small_integers(layout, case):
    m, n, l, c_blk, b, density = CASES[case]
    rng = np.random.default_rng(100 + case)
    art, port = _artifacts(_dense(rng, m, n, density, integers=True), l, c_blk, layout)
    xp = _xp(rng, n, l, b, integers=True)
    assert np.array_equal(_run_port(port, xp), _run_ref(art, xp))


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt", ["float32", "int8"])
def test_plain_matches_pallas_kernels(layout, vdt):
    """Kernels #1 and #2 of the TPU table, interpreted on the CPU."""
    rng = np.random.default_rng(7)
    m, n, l, c_blk, b = 24, 20, 8, 4, 2
    art, port = _artifacts(_dense(rng, m, n, 0.3), l, c_blk, layout, vdt)
    xp = _xp(rng, n, l, b)
    xs = jnp.asarray(xp.reshape(-1, l, b))
    quant = art.scale_blk is not None
    scale = (jnp.asarray(art.scale_blk).reshape(-1, 1),) if quant else ()
    if layout == "ragged":
        fn = make_gust_spmv_ragged(art.num_blocks, art.num_windows, l, art.seg_count,
                                   b, c_blk=c_blk, interpret=True, quantized=quant)
        y = fn(art.block_window, art.block_starts, art.m_blk, art.col_blk,
               art.row_blk, *scale, xs)
    else:
        fn = make_gust_spmv(art.num_windows, art.c_pad, l, art.seg_count, b,
                            c_blk=c_blk, interpret=True, quantized=quant)
        y = fn(art.m_blk, art.col_blk, art.row_blk, *scale, xs)
    np.testing.assert_allclose(_run_port(port, xp), np.asarray(y),
                               rtol=1e-5, atol=1e-5)


def row0_collision_matrix():
    """l=4, no balancing: window 0 holds one real slot, on row 0 (lane 1),
    while window 1 is heavy, so window 0's blocks are mostly padding —
    padding slots (value 0, row 0) share a cycle with the real row-0 slot."""
    dense = np.zeros((8, 8), np.float32)
    dense[0, 1] = 3.0
    dense[4:8, :] = np.arange(1, 33, dtype=np.float32).reshape(4, 8)
    return dense


def test_row0_padding_collision_adds_nothing():
    dense = row0_collision_matrix()
    x = np.arange(1, 9, dtype=np.float32)[:, None] - 4.0
    for layout in ("padded", "ragged"):
        _, port = _artifacts(dense, 4, 4, layout, load_balance=False)
        m0, r0 = port.m_blk[0], port.row_blk[0]  # window 0, cycle 0
        assert (m0 != 0).sum() == 1 and (r0 == 0).all()  # the collision exists
        y = execute_spmm(port, torch.from_numpy(x), gather="resident")
        assert np.array_equal(y.numpy(), dense @ x)


@pytest.mark.parametrize("vdt", ["float32", "int8"])
def test_padded_equals_ragged_bitwise(vdt):
    rng = np.random.default_rng(31)
    dense = _dense(rng, 128, 90, 0.04)
    dense[5] = rng.standard_normal(90)  # one heavy row: long window, much padding
    x = torch.from_numpy(rng.standard_normal((90, 4)).astype(np.float32))
    ys = []
    for layout in ("padded", "ragged"):
        _, port = _artifacts(dense, 16, 8, layout, vdt)
        ys.append(execute_spmm(port, x, gather="resident"))
    assert torch.equal(ys[0], ys[1])


def test_wrappers_take_the_plain_path_on_cpu():
    rng = np.random.default_rng(5)
    dense = _dense(rng, 40, 40, 0.1)
    xp = torch.from_numpy(_xp(rng, 40, 8, 2))
    _, pad = _artifacts(dense, 8, 4, "padded")
    _, rag = _artifacts(dense, 8, 4, "ragged")
    before = (k_pad.launches, k_rag.launches)
    y1 = k_pad.gust_spmv(pad.m_blk, pad.col_blk, pad.row_blk, xp,
                         num_windows=pad.num_windows, l=8, c_blk=4)
    y2 = k_rag.gust_spmv_ragged(rag.m_blk, rag.col_blk, rag.row_blk,
                                rag.block_window, rag.block_starts, xp,
                                num_windows=rag.num_windows, l=8, c_blk=4)
    assert (k_pad.launches, k_rag.launches) == before
    assert torch.equal(y1, tref.gust_spmv_ref(
        pad.m_blk, pad.col_blk, pad.row_blk, xp, num_windows=pad.num_windows,
        l=8, c_blk=4))
    assert torch.equal(y1, y2)
    with pytest.raises(ValueError, match="do not split into"):
        k_pad.gust_spmv(pad.m_blk, pad.col_blk, pad.row_blk, xp,
                        num_windows=pad.num_windows, l=8, c_blk=pad.c_pad + 1)


def test_dequant_and_gather_match_reference():
    rng = np.random.default_rng(2)
    q = rng.integers(-127, 128, (24, 8)).astype(np.int8)
    scale = (rng.random(6) + 0.01).astype(np.float32)
    got = tref.dequant_ref(torch.from_numpy(q), torch.from_numpy(scale), c_blk=4)
    want = jref.dequant_ref(jnp.asarray(q), jnp.asarray(scale), c_blk=4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    col = rng.integers(0, 40, (24, 8)).astype(np.int32)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    assert np.array_equal(
        tref.gather_fill_ref(torch.from_numpy(col), torch.from_numpy(x)).numpy(),
        np.asarray(jref.gather_fill_ref(jnp.asarray(col), jnp.asarray(x))),
    )
    assert _prep_x(torch.ones(5, 2), 5, 4).shape == (8, 2)
