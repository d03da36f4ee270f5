"""Port parity of the segment-local and double-buffered paths on the CPU.

* The segment-local plain versions (``*_local_ref``) against the
  reference's (``repro.kernels.ref``) on one artifact (the reference's
  leaves carried across): within ``rtol=1e-5, atol=1e-6`` on normal f32
  inputs (the port sums within each block before adding into the
  window), bitwise on small-integer inputs; resident and local agree
  bitwise inside the port.
* Kernels 5-8 of the TPU table (the double-buffered resident and
  segment-local Pallas kernels), reached through the reference's
  executor in interpret mode, as the reference's own tests run them
  here, on ``fusable`` artifacts (else the reference would quietly take
  its jnp path), against the port's CPU path with the same knobs.

The CUDA kernels are held against these plain versions by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core.packing as RP
import repro.kernels.ops as rops
import repro.kernels.ref as jref

import repro_torch.kernels.ref as tref
from repro_torch.kernels.ops import execute_spmm

from test_torch_spmv import CASES, _artifacts, _dense, _run_port, _xp

torch.set_num_threads(1)  # the suite runs several test processes at once


def _run_ref_local(art, xp):
    kw = {"scale_blk": art.scale_blk} if art.scale_blk is not None else {}
    if isinstance(art, RP.RaggedSchedule):
        return np.asarray(jref.gust_spmv_ragged_local_ref(
            art.m_blk, art.col_loc, art.row_blk, art.seg_blk, art.block_window,
            jnp.asarray(xp), num_windows=art.num_windows, l=art.l, c_blk=art.c_blk,
            **kw))
    return np.asarray(jref.gust_spmv_local_ref(
        art.m_blk, art.col_loc, art.row_blk, art.seg_blk, jnp.asarray(xp),
        num_windows=art.num_windows, l=art.l, c_blk=art.c_blk, **kw))


def _run_port_local(p, xp):
    xp = torch.from_numpy(xp)
    kw = dict(num_windows=p.num_windows, l=p.l, c_blk=p.c_blk, scale_blk=p.scale_blk)
    if p.__class__.__name__ == "RaggedSchedule":
        return tref.gust_spmv_ragged_local_ref(
            p.m_blk, p.col_loc, p.row_blk, p.seg_blk, p.block_window, xp, **kw
        ).numpy()
    return tref.gust_spmv_local_ref(
        p.m_blk, p.col_loc, p.row_blk, p.seg_blk, xp, **kw).numpy()


VALUE_INDEX = [("float32", "int32"), ("bfloat16", "int16"), ("int8", "int16")]


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", VALUE_INDEX)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_local_plain_matches_reference_oracle(layout, vdt, idt, case):
    """``gust_spmv_local_ref`` / ``gust_spmv_ragged_local_ref`` against the
    reference's: ``rtol=1e-5, atol=1e-6`` (the port sums within each block
    first), and bitwise equal to the port's resident plain version."""
    m, n, l, c_blk, b, density = CASES[case]
    rng = np.random.default_rng(200 + case)
    art, port = _artifacts(_dense(rng, m, n, density), l, c_blk, layout, vdt, idt,
                           load_balance=False)
    xp = _xp(rng, n, l, b)
    got = _run_port_local(port, xp)
    np.testing.assert_allclose(got, _run_ref_local(art, xp), rtol=1e-5, atol=1e-6)
    assert np.array_equal(got, _run_port(port, xp))


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_local_plain_bitwise_on_small_integers(layout, case):
    m, n, l, c_blk, b, density = CASES[case]
    rng = np.random.default_rng(300 + case)
    art, port = _artifacts(_dense(rng, m, n, density, integers=True), l, c_blk, layout)
    xp = _xp(rng, n, l, b, integers=True)
    assert np.array_equal(_run_port_local(port, xp), _run_ref_local(art, xp))


@pytest.mark.parametrize("idt", ["int32", "int16"])
def test_gather_fill_local_matches_reference(idt):
    rng = np.random.default_rng(11)
    art, port = _artifacts(_dense(rng, 60, 90, 0.1), 16, 4, "padded", idt=idt)
    xp = _xp(rng, 90, 16, 3)
    got = tref.gather_fill_local_ref(port.col_loc, port.seg_blk, torch.from_numpy(xp),
                                     l=16, c_blk=4)
    want = jref.gather_fill_local_ref(art.col_loc, art.seg_blk, jnp.asarray(xp),
                                      l=16, c_blk=4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the same values as the resident gather, slot for slot
    assert torch.equal(got, tref.gather_fill_ref(port.col_blk, torch.from_numpy(xp)))


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt", ["float32", "bfloat16", "int8"])
def test_resident_equals_local_bitwise(layout, vdt):
    rng = np.random.default_rng(41)
    dense = _dense(rng, 120, 150, 0.06)
    x = torch.from_numpy(rng.standard_normal((150, 3)).astype(np.float32))
    _, port = _artifacts(dense, 16, 8, layout, vdt)
    for pipeline in ("single", "double"):
        y_res = execute_spmm(port, x, gather="resident", pipeline=pipeline)
        assert torch.equal(y_res, execute_spmm(port, x, gather="local", pipeline=pipeline))


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("gather", ["resident", "local"])
@pytest.mark.parametrize("vdt", ["float32", "int8"])
def test_double_buffered_path_matches_pallas_kernels(layout, gather, vdt):
    """Kernels 5-8 of the TPU table (``make_gust_spmv_db``,
    ``make_gust_spmv_local_db``, ``make_gust_spmv_ragged_db``,
    ``make_gust_spmv_ragged_local_db``), reached through the reference's
    executor with ``use_kernel=True, interpret=True,
    pipeline="double"``, against the port's CPU path with the same knobs
    on the same artifact: ``rtol=1e-5, atol=1e-6`` (the Pallas kernels
    route products through one-hot matmuls, another summation order)."""
    rng = np.random.default_rng(17)
    m, n, l, c_blk, b = 24, 40, 8, 4, 2
    art, port = _artifacts(_dense(rng, m, n, 0.25), l, c_blk, layout, vdt,
                           load_balance=False)
    assert art.fusable, "the reference runs its Pallas kernel only on fusable packs"
    x = rng.standard_normal((n, b)).astype(np.float32)
    want = rops.execute_spmm(art, jnp.asarray(x), use_kernel=True, interpret=True,
                             c_blk=c_blk, gather=gather, pipeline="double")
    got = execute_spmm(port, torch.from_numpy(x), c_blk=c_blk, gather=gather,
                       pipeline="double")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt", ["float32", "int8"])
def test_local_plain_takes_unordered_segment_tables(layout, vdt):
    """The local plain versions read each slot's column through the table,
    so a block's segments in any order (``col_loc`` remapped) give the
    same bits; the CUDA kernels are held to the same on the card."""
    from test_torch_gpu import shuffle_segment_table

    rng = np.random.default_rng(23)
    _, port = _artifacts(_dense(rng, 90, 200, 0.08), 16, 4, layout, vdt,
                         load_balance=False)
    shuffled = shuffle_segment_table(port, seed=5)
    assert not torch.equal(shuffled.seg_blk, port.seg_blk)
    xp = _xp(rng, 200, 16, 2)
    assert np.array_equal(_run_port_local(shuffled, xp), _run_port_local(port, xp))


def test_local_db_sweep_edits_apply_to_the_source():
    """``python -m repro_torch.kernels.local_db_sweep`` builds its variants
    of the spread kernels (1/2, 5/7, 3/4, 6/8) by editing their shared
    template ``csrc/gust_spread.cuh``; every edit must still find its
    text, and change it, and each library a variant is built for must
    include that template.  ``stream_registers`` builds kernels 5/7 with
    the bulk-copy ring's condition edited out (so the register prefetch
    of kernels 1/2 runs in their library), ``ring_b1`` with the ring at
    B=1 too, ``ring_bytes`` builds kernels 1/2 holding the ring's shared
    memory, and the diagnostics reach kernels 5/7 too."""
    from repro_torch.kernels import _build, local_db_sweep

    src = (_build.CSRC / local_db_sweep.HEADER).read_text()
    for name, (edits, _, libs) in local_db_sweep.VARIANTS.items():
        text = src
        for old, new in edits:
            assert old in text, name
            text = text.replace(old, new)
        assert text != src, name
        assert local_db_sweep.edited_header(edits) == text, name
        for lib in libs:
            cu = (_build.CSRC / _build.SOURCES[lib]).read_text()
            assert f'#include "{local_db_sweep.HEADER}"' in cu, (name, lib)
    edits, bitwise, libs = local_db_sweep.VARIANTS["stream_registers"]
    assert bitwise and libs == ("gust_spmv_db",)
    assert "ring_fits<V, I>(" in src
    assert "ring_fits<V, I>(" not in local_db_sweep.edited_header(edits)
    edits, bitwise, libs = local_db_sweep.VARIANTS["ring_b1"]
    assert bitwise and libs == ("gust_spmv_db",)
    assert "BT > 1" in src and "BT > 1" not in local_db_sweep.edited_header(edits)
    assert local_db_sweep.VARIANTS["ring_bytes"][1:] == (True, ("gust_spmv",))
    for name in ("diag_no_products", "diag_no_scratch"):
        assert "gust_spmv_db" in local_db_sweep.VARIANTS[name][2], name
    assert set(local_db_sweep.PARENT_SIGNATURES) == {
        "gust_spmv", "gust_spmv_db", *local_db_sweep.LIBS.values()}


def test_local_launch_plan_takes_only_a_pipeline_of_the_local_kernels():
    """``spread_launch_plan`` reads the launch of kernels 1/2 or 5/7
    (``gather="resident"``) or of kernels 3/4 or 6/8 (``"local"``), of
    ``pipeline="single"`` or ``"double"``; any other gather or pipeline
    is refused before a library is built."""
    import repro_torch.kernels.gust_spmv as k_pad

    m = torch.zeros(8, 4)
    col = torch.zeros(8, 4, dtype=torch.int32)
    for gather, pipeline in (("local", "auto"), ("local", "resident"), ("local", ""),
                             ("auto", "single"), ("resident", "auto"), ("", "double")):
        with pytest.raises(ValueError, match="pipeline"):
            k_pad.spread_launch_plan(m, col, col, torch.zeros(8, 1), l=4, c_blk=2,
                                     gather=gather, pipeline=pipeline)