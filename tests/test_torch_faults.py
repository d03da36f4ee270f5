"""Pins of two port faults, on the CPU.

* An int16 index leaf that cannot hold the largest column (or the
  largest block-local column) used to wrap without a word, and the card's
  kernels then read outside x.  Both packers now refuse such a pack, and
  the same matrix at int32 still gives ``M·x``.  The reference's packer
  still wraps: here the port departs from it.
* ``spmm`` with an x of no column (B = 0) used to raise.  It now returns
  the empty ``(m, 0)`` product (``(0, m)`` batch-major), as the
  reference's kernel path (``backend="pallas"``, interpret mode) does.
"""

import numpy as np
import pytest
import torch

import repro

from repro_torch.core.formats import COOMatrix
from repro_torch.core.packing import pack_ragged, pack_schedule
from repro_torch.core.plan import PlanConfig, plan
from repro_torch.core.scheduler import schedule

torch.set_num_threads(1)  # the suite runs several test processes at once

PACKERS = {"padded": pack_schedule, "ragged": pack_ragged}


def _wide(seed=0, m=64, n=40000, nnz=300):
    """A random 64 x 40000 matrix with 300 nonzeros: columns past int16."""
    rng = np.random.default_rng(seed)
    key = rng.choice(m * n, size=nnz, replace=False)
    return COOMatrix((m, n), key // n, key % n, rng.standard_normal(nnz).astype(np.float32))


@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_int16_pack_refuses_columns_past_its_range(layout):
    coo = _wide()
    sched = schedule(coo, 256)
    with pytest.raises(ValueError, match="int32"):
        PACKERS[layout](sched, 8, "float32", "int16", device="cpu")
    for gather in ("resident", "local"):
        p = plan(coo, PlanConfig(l=256, layout=layout, gather=gather, index_dtype="int16"),
                 device="cpu")
        with pytest.raises(ValueError, match="int16 stops at 32767"):
            p.spmv(np.ones(coo.shape[1], np.float32))
    x = np.random.default_rng(1).standard_normal((coo.shape[1], 2)).astype(np.float32)
    dense = np.zeros(coo.shape, np.float64)
    np.add.at(dense, (coo.rows, coo.cols), coo.vals.astype(np.float64))
    want = dense @ x.astype(np.float64)
    for gather in ("resident", "local"):
        p = plan(coo, PlanConfig(l=256, layout=layout, gather=gather, index_dtype="int32"),
                 device="cpu")
        got = p.spmm(x).numpy().astype(np.float64)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_int16_pack_takes_the_largest_column_it_can_hold():
    """n = 32768: the largest column, 32767, still fits."""
    coo = _wide(n=32768)
    coo = COOMatrix(coo.shape, np.append(coo.rows, 0), np.append(coo.cols, 32767),
                    np.append(coo.vals, np.float32(1.0)))
    for layout, pack in PACKERS.items():
        art = pack(schedule(coo, 256), 8, "float32", "int16", device="cpu")
        assert art.col_blk.dtype == torch.int16
        assert int(art.col_blk.max()) == 32767, layout


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("transpose_io", [False, True])
def test_spmm_with_no_column_matches_reference_pallas_path(layout, transpose_io):
    rng = np.random.default_rng(4)
    d = ((rng.random((20, 30)) < 0.3) * rng.standard_normal((20, 30))).astype(np.float32)
    r, c = np.nonzero(d)
    ref = repro.plan(repro.core.formats.COOMatrix(d.shape, r.astype(np.int64),
                                                  c.astype(np.int64), d[r, c]),
                     repro.PlanConfig(l=8, layout=layout, backend="pallas", interpret=True))
    x = np.zeros((0, 30) if transpose_io else (30, 0), np.float32)
    want = np.asarray(ref.spmm(x, transpose_io=transpose_io))
    p = plan(COOMatrix(d.shape, r.astype(np.int64), c.astype(np.int64), d[r, c]),
             PlanConfig(l=8, layout=layout), device="cpu")
    got = p.spmm(torch.from_numpy(x), transpose_io=transpose_io)
    assert tuple(got.shape) == want.shape == ((0, 20) if transpose_io else (20, 0))
    assert got.dtype == torch.float32
