"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test decides inside itself whether a card is
present and skips without one.  Imports neither ``jax`` nor ``repro``, so
it runs on a machine that has only the port's requirements:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Against the plain version run on the card (``index_add_`` with atomics,
so its order varies) the tolerance is ``rtol=1e-5, atol=1e-5``; against
the plain version run on the CPU (the kernel's own order) the results
must be bitwise equal.
"""

import numpy as np
import pytest
import torch

import repro_torch.kernels.gust_spmv as k_pad
import repro_torch.kernels.gust_spmv_ragged as k_rag
import repro_torch.kernels.ref as tref
from repro_torch.core.formats import COOMatrix
from repro_torch.core.packing import pack_ragged, pack_schedule
from repro_torch.core.plan import PlanConfig, plan
from repro_torch.core.scheduler import schedule
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


CASES = [  # (m, n, l, c_blk, b)
    (200, 300, 32, 8, 1),
    (130, 90, 12, 3, 9),  # l not a power of two, B across two column tiles
    (64, 20, 64, 16, 8),  # n < l, c_blk above the kernel's load stage
    (700, 700, 256, 8, 3),
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


def test_row0_padding_collision(cuda):
    dense = np.zeros((8, 8), np.float32)
    dense[0, 1] = 3.0  # window 0: one real slot, on row 0
    dense[4:8, :] = np.arange(1, 33, dtype=np.float32).reshape(4, 8)
    x = np.arange(1, 9, dtype=np.float32)[:, None] - 4.0
    for layout in ("padded", "ragged"):
        p = plan(dense, PlanConfig(l=4, c_blk=4, load_balance=False, layout=layout,
                                   gather="resident", pipeline="single"), device=cuda)
        y = p.spmm(x)
        assert np.array_equal(y.cpu().numpy(), dense @ x)


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        plan(dense, PlanConfig(l=32, gather="resident"), device=cuda).spmv(v)
    art = plan(dense, cfg, layout="padded", device=cuda).artifact
    xp = torch.zeros(2, 288, device=cuda).T  # (S*l, 2), not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        k_pad.gust_spmv(art.m_blk, art.col_blk, art.row_blk, xp,
                        num_windows=art.num_windows, l=32, c_blk=art.c_blk)
    with pytest.raises(ValueError, match="tensors on"):
        k_pad.gust_spmv(art.m_blk, art.col_blk, art.row_blk, xp.cpu(),
                        num_windows=art.num_windows, l=32, c_blk=art.c_blk)
