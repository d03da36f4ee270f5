"""Port parity of the single-buffered segment-local path and of the
Buffer Filler, on the CPU.

* Kernels 3-4 of the TPU table (``make_gust_spmv_local``,
  ``make_gust_spmv_ragged_local``), reached through the reference's
  executor with ``use_kernel=True, interpret=True, gather="local",
  pipeline="single"`` on ``fusable`` artifacts (else the reference would
  quietly take its jnp path), against the port's executor with the same
  knobs: f32 and int8 values, int32 and int16 indices, within
  ``rtol=1e-5, atol=1e-6`` (the Pallas kernels route products through
  one-hot matmuls, another summation order).
* The new wrappers ``gust_spmv_local`` / ``gust_spmv_ragged_local`` on
  CPU tensors: the local plain versions, no launch, bitwise equal to the
  resident plain versions.
* Kernel 10 (``make_gather_fill``, interpret mode) against the port's
  ``gather_fill`` on CPU tensors: bitwise, and equal to ``x[col]``.

The CUDA kernels are held against these plain versions by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.kernels.ops as rops
from repro.kernels.gather_fill import make_gather_fill

import repro_torch.kernels.gather_fill as kg
import repro_torch.kernels.gust_spmv as k_pad
import repro_torch.kernels.gust_spmv_ragged as k_rag
from repro_torch.kernels.ops import execute_spmm

from test_torch_local import _run_port_local
from test_torch_spmv import CASES, _artifacts, _dense, _run_port, _xp

torch.set_num_threads(1)  # the suite runs several test processes at once


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt", ["float32", "int8"])
@pytest.mark.parametrize("idt", ["int32", "int16"])
def test_single_local_path_matches_pallas_kernels(layout, vdt, idt):
    rng = np.random.default_rng(31)
    m, n, l, c_blk, b = 24, 40, 8, 4, 2
    art, port = _artifacts(_dense(rng, m, n, 0.25), l, c_blk, layout, vdt, idt,
                           load_balance=False)
    assert art.fusable, "the reference runs its Pallas kernel only on fusable packs"
    x = rng.standard_normal((n, b)).astype(np.float32)
    want = rops.execute_spmm(art, jnp.asarray(x), use_kernel=True, interpret=True,
                             c_blk=c_blk, gather="local", pipeline="single")
    got = execute_spmm(port, torch.from_numpy(x), c_blk=c_blk, gather="local",
                       pipeline="single")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert torch.equal(got, execute_spmm(port, torch.from_numpy(x), c_blk=c_blk,
                                         gather="resident", pipeline="single"))


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt,idt", [("float32", "int32"), ("bfloat16", "int16"),
                                     ("int8", "int16")])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_local_wrappers_take_the_plain_path_on_cpu(layout, vdt, idt, case):
    m, n, l, c_blk, b, density = CASES[case]
    rng = np.random.default_rng(500 + case)
    _, port = _artifacts(_dense(rng, m, n, density), l, c_blk, layout, vdt, idt,
                         load_balance=False)
    xp = _xp(rng, n, l, b)
    kw = dict(num_windows=port.num_windows, l=l, c_blk=c_blk, scale_blk=port.scale_blk)
    before = (k_pad.local_launches, k_rag.local_launches)
    if layout == "ragged":
        y = k_rag.gust_spmv_ragged_local(
            port.m_blk, port.col_loc, port.row_blk, port.seg_blk, port.block_window,
            port.block_starts, torch.from_numpy(xp), **kw)
    else:
        y = k_pad.gust_spmv_local(port.m_blk, port.col_loc, port.row_blk, port.seg_blk,
                                  torch.from_numpy(xp), **kw)
    assert (k_pad.local_launches, k_rag.local_launches) == before
    assert np.array_equal(y.numpy(), _run_port_local(port, xp))
    assert np.array_equal(y.numpy(), _run_port(port, xp))


@pytest.mark.parametrize("idt", ["int32", "int16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_gather_fill_matches_pallas_kernel(idt, case):
    m, n, l, c_blk, b, density = CASES[case]
    rng = np.random.default_rng(700 + case)
    art, port = _artifacts(_dense(rng, m, n, density), l, c_blk, "padded", idt=idt,
                           load_balance=False)
    xp = _xp(rng, n, l, b)
    rows = port.col_blk.shape[0]
    want = make_gather_fill(rows, l, art.seg_count, b, c_blk=c_blk, interpret=True)(
        art.col_blk, jnp.asarray(xp.reshape(-1, l, b)))
    before = kg.launches
    got = kg.gather_fill(port.col_blk, torch.from_numpy(xp))
    assert kg.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, l, b)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), xp[port.col_blk.long().numpy()])
