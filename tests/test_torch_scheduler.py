"""Port parity: the scheduler and the matrix generators of ``repro_torch``
give the reference's arrays bit for bit.

Seeded inputs (numpy), serial coloring (the inputs stay far below the
parallel colorer's edge threshold, so no process is forked here).
"""

import numpy as np
import pytest

import repro.core.scheduler as ref_sched
import repro.data.matrices as ref_mat
from repro.core.formats import COOMatrix as RefCOO

import repro_torch.core.scheduler as port_sched
import repro_torch.data.matrices as port_mat
from repro_torch.core.formats import COOMatrix as PortCOO

SCHED_FIELDS = ("m_sch", "row_sch", "col_sch", "window_starts", "row_perm", "valid")

#: (generator, args) — n <= 512, a few thousand nonzeros each.
GENERATORS = {
    "uniform": ("synth_uniform", (256, 0.02)),
    "power_law": ("synth_power_law", (256, 0.03)),
    "k_regular": ("synth_k_regular", (192, 0.03)),
    "banded": ("synth_banded", (512, 4000)),
}


def _pair(gen: str, seed: int = 3):
    name, args = GENERATORS[gen]
    ref = getattr(ref_mat, name)(*args, seed=seed)
    port = getattr(port_mat, name)(*args, seed=seed)
    return ref, port


def _assert_same_schedule(a, b):
    assert (a.l, tuple(a.shape), a.nnz) == (b.l, tuple(b.shape), b.nnz)
    for f in SCHED_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f


@pytest.mark.parametrize("gen", sorted(GENERATORS) + ["block_diagonal"])
def test_generators_match_reference(gen):
    if gen == "block_diagonal":
        ref = ref_mat.synth_block_diagonal(256, 3000, num_blocks=8, seed=5)
        port = port_mat.synth_block_diagonal(256, 3000, num_blocks=8, seed=5)
    else:
        ref, port = _pair(gen, seed=5)
    assert tuple(ref.shape) == tuple(port.shape)
    for f in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(ref, f), getattr(port, f)), f


def test_real_world_suite_matches_reference():
    assert [tuple(vars(s).values()) for s in ref_mat.REAL_WORLD_SUITE] == [
        tuple(vars(s).values()) for s in port_mat.REAL_WORLD_SUITE
    ]
    spec = ref_mat.REAL_WORLD_SUITE[0]  # crankseg_2, scaled down
    ref = ref_mat.make_real_world_surrogate(spec, scale=0.01, seed=1)
    port = port_mat.make_real_world_surrogate(
        port_mat.REAL_WORLD_SUITE[0], scale=0.01, seed=1
    )
    for f in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(ref, f), getattr(port, f)), f


@pytest.mark.parametrize("gen", sorted(GENERATORS))
@pytest.mark.parametrize("load_balance", [False, True])
@pytest.mark.parametrize("method", ["paper", "fast", "exact"])
def test_schedule_bitwise_equal(gen, load_balance, method):
    ref, port = _pair(gen)
    l = 32
    a = ref_sched.schedule(ref, l, load_balance=load_balance, method=method)
    b = port_sched.schedule(port, l, load_balance=load_balance, method=method)
    _assert_same_schedule(a, b)


@pytest.mark.parametrize("l", [1, 7, 64])
def test_schedule_odd_lengths_and_empty(l):
    rng = np.random.default_rng(l)
    m, n = 50, 70
    dense = ((rng.random((m, n)) < 0.15) * rng.integers(-4, 5, (m, n))).astype(
        np.float32
    )
    dense[:l] = 0  # an empty first window
    r, c = np.nonzero(dense)
    args = ((m, n), r.astype(np.int64), c.astype(np.int64), dense[r, c])
    a = ref_sched.schedule(RefCOO(*args), l)
    b = port_sched.schedule(PortCOO(*args), l)
    _assert_same_schedule(a, b)
    empty = ((m, n), np.zeros(0, np.int64), np.zeros(0, np.int64),
             np.zeros(0, np.float32))
    _assert_same_schedule(
        ref_sched.schedule(RefCOO(*empty), l), port_sched.schedule(PortCOO(*empty), l)
    )


def test_colorers_match_on_raw_keys():
    rng = np.random.default_rng(11)
    e = 600
    row = np.sort(rng.integers(0, 40, e))
    lane = rng.integers(0, 16, e)
    for name in ("color_edges_paper", "color_edges_fast", "color_edges_exact"):
        assert np.array_equal(
            getattr(ref_sched, name)(row, lane), getattr(port_sched, name)(row, lane)
        ), name


def test_chunked_colorer_serial_below_threshold():
    """Below the edge threshold (and with one worker) the chunked colorer
    is the serial one, and forks nothing."""
    ref, port = _pair("uniform")
    sched = port_sched.schedule(port, 16, workers=1)
    before = dict(port_sched.sched_counters)
    again = port_sched.schedule(port, 16, workers=None)
    assert port_sched.sched_counters["parallel_chunks"] == before["parallel_chunks"]
    assert port_sched.sched_counters["color_calls"] == before["color_calls"] + 1
    _assert_same_schedule(sched, again)
    assert port_sched.DEFAULT_PARALLEL_MIN_EDGES == ref_sched.DEFAULT_PARALLEL_MIN_EDGES
