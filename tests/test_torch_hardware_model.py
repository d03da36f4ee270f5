"""Port parity of the paper's hardware and baseline models
(``repro_torch.core.hardware_model``, ``core.baselines``,
``configs.gust_paper``) against ``repro``: on seeded matrices every
``model_*`` ``DesignReport`` equals the reference's field for field, and
so do the energy and bandwidth functions and the five accelerator specs.
These are the paper's FPGA models (clocks, powers, cycle counts), never
a measurement of the card; ``model_gust``'s plan is built on the CPU here
(``device="cpu"``), since the port's entry points default to the card.
"""

import dataclasses

import numpy as np
import pytest

import repro.configs.gust_paper as ref_paper
import repro.core.baselines as RB
import repro.core.hardware_model as RH
from repro.core.formats import COOMatrix as RefCOO
from repro.core.scheduler import schedule as ref_schedule
from repro.data.matrices import synth_power_law as ref_power_law
from repro.data.matrices import synth_uniform as ref_uniform

import repro_torch.configs.gust_paper as paper
import repro_torch.core.baselines as B
import repro_torch.core.hardware_model as H
from repro_torch.core.formats import COOMatrix
from repro_torch.core.packing import ScheduleCache
from repro_torch.core.scheduler import schedule
from repro_torch.data.matrices import synth_power_law, synth_uniform

SPECS = ("GUST_256", "GUST_87", "GUST_8", "SYSTOLIC_1D_256", "SERPENS")


def matrices():
    """(name, port COO, reference COO): seeded generators of both packages
    and a skewed numpy matrix with empty rows."""
    rng = np.random.default_rng(0)
    m, n, nnz = 300, 280, 2500
    flat = np.unique(rng.integers(0, m * n, nnz))
    rows, cols = (flat // n).astype(np.int64), (flat % n).astype(np.int64)
    rows = np.where(rows < 40, rows, (rows // 3) * 3)  # every third row only
    key = np.unique(rows * n + cols)
    rows, cols = key // n, key % n
    vals = rng.standard_normal(key.size).astype(np.float32)
    return [
        ("uniform", synth_uniform(512, 0.02, seed=1), ref_uniform(512, 0.02, seed=1)),
        ("power_law", synth_power_law(700, 0.01, seed=2), ref_power_law(700, 0.01, seed=2)),
        ("skewed", COOMatrix((m, n), rows, cols, vals), RefCOO((m, n), rows, cols, vals)),
    ]


MATRICES = matrices()


@pytest.mark.parametrize("name,coo,rcoo", MATRICES, ids=[m[0] for m in MATRICES])
def test_every_design_report_equals_reference(name, coo, rcoo):
    assert np.array_equal(coo.rows, rcoo.rows) and np.array_equal(coo.vals, rcoo.vals)
    pairs = [
        (B.model_1d(coo, 256), RB.model_1d(rcoo, 256)),
        (B.model_1d(coo, 64), RB.model_1d(rcoo, 64)),
        (B.model_adder_tree(coo), RB.model_adder_tree(rcoo)),
        (B.model_flex_tpu(coo, 16), RB.model_flex_tpu(rcoo, 16)),
        (B.model_fafnir(coo, 128), RB.model_fafnir(rcoo, 128)),
        (B.model_gust_naive(coo, 64), RB.model_gust_naive(rcoo, 64)),
    ]
    for lb in (True, False):
        for method in ("fast", "paper"):
            pairs.append((B.model_gust(coo, 64, load_balance=lb, method=method,
                                       device="cpu"),
                          RB.model_gust(rcoo, 64, load_balance=lb, method=method)))
    for got, want in pairs:
        assert dataclasses.astuple(got) == dataclasses.astuple(want), want.design
        assert got.utilization == want.utilization
    got = B.all_designs(coo, 64, device="cpu")
    want = RB.all_designs(rcoo, 64)
    assert list(got) == list(want)
    assert all(dataclasses.astuple(got[k]) == dataclasses.astuple(want[k]) for k in want)


def test_model_gust_shares_a_schedule_cache_and_defaults_to_the_card():
    """A cache passed in is the one the plan schedules through (a second
    model over the same matrix colors nothing new); without a card the
    default device raises before any scheduling."""
    _, coo, rcoo = MATRICES[1]
    cache = ScheduleCache()
    first = B.model_gust(coo, 64, cache=cache, device="cpu")
    before = cache.stats()
    again = B.model_gust(coo, 64, cache=cache, device="cpu")
    assert again == first and cache.stats()["hits"] == before["hits"] + 1
    assert dataclasses.astuple(first) == dataclasses.astuple(RB.model_gust(rcoo, 64))
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            B.model_gust(coo, 64)


@pytest.mark.parametrize("name,coo,rcoo", MATRICES[:2], ids=[m[0] for m in MATRICES[:2]])
def test_energy_and_bandwidth_equal_reference(name, coo, rcoo):
    for l in (8, 87, 256):
        assert H.required_bandwidth_bits_per_s(l) == RH.required_bandwidth_bits_per_s(l)
        assert H.required_bandwidth_bits_per_s(l, 223e6) == \
            RH.required_bandwidth_bits_per_s(l, 223e6)
    sched, rsched = schedule(coo, 256), ref_schedule(rcoo, 256)
    assert sched.cycles == rsched.cycles
    for spec in SPECS:
        got, want = getattr(H, spec), getattr(RH, spec)
        assert H.gust_energy_joules(sched, got) == RH.gust_energy_joules(rsched, want)
        assert H.execution_seconds(1234.0, got) == RH.execution_seconds(1234.0, want)
    consts = H.EnergyConstants(read_off=70.0, dist_gust_mm=100.0)
    rconsts = RH.EnergyConstants(read_off=70.0, dist_gust_mm=100.0)
    assert H.gust_energy_joules(sched, H.GUST_87, consts) == \
        RH.gust_energy_joules(rsched, RH.GUST_87, rconsts)
    cycles = RB.model_1d(rcoo).cycles
    assert H.systolic_1d_energy_joules(coo, cycles) == \
        RH.systolic_1d_energy_joules(rcoo, cycles)
    assert dataclasses.asdict(H.DEFAULT_ENERGY) == dataclasses.asdict(RH.DEFAULT_ENERGY)


def test_paper_specs_equal_reference():
    for spec in SPECS:
        got, want = getattr(paper, spec), getattr(ref_paper, spec)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got is getattr(H, spec)
        assert got.max_bandwidth_bits_per_s == want.max_bandwidth_bits_per_s
    assert sorted(paper.__all__) == sorted(ref_paper.__all__)
    assert B.FAFNIR_STALL_KAPPA == RB.FAFNIR_STALL_KAPPA
