"""Port parity of the plan/execute API: ``repro_torch.plan(M, cfg,
device="cpu")`` against ``repro.plan(M, cfg, backend="jnp")`` — the
reference's plain path — for both layouts, f32 and int8 values, ``spmv``,
``spmm`` and ``spmm(transpose_io=True)``; the executor's knob checks with
the reference's messages; the device rule; and the import boundary (the
port loads neither ``jax`` nor ``repro``).

Tolerance: ``rtol=1e-5, atol=1e-6``; the port sums within each block
before adding into the window, the reference's plain path scatters every
product straight into the window.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro
import repro.kernels.ops as rops
from repro.core.formats import COOMatrix as RefCOO

import repro_torch
import repro_torch.kernels.ops as tops
from repro_torch.core.formats import COOMatrix as PortCOO
from repro_torch.core.plan import PlanConfig as PortConfig
from repro_torch.core.plan import plan as port_plan

from conftest import REPO

torch.set_num_threads(1)  # the suite runs several test processes at once


def _matrix(seed, m=150, n=110, density=0.05, heavy=True):
    rng = np.random.default_rng(seed)
    dense = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(
        np.float32
    )
    if heavy:
        dense[rng.choice(m, 2, replace=False)] = rng.standard_normal((2, n))
    r, c = np.nonzero(dense)
    args = ((m, n), r.astype(np.int64), c.astype(np.int64), dense[r, c])
    return dense, args


CFG = dict(l=16, c_blk=8, gather="resident", pipeline="single")


def _plans(layout, vdt, seed=0, **extra):
    dense, args = _matrix(seed)
    kw = dict(CFG, layout=layout, value_dtype=vdt, **extra)
    ref = repro.plan(RefCOO(*args), repro.PlanConfig(backend="jnp", **kw), cache=None)
    port = port_plan(PortCOO(*args), PortConfig(**kw), cache=None, device="cpu")
    return dense, ref, port


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("vdt", ["float32", "int8"])
def test_plan_matches_reference(layout, vdt):
    dense, ref, port = _plans(layout, vdt)
    m, n = dense.shape
    rng = np.random.default_rng(1)
    v = rng.standard_normal(n).astype(np.float32)
    X = rng.standard_normal((n, 5)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-6)
    y = port.spmv(torch.from_numpy(v))
    assert y.shape == (m,) and y.dtype == torch.float32 and y.device.type == "cpu"
    np.testing.assert_allclose(y.numpy(), np.asarray(ref.spmv(jnp.asarray(v))), **tol)
    np.testing.assert_allclose(
        port.spmm(X).numpy(), np.asarray(ref.spmm(jnp.asarray(X))), **tol
    )
    yt = port.spmm(torch.from_numpy(X.T.copy()), transpose_io=True)
    assert yt.shape == (5, m)
    np.testing.assert_allclose(
        yt.numpy(),
        np.asarray(ref.spmm(jnp.asarray(X.T), transpose_io=True)), **tol,
    )
    assert port.layout == ref.layout == layout
    assert port.gather_mode == ref.gather_mode == "resident"
    # the full PlanCost: every field the reference's but the execution
    # path's name
    port_cost, ref_cost = dataclasses.asdict(port.cost()), dataclasses.asdict(ref.cost())
    assert (port_cost.pop("backend"), ref_cost.pop("backend")) == ("plain", "jnp")
    assert port_cost == ref_cost
    if vdt == "float32":  # and against the matrix itself
        np.testing.assert_allclose(y.numpy(), dense @ v, rtol=1e-4, atol=1e-4)


def test_plan_small_integers_bitwise_and_layouts_agree():
    rng = np.random.default_rng(9)
    dense = ((rng.random((70, 90)) < 0.1) * rng.integers(-4, 5, (70, 90))).astype(
        np.float32
    )
    x = rng.integers(-3, 4, (90, 3)).astype(np.float32)
    ys = []
    for layout in ("padded", "ragged"):
        p = port_plan(dense, PortConfig(layout=layout, **CFG), device="cpu")
        ys.append(p.spmm(x))
        r = repro.plan(dense, repro.PlanConfig(layout=layout, backend="jnp", **CFG))
        assert np.array_equal(ys[-1].numpy(), np.asarray(r.spmm(jnp.asarray(x))))
    assert torch.equal(ys[0], ys[1])
    assert np.array_equal(ys[0].numpy(), dense @ x)


def test_auto_layout_resolves_as_reference():
    for seed, heavy in ((3, False), (4, True)):
        _, args = _matrix(seed, heavy=heavy)
        ref = repro.plan(RefCOO(*args), repro.PlanConfig(l=16, backend="jnp"), cache=None)
        port = port_plan(PortCOO(*args), PortConfig(l=16), cache=None, device="cpu")
        assert port.layout == ref.layout
        assert port.gather_mode == ref.gather_mode


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dense, _ = _matrix(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.plan(dense)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.plan(dense, device="cuda:0")


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import sys; import repro_torch; repro_torch.plan; repro_torch.PlanConfig; "
        "repro_torch.spgemm; repro_torch.graph.triangle_count; "
        "import repro_torch.kernels.ops, repro_torch.core.convert, "
        "repro_torch.kernels._build, repro_torch.data.matrices, "
        "repro_torch.core.spgemm, repro_torch.graph.analytics, "
        "repro_torch.kernels.gust_spgemm, repro_torch.kernels.gather_fill, "
        "repro_torch.kernels.local_db_sweep, repro_torch.kernels.spgemm_sweep, "
        "repro_torch.core.plan_store, repro_torch.core.gust_linear, "
        "repro_torch.core.spmv, repro_torch.core.bounds, repro_torch.resilience, "
        "repro_torch.resilience.faults, repro_torch.resilience.retry, "
        "repro_torch.resilience.lifecycle, repro_torch.resilience.fallback, "
        "repro_torch.configs, repro_torch.models, repro_torch.models.layers, "
        "repro_torch.models.attention, repro_torch.models.transformer, "
        "repro_torch.models.moe, repro_torch.models.recurrent, "
        "repro_torch.models.model_zoo, repro_torch.models.tree, repro_torch.serving, "
        "repro_torch.serving.kv_cache, repro_torch.serving.gust_serve, "
        "repro_torch.serving.serve_loop, repro_torch.launch, repro_torch.launch.serve; "
        "[repro_torch.configs.get_arch(a) for a in repro_torch.configs.ARCH_IDS]; "
        "[getattr(repro_torch, n) for n in repro_torch.__all__]; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')); "
        "assert not bad, bad; print('ok')"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "ok"


def test_local_gather_runs_on_cpu_under_every_pipeline():
    """A resolved ``gather="local"`` runs the segment-local plain versions
    on the CPU under every pipeline, matches the reference's plain path,
    and equals the resident gather bitwise (the plain path ignores
    ``pipeline``)."""
    for layout in ("padded", "ragged"):
        _, ref, port = _plans(layout, "float32")
        x = np.random.default_rng(4).standard_normal((port.shape[1], 2)).astype(np.float32)
        y = tops.execute_spmm(port.artifact, torch.from_numpy(x), gather="local",
                              pipeline="single")
        want = rops.execute_spmm(ref.artifact, jnp.asarray(x), use_kernel=False,
                                 gather="local")
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        assert torch.equal(y, tops.execute_spmm(port.artifact, torch.from_numpy(x),
                                                gather="resident", pipeline="double"))


def _local_matrix(seed, m=256, n=1024, per_row=6):
    """Rows whose columns sit in a narrow band around their diagonal
    position: at l=8 (128 column segments) each block references few
    segments, so ``gather="auto"`` resolves local."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), per_row)
    centre = rows * (n // m)
    cols = np.clip(centre + rng.integers(-12, 12, rows.size), 0, n - 1)
    dense = np.zeros((m, n), np.float32)
    dense[rows, cols] = rng.standard_normal(rows.size).astype(np.float32)
    r, c = np.nonzero(dense)
    return dense, ((m, n), r.astype(np.int64), c.astype(np.int64), dense[r, c])


@pytest.mark.parametrize("load_balance", [True, False])
@pytest.mark.parametrize("layout", ["padded", "ragged"])
def test_default_config_matches_reference(load_balance, layout):
    """``plan`` with ``gather`` and ``pipeline`` left at ``"auto"``, on a
    matrix where ``gather="auto"`` resolves local, against ``repro.plan``
    with the same config: the same resolved gather, results within
    ``rtol=1e-5, atol=1e-6``, and the port's resident and local gathers
    bitwise equal."""
    dense, args = _local_matrix(7)
    kw = dict(l=8, c_blk=8, layout=layout, load_balance=load_balance)
    ref = repro.plan(RefCOO(*args), repro.PlanConfig(**kw), cache=None)
    port = port_plan(PortCOO(*args), PortConfig(**kw), cache=None, device="cpu")
    assert port.gather_mode == ref.gather_mode == "local"
    assert port._pipeline() == "double"
    x = np.random.default_rng(8).standard_normal((dense.shape[1], 3)).astype(np.float32)
    y = port.spmm(x)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref.spmm(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), dense @ x, rtol=1e-4, atol=1e-4)
    resident = port_plan(PortCOO(*args), PortConfig(gather="resident", **kw),
                         cache=None, device="cpu")
    assert torch.equal(y, resident.spmm(x))


def test_knob_rejections_match_reference_messages():
    _, ref, port = _plans("padded", "int8")
    x = torch.zeros(port.shape[1], 1)
    xj = jnp.zeros((port.shape[1], 1))

    def message(fn, *a, **kw):
        with pytest.raises(ValueError) as err:
            fn(*a, **kw)
        return str(err.value)

    for kw in ({"gather": "nearby"}, {"pipeline": "triple"}, {"layout": "csr"},
               {"layout": "ragged"}, {"c_blk": 4, "gather": "resident"},
               {"c_blk": 4, "gather": "local"}):
        assert message(tops.execute_spmm, port.artifact, x, **kw) == message(
            rops.execute_spmm, ref.artifact, xj, use_kernel=False, **kw
        ), kw
    for bad in (torch.zeros(3, 1), torch.zeros(1, 3)):
        for t in (False, True):
            assert message(tops.execute_spmm, port.artifact, bad, transpose_io=t) \
                == message(rops.execute_spmm, ref.artifact, jnp.asarray(bad.numpy()),
                           use_kernel=False, transpose_io=t)
    assert message(tops.normalize_choice, "gather", "x") == message(
        rops.normalize_choice, "gather", "x")


def test_padded_c_blk_override_runs_on_unquantized_streams():
    _, ref, port = _plans("padded", "float32")
    x = np.random.default_rng(2).standard_normal((port.shape[1], 2)).astype(np.float32)
    c_blk = port.artifact.c_pad // 2
    y = tops.execute_spmm(port.artifact, torch.from_numpy(x), c_blk=c_blk,
                          gather="resident")
    want = rops.execute_spmm(ref.artifact, jnp.asarray(x), use_kernel=False,
                             c_blk=c_blk, gather="resident")
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_plan_config_fields_and_validation():
    ref_fields = {f.name: f.default for f in dataclasses.fields(repro.PlanConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(PortConfig)}
    assert port_fields == ref_fields
    cfg = PortConfig(value_dtype=torch.bfloat16, index_dtype="int16")
    assert (cfg.value_dtype, cfg.index_dtype) == ("bfloat16", "int16")
    for kw in ({"layout": "csr"}, {"colorer": "greedy"}, {"gather": "x"},
               {"pipeline": "x"}, {"backend": "cuda"}, {"backend": "jnp"},
               {"interpret": True}, {"value_dtype": "float16"}, {"l": 0}):
        with pytest.raises(ValueError):
            PortConfig(**kw)


def test_two_plans_share_one_schedule():
    from repro_torch.core.packing import ScheduleCache
    from repro_torch.core.scheduler import sched_counters

    cache = ScheduleCache()
    dense, _ = _matrix(5)
    before = sched_counters["color_calls"]
    p1 = port_plan(dense, PortConfig(layout="padded", **CFG), cache=cache, device="cpu")
    p2 = port_plan(dense, PortConfig(layout="ragged", **CFG), cache=cache, device="cpu")
    assert sched_counters["color_calls"] == before + 1
    assert p1.sched is p2.sched
    assert p1._artifact is None  # packing is lazy
    assert p1.artifact is p1.artifact and p1.artifact is not p2.artifact
