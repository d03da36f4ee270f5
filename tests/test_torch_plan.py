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
    assert dataclasses.asdict(port.cost()) == {
        k: getattr(ref.cost(), k)
        for k in ("waste_ratio", "layout", "streamed_slots", "stream_bytes")
    }
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
        "import repro_torch.kernels.ops, repro_torch.core.convert, "
        "repro_torch.kernels._build, repro_torch.data.matrices; "
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


def test_unported_modes_raise_naming_the_roadmap():
    _, _, port = _plans("padded", "float32")
    x = torch.zeros(port.shape[1], 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.execute_spmm(port.artifact, x, gather="local")
    # the plain path has no tile pipeline: "double" changes nothing there,
    # as on the reference's jnp path
    y = tops.execute_spmm(port.artifact, x, gather="resident", pipeline="double")
    assert torch.equal(y, torch.zeros(port.shape[0], 1))


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
