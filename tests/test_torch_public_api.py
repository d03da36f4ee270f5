"""The port's public names against the reference's, in fresh interpreters.

Every module of ``repro`` that has an ``__all__`` and a counterpart in
``repro_torch`` must export the reference's names, less the departures
listed below with their reasons (ROADMAP §3).  The walk imports every
reference module, and ``repro.launch.dryrun`` sets ``XLA_FLAGS`` at
import (512 host devices), so it never runs in the pytest worker: each
check runs in a subprocess of its own with its own ``timeout=``."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

#: The Pallas kernel builders and their TPU helpers: each builder has a
#: hand-written CUDA kernel in its place (``repro_torch/kernels/csrc``), and
#: the helpers (one-hot routing, block math) are the TPU's workaround for a
#: gather and a scatter, which the card does directly (ROADMAP §2, §3).
PALLAS = {
    "make_gust_spmv", "make_gust_spmv_local", "make_gust_spmv_db",
    "make_gust_spmv_local_db", "make_gust_spmv_ragged", "make_gust_spmv_ragged_local",
    "make_gust_spmv_ragged_db", "make_gust_spmv_ragged_local_db", "make_gust_spgemm",
    "make_gather_fill", "block_accumulate", "block_math", "route_rows",
    "decode_local_cols", "local_tile_delta",
}
#: (reference module, name) -> the reason it has no counterpart (ROADMAP §3).
DEPARTURES = {
    **{("repro.kernels." + mod, name): "a Pallas builder or helper"
       for mod in ("gust_spmv", "gust_spmv_ragged", "gust_spgemm", "gather_fill")
       for name in PALLAS},
    **{(mod, "SparsityConfig"): "the reference's shim for its Pallas/jnp backend; "
       "the plan's device chooses" for mod in ("repro", "repro.core",
                                                "repro.core.gust_linear")},
    ("repro.distributed.collectives", "shard_map"): "jax's SPMD transform; the port's "
    "ranks are processes over torch.distributed",
    **{("repro.distributed.sharding", name): "an activation hint to XLA's partitioner; "
       "eager PyTorch has none" for name in (
           "activation_ctx", "constrain_activation", "constrain_attn",
           "constrain_kv_cache", "constrain_ep")},
    ("repro.analysis.kernel_audit", "VMEM_BUDGET_BYTES"): "a TPU core's VMEM; the "
    "Hopper audit holds the card's own budgets (GUST-H01..H06)",
}
#: Reference modules with no counterpart module.
MODULE_DEPARTURES = {
    "repro.launch.hlo_analysis": "reads XLA's HLO; the port's meta-device account "
    "(repro_torch.launch.cost_account) takes its place",
}

_WALK = r"""
import importlib, json, os, sys
src = sys.argv[1]
out = {"modules": {}, "no_counterpart": []}
for dirpath, dirnames, files in os.walk(os.path.join(src, "repro")):
    dirnames.sort()
    for f in sorted(files):
        if not f.endswith(".py") or f == "__main__.py":
            continue
        rel = os.path.relpath(os.path.join(dirpath, f), src)[:-3].replace(os.sep, ".")
        ref_name = rel[: -len(".__init__")] if rel.endswith(".__init__") else rel
        ref = importlib.import_module(ref_name)
        if not hasattr(ref, "__all__"):
            continue
        port_name = "repro_torch" + ref_name[len("repro"):]
        try:
            port = importlib.import_module(port_name)
        except ModuleNotFoundError:
            out["no_counterpart"].append(ref_name)
            continue
        names = set(getattr(port, "__all__", ())) | set(dir(port))
        out["modules"][ref_name] = {
            "reference": list(ref.__all__),
            "missing": [n for n in ref.__all__ if n not in names],
            "unresolved": [n for n in getattr(port, "__all__", ())
                           if getattr(port, n, None) is None],
        }
import repro_torch
from repro_torch.analysis import verify as v_mod
out["verify_is_function"] = callable(repro_torch.verify) and not hasattr(
    repro_torch.verify, "__path__") and repro_torch.verify is v_mod.verify
out["finding"] = repro_torch.Finding is v_mod.Finding
from repro_torch import core
out["core_submodules"] = core.plan is sys.modules["repro_torch.core.plan"] and \
    core.spmv is sys.modules["repro_torch.core.spmv"]
print(json.dumps(out))
"""


def _run(args, timeout):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=os.pathsep.join([SRC, ROOT]), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=timeout)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def walk():
    return _run(["-c", _WALK, SRC], timeout=240)


def test_every_reference_export_has_a_counterpart(walk):
    missing = {(mod, n) for mod, r in walk["modules"].items() for n in r["missing"]}
    assert missing - set(DEPARTURES) == set()


def test_departures_are_still_departures(walk):
    """A name the port gained leaves the list (it would hide nothing)."""
    missing = {(mod, n) for mod, r in walk["modules"].items() for n in r["missing"]}
    listed = {d for d in DEPARTURES if d[1] in walk["modules"].get(d[0], {}).get(
        "reference", ())}
    assert listed <= missing


def test_only_the_listed_modules_lack_a_counterpart(walk):
    assert sorted(walk["no_counterpart"]) == sorted(MODULE_DEPARTURES)
    assert {"repro", "repro.core", "repro.analysis", "repro.analysis.lint",
            "repro.models.layers", "repro.kernels.ops"} <= set(walk["modules"])


def test_every_port_export_resolves(walk):
    assert {m: r["unresolved"] for m, r in walk["modules"].items() if r["unresolved"]} == {}


def test_top_level_verify_is_the_function_after_the_submodule(walk):
    """The submodules first (the walk imported them): ``repro_torch.verify``
    is the function, and ``repro_torch.core``'s ``plan`` / ``spmv`` the
    submodules, as in the other order below."""
    assert walk["verify_is_function"] and walk["finding"] and walk["core_submodules"]


_ORDER = r"""
import json, sys
import repro_torch
fresh = not any(m in sys.modules for m in (
    "repro_torch.analysis.verify", "repro_torch.core.plan", "repro_torch.core.spmv"))
from repro_torch.core import plan, spmv       # the package's names first
fn = repro_torch.verify                       # the lazy export first
import repro_torch.analysis.verify as mod     # then the submodules
import repro_torch.core.spmv as spmv_mod
from repro_torch import core
print(json.dumps({
    "fresh": fresh,
    "verify": fn is mod.verify and repro_torch.verify is mod.verify,
    "core_submodules": plan is sys.modules["repro_torch.core.plan"]
                       and spmv is spmv_mod and core.spmv is spmv_mod,
    "core_exports": all(getattr(core, n) is getattr(
        __import__(core._EXPORTS[n], fromlist=[n]), n) for n in core._EXPORTS),
    "functions": repro_torch.plan is sys.modules["repro_torch.core.plan"].plan
                 and repro_torch.spmv is spmv_mod.spmv,
}))
"""


def test_verify_and_core_names_in_the_other_order():
    """The export first, then the submodules: ``repro_torch.verify`` is the
    function either way; in ``repro_torch.core`` the names ``plan`` and
    ``spmv`` are the submodules either way (the functions are
    ``repro_torch.plan`` and ``repro_torch.spmv``)."""
    assert _run(["-c", _ORDER], timeout=120) == {
        "fresh": True, "verify": True, "core_submodules": True, "core_exports": True,
        "functions": True}


_HOST = r"""
import importlib, json, sys
out = {}
for name in ("formats", "scheduler", "load_balance", "bounds", "baselines",
             "hardware_model"):
    importlib.import_module("repro_torch.core." + name)
    out[name] = "torch" in sys.modules
import repro_torch.core
out["core_package"] = "torch" in sys.modules
print(json.dumps(out))
"""


def test_host_modules_of_core_load_without_torch():
    loaded = _run(["-c", _HOST], timeout=120)
    assert not any(loaded.values()), loaded
