"""Port parity of the sharding rules (``repro_torch.distributed.sharding``)
and the production mesh (``repro_torch.launch.mesh``).

``param_specs`` (train and serve) and ``cache_shardings`` (the serving
shapes of ``SHAPES``) equal the reference's spec for spec, keyed by leaf
path, for every arch of ``ARCH_IDS``: on a (2, 4) mesh in an 8-device
subprocess, and on the production (16, 16) and (2, 16, 16) meshes in one
512-device subprocess, all on ``jax.eval_shape`` trees (no allocation);
the port reads the same meshes as ``MeshLayout``s and its trees on the
meta device.  ``mesh_shape`` and ``require_devices`` behave as
``tests/test_launch.py`` pins the reference's.
"""

import json

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.distributed.sharding import MeshLayout, dp_axes, param_specs
from repro_torch.launch.mesh import make_production_mesh, mesh_shape, require_devices
from repro_torch.models.model_zoo import build_model
from repro_torch.serving.kv_cache import cache_shardings

from conftest import run_spmd_subprocess

CACHE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

_REFERENCE = """
import json
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs.base import ARCH_IDS, SHAPES, get_arch
from repro.distributed.sharding import _path_str, param_specs
from repro.models.model_zoo import build_model
from repro.serving.kv_cache import cache_shardings

def keyed(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {_path_str(p): [list(e) if isinstance(e, tuple) else e for e in s.spec]
            for p, s in flat}

out = {}
devs = np.array(jax.devices())
for name, (shape, axes) in MESHES.items():
    mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), axes)
    for arch in ARCH_IDS:
        lm = build_model(get_arch(arch))
        params = jax.eval_shape(lambda: lm.init(jax.random.PRNGKey(0)))
        for mode in ("train", "serve"):
            out[f"{name}/{arch}/params/{mode}"] = keyed(param_specs(params, mesh, mode=mode))
        for s in CACHE_SHAPES:
            sh = SHAPES[s]
            out[f"{name}/{arch}/caches/{s}"] = keyed(
                cache_shardings(lm, mesh, sh.global_batch, sh.seq_len))
print(json.dumps(out))
"""


def _reference(meshes, devices):
    code = (f"MESHES = {meshes!r}\nCACHE_SHAPES = {CACHE_SHAPES!r}\n" + _REFERENCE)
    out = run_spmd_subprocess(code, devices=devices, timeout=300)
    return json.loads(out.strip().splitlines()[-1])


def _keyed(tree, path=()):
    """'/'-joined leaf path -> spec as JSON gives the reference's."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _keyed(sub, path + (str(key),)).items()}
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                  and isinstance(tree[0], (dict, list))):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _keyed(sub, path + (str(i),)).items()}
    return {"/".join(path): [list(e) if isinstance(e, tuple) else e for e in tree]}


def _check(ref, names):
    for name in names:
        mesh = MeshLayout(*MESHES[name])
        for arch in ARCH_IDS:
            lm = build_model(get_arch(arch))
            params = lm.init(None)
            for mode in ("train", "serve"):
                got = _keyed(param_specs(params, mesh, mode=mode))
                assert got == ref[f"{name}/{arch}/params/{mode}"], (name, arch, mode)
            for s in CACHE_SHAPES:
                sh = SHAPES[s]
                got = _keyed(cache_shardings(lm, mesh, sh.global_batch, sh.seq_len))
                assert got == ref[f"{name}/{arch}/caches/{s}"], (name, arch, s)


def test_specs_equal_reference_on_2x4():
    meshes = {"2x4": MESHES["2x4"]}
    _check(_reference(meshes, 8), meshes)


def test_specs_equal_reference_on_production_meshes():
    meshes = {k: MESHES[k] for k in ("16x16", "2x16x16")}
    _check(_reference(meshes, 512), meshes)


def test_mesh_shapes_and_device_rule():
    assert mesh_shape(False) == ((16, 16), ("data", "model"))
    assert mesh_shape(True) == ((2, 16, 16), ("pod", "data", "model"))
    assert dp_axes(MeshLayout(*mesh_shape(True))) == ("pod", "data")
    assert dp_axes(MeshLayout(*mesh_shape(False))) == ("data",)
    have = torch.cuda.device_count()
    assert require_devices(have) == have
    with pytest.raises(RuntimeError, match="need 256 devices"):
        require_devices(256)
    with pytest.raises(RuntimeError, match="need 512 devices"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError):
        MeshLayout((2, 4), ("data",))
