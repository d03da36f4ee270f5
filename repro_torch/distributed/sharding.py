"""Sharding rules: DP / FSDP / TP / EP / SP per architecture and shape.

Counterpart of ``repro.distributed.sharding``, rule for rule.  The mesh
is ``(data, model)`` single-pod or ``(pod, data, model)`` multi-pod
(``launch/mesh.py``).  Axis roles:

  * batch          -> ("pod", "data")   (pure DP)
  * parameters     -> a TP dim over "model" plus an FSDP dim over "data"
                      wherever divisibility allows
  * attention TP   -> query/output heads over "model" when the head count
                      divides the axis, else FSDP only
  * MoE            -> experts over "model" (EP)
  * KV cache       -> batch over DP axes, the cache length over "model"

A spec is a tuple with one entry per dim: an axis name, a tuple of axis
names, or None (the reference's ``PartitionSpec`` entries; a leaf the
reference gives ``P()`` gets ``()``, replicated; a one-name tuple is
written as the name, as ``PartitionSpec`` writes it).  Every function takes
a mesh as a ``torch.distributed.device_mesh.DeviceMesh`` (read through
``mesh_dim_names`` and ``shape``) or as a :class:`MeshLayout`, which
names a mesh of any size without its processes (the dry-run account
reasons about 256 and 512 devices from one host).

The reference's activation hints (``activation_ctx``, ``constrain_*``)
tell XLA's partitioner how to lay out intermediates; eager PyTorch has
no partitioner, so they are not ported (ROADMAP §3, departures).  The
port executes every placement of :func:`param_specs` in the train step:
the batch over the DP axes (``training.train_loop``), and on a sharded
state (``train_loop.shard_train_state``) the "model" dims as tensor and
expert parallelism inside the blocks and the "data" dims as FSDP
(``distributed/tensor_parallel.py``); the dry-run account runs that step
on meta shards.  Serving executes the ``mode="serve"`` placements and the
cache rule the same way (``serving.shard_serve_state``: the batch over the
DP axes, heads, experts and the vocabulary over "model", the cache length
over "model" flash-decode style, the large serve leaves over "data").
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, Tuple

__all__ = [
    "MeshLayout",
    "mesh_sizes",
    "mesh_axis_names",
    "dp_axes",
    "dp_entry",
    "dp_size",
    "tp_axis",
    "param_specs",
    "batch_specs",
    "cache_spec_overrides",
    "map_with_path",
    "local_shape",
    "tree_bytes_per_device",
]


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's shape and axis names, without devices or processes."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axis names {self.axis_names} "
                             "differ in length")


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, MeshLayout):
        return tuple(mesh.axis_names)
    return tuple(mesh.mesh_dim_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size."""
    return dict(zip(mesh_axis_names(mesh), (int(s) for s in mesh.shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: ("pod", "data") if multi-pod else ("data",)."""
    return tuple(a for a in mesh_axis_names(mesh) if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"


def dp_size(mesh) -> int:
    """The product of the DP axes' sizes."""
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def dp_entry(mesh):
    """The DP axes as one spec entry: the name alone when there is one
    (``PartitionSpec``'s canonical form), else the tuple of names."""
    dp = dp_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


# ---------------------------------------------------------------------------
# Parameter sharding
# ---------------------------------------------------------------------------


def _divis(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _leaf_spec(path: str, shape, tp: int, fsdp: int, mode: str) -> Tuple:
    """The spec of one parameter leaf.  ``path`` is the '/'-joined key
    path; divisibility decides whether a dim actually takes an axis."""
    nd = len(shape)
    spec = [None] * nd
    name = path.rsplit("/", 1)[-1]

    def take(dim: int, axis: str, size: int) -> bool:
        if spec[dim] is None and _divis(shape[dim], size):
            spec[dim] = axis
            return True
        return False

    def fsdp_any(exclude=()):
        # FSDP: shard the largest remaining dim over "data"
        if mode != "train" and math.prod(shape) * 4 < (1 << 22):
            return  # small serving weights stay replicated over data
        for dim in sorted(range(nd), key=lambda i: -shape[i]):
            if dim not in exclude and take(dim, "data", fsdp):
                return

    if nd == 1:
        return (None,)

    if name == "table":  # embedding (V, d): vocab over model only
        take(0, "model", tp)
    elif name == "wq" and nd == 3:  # (d, H, dh): column-parallel
        take(1, "model", tp)
        fsdp_any(exclude=(1,))
    elif name in ("wk", "wv") and nd == 3:  # (d, KV, dh)
        take(1, "model", tp)
        fsdp_any(exclude=(1,))
    elif name == "wo" and nd == 3:  # (H, dh, d): row-parallel
        take(0, "model", tp)
        fsdp_any(exclude=(0,))
    elif name in ("w_gate", "w_up") and nd == 3:  # MoE (E, d, f): EP
        take(0, "model", tp)
        fsdp_any(exclude=(0,))
    elif name == "w_down" and nd == 3:  # MoE (E, f, d)
        take(0, "model", tp)
        fsdp_any(exclude=(0,))
    elif name in ("w_gate", "w_up", "w_up_gate") and nd == 2:  # (d, f)
        take(1, "model", tp)
        fsdp_any(exclude=(1,))
    elif name == "w_down" and nd == 2:  # (f, d)
        take(0, "model", tp)
        fsdp_any(exclude=(0,))
    elif name == "router":  # (d, E), replicated over model
        fsdp_any()
    elif name in ("w_x", "w_gate_branch"):  # RG-LRU in-projections (d, w)
        take(1, "model", tp)
        fsdp_any(exclude=(1,))
    elif name in ("w_rgate", "w_igate"):  # (w, w)
        take(1, "model", tp)
        fsdp_any(exclude=(1,))
    elif name == "w_out":  # (w, d)
        take(0, "model", tp)
        fsdp_any(exclude=(0,))
    elif name in ("w_up", "w_ogate") and nd == 2:  # mLSTM (d, di)
        take(1, "model", tp)
        fsdp_any(exclude=(1,))
    elif name in ("wq", "wk", "wv") and nd == 2:  # mLSTM (di, di)
        take(1, "model", tp)
        fsdp_any(exclude=(1,))
    elif name == "w_if":  # (di, 2h)
        fsdp_any()
    elif name == "w_in" and nd == 3:  # sLSTM (d, 4, d)
        take(2, "model", tp)
        fsdp_any(exclude=(2,))
    elif name == "r" and nd == 4:  # sLSTM recurrent (4, h, dh, dh)
        take(1, "model", tp)
    elif name == "conv":  # (W, width)
        take(1, "model", tp)
    else:
        fsdp_any()
    return tuple(spec)


def map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """``fn('/'-joined path, leaf)`` over ``tree``'s leaves (dict keys,
    list and tuple positions, as the reference's ``_path_str`` joins
    them), keeping its nesting: how a ``spec_of`` such as
    :func:`cache_spec_overrides`' is applied to a tree."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def param_specs(params, mesh, mode: str = "train"):
    """A tree of specs matching ``params`` (tensors of any device, the
    meta device included); the leaves of the stacked ``reps`` get a
    leading None."""
    sizes = mesh_sizes(mesh)
    tp, fsdp = sizes.get("model", 1), sizes.get("data", 1)

    def spec_of(ps, leaf):
        shape = tuple(leaf.shape)
        stacked = "/reps/" in f"/{ps}/" or re.search(r"(^|/)reps(/|$)", ps)
        if stacked and len(shape) >= 2:
            return (None,) + _leaf_spec(ps, shape[1:], tp, fsdp, mode)
        return _leaf_spec(ps, shape, tp, fsdp, mode)

    return map_with_path(spec_of, params)


# ---------------------------------------------------------------------------
# Batch / cache sharding
# ---------------------------------------------------------------------------


def batch_specs(mesh, *, seq_sharded: bool = False) -> Tuple:
    """The spec of (B, S[, d]) batch inputs: batch over the DP axes,
    optionally the sequence over "model"."""
    return (dp_entry(mesh), "model" if seq_sharded else None)


def cache_spec_overrides(mesh, batch: int) -> Callable:
    """``spec_of(path, leaf)`` for KV-cache leaves (B, c, KV, dh) and
    recurrent states: batch over DP where divisible, the cache length
    over "model" where divisible."""
    bspec = dp_entry(mesh) if batch % max(dp_size(mesh), 1) == 0 else None
    tp = mesh_sizes(mesh).get("model", 1)

    def spec_of(ps: str, leaf) -> Tuple:
        shape = tuple(leaf.shape)
        nd = len(shape)
        name = ps.rsplit("/", 1)[-1]
        if name == "pos":
            return ()
        # cache leaves are (B, ...) for tail blocks and (R, B, ...) for the
        # stacked rep caches
        b_dim = 1 if "/reps/" in f"/{ps}/" else 0
        if nd <= b_dim or shape[b_dim] != batch:
            return (None,) * nd
        spec = [None] * nd
        spec[b_dim] = bspec
        if name in ("k", "v", "ck", "cv") and nd >= b_dim + 4:
            if shape[b_dim + 1] % tp == 0:
                spec[b_dim + 1] = "model"
        return tuple(spec)

    return spec_of


# ---------------------------------------------------------------------------
# Per-device sizes
# ---------------------------------------------------------------------------


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """One device's shard of a leaf of ``shape`` under ``spec``: each dim
    divided (rounding up) by the product of its axes' sizes; dims past
    the spec's length are whole."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, n in enumerate(shape):
        axes = spec[dim] if dim < len(spec) else None
        if axes is None:
            out.append(int(n))
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        k = math.prod(sizes[a] for a in axes)
        out.append(-(-int(n) // k))
    return tuple(out)


def tree_bytes_per_device(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors of any device, meta
    included) laid out by ``specs``, a spec tree of ``tree``'s nesting
    (walked alongside ``tree``, so a spec's own tuple is never taken for
    a container)."""
    if isinstance(tree, dict):
        return sum(tree_bytes_per_device(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes_per_device(v, s, mesh) for v, s in zip(tree, specs))
    return math.prod(local_shape(tree.shape, specs, mesh)) * tree.element_size()
