"""Checkpoints in the reference's layout (counterpart of
``repro.training.checkpoint``), so that a checkpoint written by either
package restores in the other bit for bit.

Layout (one directory per step):

    ckpt_dir/step_000000123/
        manifest.json       — step, leaf count, each leaf's shape and dtype, extra
        arrays/<idx>.npy    — one file per leaf, host copies
        COMMIT              — written last; a directory without it is ignored

Leaves are numbered in ``jax.tree_util.tree_flatten``'s order (dict keys
sorted, lists and tuples in order: ``tree_flatten_sorted``), which is not
the insertion order the rest of the port walks.  The directory is written
under a temporary name and renamed into place.  A checkpoint holds no
device: ``restore_checkpoint`` puts every leaf on the device it is asked
for, so a run saved on the card resumes on the CPU and the reverse.

A sharded train state (``train_loop.ShardedTrainState``) saves in the
same layout: every rank takes part in gathering each leaf whole, one leaf
at a time, and global rank 0 writes it; the ranks then meet at a barrier,
so none reads the directory before it is committed.  Restoring into a
sharded ``like`` cuts each rank's shards from the whole leaves, so a
checkpoint written by either package, sharded or not, resumes on any
mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.packing import resolve_device
from ..distributed.sharding import local_shape
from ..distributed.tensor_parallel import gather_tree, mesh_axes, shard_tree
from ..models.tree import tree_flatten_sorted, tree_map, tree_unflatten_sorted
from .train_loop import ShardedTrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "list_steps"]


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def _structure(tree) -> str:
    """A readable outline of the tree (the manifest's ``treedef``; restore
    reads only the leaf count and shapes)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(t) for t in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


class _Spec:
    """A leaf's spec as a leaf (a spec's own tuple is not a container)."""

    def __init__(self, spec):
        self.spec = spec


def _sorted_specs(state: ShardedTrainState):
    """The state's leaf specs in ``tree_flatten_sorted`` order."""
    wrapped = tree_map(lambda _, s: _Spec(s), state, state.state_specs())
    return [w.spec for w in tree_flatten_sorted(wrapped)]


def save_checkpoint(ckpt_dir: str, step: int, state, extra: Optional[Dict] = None):
    """Copy every leaf to the host and write the step's directory
    atomically (temporary directory, rename, COMMIT marker).  Returns the
    directory.  A sharded state is gathered leaf by leaf and written by
    global rank 0 (module docstring); every rank of its mesh calls this."""
    leaves = tree_flatten_sorted(state)
    if isinstance(state, ShardedTrainState):
        axes = mesh_axes(state.mesh)
        leaves = (gather_tree(leaf, spec, axes)
                  for leaf, spec in zip(leaves, _sorted_specs(state)))
        if dist.get_rank() != 0:
            for _ in leaves:  # each gather is a collective
                pass
            dist.barrier()
            return _step_dir(ckpt_dir, step)
    final = _write(ckpt_dir, step, state, leaves, extra)
    if isinstance(state, ShardedTrainState):
        dist.barrier()
    return final


def _write(ckpt_dir: str, step: int, state, leaves, extra):
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_ckpt_")
    arrays_dir = os.path.join(tmp, "arrays")
    os.makedirs(arrays_dir)
    manifest = {
        "step": step,
        "treedef": _structure(state),
        "n_leaves": len(tree_flatten_sorted(state)),
        "leaves": [],
        "extra": extra or {},
    }
    for i, leaf in enumerate(leaves):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else \
            np.asarray(leaf)
        np.save(os.path.join(arrays_dir, f"{i}.npy"), arr)
        manifest["leaves"].append({"idx": i, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_steps(ckpt_dir: str) -> List[int]:
    """Committed checkpoint steps, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like, device="cuda") -> Tuple[Any, Dict]:
    """(the tree of ``like``'s structure with the checkpoint's leaves on
    ``device``, the manifest's ``extra``).  ``like``'s leaves give only
    shapes (meta tensors do); each leaf keeps the dtype and bits it was
    saved with.  A leaf count or a shape that differs raises
    ``ValueError``.  A sharded ``like`` gets this rank's shards of each
    leaf, a ``ShardedTrainState`` of its specs and mesh."""
    device = resolve_device(device)
    d = _step_dir(ckpt_dir, step)
    if not os.path.exists(os.path.join(d, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = tree_flatten_sorted(like)
    if manifest["n_leaves"] != len(like_leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, expected "
                         f"{len(like_leaves)} — structure mismatch")
    sharded = isinstance(like, ShardedTrainState)
    if sharded:
        axes, specs = mesh_axes(like.mesh), _sorted_specs(like)
    out = []
    for i, ref in enumerate(like_leaves):
        arr = np.load(os.path.join(d, "arrays", f"{i}.npy"))
        shape = local_shape(arr.shape, specs[i], like.mesh) if sharded else tuple(arr.shape)
        if shape != tuple(ref.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != expected "
                             f"{tuple(ref.shape)}")
        leaf = torch.from_numpy(arr)
        out.append((shard_tree(leaf, specs[i], axes) if sharded else leaf).to(device))
    tree = tree_unflatten_sorted(like, out)
    if sharded:
        tree = ShardedTrainState(tree, like.specs, like.mesh)
    return tree, manifest["extra"]
