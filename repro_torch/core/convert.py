"""Carry a packed artifact, or a model's parameters, across from the
reference.

The packed color-block stream is the state of a plan:
``repro.core.packing.packed_leaves`` / ``ragged_leaves`` (as numpy arrays)
plus the meta tuple are the reference's wire format, and
:func:`from_reference_leaves` turns them into the port's artifact on a
device, bit for bit — so the two packages can run one artifact.

A model's parameters are the reference's pytree; ``jax.random`` cannot
be reproduced in torch, so :func:`from_reference_params` takes the tree
as numpy arrays (``jax.tree.map(np.asarray, lm.init(key))``) and returns
the port's tree, name for name and bit for bit;
:func:`from_reference_train_state` does the same for a training state
(params, AdamW's m, v and step, the compression residual), and
:func:`train_state_to_numpy` carries one back.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from .packing import (
    PackedSchedule,
    RaggedSchedule,
    packed_from_leaves,
    ragged_from_leaves,
    resolve_device,
)

__all__ = ["from_reference_leaves", "from_reference_params", "to_numpy_leaves",
           "from_reference_train_state", "train_state_to_numpy"]


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr, order="C")  # a writable host copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def from_reference_leaves(
    leaves: Dict[str, np.ndarray], meta: Tuple, device="cuda"
) -> Union[PackedSchedule, RaggedSchedule]:
    """The port's artifact from the reference's leaves and meta tuple.
    Leaf dtypes are kept as they are (bf16, int16 and int8 included)."""
    device = resolve_device(device)
    tensors = {k: _to_tensor(v, device) for k, v in leaves.items()}
    if meta and meta[0] == "ragged":
        return ragged_from_leaves(tensors, meta)
    return packed_from_leaves(tensors, meta)


def from_reference_params(params, cfg, device="cuda"):
    """The port's parameter tree for ``repro_torch.models.model_zoo.LM(cfg)``
    from the reference's (numpy leaves, the reference's nesting).  Every
    leaf keeps its dtype and bits; a tree whose names, shapes or dtypes
    differ from what ``LM(cfg).init`` makes raises ``ValueError``."""
    from ..models.model_zoo import LM
    from ..models.tree import tree_map

    device = resolve_device(device)
    want = LM(cfg).init(None)

    def check(path, got, spec):
        if isinstance(spec, dict):
            if not isinstance(got, dict) or set(got) != set(spec):
                raise ValueError(f"{path or 'params'}: expected the keys {sorted(spec)}")
            for k in spec:
                check(f"{path}/{k}", got[k], spec[k])
        elif isinstance(spec, (list, tuple)):
            if not isinstance(got, (list, tuple)) or len(got) != len(spec):
                raise ValueError(f"{path}: expected {len(spec)} entries")
            for i, (g, s) in enumerate(zip(got, spec)):
                check(f"{path}/{i}", g, s)
        else:
            arr = np.asarray(got)
            if tuple(arr.shape) != tuple(spec.shape) or arr.dtype.name != str(
                    spec.dtype).replace("torch.", ""):
                raise ValueError(f"{path}: {arr.dtype.name}{tuple(arr.shape)} != "
                                 f"{spec.dtype}{tuple(spec.shape)}")

    check("", params, want)
    return tree_map(lambda s, a: _to_tensor(np.asarray(a), device), want, params)


def to_numpy_leaves(leaves: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host copies of tensor leaves; bf16 leaves come back as their int16
    bit patterns (numpy has no bfloat16)."""
    out = {}
    for k, t in leaves.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[k] = t.numpy()
    return out


def from_reference_train_state(state, cfg, device="cuda"):
    """The port's train state from the reference's, as numpy leaves:
    ``params``, ``opt.m``, ``opt.v`` and ``residual`` (when present) each
    through :func:`from_reference_params`, ``opt.step`` an int32 scalar.
    Bits are kept."""
    device = resolve_device(device)
    opt = state["opt"]
    out = {"params": from_reference_params(state["params"], cfg, device),
           "opt": {"m": from_reference_params(opt["m"], cfg, device),
                   "v": from_reference_params(opt["v"], cfg, device),
                   "step": _to_tensor(np.asarray(opt["step"], dtype=np.int32), device)}}
    if "residual" in state:
        out["residual"] = from_reference_params(state["residual"], cfg, device)
    return out


def train_state_to_numpy(state):
    """Host numpy copies of every leaf of a port tree (a train state, a
    parameter tree), nesting kept: the inverse of
    :func:`from_reference_train_state` for float32 and integer leaves."""
    from ..models.tree import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), state)
