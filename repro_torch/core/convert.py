"""Carry a packed artifact across from the reference.

The system has no weights: the packed color-block stream is its state.
``repro.core.packing.packed_leaves`` / ``ragged_leaves`` (as numpy arrays)
plus the meta tuple are the reference's wire format, and
:func:`from_reference_leaves` turns them into the port's artifact on a
device, bit for bit — so the two packages can run one artifact.
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

__all__ = ["from_reference_leaves", "to_numpy_leaves"]


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
