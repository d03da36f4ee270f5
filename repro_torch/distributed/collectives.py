"""Collectives over a ``torch.distributed`` process group (counterpart of
``repro.distributed.collectives``):

  * :func:`ring_all_reduce` — reduce-scatter then all-gather in ``k-1``
    hops each, every hop a ``batch_isend_irecv`` to the next rank of the
    group: the reference's chunking, padding and hop order, so the sums
    are added in its order.
  * :func:`bucketed` / :func:`unbucketed` — many small gradient tensors
    fused into a few float32 buckets and back (tensor code only).
  * :func:`compressed_psum` — int8 quantization with error feedback
    around an ``all_reduce`` of the dequantized payload.
  * :func:`all_reduce_sum`, :func:`all_reduce_max`, :func:`all_gather_dim`,
    :func:`reduce_scatter_dim` — the sum, the elementwise max, the
    concatenation along a dim and the summed chunk along a dim over a
    group, as new tensors: the payloads of the tensor- and
    fully-sharded-parallel collectives (``tensor_parallel.py``).

``group`` is a process group (a mesh dim's: ``mesh.get_group(axis)``),
or None for the default group.

**Transport.**  Each collective is written once, for every backend, and
never asks where a tensor lies.  The backend decides only two things:
gloo's point-to-point ops take no CUDA tensor (its TCP transport writes
from the tensor's address: "Bad address" on torch 2.11 + CUDA 12.8,
while its ``all_reduce``, ``all_gather`` and ``reduce_scatter`` take CUDA
tensors), so on gloo a ring hop goes through a host copy
(:data:`HOST_STAGED`); and the ``fake`` backend (the dry-run account's
shape-only ranks) moves nothing, so a hop there is an empty tensor of the
hop's shape.  :data:`traffic` counts, per collective, the calls and the
bytes this rank sends (a ring's ``2(k-1)/k`` of the payload for a sum,
``(k-1)/k`` for a gather or a scatter).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["ring_all_reduce", "bucketed", "unbucketed", "compressed_psum",
           "all_reduce_sum", "all_reduce_max", "all_gather_dim", "reduce_scatter_dim", "traffic",
           "reset_traffic", "HOST_STAGED"]

#: Backend -> the collectives that go through a host copy on it.
HOST_STAGED = {"gloo": ("send_recv",)}

#: Per collective: ``calls`` and ``bytes`` (sent by this rank).
traffic: Dict[str, Dict[str, int]] = {}


def reset_traffic() -> None:
    traffic.clear()


def _count(op: str, nbytes: float) -> None:
    row = traffic.setdefault(op, {"calls": 0, "bytes": 0})
    row["calls"] += 1
    row["bytes"] += int(nbytes)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _ring_hop(x: torch.Tensor, group, ranks, idx: int) -> torch.Tensor:
    """Send ``x`` to the next rank of the ring, return the previous one's
    (through the host where the backend stages point-to-point ops)."""
    k = len(ranks)
    backend = dist.get_backend(group)
    _count("send_recv", _nbytes(x))
    if backend == "fake":  # shape-only ranks: nothing moves
        return torch.empty_like(x)
    staged = "send_recv" in HOST_STAGED.get(backend, ())
    send = x.to("cpu", copy=True) if staged else x.contiguous()
    out = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[(idx + 1) % k], group=group),
           dist.P2POp(dist.irecv, out, ranks[(idx - 1) % k], group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device) if staged else out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, a new tensor."""
    k = dist.get_world_size(group)
    out = x.contiguous().clone()
    if k > 1:
        _count("all_reduce", 2 * (k - 1) / k * _nbytes(out))
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group's ranks, a new tensor
    (counted as an ``all_reduce``)."""
    k = dist.get_world_size(group)
    out = x.detach().contiguous().clone()
    if k > 1:
        _count("all_reduce", 2 * (k - 1) / k * _nbytes(out))
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order."""
    k = dist.get_world_size(group)
    if k == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(k)]
    _count("all_gather", (k - 1) * _nbytes(x))
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` (``k`` equal chunks in group-rank
    order) of the sum of ``x`` over the group's ranks."""
    k = dist.get_world_size(group)
    if k == 1:
        return x
    chunks = [c.contiguous() for c in x.chunk(k, dim)]
    out = torch.empty_like(chunks[0])
    _count("reduce_scatter", (k - 1) / k * _nbytes(x))
    dist.reduce_scatter(out, chunks, op=dist.ReduceOp.SUM, group=group)
    return out


def ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, as a ring: after ``k-1``
    reduce-scatter hops rank ``i`` holds the reduced chunk ``(i+1) % k``,
    then ``k-1`` all-gather hops circulate the reduced chunks.  ``x`` is
    padded along dim 0 to a multiple of ``k``."""
    k = dist.get_world_size(group)
    if k == 1:
        return x
    ranks = dist.get_process_group_ranks(group) if group is not None else list(range(k))
    idx = ranks.index(dist.get_rank())
    n = x.shape[0]
    pad = (-n) % k
    xp = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) if pad else x
    chunks = xp.reshape((k, (n + pad) // k) + tuple(x.shape[1:]))

    # reduce-scatter: partial sums travel; after k-1 hops this rank holds
    # the fully reduced chunk (idx + 1) % k
    travelling = chunks[idx]
    for i in range(k - 1):
        travelling = _ring_hop(travelling, group, ranks, idx)
        travelling = travelling + chunks[(idx - i - 1) % k]

    # all-gather: circulate the reduced chunks
    gathered = torch.zeros_like(chunks)
    gathered[(idx + 1) % k] = travelling
    block = travelling
    for t in range(1, k):
        block = _ring_hop(block, group, ranks, idx)
        gathered[(idx - t + 1) % k] = block
    return gathered.reshape((-1,) + tuple(x.shape[1:]))[:n]


def bucketed(tensors: Sequence[torch.Tensor], bucket_bytes: int = 1 << 24):
    """Flatten and concatenate ``tensors`` (as float32) into buckets of
    about ``bucket_bytes``.  Returns (buckets, spec); ``spec`` rebuilds
    the originals through :func:`unbucketed`."""
    spec = [(tuple(t.shape), t.dtype, t.numel()) for t in tensors]
    buckets: List[torch.Tensor] = []
    cur: List[torch.Tensor] = []
    cur_bytes = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(torch.cat([c.reshape(-1).float() for c in cur]))
            cur, cur_bytes = [], 0
        cur.append(t)
        cur_bytes += nbytes
    if cur:
        buckets.append(torch.cat([c.reshape(-1).float() for c in cur]))
    return buckets, spec


def unbucketed(buckets: Sequence[torch.Tensor], spec) -> List[torch.Tensor]:
    flat = torch.cat(list(buckets)) if len(buckets) > 1 else buckets[0]
    out, off = [], 0
    for shape, dtype, size in spec:
        out.append(flat[off:off + size].reshape(shape).to(dtype))
        off += size
    return out


def compressed_psum(x: torch.Tensor, residual: torch.Tensor, group=None,
                    bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 + error-feedback sum: quantize ``x + residual`` locally (one
    float32 scale per tensor, as ``training.compression`` does), sum the
    dequantized payload over the group, and return (sum, new residual)."""
    from ..training.compression import _quant

    val = x.float() + residual
    _, _, deq = _quant(val, bits)
    new_residual = val - deq
    k = dist.get_world_size(group)
    _count("all_reduce", 2 * (k - 1) / k * _nbytes(deq))
    dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
    return deq, new_residual
