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

``group`` is a process group (a mesh dim's: ``mesh.get_group(axis)``),
or None for the default group.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["ring_all_reduce", "bucketed", "unbucketed", "compressed_psum"]


def _ring_hop(x: torch.Tensor, group, ranks, idx: int) -> torch.Tensor:
    """Send ``x`` to the next rank of the ring, return the previous one's."""
    k = len(ranks)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[(idx + 1) % k], group=group),
           dist.P2POp(dist.irecv, out, ranks[(idx - 1) % k], group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
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
    dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
    return deq, new_residual
