"""The dry-run account: per-device bytes and a step's cost, from trees on
the meta device.

Counterpart of what ``repro.launch.dryrun`` reads off XLA (``lower`` +
``compile``: ``memory_analysis``, the loop-aware HLO analysis of
``hlo_analysis.py`` and its roofline).  Eager PyTorch compiles nothing,
so the account is built from the port's own pieces:

* **Bytes per device, exact.**  The parameter, optimizer, cache, input
  and GUST-stream trees are built on the meta device and laid out by the
  sharding rules (``distributed.sharding``): each leaf's bytes are its
  per-device shard's (:func:`~repro_torch.distributed.sharding.tree_bytes_per_device`).
* **The step's cost.**  The step itself runs on meta tensors under
  ``torch.utils.flop_counter.FlopCounterMode`` (matmul FLOPs) and
  :class:`LiveBytes` (the peak of the bytes its outputs hold while they
  live).  A train cell runs rank 0's sharded step
  (``make_train_step(lm, cfg, mesh)`` on a ``ShardedTrainState`` of meta
  shards at their local shapes) over a ``DeviceMesh`` of the cell's
  layout on torch's ``fake`` process-group backend (:func:`fake_mesh`:
  every collective returns at once and moves nothing), one microbatch of
  it (its FLOPs and per-microbatch traffic times their number): tensor,
  expert and fully-sharded parallelism are divided as the port executes
  them, the FSDP gathers counted among the temporaries.  A serving cell
  runs rank 0's sharded prefill or decode step the same way (``LM.prefill``,
  ``LM.decode_step``, ``decode_step_gust`` with the placement of
  ``serving.serve_placement`` over meta shards of the parameters and
  caches at their local shapes, the whole batch given, rank 0's rows
  run): attention over its heads and, flash-decode style, its positions
  of the cache, the MoE's experts, the vocabulary, and the large serve
  leaves' "data" gathers, each collective's bytes counted.  Shape-only
  stand-ins: the recurrent
  mixers' host time loops run as one step over every step's rows at once
  (:func:`time_loops_at_once`: one step's count scaled by the length),
  and a GUST product (whose kernel reads real data) is reckoned by hand
  at ``2 · streamed slots · B`` FLOPs.  Not counted: what the runtime
  allocates beside the step's tensors, chiefly cuBLAS's workspace (32
  MiB for each thread and stream that runs a product, under
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8``; a serving process holds one), and
  a collective backend's own staging buffers.
* **Roofline terms** against an NVIDIA H100 SXM (:data:`H100`): compute
  at the dense bf16 (or f32) peak, memory as every argument byte read
  once at the HBM rate, and the collective term from the bytes rank 0
  sends (``collectives.traffic`` of the step on the fake ranks: the TP
  sums and gathers, the FSDP gathers and reduce-scatters, the
  data-parallel ring, the flash decode's partial softmax), at NVLink's
  rate.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..distributed import collectives
from ..distributed.sharding import (
    dp_entry,
    dp_size,
    local_shape,
    map_with_path,
    mesh_axis_names,
    mesh_sizes,
    param_specs,
    tree_bytes_per_device,
)
from ..models.tree import tree_leaves, tree_map
from ..serving.kv_cache import cache_tree_specs, serve_placement

__all__ = ["H100", "LiveBytes", "time_loops_at_once", "count_step", "roofline_terms", "batch_spec_tree",
           "cell_trees", "cell_specs", "account_cell", "memory_limit", "fake_mesh"]

#: NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU datasheet
#: (dense rates, without sparsity, at the 700 W power limit).
H100 = {
    "bf16_flop_per_s": 989e12,  # datasheet: BF16 Tensor Core, dense
    "f32_flop_per_s": 67e12,  # datasheet: FP32 (CUDA cores)
    "hbm_bytes_per_s": 3.35e12,  # datasheet: GPU memory bandwidth (HBM3)
    "nvlink_bytes_per_s": 450e9,  # datasheet: NVLink 900 GB/s, each direction half
    "memory_bytes": 80e9,  # datasheet: GPU memory 80 GB
}


class LiveBytes(TorchDispatchMode):
    """Peak bytes held by the outputs of the ops run under it.  Each
    output's storage is added once when an op makes it and taken off when
    the last tensor over it is freed (a tensor whose C++ side lives on, a
    saved activation, keeps its Python object).  Storages made before the
    mode (the step's arguments) are not counted, nor the views an op
    returns of them (a layer's slice of a stacked weight)."""

    def __init__(self):
        super().__init__()
        self.now = self.peak = 0
        self._refs: Dict[int, int] = {}
        self._bytes: Dict[int, int] = {}

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.now -= self._bytes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = {t.untyped_storage()._cdata for t in _pytree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in _pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                storage = t.untyped_storage()
                key = storage._cdata
                if key not in self._refs:
                    if key in inputs:  # a view of a storage made before the mode
                        continue
                    self._refs[key] = 0
                    self._bytes[key] = storage.nbytes()
                    self.now += storage.nbytes()
                self._refs[key] += 1
                weakref.finalize(t, self._release, key)
        self.peak = max(self.peak, self.now)
        return out


def _over_steps(a, n):
    """(B, ...) -> (B*n, ...): ``a`` repeated for each of n steps."""
    return a[:, None].expand(a.shape[0], n, *a.shape[1:]).reshape(-1, *a.shape[1:])


def _last_step(a, b):
    """(B*n, ...) -> (B, ...): the last step of each row."""
    return a.reshape(b, -1, *a.shape[1:])[:, -1]


@contextlib.contextmanager
def time_loops_at_once():
    """Shape-only stand-ins for the recurrent mixers' host time loops
    (``models/recurrent.py``: ``_mlstm_chunk_scan`` over chunks,
    ``_slstm_scan`` and ``_rglru_scan`` over time steps) while a step runs
    on meta tensors.  Those loops dispatch their ops once a step, about a
    millisecond an op on the meta device under the counters: an hour and
    more at 4k tokens.  Here the first step (chunk) runs as the loop runs
    it, on the carried state, and the others run as one step over all
    their rows at once, each row on the first step's new state: the
    loop's shapes, and one step's matmul FLOPs times the number of steps,
    forward and backward, the state's gradient where the loop has one:
    the loop's count, exactly.  The temporaries hold every step's tensors
    at once, as the loop's saved ones do.  The RG-LRU step is elementwise
    (no matmul FLOPs): its stand-in keeps the shapes and the autograd
    edges only.  Not for real tensors: their values would be wrong."""
    from ..models import recurrent as R

    mlstm, slstm, rglru = R._mlstm_chunk_scan, R._slstm_scan, R._rglru_scan

    def mlstm_at_once(q, k, v, i_pre, logf, state):
        b, nc = q.shape[:2]
        h0, first = mlstm(q[:, :1], k[:, :1], v[:, :1], i_pre[:, :1], logf[:, :1], state)
        if nc == 1:
            return h0, first

        def fold(a):
            return a[:, 1:].reshape(b * (nc - 1), 1, *a.shape[2:])

        hs, new = mlstm(fold(q), fold(k), fold(v), fold(i_pre), fold(logf),
                        tuple(_over_steps(z, nc - 1) for z in first))
        return (torch.cat([h0, hs.reshape(b, nc - 1, *hs.shape[2:])], dim=1),
                tuple(_last_step(z, b) for z in new))

    def slstm_at_once(p, xin, spec, state):
        b, s = xin.shape[:2]
        h0, first = slstm(p, xin[:, :1], spec, state)
        if s == 1:
            return h0, first
        new, h = R._slstm_cell(p, xin[:, 1:].reshape(b * (s - 1), *xin.shape[2:]),
                               {n: _over_steps(z, s - 1) for n, z in first.items()}, spec)
        return (torch.cat([h0, h.reshape(b, s - 1, -1)], dim=1),
                {n: _last_step(z, b) for n, z in new.items()})

    def rglru_at_once(a_seq, gated, h0):
        h_seq = gated + a_seq * h0[:, None]
        return h_seq, h_seq[:, -1]

    R._mlstm_chunk_scan, R._slstm_scan, R._rglru_scan = (
        mlstm_at_once, slstm_at_once, rglru_at_once)
    try:
        yield
    finally:
        R._mlstm_chunk_scan, R._slstm_scan, R._rglru_scan = mlstm, slstm, rglru


def count_step(fn: Callable, *args, **kwargs):
    """Run ``fn`` (on meta tensors) under both counters, the recurrent
    time loops at once (:func:`time_loops_at_once`); returns (its result,
    ``{"matmul_flops", "flops_by_op", "peak_temp_bytes"}``)."""
    flops = FlopCounterMode(display=False)
    live = LiveBytes()
    with time_loops_at_once(), flops, live:
        out = fn(*args, **kwargs)
    by_op = {str(op): int(n) for op, n in flops.get_flop_counts().get("Global", {}).items()}
    return out, {"matmul_flops": int(flops.get_total_flops()), "flops_by_op": by_op,
                 "peak_temp_bytes": int(live.peak)}


@contextlib.contextmanager
def fake_mesh(mesh):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names whose process
    group is torch's ``fake`` backend with this process as rank 0: a
    collective returns at once and moves nothing, so one process runs rank
    0's share of a step on meta tensors.  The default process group is
    made for the block and destroyed after; there must be none before."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the account's fake ranks need a process without a process group")
    shape = tuple(int(s) for s in mesh.shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=mesh_axis_names(mesh))
    finally:
        dist.destroy_process_group()


def memory_limit() -> Dict:
    """The per-device memory the account holds a cell to: the card's
    ``total_memory`` when a card is present, else the datasheet's 80 GB."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return {"bytes": int(props.total_memory), "source": f"total_memory of {props.name}"}
    return {"bytes": int(H100["memory_bytes"]), "source": "H100 datasheet, 80 GB (no card)"}


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   compute_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Per-device seconds of each roofline term against :data:`H100`."""
    peak = H100["bf16_flop_per_s"] if compute_dtype == torch.bfloat16 else H100["f32_flop_per_s"]
    terms = {
        "compute_s": flops / peak,
        "memory_s": hbm_bytes / H100["hbm_bytes_per_s"],
        "collective_s": collective_bytes / H100["nvlink_bytes_per_s"],
    }
    dominant = max(terms, key=terms.get).rsplit("_", 1)[0]
    return dict(terms, dominant=dominant,
                peak_flop_per_s=peak, hbm_bytes_per_s=H100["hbm_bytes_per_s"],
                nvlink_bytes_per_s=H100["nvlink_bytes_per_s"])


def batch_spec_tree(mesh, inputs: Dict) -> Dict:
    """The reference's ``_batch_sharding``: dim 0 over the DP axes when it
    divides, else replicated."""
    dp, k = dp_entry(mesh), dp_size(mesh)
    return {name: ((dp if x.shape and x.shape[0] % k == 0 else None),)
            + (None,) * (x.dim() - 1) for name, x in inputs.items()}


def _meta_shards(tree, specs, mesh):
    """Meta tensors of each leaf's ``local_shape`` under its spec."""
    return tree_map(lambda x, s: torch.empty(local_shape(x.shape, s, mesh), dtype=x.dtype,
                                             device="meta"), tree, specs)


def _nbytes(tree) -> int:
    return sum(x.element_size() * math.prod(x.shape) for x in tree_leaves(tree))


def _cast_float(tree, dtype):
    return tree_map(lambda x: torch.empty(x.shape, dtype=dtype if x.is_floating_point()
                                          else x.dtype, device="meta"), tree)


class _ShapeOnlyProduct:
    """Stand-in for one layer's GUST plan in a meta run: ``spmm`` returns
    the product's shape and reckons its FLOPs by hand (a multiply and an
    add per streamed slot and vector column) into ``counter``."""

    def __init__(self, m: int, slots: int, counter: Dict):
        self.m, self.slots, self.counter = m, slots, counter

    def spmm(self, x, *, transpose_io: bool = False):
        b = x.shape[0] if transpose_io else x.shape[1]
        self.counter["gust_flops"] += 2 * self.slots * b
        shape = (b, self.m) if transpose_io else (self.m, b)
        return torch.empty(shape, dtype=x.dtype, device="meta")


def cell_trees(lm, kind: str, batch: int, seq_len: int, *, param_dtype: torch.dtype,
               cache_dtype: torch.dtype = torch.bfloat16, gust_specs=None) -> Dict:
    """A cell's step arguments as meta trees, the reference's ``build_cell``
    arguments: ``params`` (floats in ``param_dtype``), then for ``train``
    the AdamW state ``optimizer`` (m, v, step) and the batch ``inputs``;
    for ``prefill`` / ``decode`` the ``caches`` and the ``inputs`` (a
    decode step's tokens and its scalar ``pos``); with ``gust_specs``
    (``serving.dryrun_specs``'s tree) the ``gust_stream`` leaves."""
    from ..training.optimizer import init_opt_state

    params = _cast_float(lm.init(None), param_dtype)
    trees = {"params": params}
    if kind == "train":
        trees["optimizer"] = init_opt_state(params)
    else:
        trees["caches"] = lm.init_caches(batch, seq_len, cache_dtype, device="meta")
    trees["inputs"] = lm.input_specs(seq_len, batch, kind)
    if kind == "decode":
        trees["inputs"]["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    if gust_specs is not None:
        trees["gust_stream"] = {name: e["leaves"] for name, e in gust_specs["mats"].items()}
    return trees


def cell_specs(trees: Dict, mesh, kind: str, batch: int) -> Dict:
    """The specs of :func:`cell_trees`' trees over ``mesh``: the parameter
    rules (and the same for m and v), the cache rules, the batch rule of
    the reference's ``_batch_sharding``; the GUST stream replicated."""
    pspecs = param_specs(trees["params"], mesh, mode="train" if kind == "train" else "serve")
    specs = {"params": pspecs, "inputs": batch_spec_tree(mesh, trees["inputs"])}
    if "optimizer" in trees:
        specs["optimizer"] = {"m": pspecs, "v": pspecs, "step": ()}
    if "caches" in trees:
        specs["caches"] = cache_tree_specs(trees["caches"], mesh, batch)
    if "gust_stream" in trees:
        specs["gust_stream"] = map_with_path(lambda _, x: (None,) * x.dim(),
                                             trees["gust_stream"])
    return specs


def account_cell(lm, kind: str, batch: int, seq_len: int, mesh, *,
                 param_dtype: torch.dtype, cache_dtype: torch.dtype = torch.bfloat16,
                 compute_dtype: torch.dtype = torch.bfloat16, microbatches: int = 1,
                 gust_specs=None) -> Dict:
    """Bytes per device and the step's cost of one cell: ``kind`` is
    ``train``, ``prefill`` or ``decode``; ``batch`` the global batch;
    ``mesh`` a ``MeshLayout`` or ``DeviceMesh``.  With ``gust_specs``
    (decode only; ``serving.dryrun_specs``' tree) the stream leaves count
    whole on every device, and the step is ``decode_step_gust`` with each
    GUST product reckoned by hand."""
    from ..training import TrainConfig, make_train_step

    k = dp_size(mesh)
    trees = cell_trees(lm, kind, batch, seq_len, param_dtype=param_dtype,
                       cache_dtype=cache_dtype, gust_specs=gust_specs)
    specs = cell_specs(trees, mesh, kind, batch)
    per_device = {name: tree_bytes_per_device(t, specs[name], mesh) for name, t in trees.items()}
    whole = {name: _nbytes(t) for name, t in trees.items()}
    # the port's layers take float32 weights: the step runs on them, while
    # the bytes above reckon the cell's parameter dtype (the FLOPs are the
    # same)
    params = _cast_float(trees["params"], torch.float32)
    n_params = sum(x.numel() for x in tree_leaves(params))
    rec: Dict = {"n_params": n_params, "kind": kind, "batch": batch, "seq_len": seq_len,
                 "dp": k, "mesh_shape": dict(mesh_sizes(mesh)),
                 "tokens_per_step": batch * (seq_len if kind != "decode" else 1)}
    b_local = batch // k if batch % k == 0 else batch
    notes = []
    if param_dtype != torch.float32:
        notes.append(f"parameters reckoned in {param_dtype}; the step ran on float32 "
                     "ones, the dtype the port's layers take")
    collective = 0.0
    if kind == "train":
        from ..training.train_loop import ShardedTrainState
        from ..training.optimizer import init_opt_state

        tc = TrainConfig(remat=True,
                         dtype="bfloat16" if compute_dtype == torch.bfloat16 else "float32")
        pspecs = specs["params"]
        shards = _meta_shards(params, pspecs, mesh)
        # one microbatch's step (every microbatch has its shapes): each DP
        # rank's rows, split from the global ones by the step itself
        rows = b_local // microbatches * k
        collectives.reset_traffic()
        with fake_mesh(mesh) as dmesh:
            state = ShardedTrainState({"params": shards, "opt": init_opt_state(shards)},
                                      pspecs, dmesh)
            _, cost = count_step(make_train_step(lm, tc, dmesh), state,
                                 lm.input_specs(seq_len, rows, "train"))
        traffic = {op: dict(row) for op, row in collectives.traffic.items()}
        collectives.reset_traffic()
        local_params = sum(x.numel() for x in tree_leaves(shards))
        if microbatches > 1:
            cost["matmul_flops"] *= microbatches
            cost["flops_by_op"] = {op: n * microbatches for op, n in cost["flops_by_op"].items()}
            cost["peak_temp_bytes"] += local_params * 4
            for op, row in traffic.items():
                if op != "send_recv":  # the DP ring runs once a step
                    row["bytes"] *= microbatches
                    row["calls"] *= microbatches
            notes.append(f"one microbatch's step counted: its matmul FLOPs and its TP / "
                         f"FSDP traffic times the {microbatches} microbatches, the f32 "
                         "gradient accumulator of the rank's shards added to its "
                         "temporaries")
        notes.append("rank 0's sharded step on the fake process-group backend: tensor, "
                     "expert and fully-sharded parallelism divided as the port executes "
                     "them")
        rec["microbatches"] = microbatches
        rec["traffic"] = traffic
        collective = float(sum(row["bytes"] for row in traffic.values()))
    else:
        inputs = trees["inputs"]  # the whole batch: the step runs rank 0's rows
        plans = None
        if gust_specs is not None:
            from ..serving.gust_serve import decode_step_gust

            counter = {"gust_flops": 0}
            plans = {}
            for name, e in gust_specs["mats"].items():
                meta = tuple(e["meta"])
                m_rows = (meta[5] if meta[0] == "ragged" else meta[3])[0]
                _, rows, lanes = e["leaves"]["m_blk"].shape  # (R, stream rows, l)
                plans[name] = [_ShapeOnlyProduct(m_rows, rows * lanes, counter)] * lm.stack.reps
        collectives.reset_traffic()
        with fake_mesh(mesh) as dmesh:
            place = serve_placement(params, trees["caches"], dmesh)
            shards = _meta_shards(params, place.specs, mesh)
            caches = _meta_shards(trees["caches"], place.cache, mesh)
            if kind == "prefill":
                _, cost = count_step(lm.prefill, shards, inputs, caches, dtype=compute_dtype,
                                     place=place)
            elif plans is None:
                _, cost = count_step(lm.decode_step, shards, caches, inputs["tokens"],
                                     inputs["pos"], dtype=compute_dtype, place=place)
            else:
                _, cost = count_step(decode_step_gust, lm, shards, {"plans": plans}, caches,
                                     inputs["tokens"], inputs["pos"], dtype=compute_dtype,
                                     place=place)
        traffic = {op: dict(row) for op, row in collectives.traffic.items()}
        collectives.reset_traffic()
        if plans is not None:
            cost["matmul_flops"] += counter["gust_flops"]
            rec["gust_flops"] = counter["gust_flops"]
            notes.append("GUST products reckoned by hand: 2 x streamed slots x B each "
                         "(the Eq. 9-sized stream, padding slots included), the stream "
                         "replicated on every rank")
        notes.append(f"rank 0's sharded {kind} step on the fake process-group backend: "
                     "tensor, expert and fully-sharded parallelism and the cache length over "
                     "\"model\" divided as the port executes them")
        rec["traffic"] = traffic
        collective = float(sum(row["bytes"] for row in traffic.values()))
    if any(b in lm.cfg.pattern for b in ("rec", "mlstm", "slstm")) and kind != "decode":
        notes.append("recurrent time loops counted as one step over every step's rows at "
                     "once: one step's matmul FLOPs scaled by the length "
                     "(cost_account.time_loops_at_once)")
    argument = sum(per_device.values())
    limit = memory_limit()
    rec.update(
        bytes_per_device=dict(per_device, arguments=argument),
        bytes_whole=whole,
        matmul_flops_per_device=cost["matmul_flops"],
        flops_by_op=cost["flops_by_op"],
        peak_temp_bytes=cost["peak_temp_bytes"],
        peak_bytes=argument + cost["peak_temp_bytes"],
        memory_limit=limit,
        fits=argument + cost["peak_temp_bytes"] <= limit["bytes"],
        collective_bytes=collective,
        roofline=roofline_terms(cost["matmul_flops"], argument, collective, compute_dtype),
        notes=notes,
    )
    return rec
