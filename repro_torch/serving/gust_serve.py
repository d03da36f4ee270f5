"""GUST-sparse serving: the paper's technique on the decode path.

Counterpart of ``repro.serving.gust_serve``.  Decode-time LM inference is
matvec-bound.  :func:`gustify` converts a model's MLP weights into GUST
plans (magnitude pruning -> ``repro_torch.plan`` -> packed blocks) once,
at weight-load time, and stacks each matrix's per-layer plans with
:meth:`GustPlan.stack` (padded layout: uniform ``C_pad``; ragged: uniform
block count).  :func:`decode_step_gust` mirrors ``LM.decode_step`` but
runs each layer's three MLP products through :meth:`GustPlan.spmm`: on
the card, the double-buffered SpMV kernel of the layout and gather that
the plan resolves (kernel 5 padded, 7 ragged at the default resident
gather); on the CPU, their plain versions.

Departures from the reference (ROADMAP §3):

  * no ``use_kernel``/``backend``/``interpret`` knobs: the device of the
    plans (that of the MLP weights) chooses the path;
  * the reference rebuilds each layer's ``GustPlan.from_spec`` inside its
    layer scan, which it pays once, at trace time.  Eagerly that would be
    once per layer and decode step, so :func:`gustify` builds the
    per-layer slices once and keeps them in its tree (``"plans"``), and
    :func:`decode_step_gust` takes no ``cfg``;
  * ``store_verify="load"`` raises, as ``PlanStore(verify="load")`` does.

Applies to homogeneous ``attn_mlp`` stacks (pattern length 1: phi3, yi,
mistral-large, llava); :func:`gustify` refuses the others (gemma3's
local/global pattern, the MoE and recurrent stacks) with the reference's
message, and they serve dense.  :func:`dryrun_specs` sizes the stream from the
paper's Eq. 9 bound (:meth:`GustPlan.spec_for`) on the meta device,
without running the scheduler.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.bounds import expected_colors_bound
from ..core.formats import COOMatrix
from ..core.gust_linear import prune_by_magnitude
from ..core.packing import default_cache, stacked_leaf_specs
from ..core.plan import GustPlan, PlanConfig, plan
from ..core.plan_store import PlanStore
from ..models import attention as A
from ..models.layers import apply_norm, gelu
from ..models.model_zoo import LM
from ..models.transformer import rep_slice
from ..resilience.fallback import fallback_counters

__all__ = ["GustServeConfig", "gustify", "decode_step_gust", "dryrun_specs"]

_MLP_MATS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class GustServeConfig:
    density: float = 0.1
    gust_length: int = 256
    load_balance: bool = True
    method: str = "fast"
    compact: bool = False  # bf16 values + int16 indices: 12 -> 6 B/slot
    ragged: bool = False  # ragged color-block streams: only real blocks
    gather: str = "auto"  # "resident" | "local" | "auto" (measured locality)
    plan_store: Optional[str] = None  # directory of a persistent PlanStore
    store_verify: str = "off"  # "load" raises until the verifier is ported
    mats: Tuple[str, ...] = _MLP_MATS

    @property
    def plan_config(self) -> PlanConfig:
        """These knobs in the one canonical spelling: gustify, decode and
        the dry-run specs all plan through this config."""
        return PlanConfig(
            l=self.gust_length,
            colorer=self.method,
            load_balance=self.load_balance,
            c_blk=8,
            layout="ragged" if self.ragged else "padded",
            gather=self.gather,
            value_dtype="bfloat16" if self.compact else "float32",
            index_dtype="int16" if self.compact else "int32",
        )


def _prune_to_coo(w: np.ndarray, cfg: GustServeConfig) -> COOMatrix:
    """w: (d_in, d_out) layer weight; GUST computes y = M x with
    M = w^T (d_out, d_in)."""
    m = prune_by_magnitude(np.asarray(w, np.float32).T, cfg.density)
    rows, cols = np.nonzero(m)
    return COOMatrix(m.shape, rows.astype(np.int64), cols.astype(np.int64),
                     m[rows, cols].astype(np.float32))


def _plan_cycles(p: GustPlan) -> int:
    """Cycle count for stats: store-loaded plans carry no schedule, only
    the persisted ``summary``."""
    if p.sched is not None:
        return int(p.sched.cycles)
    if p.summary is not None and "cycles" in p.summary:
        return int(p.summary["cycles"])
    return -1


def gustify(lm: LM, params, cfg: GustServeConfig, *,
            store: Optional[PlanStore] = None) -> Dict:
    """Build stacked GUST plans for every rep-layer MLP matrix, on the
    device of the MLP weights.

    Returns ``{"mats": {name: {"leaves": {...(R, ...)}, "meta": ...}},
    "stats": {...}, "seconds": {"prune", "schedule", "pack"},
    "plans": {name: [GustPlan] * R}}``: per matrix the
    :meth:`GustPlan.stack` of one plan per layer, the reference's stats,
    and (the port's additions) the host seconds of each build stage
    (summed over matrices and layers) and the per-layer plans that
    :func:`decode_step_gust` runs, rebuilt once from the stacked leaves.  Plans go through the
    content-keyed ``ScheduleCache``, so re-gustifying the same weights in
    another layout reuses every schedule, and through the
    :class:`PlanStore` of ``cfg.plan_store`` (or ``store``) when given.
    """
    if len(lm.stack.pattern) != 1 or lm.stack.pattern[0].kind != "attn_mlp":
        raise ValueError(
            "gustify currently targets homogeneous dense stacks "
            f"(got pattern {[b.kind for b in lm.stack.pattern]})"
        )
    if store is None and cfg.plan_store is not None:
        store = PlanStore(cfg.plan_store, verify=cfg.store_verify)
    mlp_params = params["stack"]["reps"][0]["mlp"]
    reps = lm.stack.reps
    pc = cfg.plan_config
    out: Dict = {"mats": {}, "stats": {}}
    seconds = {"prune": 0.0, "schedule": 0.0, "pack": 0.0}
    fb0 = dict(fallback_counters)  # attribute downgrades to this build
    for name in cfg.mats:
        w_stack = mlp_params[name]  # (R, d_in, d_out)
        device = w_stack.device
        plans = []
        for r in range(reps):
            t0 = time.perf_counter()
            coo = _prune_to_coo(w_stack[r].detach().cpu().numpy(), cfg)
            t1 = time.perf_counter()
            p = plan(coo, pc, cache=default_cache, store=store, device=device)
            t2 = time.perf_counter()
            p.artifact  # pack now, so that the stage is timed on its own
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds["prune"] += t1 - t0
            seconds["schedule"] += t2 - t1
            seconds["pack"] += time.perf_counter() - t2
            plans.append(p)
        stacked = GustPlan.stack(plans)
        out["mats"][name] = stacked
        # uniform stream size after stacking = max over layers
        if cfg.ragged:
            size_stat = {"num_blocks": max(p.artifact.num_blocks for p in plans)}
        else:
            size_stat = {"c_pad": max(p.artifact.c_pad for p in plans)}
        m_blk = stacked["leaves"]["m_blk"]
        nnz = int(torch.count_nonzero(m_blk))
        slots = m_blk.numel()
        out["stats"][name] = {
            "cycles_per_layer": [_plan_cycles(p) for p in plans],
            "stream_utilization": nnz / max(slots, 1),
            "streamed_slots": int(slots),
            **size_stat,
        }
    if store is not None:
        out["stats"]["plan_store"] = store.stats()
    fb = {k: v - fb0[k] for k, v in fallback_counters.items() if v - fb0[k]}
    if fb:
        # degradations applied while building (stored -> fresh on a
        # failing store read): counted, surfaced, never an exception
        out["stats"]["fallbacks"] = fb
    out["seconds"] = seconds
    out["plans"] = _layer_plans(out["mats"], pc)
    return out


def _layer_plans(mats: Dict, pc: PlanConfig) -> Dict[str, List[GustPlan]]:
    """Each matrix's per-layer plan, rebuilt from its slice of the
    stacked leaves through the leaves/meta codec (the route every entry
    point takes).  The slices are views of the stacked tensors."""
    out = {}
    for name, entry in mats.items():
        leaves = entry["leaves"]
        reps = next(iter(leaves.values())).shape[0]
        out[name] = [
            GustPlan.from_spec({"leaves": {k: v[r] for k, v in leaves.items()},
                                "meta": entry["meta"]}, config=pc)
            for r in range(reps)
        ]
    return out


def _gust_mlp(plans: Dict[str, GustPlan], x, mlp_kind: str):
    """x: (B, 1, d).  SwiGLU/GeGLU with every product through GUST, in
    f32, batch-major (``transpose_io``: the executor copies x into its
    padded layout either way)."""
    xb = x[:, 0].float()  # (B, d)
    act = F.silu if mlp_kind == "swiglu" else gelu

    def mv(name, v):
        return plans[name].spmm(v, transpose_io=True)

    g = act(mv("w_gate", xb).float())
    u = mv("w_up", xb).float()
    h = g * u  # (B, f)
    y = mv("w_down", h)  # (B, d)
    return y[:, None, :].to(x.dtype)


def decode_step_gust(lm: LM, params, gust, caches, tokens, pos, *,
                     dtype=torch.bfloat16):
    """Mirror of ``LM.decode_step`` with each layer's MLP routed through
    GUST.  ``gust`` is :func:`gustify`'s tree, whose per-layer
    ``"plans"`` run the products.  ``pos`` is a scalar
    or a (B,) vector of per-slot positions: the GUST path shares the
    continuous-batching machinery (slot-local caches, per-row masks) with
    the dense decode.  ``caches`` is written in place."""
    plans = gust["plans"]
    sc = lm.stack
    bc = sc.pattern[0]
    x = lm._embed_tokens(params, tokens, dtype)
    p_stack, c_stack = params["stack"]["reps"][0], caches["reps"][0]
    for r in range(sc.reps):
        p_r, c_r = rep_slice(p_stack, r), rep_slice(c_stack, r)
        h = apply_norm(p_r["ln_attn"], x, kind=bc.norm_kind)
        y, _ = A.decode_step(p_r["attn"], h, bc.attn, c_r, pos)
        x = x + y
        h = apply_norm(p_r["ln_mlp"], x, kind=bc.norm_kind)
        x = x + _gust_mlp({k: v[r] for k, v in plans.items()}, h, bc.mlp_kind)
    return lm._logits(params, x), caches


def dryrun_specs(lm: LM, cfg: GustServeConfig) -> Dict:
    """Meta-device stand-in for the gust tree, with the scheduled stream
    sized from Eq. 9 (the expected-colors bound at the pruned density).
    Each matrix is a :meth:`GustPlan.spec_for` plan (a ragged config
    sizes every window's block count), stacked across reps."""
    reps = lm.stack.reps
    d = lm.cfg.d_model
    f = lm.cfg.d_ff
    pc = cfg.plan_config
    out: Dict = {"mats": {}, "stats": {}}
    for name in cfg.mats:
        m, n = (d, f) if name == "w_down" else (f, d)
        proto = GustPlan.spec_for(
            m, n, pc, colors=expected_colors_bound(n, cfg.density, pc.l)
        )
        out["mats"][name] = {
            "leaves": stacked_leaf_specs(proto.artifact, reps),
            "meta": proto.to_spec()["meta"],
        }
    return out
