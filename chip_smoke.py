#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``repro_torch/kernels/csrc`` (one
``nvcc`` per source, in parallel), then drives six paths of the port,
each (and each phase of the fourth, fifth and sixth) with the launch
counts zeroed just before it and read just after:

1. **SpMV** — ``repro_torch.plan(M, PlanConfig(...)).spmv(v)`` /
   ``.spmm(X)`` on the Table-3 matrix ``crankseg_2`` at its published
   size (63,838 x 63,838, 14,148,858 nonzeros; the repository's
   structure-matched surrogate, seed 0) with ``l=256, c_blk=8``, both
   layouts and both value types (float32, int8):

   * the resident single-buffered plans (``gather="resident",
     pipeline="single"``, load-balanced schedule): kernels ``gust_spmv``
     and ``gust_spmv_ragged``;
   * the segment-local single-buffered plans (``gather="local",
     pipeline="single"``, ``load_balance=False``): ``gust_spmv_local``,
     ``gust_spmv_ragged_local``;
   * the default plans (``gather`` and ``pipeline`` left at ``"auto"``)
     over the load-balanced schedule, where the gather resolves resident
     (``gust_spmv_db``, ``gust_spmv_ragged_db``), and over the unbalanced
     one, where it resolves segment-local (``gust_spmv_local_db``,
     ``gust_spmv_ragged_local_db``).

2. **The Buffer Filler** — ``gather_fill(col, x)``, its own entry point,
   on the balanced padded stream at B = 1 and 8.

3. **SpGEMM and graph analytics** on G, the symmetric 0/1 pattern of
   ``synth_power_law(16384, 1e-3, seed=0)`` without self-loops (377,508
   edges, hub degree 7,010): ``triangle_count(G)`` with the default
   ``PlanConfig(l=256)``, ``plan(G, layout=...).spgemm(G)`` on both
   layouts, ``pagerank(G)`` and ``feature_propagation(G, F=64)``: kernel
   ``gust_spgemm`` (and the SpMV kernels the default plans pick).

4. **The plan lifecycle** at yi-6b's MLP widths (``src/repro/configs/
   yi_6b.py``: d_model 4,096, d_ff 11,008): W_gate and W_up (11,008 x
   4,096) and W_down (4,096 x 11,008), each drawn normal from numpy seed 0
   and pruned by ``prune_by_magnitude`` at density 0.1 (4,508,877
   nonzeros), as ``GustLinear(w, config=PlanConfig())`` layers:

   * ``linear``: each layer's forward at B = 1 and 8;
   * ``store``: W_up through ``plan(..., store=PlanStore(tmp))`` cold,
     then warm with a fresh cache;
   * ``stack``: ``GustPlan.stack([gate, up])`` and each layer's slice
     through ``from_spec``, with the gather at ``"auto"`` and forced
     ``"local"``;
   * ``tune``: ``up.plan.tune(x)`` at B = 8 over the default candidates
     (c_blk 4/8/16, l 256/128, both layouts, both gathers);
   * ``reschedule``: crankseg_2's unbalanced ragged plan after an edit of
     three windows (about 1% of their values rescaled, three edges each
     dropped and added);
   * ``no_fallback``: a ``FaultPlan`` at ``kernel.execute`` on the card.

5. **Serving** yi-6b at its published widths (d_model 4,096, 32 heads
   with 4 KV heads of 128, d_ff 11,008, vocab 64,000; 5.80 B parameters,
   random from ``torch.Generator`` seed 0 on the card), float32, through
   ``ServeLoop`` at batch 4 and ``seq_len`` 512: 8 requests (prompts of
   64, 96 and 128 tokens from numpy seed 0, 32 new tokens each):

   * ``serve.dense``: all 32 layers;
   * ``serve.gust``: the first 2 layers (the host schedule of all 96 MLP
     matrices would take over half an hour), gustified at
     ``GustServeConfig()`` (density 0.1, l=256, load-balanced, padded:
     kernel 5), then with ``ragged=True`` (kernel 7).

6. **The MoE and recurrent archs** at their published widths, the same
   engine and traffic as path 5, dense (the reference's ``gustify`` takes
   only ``attn_mlp`` stacks), each phase's weights drawn on the card from
   ``torch.Generator`` seed 0 and freed before the next; depth cut to fit
   80 GB in float32, never the widths (``FAMILIES``):

   * ``families.llama4``: llama4-scout-17b-a16e (d_model 5,120, 40 heads
     / 8 KV of 128, 16 experts × d_ff 8,192, top-1, vocab 202,048), 4 of
     48 layers (one pattern repetition: 3 chunked + 1 global, MoE each),
     9.34 B parameters;
   * ``families.dbrx``: dbrx-132b (d_model 6,144, 48 / 8 × 128, 16
     experts × d_ff 10,752, top-4, vocab 100,352), 2 of 40 layers, 7.13 B;
   * ``families.recurrentgemma``: recurrentgemma-9b (d_model 4,096, 16 / 1
     × 256, GeGLU d_ff 12,288, vocab 256,000, window 2,048), 5 of 38
     layers (``rec, rec, local`` and the 2-block tail), 2.17 B;
   * ``families.xlstm``: xlstm-125m (d_model 768, 4 heads, vocab 50,304),
     all 12 layers (mLSTM, sLSTM), 134 M.

Checks, each fatal:
  * every SpMV kernel against its plain PyTorch version on the card, at
    the main path's shapes (B = 1 and 8): per element
    ``|kernel - plain| <= 1e-5 * (|M|·|x|)`` (sums are reordered: the
    plain version's ``index_add_`` uses atomics on the card); at B=1
    bitwise against the plain version run on the CPU (the kernel's own
    order); at B=8 each column k bitwise against the same kernel's B=1
    result on ``x[:, k]``, so that every B=8 result is held, through
    B=1, to the CPU plain version; every kernel bitwise against the
    resident single-buffered kernel of its layout (kernel 1 padded, 2
    ragged) on the same artifact, so single == double (1 == 5, 2 == 7)
    and resident == local (3/6 == 1, 4/8 == 2), and each single-buffered
    local kernel also against the double-buffered local one;
  * ``gather_fill`` bitwise against its plain version and ``x[col]``;
  * ``gust_spgemm`` on G, with B by row offsets as the SpGEMM path gives
    it, bitwise against its plain version on the card (0/1 values: exact
    arithmetic), and on a float-valued copy of G (standard normal values,
    seed 0) within ``1e-5 * (|A|·|B|)`` per element;
  * the default plans resolve the gather named above;
  * each path launched each of its kernels (counts > 0);
  * the SpMV results against scipy in float64, per row
    ``|y - M·x| <= 1e-4 * (|M|·|x|)`` (int8: against the dequantized
    matrix), finite and of the expected shape; padded == ragged bitwise
    for each schedule; the default plans == the resident single plans
    bitwise on the load-balanced schedule, and == the local single plans
    on the unbalanced one;
  * ``triangle_count(G)`` == 583,750 == scipy's ``(G·G ⊙ G).sum() / 6``
    in the same run, over a ``G·G`` of 138,116,226 nonzeros; ``spgemm`` canonical and bitwise equal to the dense
    ``G·G`` (``torch.matmul``, TF32 off) on both layouts, padded ==
    ragged; ``pagerank(G)`` converged and within 2e-5 in L1 of scipy's
    float64 iteration run to its fixed point; ``feature_propagation``
    within ``1e-4 * (|Â|·|Â|·|H|)`` per element of scipy in float64;
  * no function of any library spills (ptxas): the four SpMV libraries,
    ``gust_spgemm`` and ``gather_fill``;
  * the lifecycle path: every layer's output within ``1e-4 * (|W|·|x|)``
    per element of float64, bitwise the same plan's plain version on the
    CPU at B=1, and each B=8 row bitwise the same layer at B=1; the warm
    store load colors nothing (``sched_counters`` unmoved) and gives the
    cold plan's leaves and ``spmm`` bit for bit; each stacked slice's
    ``spmm`` bitwise its unstacked plan at B = 1 and 8 (the local slices
    also the resident plan); the tuned plan within the gate; the
    rescheduled plan spliced, its dirty windows the edited ones, its
    leaves and ``spmv`` bitwise a fresh plan's; the fault at
    ``kernel.execute`` raises, launches nothing, and no plan's
    ``fallback_kernel`` / ``fallback_gather`` and no process fallback
    counter moves;
  * the serving path: every request DONE with no retry, no failure and
    every fallback counter 0; one request served alone on the idle engine
    of the same batch equals its stream in the mixed run bitwise (both
    phases); the first decode step at two layers on the card within
    ``2e-4`` of the largest logit of the same step on the CPU's plain path
    (float32, TF32 off); each GUST phase launches its kernel exactly once
    per GUST product (3 x 2 layers x decode steps) and no other kernel,
    so no product ran a plain version; padded == ragged token streams
    bitwise; a GUST decode step within ``1e-4`` of the largest logit of a
    dense decode step on the same pruned MLP weights;
  * the families path, per phase: the arch's published widths; every
    request DONE with no retry, failure or fallback and no kernel
    launched; one request alone equals its mixed stream bitwise (MoE at
    batch 4 = ``min_capacity``: no pair is dropped); the first decode
    step on the card within ``2e-4`` of the largest logit of the CPU's
    plain path with the same first token, at one layer for the MoE archs
    and at the phase's depth for the recurrent ones.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
for all ten kernels (times from CUDA events, bounds from this run's
bytes; the SpMV kernels 1-8, all spread over the card's CTAs, also with
their CTAs per SM, grid, stream stages (2 where kernels 5/7 take their
slots through the bulk-copy ring) and ``partial_bytes``, the scratch of
block tiles that their fold reads; kernel 9 with its tile width ``n_t``,
the grid of its row-tile kernel, its pre-pass and row-tile device times
(``torch.profiler``), its longest unit and the median over its CTAs of
each CTA's longest unit, and the longest slot-loading and product phases
of a unit, in clock cycles),
SpGEMM's wall time split (B's row offsets built on the card, kernel,
reorder, compaction on the card, host copy), per yi-6b layer and B the
forward and kernel ms beside the bytes bound, cuSPARSE CSR and dense
``torch.matmul`` on the pruned weight, ``partial_bytes``, cycles,
utilization, the resolved layout, gather and pipeline and the schedule
and pack seconds; the store's file bytes and cold / warm seconds; the
``TuneResult``; reschedule against fresh-plan seconds; per serving phase
prefill ms by prompt length and decode-step ms (CUDA events), tokens/s,
slot occupancy, a ``torch.profiler`` window of 8 decode steps (device ms
by kernel, idle share), and for GUST the gustify seconds (prune /
schedule / pack), cycles per layer, streamed slots and stream
utilization; for each families phase the same serving numbers, the
bytes bound of a decode step (every parameter read once), peak device
memory and the card-vs-CPU error, also on a ``{"families": {...}}``
line before the card's name; and as its last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero without a CUDA device.
"""

import functools
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
FULL_POWER_W = 700.0
L, C_BLK, BATCH = 256, 8, 8
TOL_KERNEL, TOL_MAIN = 1e-5, 1e-4
SOURCES = {
    "gust_spmv.cu": "repro_torch/kernels/csrc/gust_spmv.cu",
    "gust_spmv_local.cu": "repro_torch/kernels/csrc/gust_spmv_local.cu",
    "gust_spmv_db.cu": "repro_torch/kernels/csrc/gust_spmv_db.cu",
    "gust_spmv_local_db.cu": "repro_torch/kernels/csrc/gust_spmv_local_db.cu",
    "gust_spgemm.cu": "repro_torch/kernels/csrc/gust_spgemm.cu",
    "gather_fill.cu": "repro_torch/kernels/csrc/gather_fill.cu",
}
#: name -> (layout, gather, source, TPU kernel it replaces)
KERNELS = {
    "gust_spmv": ("padded", "resident", "gust_spmv.cu",
                  "src/repro/kernels/gust_spmv.py:238"),
    "gust_spmv_ragged": ("ragged", "resident", "gust_spmv.cu",
                         "src/repro/kernels/gust_spmv_ragged.py:113"),
    "gust_spmv_local": ("padded", "local", "gust_spmv_local.cu",
                        "src/repro/kernels/gust_spmv.py:354"),
    "gust_spmv_ragged_local": ("ragged", "local", "gust_spmv_local.cu",
                               "src/repro/kernels/gust_spmv_ragged.py:199"),
    "gust_spmv_db": ("padded", "resident", "gust_spmv_db.cu",
                     "src/repro/kernels/gust_spmv.py:504"),
    "gust_spmv_local_db": ("padded", "local", "gust_spmv_local_db.cu",
                           "src/repro/kernels/gust_spmv.py:620"),
    "gust_spmv_ragged_db": ("ragged", "resident", "gust_spmv_db.cu",
                            "src/repro/kernels/gust_spmv_ragged.py:324"),
    "gust_spmv_ragged_local_db": ("ragged", "local", "gust_spmv_local_db.cu",
                                  "src/repro/kernels/gust_spmv_ragged.py:430"),
}
#: The resident single-buffered kernel of each layout (kernel 1 padded, 2
#: ragged): the bitwise yardstick of every other kernel of its layout on
#: the same artifact.  It is itself held bitwise to the plain version on
#: the CPU at B=1, and at B=8 column by column to its own B=1 results.
YARDSTICK = {"padded": "gust_spmv", "ragged": "gust_spmv_ragged"}
#: The single-buffered local kernels are also held bitwise to the
#: double-buffered local kernel of their layout.
LOCAL_TWIN = {"gust_spmv_local": "gust_spmv_local_db",
              "gust_spmv_ragged_local": "gust_spmv_ragged_local_db"}
#: The pipeline of each SpMV kernel's launch plan (the gather is
#: KERNELS'): every one spreads a window's blocks over the card's CTAs and
#: folds their (l, B) tiles from a scratch, and each of its rows also
#: prints the launch (CTAs per SM, grid, stream stages) and the scratch's
#: size, ``partial_bytes``.
SPREAD = {"gust_spmv": "single", "gust_spmv_ragged": "single",
          "gust_spmv_db": "double", "gust_spmv_ragged_db": "double",
          "gust_spmv_local": "single", "gust_spmv_ragged_local": "single",
          "gust_spmv_local_db": "double", "gust_spmv_ragged_local_db": "double"}
#: Library -> the part of a function's name that holds it to no spill
#: (ptxas): "" for every function of the library.
NO_SPILL = {"gust_spmv": "", "gust_spmv_local": "", "gust_spmv_local_db": "",
            "gust_spmv_db": "", "gust_spgemm": "", "gather_fill": ""}
#: The kernels off the SpMV path: name -> (source, TPU kernel it replaces).
OTHER_KERNELS = {
    "gather_fill": ("gather_fill.cu", "src/repro/kernels/gather_fill.py:57"),
    "gust_spgemm": ("gust_spgemm.cu", "src/repro/kernels/gust_spgemm.py:114"),
}
#: The SpGEMM graph G: the symmetric 0/1 pattern, without self-loops, of
#: synth_power_law(N, density, seed=0) (the paper's synthetic size).
G_N, G_DENSITY, G_EDGES, G_TRIANGLES = 16384, 1e-3, 377_508, 583_750
G_GG_NNZ = 138_116_226  # nonzeros of G·G
G_FEATURES = 64
TOL_SPGEMM = 1e-5
#: Which schedules each kernel's phase runs on (load_balance values): the
#: resident kernels on both, so that local and resident stand side by side
#: on the unbalanced artifact; the local ones where the default picks them.
PHASE_SCHEDULES = {"resident": (True, False), "local": (False,)}


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds of ``fn`` per call on the current stream."""
    from repro_torch.kernels._sweep import ms

    return ms(fn, iters, warmup)


def wrappers():
    """name -> (wrapper, plain version)."""
    import repro_torch.kernels.gust_spmv as k_pad
    import repro_torch.kernels.gust_spmv_ragged as k_rag
    import repro_torch.kernels.ref as plain

    return {
        "gust_spmv": (k_pad.gust_spmv, plain.gust_spmv_ref),
        "gust_spmv_ragged": (k_rag.gust_spmv_ragged, plain.gust_spmv_ragged_ref),
        "gust_spmv_local": (k_pad.gust_spmv_local, plain.gust_spmv_local_ref),
        "gust_spmv_ragged_local": (k_rag.gust_spmv_ragged_local,
                                   plain.gust_spmv_ragged_local_ref),
        "gust_spmv_db": (k_pad.gust_spmv_db, plain.gust_spmv_ref),
        "gust_spmv_local_db": (k_pad.gust_spmv_local_db, plain.gust_spmv_local_ref),
        "gust_spmv_ragged_db": (k_rag.gust_spmv_ragged_db, plain.gust_spmv_ragged_ref),
        "gust_spmv_ragged_local_db": (k_rag.gust_spmv_ragged_local_db,
                                      plain.gust_spmv_ragged_local_ref),
    }


def counters():
    """name -> (module, attribute) of each kernel's launch count."""
    import repro_torch.kernels.gather_fill as k_fill
    import repro_torch.kernels.gust_spgemm as k_gemm
    import repro_torch.kernels.gust_spmv as k_pad
    import repro_torch.kernels.gust_spmv_ragged as k_rag

    return {
        "gust_spmv": (k_pad, "launches"),
        "gust_spmv_ragged": (k_rag, "launches"),
        "gust_spmv_local": (k_pad, "local_launches"),
        "gust_spmv_ragged_local": (k_rag, "local_launches"),
        "gather_fill": (k_fill, "launches"),
        "gust_spgemm": (k_gemm, "launches"),
        "gust_spmv_db": (k_pad, "db_launches"),
        "gust_spmv_local_db": (k_pad, "local_db_launches"),
        "gust_spmv_ragged_db": (k_rag, "db_launches"),
        "gust_spmv_ragged_local_db": (k_rag, "local_db_launches"),
    }


def kernel_args(name, art):
    """Positional arguments (minus x) of kernel ``name``'s wrapper and of
    its plain version, and their keywords.  The plain ragged versions
    steer blocks by ``block_window``, the kernels by ``block_starts``."""
    local = KERNELS[name][1] == "local"
    args = [art.m_blk, art.col_loc if local else art.col_blk, art.row_blk]
    if local:
        args.append(art.seg_blk)
    pargs = list(args)
    if KERNELS[name][0] == "ragged":
        args += [art.block_window, art.block_starts]
        pargs.append(art.block_window)
    kw = dict(num_windows=art.num_windows, l=art.l, c_blk=art.c_blk,
              scale_blk=art.scale_blk)
    return args, pargs, kw


def referenced_tiles(art):
    """Sum over blocks of the x tiles each block references: the strictly
    increasing prefix of its ``seg_blk`` row."""
    seg = art.seg_blk.cpu().numpy()
    return int(seg.shape[0] + (seg[:, 1:] > seg[:, :-1]).sum())


def bytes_and_ops(name, art, xp, b, nnz):
    """What one kernel call must move and compute: each input it reads
    once (the stream, the scales, ``block_starts``, x; the segment-local
    kernels read ``col_loc`` in place of ``col_blk`` and the referenced
    prefix of each ``seg_blk`` row), the (W, l, B) output written once; a
    multiply and an add per nonzero and vector column, plus the int8
    dequant multiply per nonzero."""
    local = KERNELS[name][1] == "local"
    read = [art.m_blk, art.col_loc if local else art.col_blk, art.row_blk,
            art.scale_blk, getattr(art, "block_starts", None), xp]  # block_window: unread
    moved = sum(t.numel() * t.element_size() for t in read if t is not None)
    if local:
        moved += referenced_tiles(art) * art.seg_blk.element_size()
    moved += art.num_windows * art.l * b * 4
    ops = nnz * b * 2 + (nnz if art.scale_blk is not None else 0)
    return moved, ops


def x_tile_bytes(name, art, b):
    """The x-tile copies a segment-local kernel makes (every referenced
    tile of every block, from L2 in the main): a diagnostic beside the
    bound, not part of it; None for the resident kernels."""
    if KERNELS[name][1] != "local":
        return None
    return referenced_tiles(art) * art.l * b * 4


def main() -> int:
    start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1

    import scipy.sparse as sp

    import repro_torch
    from repro_torch.core.packing import ScheduleCache
    from repro_torch.core.scheduler import sched_counters
    from repro_torch.data.matrices import REAL_WORLD_SUITE, make_real_world_surrogate
    import repro_torch.kernels.ref as plain
    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_fill import gather_fill
    from repro_torch.kernels.gust_spmv import spread_launch_plan
    from repro_torch.kernels.ops import _prep_x

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    watts = re.search(r"([0-9.]+)\s*W\s*$", smi)
    power_w = float(watts.group(1)) if watts else None
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    report = {"device": kind, "nvidia_smi": smi, "torch": torch.__version__}
    kernel_fns = wrappers()
    launch_counts = counters()

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {}
    for lib, info in _build.build_log.items():
        lines = info["log"].splitlines()
        regs = [int(r) for ln in lines for r in re.findall(r"Used (\d+) registers", ln)]
        spills = spilling_functions(lines)
        report["ptxas"][lib] = {"seconds": info["seconds"], "kernels": len(regs),
                                "max_registers": max(regs, default=None),
                                "spilling": [f"{fn}: {ln}" for fn, ln in spills]}
        log(f"build {lib}: {info['seconds']:.1f} s, {len(regs)} kernels, "
            f"max {max(regs, default=0)} registers, {len(spills)} with spills")
        held = [f"{fn}: {ln}" for fn, ln in spills
                if lib in NO_SPILL and NO_SPILL[lib] in (fn or "")]
        if held:
            raise AssertionError(f"{lib} spills (ptxas): {held}")
    report["ptxas_unchecked"] = sorted(set(NO_SPILL) - set(_build.build_log))
    if report["ptxas_unchecked"]:
        log(f"no spill check for {report['ptxas_unchecked']}: built before this run, "
            "so ptxas reported nothing")
    log(f"build: {report['build_s']:.1f} s")

    # -- matrix, schedules, packs ----------------------------------------------
    spec = REAL_WORLD_SUITE[0]
    t0 = time.perf_counter()
    coo = make_real_world_surrogate(spec, scale=1.0, seed=0)
    report["generate_s"] = time.perf_counter() - t0
    m, n = coo.shape
    if (m, n, coo.nnz) != (spec.dim, spec.dim, spec.nnz):
        raise AssertionError(f"{spec.name}: got {m}x{n}, {coo.nnz} nnz")
    cache = ScheduleCache()
    report["schedule_s"] = {}
    for lb in (True, False):  # before any tensor touches the card
        t0 = time.perf_counter()
        cache.schedule(coo, L, load_balance=lb)
        report["schedule_s"][str(lb)] = time.perf_counter() - t0
    report["sched_counters"] = dict(sched_counters)
    log(f"{spec.name}: {m}x{n}, {coo.nnz} nnz; generate {report['generate_s']:.1f} s, "
        f"schedule {json.dumps(report['schedule_s'])} s (load_balance True/False)")

    plans, t0 = {}, time.perf_counter()
    for layout in ("padded", "ragged"):
        for vdt in ("float32", "int8"):
            cfg = repro_torch.PlanConfig(l=L, c_blk=C_BLK, layout=layout,
                                         gather="resident", pipeline="single",
                                         value_dtype=vdt)
            plans["single", True, layout, vdt] = repro_torch.plan(
                coo, cfg, cache=cache, device="cuda")
            cfg = repro_torch.PlanConfig(l=L, c_blk=C_BLK, layout=layout,
                                         load_balance=False, gather="local",
                                         pipeline="single", value_dtype=vdt)
            plans["single-local", False, layout, vdt] = repro_torch.plan(
                coo, cfg, cache=cache, device="cuda")
            for lb in (True, False):
                cfg = repro_torch.PlanConfig(l=L, c_blk=C_BLK, layout=layout,
                                             load_balance=lb, value_dtype=vdt)
                plans["default", lb, layout, vdt] = repro_torch.plan(
                    coo, cfg, cache=cache, device="cuda")
    for p in plans.values():
        p.artifact  # pack now, outside the timed main path
    torch.cuda.synchronize()
    report["pack_s"] = time.perf_counter() - t0
    report["streams"] = {}
    for (mode, lb, layout, vdt), p in plans.items():
        a = p.artifact
        want = "resident" if lb else "local"
        row = {"slots": a.streamed_slots, "bytes": a.stream_bytes, "s_blk": a.s_blk,
               "seg_count": a.seg_count, "gather": p.gather_mode,
               "referenced_tiles": referenced_tiles(a)}
        report["streams"][f"{mode}/lb={lb}/{layout}/{vdt}"] = row
        log(f"plan {mode} load_balance={lb} {layout} {vdt}: S_blk {a.s_blk} / "
            f"seg_count {a.seg_count}, gather {p.gather_mode}, {a.streamed_slots} slots, "
            f"{a.stream_bytes} bytes")
        if mode == "default" and p.gather_mode != want:
            raise AssertionError(
                f"load_balance={lb} {layout} {vdt}: gather='auto' resolved "
                f"{p.gather_mode!r}, not {want!r}: the run would not drive the "
                "kernels it claims")
    log(f"packs: {report['pack_s']:.1f} s")

    rng = np.random.default_rng(0)
    v = rng.standard_normal(n).astype(np.float32)
    X = rng.standard_normal((n, BATCH)).astype(np.float32)
    xps = {b: _prep_x(torch.from_numpy(x).cuda(), n, L)
           for b, x in ((1, v[:, None]), (BATCH, X))}
    csr = sp.csr_matrix((coo.vals.astype(np.float64), (coo.rows, coo.cols)), shape=(m, n))
    lib_csr = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr).cuda(),
        torch.from_numpy(csr.indices.astype(np.int64)).cuda(),
        torch.from_numpy(csr.data.astype(np.float32)).cuda(), (m, n),
        check_invariants=False)

    # -- kernel phase: each kernel against its plain version ---------------------
    variants, timed, cpu_plain = [], [], {}
    for name, (layout, gather, _, _) in KERNELS.items():
        kernel, ref = kernel_fns[name]
        for lb in PHASE_SCHEDULES[gather]:
            for vdt in ("float32", "int8"):
                art = plans["default", lb, layout, vdt].artifact
                args, pargs, kw = kernel_args(name, art)
                abs_args = [art.m_blk.abs()] + pargs[1:]
                for b, xp in xps.items():
                    y_k = kernel(*args, xp, **kw)
                    y_p = ref(*pargs, xp, **kw)
                    mag = ref(*abs_args, xp.abs(), **kw)
                    torch.cuda.synchronize()
                    err = (y_k - y_p).abs()
                    tag = f"{name} load_balance={lb} {vdt} B={b}"
                    if not bool(torch.isfinite(y_k).all()) or bool(
                        (err > TOL_KERNEL * mag).any()
                    ):
                        raise AssertionError(
                            f"{tag}: kernel disagrees with its plain version "
                            f"(max abs err {float(err.max()):.3e})")
                    row = {"kernel": name, "load_balance": lb, "value_dtype": vdt,
                           "B": b, "max_abs_err": float(err.max())}
                    if name != YARDSTICK[layout]:
                        yard, _ = kernel_fns[YARDSTICK[layout]]
                        y_1 = yard(*kernel_args(YARDSTICK[layout], art)[0], xp, **kw)
                        if not torch.equal(y_k, y_1):
                            raise AssertionError(
                                f"{tag}: differs bitwise from {YARDSTICK[layout]} "
                                "on the same artifact")
                        row["bitwise_vs_" + YARDSTICK[layout]] = True
                    if name in LOCAL_TWIN:
                        twin, _ = kernel_fns[LOCAL_TWIN[name]]
                        y_2 = twin(*kernel_args(LOCAL_TWIN[name], art)[0], xp, **kw)
                        if not torch.equal(y_k, y_2):
                            raise AssertionError(
                                f"{tag}: differs bitwise from {LOCAL_TWIN[name]} "
                                "on the same artifact")
                        row["bitwise_vs_" + LOCAL_TWIN[name]] = True
                    if b > 1:  # each column as the same kernel gives it at B=1
                        for k in range(b):
                            y_1 = kernel(*args, xp[:, k:k + 1].contiguous(), **kw)
                            if not torch.equal(y_k[:, :, k:k + 1], y_1):
                                raise AssertionError(
                                    f"{tag}: column {k} differs bitwise from the same "
                                    "kernel at B=1")
                        row["bitwise_columns_vs_b1"] = True
                    if b == 1:  # on the CPU the plain version sums in the kernel's order
                        key = (lb, layout, vdt, gather)
                        if key not in cpu_plain:
                            cpu_kw = dict(kw, scale_blk=None if art.scale_blk is None
                                          else art.scale_blk.cpu())
                            cpu_plain[key] = ref(*[a.cpu() for a in pargs], xp.cpu(),
                                                 **cpu_kw)
                        if not torch.equal(y_k.cpu(), cpu_plain[key]):
                            raise AssertionError(
                                f"{tag}: differs bitwise from its plain version on the CPU")
                        row["bitwise_vs_cpu_plain"] = True
                    variants.append(row)
                    timed.append((
                        row,
                        functools.partial(kernel, *args, xp, **kw),
                        functools.partial(ref, *pargs, xp, **kw),
                        functools.partial(torch.matmul, lib_csr, xp[:n].contiguous()),
                        bytes_and_ops(name, art, xp, b, coo.nnz),
                    ))
                    row["x_tile_bytes"] = x_tile_bytes(name, art, b)
                    row.update(spread_launch_plan(art.m_blk, args[1], art.row_blk, xp,
                                                  l=art.l, c_blk=art.c_blk, gather=gather,
                                                  pipeline=SPREAD[name]))
                    log(f"kernel {tag}: max |kernel - plain| = {row['max_abs_err']:.3e}; "
                        + ", ".join(k for k, val in row.items()
                                    if k.startswith("bitwise") and val))
    del cpu_plain

    # -- kernel phase: gather_fill (kernel 10) on the balanced padded stream ------
    fill_col = plans["default", True, "padded", "float32"].artifact.col_blk
    for b, xp in xps.items():
        g = gather_fill(fill_col, xp)
        torch.cuda.synchronize()
        if not (torch.equal(g, plain.gather_fill_ref(fill_col, xp))
                and torch.equal(g, xp[fill_col.long()])):
            raise AssertionError(f"gather_fill B={b}: differs from its plain version "
                                 "or from x[col]")
        del g
        row = {"kernel": "gather_fill", "load_balance": True, "value_dtype": "float32",
               "B": b, "max_abs_err": 0.0, "bitwise_vs_plain": True,
               "bitwise_vs_x_col": True, "head": b == 1,
               "variant": f"balanced padded stream, B={b}"}
        variants.append(row)
        moved = (fill_col.numel() * fill_col.element_size() + xp.numel() * 4
                 + fill_col.numel() * b * 4)
        timed.append((row, functools.partial(gather_fill, fill_col, xp),
                      functools.partial(plain.gather_fill_ref, fill_col, xp),
                      functools.partial(xp.index_select, 0, fill_col.view(-1)),
                      (moved, 0)))
        log(f"kernel gather_fill B={b}: bitwise equal to its plain version and x[col]")

    # -- path 1: the SpMV plans ---------------------------------------------------
    for mod, attr in launch_counts.values():
        setattr(mod, attr, 0)
    outs = {}
    t0 = time.perf_counter()
    for key, p in plans.items():
        outs[key] = (p.spmv(v), p.spmm(X))
    torch.cuda.synchronize()
    report["main_path_s"] = time.perf_counter() - t0
    launches = {name: getattr(*launch_counts[name]) for name in KERNELS}
    log(f"main path: {report['main_path_s']:.3f} s, launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")

    mats = {("float32", lb): csr for lb in (True, False)}
    for lb in (True, False):
        mats["int8", lb] = dequantized_csr(plans["default", lb, "padded", "int8"].artifact)
    checks = {}
    for (mode, lb, layout, vdt), (y, Y) in outs.items():
        mat = mats[vdt, lb]
        for tag, got, x in (("spmv", y, v), ("spmm", Y, X)):
            got = got.cpu().numpy().astype(np.float64)
            want_shape = (m,) if tag == "spmv" else (m, BATCH)
            name = f"{mode}/lb={lb}/{layout}/{vdt}/{tag}"
            if got.shape != want_shape or not np.isfinite(got).all():
                raise AssertionError(f"{name}: shape {got.shape} or non-finite")
            x64 = x.astype(np.float64)
            want = mat @ x64
            bound = TOL_MAIN * (abs(mat) @ np.abs(x64))
            worst = float(np.max(np.abs(got - want) - bound))
            if worst > 0:
                raise AssertionError(f"{name}: off scipy by {worst:.3e} beyond the "
                                     "per-row bound")
            checks[name] = float(np.max(np.abs(got - want)))
    for mode, lb in (("single", True), ("default", True), ("default", False),
                     ("single-local", False)):
        for vdt in ("float32", "int8"):
            for i, tag in enumerate(("spmv", "spmm")):
                pad, rag = outs[mode, lb, "padded", vdt][i], outs[mode, lb, "ragged", vdt][i]
                if not torch.equal(pad, rag):
                    raise AssertionError(f"{mode} lb={lb} {vdt} {tag}: padded and "
                                         "ragged differ")
                if mode == "default" and lb and not torch.equal(
                        pad, outs["single", True, "padded", vdt][i]):
                    raise AssertionError(f"{vdt} {tag}: the default plan differs from "
                                         "the resident single-buffered plan")
                if mode == "single-local" and not torch.equal(
                        pad, outs["default", False, "padded", vdt][i]):
                    raise AssertionError(f"{vdt} {tag}: the single-buffered local plan "
                                         "differs from the default (double-buffered "
                                         "local) plan")
    report["max_abs_err_vs_scipy"] = checks
    log(f"main path agrees with scipy (max abs err {max(checks.values()):.3e}); "
        "padded == ragged bitwise; default == single bitwise (load-balanced); "
        "single-local == default bitwise (unbalanced)")
    del outs

    # -- path 2: gather_fill, its own entry point ---------------------------------
    for mod, attr in launch_counts.values():
        setattr(mod, attr, 0)
    for xp in xps.values():  # outputs checked in the kernel phase above
        gather_fill(fill_col, xp)
    torch.cuda.synchronize()
    launches["gather_fill"] = getattr(*launch_counts["gather_fill"])
    if launches["gather_fill"] <= 0:
        raise AssertionError("the gather_fill path never launched gather_fill")

    # -- path 3: SpGEMM and graph analytics on G ----------------------------------
    gemm_rows = spgemm_path(report, launch_counts, launches, variants, timed)

    # -- timing ------------------------------------------------------------------------
    for row, run_kernel, run_plain, run_library, (moved, ops) in timed:
        heavy = row["kernel"] == "gust_spgemm"
        row["ms"] = cuda_ms(run_kernel, iters=5 if heavy else 20)
        row["plain_ms"] = cuda_ms(run_plain, iters=2 if heavy else 5, warmup=1)
        row["library_ms"] = library_ms(run_library, heavy, row)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        row["bytes"], row["ops"] = moved, ops
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        if power_w is not None and power_w < FULL_POWER_W:
            row["bound_ms_at_power_limit"] = row["bound_ms"] * FULL_POWER_W / power_w
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        log(f"time {row['kernel']} load_balance={row['load_balance']} "
            f"{row['value_dtype']} B={row['B']}: kernel {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
            f"library {lib}"
            + "".join(f", {k} {row[k]}" for k in ("x_tile_bytes", "partial_bytes",
                                                  "ctas_per_sm", "stream_stages", "n_t",
                                                  "grid", "prepass_ms", "row_tiles_ms",
                                                  "longest_unit_cycles",
                                                  "median_cta_longest_unit_cycles",
                                                  "longest_load_cycles",
                                                  "longest_products_cycles")
                      if row.get(k) is not None)
            + (f", grid ({row['grid_x']}, {row['grid_y']})" if "grid_x" in row else ""))
    report["variants"] = variants
    spgemm_wall_split(report, gemm_rows)

    # -- path 4: the plan lifecycle at yi-6b's MLP widths ---------------------------
    lifecycle_path(report, launch_counts, {"coo": coo, "plans": plans, "cache": cache,
                                           "power_w": power_w})

    # -- path 5: serving yi-6b at full width, dense and GUST-sparse -------------------
    t0 = time.perf_counter()
    serve_path(report, launch_counts)
    report["serve"]["seconds"] = time.perf_counter() - t0
    log(f"serve path: {report['serve']['seconds']:.1f} s")

    # -- path 6: the MoE and recurrent archs at their published widths ---------------
    t0 = time.perf_counter()
    families = families_path(report, launch_counts)
    report["families_seconds"] = time.perf_counter() - t0
    log(f"families path: {report['families_seconds']:.1f} s")

    kernels = []
    heads = {name: (KERNELS[name][2], KERNELS[name][3], PHASE_SCHEDULES[KERNELS[name][1]][0])
             for name in KERNELS}
    heads.update({name: (src, rep, True) for name, (src, rep) in OTHER_KERNELS.items()})
    for name, (source, replaces, lb) in heads.items():
        head = next(r for r in variants if r["kernel"] == name and (
            r.get("head") if name in OTHER_KERNELS else
            r["load_balance"] == lb and r["value_dtype"] == "float32" and r["B"] == 1))
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[source],
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in variants if r["kernel"] == name),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "variant": head.get("variant", f"float32 values, B=1, load_balance={lb}"),
        }
        if "bound_ms_at_power_limit" in head:
            entry["bound_ms_at_power_limit"] = head["bound_ms_at_power_limit"]
        entry.update({k: head[k] for k in ("ctas_per_sm", "grid_x", "grid_y",
                                           "stream_stages", "partial_bytes", "n_t", "grid",
                                           "prepass_ms", "row_tiles_ms",
                                           "longest_unit_cycles",
                                           "median_cta_longest_unit_cycles",
                                           "longest_load_cycles",
                                           "longest_products_cycles") if k in head})
        kernels.append(entry)
    report["kernels"] = kernels

    report["total_s"] = time.perf_counter() - start
    log(f"chip_smoke: {report['total_s']:.1f} s")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"families": families}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


#: yi-6b's MLP (src/repro/configs/yi_6b.py: d_model 4096, d_ff 11008):
#: name -> (rows, columns) of each projection's weight, drawn normal from
#: a numpy seed and pruned at GustServeConfig.density.
YI_MLP = {"gate": (11008, 4096), "up": (11008, 4096), "down": (4096, 11008)}
YI_DENSITY, YI_NNZ = 0.1, 4_508_877
#: The crankseg_2 windows the reschedule phase edits.
EDIT_WINDOWS = (7, 101, 203)


def plan_kernel(p):
    """The name of the SpMV kernel plan ``p`` launches on the card."""
    gather, pipe = p.gather_mode, p._pipeline()
    return next(k for k, (lay, g, _, _) in KERNELS.items()
                if lay == p.layout and g == gather and SPREAD[k] == pipe)


def phase(report, launch_counts, name, fn):
    """Run phase ``name`` with the launch counts zeroed just before it;
    record and return its launches (read just after) and seconds."""
    import torch

    for mod, attr in launch_counts.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: getattr(mod, attr) for k, (mod, attr) in launch_counts.items()
              if getattr(mod, attr)}
    report.setdefault("lifecycle", {})[name] = dict(out or {}, seconds=seconds,
                                                    launches=counts)
    log(f"phase {name}: {seconds:.1f} s, launches {counts}")
    return report["lifecycle"][name]


def check_gate(tag, y, w_csr, x):
    """The SpMV gate against float64: per element ``|y - W·x| <= 1e-4 *
    (|W|·|x|)``, finite, of the expected shape.  ``y``, ``x`` batch-major."""
    got = y.cpu().numpy().astype(np.float64)
    x64 = x.cpu().numpy().astype(np.float64).T
    want = (w_csr @ x64).T
    bound = TOL_MAIN * (abs(w_csr) @ np.abs(x64)).T
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{tag}: shape {got.shape} (want {want.shape}) or non-finite")
    worst = float(np.max(np.abs(got - want) - bound))
    if worst > 0:
        raise AssertionError(f"{tag}: off float64 by {worst:.3e} beyond the gate")
    return float(np.max(np.abs(got - want)))


def leaves_equal(a, b):
    """True when two artifacts hold the same leaves bit for bit."""
    import torch

    from repro_torch.core.packing import RaggedSchedule, packed_leaves, ragged_leaves

    fa = ragged_leaves if isinstance(a, RaggedSchedule) else packed_leaves
    fb = ragged_leaves if isinstance(b, RaggedSchedule) else packed_leaves
    la, lb = fa(a), fb(b)
    return set(la) == set(lb) and all(
        la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape
        and torch.equal(la[k], lb[k]) for k in la)


def lifecycle_path(report, launch_counts, crank):
    """The plan lifecycle on the card: yi-6b's MLP projections as
    GustLinear layers at B=1 and 8 (``linear``), a layer through a
    PlanStore cold and warm (``store``), two layers stacked (``stack``),
    one tuned (``tune``), crankseg_2's unbalanced ragged plan rescheduled
    after an edit of three windows (``reschedule``), and a fault at
    ``kernel.execute`` that must reach the caller (``no_fallback``).  Each
    phase runs with the launch counts zeroed just before it."""
    import dataclasses
    import tempfile

    import scipy.sparse as sp
    import torch

    import repro_torch
    from repro_torch.core.formats import COOMatrix
    from repro_torch.core.packing import ScheduleCache
    from repro_torch.core.scheduler import sched_counters
    from repro_torch.kernels import _sweep
    from repro_torch.kernels.gust_spmv import spread_launch_plan
    from repro_torch.kernels.ops import _prep_x
    from repro_torch.resilience import FaultError, FaultPlan, FaultSpec, fallback_counters
    from repro_torch.resilience import injected

    kernel_fns = wrappers()
    cfg = repro_torch.PlanConfig()  # l=256, c_blk=8, load-balanced, auto
    layers, rng = {}, np.random.default_rng(0)
    n_max, n_up = max(n for _, n in YI_MLP.values()), YI_MLP["up"][1]
    xs = {b: torch.from_numpy(rng.standard_normal((b, n_max)).astype(np.float32)).cuda()
          for b in (1, BATCH)}

    def build_layers():
        info = {}
        for name, (m, n) in YI_MLP.items():
            t0 = time.perf_counter()
            w = np.random.default_rng(0).standard_normal((m, n)).astype(np.float32)
            pruned = repro_torch.prune_by_magnitude(w, YI_DENSITY)
            r, c = np.nonzero(pruned)
            coo = COOMatrix((m, n), r.astype(np.int64), c.astype(np.int64), pruned[r, c])
            if coo.nnz != YI_NNZ:
                raise AssertionError(f"{name}: {coo.nnz} nonzeros after pruning, not {YI_NNZ}")
            prune_s = time.perf_counter() - t0
            cache = ScheduleCache()
            t0 = time.perf_counter()
            cache.schedule(coo, cfg.l, load_balance=cfg.load_balance, method=cfg.colorer)
            schedule_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            repro_torch.plan(coo, cfg, cache=cache).artifact
            torch.cuda.synchronize()
            pack_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            lin = repro_torch.GustLinear(w, config=cfg, density=YI_DENSITY, cache=cache)
            construct_s = time.perf_counter() - t0  # prune again; schedule and pack cached
            csr = sp.csr_matrix((coo.vals.astype(np.float64), (coo.rows, coo.cols)),
                                shape=(m, n))
            layers[name] = dict(lin=lin, coo=coo, csr=csr, w=pruned, cache=cache)
            info[name] = dict(prune_s=prune_s, schedule_s=schedule_s, pack_s=pack_s,
                              construct_s=construct_s, nnz=coo.nnz)
        return info

    built = phase(report, launch_counts, "linear_build", build_layers)

    def linear():  # the path: each layer's forward at B=1 and 8
        return {"y": {(name, b): L_["lin"](xs[b][:, :YI_MLP[name][1]].contiguous())
                      for name, L_ in layers.items() for b in (1, BATCH)}}

    ys = phase(report, launch_counts, "linear", linear).pop("y")
    rows = report["lifecycle"]["linear"]["rows"] = {}
    for name, L_ in layers.items():
        lin, (m, n) = L_["lin"], YI_MLP[name]
        p = lin.plan
        art, kname = p.artifact, plan_kernel(p)
        kernel, _ = kernel_fns[kname]
        cpu_plan = repro_torch.GustPlan.from_artifact(
            type(art)(**{f.name: (getattr(art, f.name).cpu()
                                  if isinstance(getattr(art, f.name), torch.Tensor)
                                  else getattr(art, f.name))
                         for f in dataclasses.fields(art)}),
            config=p.config)
        lib_csr = torch.sparse_csr_tensor(
            torch.from_numpy(L_["csr"].indptr).cuda(),
            torch.from_numpy(L_["csr"].indices.astype(np.int64)).cuda(),
            torch.from_numpy(L_["csr"].data.astype(np.float32)).cuda(), (m, n),
            check_invariants=False)
        dense = torch.from_numpy(L_["w"]).cuda()
        for b in (1, BATCH):
            x, y = xs[b][:, :n].contiguous(), ys[name, b]
            tag = f"linear {name} B={b}"
            err = check_gate(tag, y, L_["csr"], x)
            if b == 1:
                if not torch.equal(y.cpu(), cpu_plan.spmm(x.cpu(), transpose_io=True)):
                    raise AssertionError(f"{tag}: differs bitwise from its plain "
                                         "version on the CPU")
            else:
                for k in range(b):
                    if not torch.equal(y[k:k + 1], lin(x[k:k + 1])):
                        raise AssertionError(f"{tag}: row {k} differs bitwise from "
                                             "the same layer at B=1")
            xp = _prep_x(x.T, n, p.l)
            args, _, kw = kernel_args(kname, art)
            moved, ops = bytes_and_ops(kname, art, xp, b, lin.nnz)
            t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
            xt = x.T.contiguous()
            row = {
                "forward_ms": cuda_ms(lambda: lin(x), iters=50, warmup=5),
                "kernel": kname,
                "kernel_ms": cuda_ms(functools.partial(kernel, *args, xp, **kw), iters=50,
                                     warmup=5),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "cusparse_ms": library_ms(functools.partial(torch.matmul, lib_csr, xt),
                                          False, {}),
                "dense_matmul_ms": cuda_ms(functools.partial(torch.matmul, dense, xt),
                                           iters=50, warmup=5),
                "max_abs_err_vs_f64": err,
                "cycles": lin.cycles, "utilization": lin.hardware_utilization,
                "layout": p.layout, "gather": p.gather_mode, "pipeline": p._pipeline(),
                "stream_bytes": art.stream_bytes, "bytes": moved,
            }
            # device time of one forward, by kernel: what is left of
            # forward_ms is the card waiting on the host
            split = _sweep.profile_split(lambda: lin(x), ("spread_partials", "spread_fold"))
            row["device_ms"] = split["spread_partials"] + split["spread_fold"] + split["other"]
            row["device_split"] = split
            row["idle_share"] = max(0.0, 1.0 - row["device_ms"] / row["forward_ms"])
            if p.device.type == "cuda":
                row.update(spread_launch_plan(art.m_blk, args[1], art.row_blk, xp,
                                              l=art.l, c_blk=art.c_blk,
                                              gather=p.gather_mode,
                                              pipeline=p._pipeline()))
            row.update(built[name])
            rows[f"{name}/B={b}"] = row
            log(f"linear {name} {m}x{n} B={b}: forward {row['forward_ms']:.4f} ms "
                f"(device {row['device_ms']:.4f} ms, idle share {row['idle_share']:.3f}), "
                f"kernel {kname} {row['kernel_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms, cuSPARSE {row['cusparse_ms']} ms, dense "
                f"matmul {row['dense_matmul_ms']:.4f} ms, partial_bytes "
                f"{row.get('partial_bytes')}, cycles {row['cycles']}, utilization "
                f"{row['utilization']:.4f}, {row['layout']}/{row['gather']}/"
                f"{row['pipeline']}, schedule {row['schedule_s']:.1f} s, pack "
                f"{row['pack_s']:.1f} s; gate max abs err {err:.3e}; bitwise "
                + ("vs the CPU plain version" if b == 1 else "per row vs B=1"))
        del lib_csr, dense, cpu_plan
    del ys

    def store():
        up = layers["up"]
        with tempfile.TemporaryDirectory() as tmp:
            cold_store = repro_torch.PlanStore(tmp)
            t0 = time.perf_counter()
            cold = repro_torch.plan(up["coo"], cfg, cache=ScheduleCache(), store=cold_store)
            cold.artifact
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            file_bytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
            before = dict(sched_counters)
            warm_store = repro_torch.PlanStore(tmp)
            t0 = time.perf_counter()
            warm = repro_torch.plan(up["coo"], cfg, cache=ScheduleCache(), store=warm_store)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            if dict(sched_counters) != before or not warm._store_loaded:
                raise AssertionError("store: the warm load colored or missed "
                                     f"({before} -> {dict(sched_counters)})")
            if not leaves_equal(warm.artifact, cold.artifact):
                raise AssertionError("store: warm leaves differ from the cold plan's")
            for b in (1, BATCH):
                x = xs[b][:, :n_up].T.contiguous()
                if not torch.equal(warm.spmm(x), cold.spmm(x)):
                    raise AssertionError(f"store: warm spmm differs at B={b}")
            stats = warm_store.stats()
        log(f"store: {file_bytes} bytes, cold {cold_s:.2f} s, warm {warm_s:.2f} s; "
            "zero coloring on the warm load, leaves and spmm bitwise")
        return {"file_bytes": file_bytes, "cold_s": cold_s, "warm_s": warm_s,
                "warm_store": stats, "writes": cold_store.writes}

    phase(report, launch_counts, "store", store)

    def stack():
        gate, up = layers["gate"]["lin"].plan, layers["up"]["lin"].plan
        out = {}
        for gather in ("auto", "local"):
            stacked = repro_torch.GustPlan.stack([gate, up])
            out["meta"] = list(stacked["meta"])
            for i, base in enumerate((gate, up)):
                c = dataclasses.replace(base.config, gather=gather)
                sl = repro_torch.GustPlan.from_spec(
                    {"leaves": {k: v[i] for k, v in stacked["leaves"].items()},
                     "meta": stacked["meta"]}, config=c)
                ref = repro_torch.GustPlan.from_artifact(base.artifact, config=c)
                for b in (1, BATCH):
                    x = xs[b][:, :n_up].T.contiguous()
                    if not torch.equal(sl.spmm(x), ref.spmm(x)):
                        raise AssertionError(f"stack: layer {i} gather={gather} B={b} "
                                             "differs from its unstacked plan")
                    if gather == "local" and not torch.equal(sl.spmm(x), base.spmm(x)):
                        raise AssertionError(f"stack: layer {i} local differs from "
                                             "the resident plan")
                out[f"{gather}/{i}"] = {"gather": sl.gather_mode, "kernel": plan_kernel(sl),
                                        "s_blk": sl.artifact.s_blk,
                                        "c_pad": getattr(sl.artifact, "c_pad", None),
                                        "unstacked_c_pad": getattr(base.artifact, "c_pad",
                                                                   None)}
            del stacked
        log(f"stack: gate and up stacked; every slice bitwise its unstacked plan at "
            f"B=1 and {BATCH}, auto and local gathers: {out}")
        return {"slices": out}

    phase(report, launch_counts, "stack", stack)

    def tune():
        up = layers["up"]
        x = xs[BATCH][:, :n_up].T.contiguous()
        t0 = time.perf_counter()
        tuned = up["lin"].plan.tune(x)
        tune_s = time.perf_counter() - t0
        res = tuned.tuning
        err = check_gate("tune", tuned.spmm(x).T, up["csr"], x.T)
        log(f"tune: {tune_s:.1f} s; choice {res.choice}, baseline {res.baseline}, "
            f"improvement {res.improvement:.4f}, {len(res.measurements)} measured, "
            f"{len(res.pruned)} pruned; tuned plan passes the gate ({err:.3e})")
        return {"tune_s": tune_s, "result": res.to_dict(), "max_abs_err_vs_f64": err,
                "kernel": plan_kernel(tuned)}

    phase(report, launch_counts, "tune", tune)

    def reschedule():
        base = crank["plans"]["default", False, "ragged", "float32"]
        coo, l = crank["coo"], base.l
        m2 = edited_coo(coo, l, EDIT_WINDOWS)
        t0 = time.perf_counter()
        p2 = repro_torch.reschedule(base, m2)
        torch.cuda.synchronize()
        resched_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh = repro_torch.plan(m2, base.config, cache=ScheduleCache())
        fresh.artifact
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
        r = p2.resched
        if not r.spliced or r.full_fallback or r.dirty_windows != len(EDIT_WINDOWS):
            raise AssertionError(f"reschedule: {r}")
        if not leaves_equal(p2.artifact, fresh.artifact):
            raise AssertionError("reschedule: leaves differ from the fresh plan's")
        v = torch.from_numpy(np.random.default_rng(2).standard_normal(m2.shape[1])
                             .astype(np.float32)).cuda()
        if not torch.equal(p2.spmv(v), fresh.spmv(v)):
            raise AssertionError("reschedule: spmv differs from the fresh plan's")
        log(f"reschedule: {resched_s:.2f} s against a fresh plan's {fresh_s:.2f} s; "
            f"{r}; leaves and spmv bitwise the fresh plan's")
        return {"reschedule_s": resched_s, "fresh_s": fresh_s, "result": r.to_dict(),
                "edited_nnz": m2.nnz, "kernel": plan_kernel(p2)}

    phase(report, launch_counts, "reschedule", reschedule)

    def no_fallback():
        p = layers["gate"]["lin"].plan
        before = dict(fallback_counters)
        fp = FaultPlan([FaultSpec("kernel.execute", times=-1)], seed=0)
        raised = False
        with injected(fp):
            try:
                p.spmv(xs[1][0, :YI_MLP["gate"][1]])
            except FaultError:
                raised = True
        if not raised:
            raise AssertionError("no_fallback: a fault at kernel.execute did not reach "
                                 "the caller")
        return {"raised": raised, "fired": [list(f) for f in fp.fired]}

    out = phase(report, launch_counts, "no_fallback", no_fallback)
    if out["launches"]:
        raise AssertionError(f"no_fallback: a kernel launched ({out['launches']})")
    plans = [L_["lin"].plan for L_ in layers.values()] + list(crank["plans"].values())
    for p in plans:
        c = p.cost()
        if c.fallback_kernel or c.fallback_gather:
            raise AssertionError(f"{p}: fallback_kernel {c.fallback_kernel}, "
                                 f"fallback_gather {c.fallback_gather}")
    if any(fallback_counters.values()):
        raise AssertionError(f"fallback counters moved: {fallback_counters}")
    log(f"no_fallback: kernel.execute raised, no kernel launched, every fallback "
        f"counter 0 on {len(plans)} plans")
    for name in ("linear", "stack", "tune", "reschedule"):
        if not report["lifecycle"][name]["launches"]:
            raise AssertionError(f"phase {name} launched no kernel")


#: yi-6b as the serving path drives it (src/repro/configs/yi_6b.py):
#: the published widths it must have, the traffic and the engine.
YI_WIDTHS = dict(d_model=4096, n_heads=32, n_kv=4, head_dim=128, d_ff=11008,
                 vocab=64_000, n_layers=32)
SERVE = dict(batch=4, seq_len=512, prompt_lens=(64, 96, 128), requests=8, max_new=32,
             gust_layers=2, profile_steps=8)
#: Tolerances, of the largest |logit|: the card's first decode step at two
#: layers against the CPU's plain path (float32 products summed in another
#: order), and the GUST decode against a dense decode on the same pruned
#: MLP weights (the sparse products sum in another order).
TOL_SERVE_CPU, TOL_SERVE_GUST = 2e-4, 1e-4
SERVE_DEVICE = "cuda"


def first_layers(params, sc, n):
    """The parameter tree of the first ``n`` layers of stack ``sc`` (views):
    ``n // P`` repetitions of its pattern of length P, then the first
    ``n % P`` blocks of the next as the tail."""
    from repro_torch.models.transformer import rep_slice
    from repro_torch.models.tree import tree_map

    reps, stack = n // len(sc.pattern), params["stack"]
    tail = [rep_slice(stack["reps"][i], reps) if reps < sc.reps else stack["tail"][i]
            for i in range(n % len(sc.pattern))]
    return dict(params, stack={"reps": tuple(tree_map(lambda a: a[:reps], r)
                                             for r in stack["reps"]),
                               "tail": tail})


def serve_prompts(vocab):
    """The serving traffic's prompts: lengths 64, 96, 128 in turn, tokens
    from numpy seed 0."""
    rng = np.random.default_rng(0)
    lens = SERVE["prompt_lens"]
    return [rng.integers(0, vocab, lens[r % len(lens)]).astype(np.int32)
            for r in range(SERVE["requests"])]


def first_step_vs_cpu(lm, params, prompt, seq_len, what):
    """Prefill ``prompt`` and take one greedy decode step with ``params``
    on the card and with a host copy on the CPU's plain path (float32):
    both pick the same first token, and the step's logits agree within
    ``TOL_SERVE_CPU`` of the largest |logit|."""
    import torch

    from repro_torch.models.tree import tree_map

    dev = torch.device(SERVE_DEVICE)
    cpu = tree_map(lambda a: a.cpu(), params)
    x = torch.from_numpy(prompt)[None]
    logits = {}
    for name, p, d in (("card", params, dev), ("cpu", cpu, torch.device("cpu"))):
        t0 = time.perf_counter()
        caches = lm.init_caches(1, seq_len, torch.float32, device=d)
        first, caches = lm.prefill(p, {"tokens": x.to(d)}, caches, dtype=torch.float32)
        tok = torch.argmax(first[:, -1], dim=-1).to(torch.int32)
        if name == "cpu" and not torch.equal(tok, logits["card"][1]):
            raise AssertionError(f"{what}: card and CPU prefill pick different first "
                                 "tokens")
        step, _ = lm.decode_step(p, caches, tok[:, None].to(d), x.shape[1],
                                 dtype=torch.float32)
        logits[name] = (step.cpu(), tok.cpu(), time.perf_counter() - t0)
    del cpu
    # the padded vocabulary's columns hold -1e30 on both: compare the real ones
    (card, card_pad), (host, host_pad) = (
        logits[k][0].split([lm.cfg.vocab, lm.cfg.padded_vocab - lm.cfg.vocab], dim=-1)
        for k in ("card", "cpu"))
    if not torch.equal(card_pad, host_pad):
        raise AssertionError(f"{what}: the padded vocabulary's logits differ")
    err = float((card - host).abs().max())
    scale = float(host.abs().max())
    if not np.isfinite(err) or err > TOL_SERVE_CPU * scale:
        raise AssertionError(f"{what}: the {lm.stack.n_layers}-layer decode step on the "
                             f"card is {err:.3e} off the CPU's (max |logit| {scale:.3e})")
    return {"layers": lm.stack.n_layers, "max_abs_err": err, "max_abs_logit": scale,
            "cpu_s": logits["cpu"][2], "card_s": logits["card"][2]}


def instrument(loop):
    """Wrap the loop's prefill, decode and sampler in CUDA events; returns
    the list each call appends ``(kind, prompt length or None, start,
    end)`` to."""
    import torch

    calls = []

    def timed(kind, fn):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            size = args[1]["tokens"].shape[1] if kind == "prefill" else None
            calls.append((kind, size, start, end))
            return out
        return run

    loop._prefill = timed("prefill", loop._prefill)
    loop._decode = timed("decode", loop._decode)
    loop._sample_rows = timed("sample", loop._sample_rows)
    return calls


def zero_launches(launch_counts):
    for mod, attr in launch_counts.values():
        setattr(mod, attr, 0)


def read_launches(launch_counts):
    """The kernels launched since the counts were zeroed, by name."""
    counts = {k: getattr(mod, attr) for k, (mod, attr) in launch_counts.items()}
    return {k: v for k, v in counts.items() if v}


def check_run(loop, rids, launches, kernel, steps, what):
    """Every request of ``rids`` DONE, no contained decode retry or
    failure and no fallback so far on ``loop``, and ``launches`` exactly
    one of ``kernel`` per GUST product of ``steps`` decode steps (three a
    layer; none at all when ``kernel`` is None, the dense decode)."""
    statuses = {str(loop.results[r].status) for r in rids}
    res = loop.resilience_stats()
    if statuses != {"DONE"} or res["decode_retries"] or res["failed"] or any(
            v for k, v in res.items() if k.startswith("fallback_")):
        raise AssertionError(f"{what}: statuses {statuses}, resilience {res}")
    want = {} if kernel is None else {kernel: 3 * loop.lm.stack.n_layers * steps}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, not {want} (one per GUST "
                             "product)")
    return res


def serve_run(loop, prompts, launch_counts, kernel):
    """Enqueue ``prompts``, drain the loop with the launch counts zeroed
    just before and read just after; the phase's numbers."""
    import torch

    calls = instrument(loop)
    zero_launches(launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [loop.enqueue(x, max_new=SERVE["max_new"]) for x in prompts]
    loop.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(launch_counts)
    prefill, decode, sample = {}, [], []
    for kind, size, start, end in calls:
        ms = start.elapsed_time(end)
        if kind == "prefill":
            prefill.setdefault(str(size), []).append(ms)
        else:
            (decode if kind == "decode" else sample).append(ms)
    tokens = sum(len(loop.results[r].tokens) for r in rids)
    out = {
        "wall_s": wall, "tokens": tokens, "tok_per_s": tokens / wall,
        "decode_steps": loop.stats["decode_steps"], "slot_occupancy": loop.occupancy,
        "prefill_ms_by_prompt_len": {k: float(np.median(v)) for k, v in prefill.items()},
        "decode_step_ms": {"median": float(np.median(decode)), "min": float(min(decode)),
                           "max": float(max(decode)), "mean": float(np.mean(decode))},
        "sample_ms_median": float(np.median(sample)),
        "launches": launches,
    }
    out["resilience"] = check_run(loop, rids, launches, kernel, out["decode_steps"],
                                  "serving")
    return [loop.results[r].tokens for r in rids], out


def solo_equals(loop, prompts, streams, index, launch_counts, kernel):
    """Serve prompts[index] alone on the (now idle) engine of the same
    batch; its stream must equal the mixed run's, bit for bit."""
    zero_launches(launch_counts)
    steps0 = loop.stats["decode_steps"]
    rid = loop.submit(prompts[index], max_new=SERVE["max_new"])
    loop.run_to_completion()
    check_run(loop, [rid], read_launches(launch_counts), kernel,
              loop.stats["decode_steps"] - steps0, f"request {index} served alone")
    if loop.results[rid].tokens != streams[index]:
        raise AssertionError(f"request {index} served alone differs from its stream in "
                             "the mixed run")


def decode_profile(loop, prompts, steps, step_ms, launch_counts, kernel):
    """``torch.profiler`` (CUDA activity) over ``steps`` decode steps of a
    full batch on the idle engine: device ms per step by kernel, and the
    idle share ``1 - device / wall``, against the profiled window's wall
    and against ``step_ms``, the unprofiled run's median step.  The
    window's launch counts and the batch's statuses are checked as
    ``serve_run``'s are."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rids = [loop.enqueue(x, max_new=steps + 2) for x in prompts[:loop.cfg.batch]]
    loop.step()  # admissions and a first decode step, outside the window
    torch.cuda.synchronize()
    steps0 = loop.stats["decode_steps"]
    zero_launches(launch_counts)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loop.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = read_launches(launch_counts)
    if loop.stats["decode_steps"] - steps0 != steps:
        raise AssertionError(f"profile: {loop.stats['decode_steps'] - steps0} decode "
                             f"steps in the window, not {steps}")
    loop.run_to_completion()
    check_run(loop, rids, launches, kernel, steps, "profiled decode steps")
    by_kernel, launched = {}, 0
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = evt.cuda_time_total
        if total:
            by_kernel[evt.key[:100]] = total / steps / 1e3
            launched += evt.count
    groups = {"gust_spmv": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms in by_kernel.items():
        low = name.lower()
        if "spread" in low:
            groups["gust_spmv"] += ms
        elif "gemm" in low or "gemv" in low or "cutlass" in low or "matmul" in low:
            groups["gemm"] += ms
        else:
            groups["other"] += ms
    device_ms = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    return {"steps": steps, "launches": launches,
            "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "device_ops_per_step": launched / steps,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "idle_share_vs_unprofiled_step": max(0.0, 1.0 - device_ms / step_ms),
            "by_group_ms": groups,
            "top_kernels_ms": top}


def serve_path(report, launch_counts):
    """Serving yi-6b at its published widths on the card, random weights
    from a seeded ``torch.Generator``.  ``serve.dense``: all 32 layers,
    float32, 8 requests (prompts of 64, 96 and 128 tokens, 32 new tokens
    each) through the continuous-batching ``ServeLoop`` at batch 4; one
    request alone equals its mixed stream bitwise; the first decode step
    at two layers agrees with the CPU's plain path.  ``serve.gust``: the
    first two layers, gustified at ``GustServeConfig()`` (padded, kernel 5)
    and with ``ragged=True`` (kernel 7), serving the same traffic: every
    GUST product launches its kernel, padded == ragged and solo ==
    concurrent bitwise, and a GUST decode step agrees with a dense one on
    the same pruned MLP weights."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.tree import tree_map
    from repro_torch.resilience import fallback_counters
    from repro_torch.serving import (CachePolicy, GustServeConfig, ServeConfig,
                                     ServeLoop, cache_bytes, decode_step_gust)
    from repro_torch.core.gust_linear import prune_by_magnitude

    dev = torch.device(SERVE_DEVICE)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the float32 products would not be float32")
    cfg = get_arch("yi_6b")
    widths = {k: getattr(cfg, k) for k in YI_WIDTHS}
    if widths != YI_WIDTHS:
        raise AssertionError(f"yi-6b widths {widths} != the published {YI_WIDTHS}")
    lm = build_model(cfg)
    out = report.setdefault("serve", {})
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = lm.param_count(params)
    out["param_bytes"] = out["params"] * 4
    sc = ServeConfig(batch=SERVE["batch"], seq_len=SERVE["seq_len"], dtype="float32")
    out["kv_cache_bytes"] = cache_bytes(lm, sc.batch, sc.seq_len, CachePolicy("float32"))
    prompts = serve_prompts(cfg.vocab)
    log(f"serve: yi-6b {widths}, {out['params']} parameters ({out['param_bytes']} "
        f"bytes float32), init {out['init_s']:.1f} s; KV cache at batch {sc.batch}, "
        f"seq_len {sc.seq_len}: {out['kv_cache_bytes']} bytes")

    # -- serve.dense: all 32 layers ---------------------------------------------------
    loop = ServeLoop(lm, params, sc)
    streams, dense = serve_run(loop, prompts, launch_counts, None)
    solo_equals(loop, prompts, streams, 1, launch_counts, None)
    dense["profile"] = decode_profile(loop, prompts, SERVE["profile_steps"],
                                      dense["decode_step_ms"]["median"], launch_counts,
                                      None)
    del loop
    # the first decode step at two layers, on the card and on the CPU
    lm2 = build_model(dataclasses.replace(cfg, n_layers=SERVE["gust_layers"]))
    params2 = first_layers(params, lm.stack, SERVE["gust_layers"])
    dense["cpu_check"] = first_step_vs_cpu(lm2, params2, prompts[0], sc.seq_len,
                                           "serve.dense")
    err, scale = dense["cpu_check"]["max_abs_err"], dense["cpu_check"]["max_abs_logit"]
    out["dense"] = dense
    log(f"serve.dense: {cfg.n_layers} layers, {dense['tokens']} tokens in {dense['wall_s']:.2f} s "
        f"({dense['tok_per_s']:.1f} tokens/s), {dense['decode_steps']} decode steps, "
        f"step {json.dumps(dense['decode_step_ms'])} ms, sampler "
        f"{dense['sample_ms_median']:.3f} ms, prefill ms by prompt length "
        f"{json.dumps(dense['prefill_ms_by_prompt_len'])}, occupancy "
        f"{dense['slot_occupancy']:.3f}; every request DONE, no retry or fallback; solo "
        f"== mixed bitwise; 2-layer decode step card vs CPU max abs err {err:.3e} "
        f"(max |logit| {scale:.3e}); profile "
        f"{json.dumps({k: v for k, v in dense['profile'].items() if k != 'top_kernels_ms'})}")

    # -- serve.gust: the first 2 layers, gustified padded then ragged ----------------
    gust_streams = {}
    for layout in ("padded", "ragged"):
        gcfg = GustServeConfig(ragged=layout == "ragged")
        t0 = time.perf_counter()
        loop = ServeLoop(lm2, params2, dataclasses.replace(sc, gust=gcfg))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        plans = loop.gust_tree["plans"]
        kernels = {plan_kernel(p) for ps in plans.values() for p in ps}
        want = "gust_spmv_ragged_db" if layout == "ragged" else "gust_spmv_db"
        if kernels != {want}:
            raise AssertionError(f"serve.gust {layout}: the plans resolve {kernels}, "
                                 f"not {want}")
        streams, row = serve_run(loop, prompts, launch_counts, want)
        solo_equals(loop, prompts, streams, 1, launch_counts, want)
        row["profile"] = decode_profile(loop, prompts, SERVE["profile_steps"],
                                        row["decode_step_ms"]["median"], launch_counts,
                                        want)
        gust_streams[layout] = streams
        tree = loop.gust_tree
        row.update(build_s=build_s, gustify_s=tree["seconds"], kernel=want,
                   stats={k: v for k, v in tree["stats"].items()})
        if layout == "padded":
            gust_loop, gust_cfg = loop, gcfg
        out[f"gust_{layout}"] = row
        log(f"serve.gust {layout}: 2 layers, gustify {build_s:.1f} s "
            f"{json.dumps(tree['seconds'])}, {row['tokens']} tokens in "
            f"{row['wall_s']:.2f} s ({row['tok_per_s']:.1f} tokens/s), "
            f"{row['decode_steps']} decode steps, step "
            f"{json.dumps(row['decode_step_ms'])} ms, sampler "
            f"{row['sample_ms_median']:.3f} ms, prefill ms "
            f"{json.dumps(row['prefill_ms_by_prompt_len'])}, occupancy "
            f"{row['slot_occupancy']:.3f}, launches {row['launches']}; stats "
            f"{json.dumps(row['stats'])}; profile "
            f"{json.dumps({k: v for k, v in row['profile'].items() if k != 'top_kernels_ms'})}")
        del loop
    if gust_streams["padded"] != gust_streams["ragged"]:
        raise AssertionError("serve.gust: padded and ragged token streams differ")

    # a GUST decode step against a dense one on the same pruned MLP weights
    pruned = {}
    mlp = params2["stack"]["reps"][0]["mlp"]
    for name, w in mlp.items():
        pruned[name] = torch.stack([
            torch.from_numpy(np.ascontiguousarray(prune_by_magnitude(
                w[r].cpu().numpy().T, gust_cfg.density).T)) for r in range(w.shape[0])
        ]).to(dev)
    params_pruned = dict(params2, stack={"reps": (dict(params2["stack"]["reps"][0],
                                                       mlp=pruned),), "tail": []})
    caches = lm2.init_caches(sc.batch, sc.seq_len, torch.float32, device=dev)
    template = lm2.init_caches(1, sc.seq_len, torch.float32, device=dev)
    for slot, x in enumerate(prompts[:sc.batch]):
        _, one = lm2.prefill(params2, {"tokens": torch.from_numpy(x)[None].to(dev)},
                             template, dtype=torch.float32)
        lm2.insert_slot_caches(caches, one, slot)
    pos = torch.tensor([len(x) for x in prompts[:sc.batch]], dtype=torch.int32, device=dev)
    tok = torch.arange(sc.batch, dtype=torch.int32, device=dev)[:, None] * 7
    twin = tree_map(lambda a: a.clone(), caches)
    want, _ = lm2.decode_step(params_pruned, twin, tok, pos, dtype=torch.float32)
    got, _ = decode_step_gust(lm2, params2, gust_loop.gust_tree, caches, tok, pos,
                              dtype=torch.float32)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not np.isfinite(err) or err > TOL_SERVE_GUST * scale:
        raise AssertionError(f"serve.gust: the GUST decode step is {err:.3e} off the dense "
                             f"one on the pruned weights (max |logit| {scale:.3e})")
    out["gust_vs_dense_pruned"] = {"max_abs_err": err, "max_abs_logit": scale}
    if any(fallback_counters.values()):
        raise AssertionError(f"serve: fallback counters moved: {fallback_counters}")
    log(f"serve.gust: padded == ragged token streams bitwise; solo == mixed bitwise; "
        f"GUST decode vs dense on the pruned weights max abs err {err:.3e} (max |logit| "
        f"{scale:.3e})")


#: The families path: per phase the arch (``src/repro/configs/<arch>.py``),
#: the published widths it must have, the layers it runs (its depth, cut
#: to fit the card's 80 GB in float32 and the smoke's time; never its
#: widths) and the layers of its card-vs-CPU check (one for the MoE archs,
#: whose 1-layer weights, 12.4 and 15.5 GB, are copied to the host).
FAMILIES = {
    "llama4": ("llama4_scout_17b_a16e",
               dict(d_model=5120, n_heads=40, n_kv=8, head_dim=128, d_ff=8192,
                    n_experts=16, top_k=1, vocab=202_048, n_layers=48), 4, 1),
    "dbrx": ("dbrx_132b",
             dict(d_model=6144, n_heads=48, n_kv=8, head_dim=128, d_ff=10752,
                  n_experts=16, top_k=4, vocab=100_352, n_layers=40), 2, 1),
    "recurrentgemma": ("recurrentgemma_9b",
                       dict(d_model=4096, n_heads=16, n_kv=1, head_dim=256, d_ff=12288,
                            vocab=256_000, local_window=2048, n_layers=38), 5, 5),
    "xlstm": ("xlstm_125m", dict(d_model=768, n_heads=4, vocab=50_304, n_layers=12),
              12, 12),
}


def families_path(report, launch_counts):
    """Serving the MoE and recurrent archs at their published widths on
    the card, each phase's weights drawn from ``torch.Generator`` seed 0 on
    the card and freed before the next: llama4-scout (4 of 48 layers: one
    pattern repetition, MoE top-1 over 16 experts), dbrx (2 of 40: MoE
    top-4, rep stacking), recurrentgemma (5 of 38: RG-LRU, local
    attention, the 2-block tail) and xlstm (all 12: mLSTM, sLSTM).  Float32
    at batch 4 and ``seq_len`` 512, the serving path's traffic: every
    request DONE with no retry, failure or fallback and no GUST kernel
    launched; one request alone equals its mixed stream bitwise;
    ``decode_profile`` over 8 decode steps; the first decode step on the
    card within ``TOL_SERVE_CPU`` of the CPU's plain path, with the same
    first token.  Returns the summary the ``families`` line prints."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving import CachePolicy, ServeConfig, ServeLoop, cache_bytes

    dev = torch.device(SERVE_DEVICE)
    out = report.setdefault("families", {})
    summary = {}
    for name, (arch, widths, layers, cpu_layers) in FAMILIES.items():
        t_phase = time.perf_counter()
        cfg = get_arch(arch)
        got = {k: getattr(cfg, k) for k in widths}
        if got != widths:
            raise AssertionError(f"families.{name}: {arch} widths {got} != the published "
                                 f"{widths}")
        lm = build_model(dataclasses.replace(cfg, n_layers=layers))
        # the earlier paths' engines are reference cycles (``instrument``)
        # that may still hold their weights: free them before drawing these
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = lm.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        row = {"arch": arch, "layers": layers, "of_layers": cfg.n_layers,
               "init_s": time.perf_counter() - t0, "params": lm.param_count(params),
               "start_memory_bytes": start_bytes}
        # a decode step reads every parameter once (every expert's weights,
        # the tied table for the logits): its bytes bound at the HBM rate
        row["param_bytes"] = row["params"] * 4
        row["decode_bytes_bound_ms"] = row["param_bytes"] / HBM_BYTES_PER_S * 1e3
        sc = ServeConfig(batch=SERVE["batch"], seq_len=SERVE["seq_len"], dtype="float32")
        row["cache_bytes"] = cache_bytes(lm, sc.batch, sc.seq_len, CachePolicy("float32"))
        prompts = serve_prompts(cfg.vocab)
        loop = ServeLoop(lm, params, sc)
        streams, run = serve_run(loop, prompts, launch_counts, None)
        solo_equals(loop, prompts, streams, 1, launch_counts, None)
        run["profile"] = decode_profile(loop, prompts, SERVE["profile_steps"],
                                        run["decode_step_ms"]["median"], launch_counts,
                                        None)
        del loop
        row.update(run)
        lm_cpu = build_model(dataclasses.replace(cfg, n_layers=cpu_layers))
        row["cpu_check"] = first_step_vs_cpu(lm_cpu, first_layers(params, lm.stack,
                                                                  cpu_layers),
                                             prompts[0], sc.seq_len, f"families.{name}")
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        del params
        row["seconds"] = time.perf_counter() - t_phase
        out[name] = row
        prof = row["profile"]
        summary[name] = {
            "arch": arch, "layers": f"{layers}/{cfg.n_layers}", "params": row["params"],
            "decode_step_ms": row["decode_step_ms"]["median"],
            "decode_bytes_bound_ms": row["decode_bytes_bound_ms"],
            "device_ms_per_step": prof["device_ms_per_step"],
            "device_ops_per_step": prof["device_ops_per_step"],
            "idle_share": prof["idle_share"],
            "prefill_ms_by_prompt_len": row["prefill_ms_by_prompt_len"],
            "tok_per_s": row["tok_per_s"], "peak_memory_bytes": row["peak_memory_bytes"],
            "start_memory_bytes": start_bytes,
            "cpu_check_max_abs_err": row["cpu_check"]["max_abs_err"],
            "cpu_check_max_abs_logit": row["cpu_check"]["max_abs_logit"],
            "seconds": row["seconds"],
        }
        log(f"families.{name}: {arch} {layers} of {cfg.n_layers} layers, {row['params']} "
            f"parameters, init {row['init_s']:.1f} s; {row['tokens']} tokens in "
            f"{row['wall_s']:.2f} s ({row['tok_per_s']:.1f} tokens/s), "
            f"{row['decode_steps']} decode steps, step "
            f"{json.dumps(row['decode_step_ms'])} ms (bytes bound "
            f"{row['decode_bytes_bound_ms']:.2f} ms), prefill ms "
            f"{json.dumps(row['prefill_ms_by_prompt_len'])}, peak memory "
            f"{row['peak_memory_bytes']} bytes ({start_bytes} at the start); every request DONE, no retry, fallback or "
            f"kernel; solo == mixed bitwise; {cpu_layers}-layer decode step card vs CPU "
            f"max abs err {row['cpu_check']['max_abs_err']:.3e} (max |logit| "
            f"{row['cpu_check']['max_abs_logit']:.3e}); profile "
            f"{json.dumps({k: v for k, v in prof.items() if k != 'top_kernels_ms'})}; "
            f"{row['seconds']:.1f} s")
    return summary


def edited_coo(coo, l, windows, seed=0):
    """``coo`` with an edit confined to the rows of ``windows``: about 1% of
    their values rescaled, three of their edges dropped and three added."""
    from repro_torch.core.formats import COOMatrix

    rng = np.random.default_rng(seed)
    rows, cols, vals = coo.rows.copy(), coo.cols.copy(), coo.vals.copy()
    keep = np.ones(coo.nnz, dtype=bool)
    add_r, add_c = [], []
    for w in windows:
        idx = np.nonzero(rows // l == w)[0]
        scale = idx[rng.random(idx.size) < 0.01]
        vals[scale] *= np.float32(1.5)
        keep[rng.choice(idx, 3, replace=False)] = False
        present = set((rows[idx] * coo.shape[1] + cols[idx]).tolist())
        while len(add_r) < 3 * (windows.index(w) + 1):
            r, c = int(rng.integers(w * l, (w + 1) * l)), int(rng.integers(coo.shape[1]))
            if r * coo.shape[1] + c not in present:
                present.add(r * coo.shape[1] + c)
                add_r.append(r)
                add_c.append(c)
    return COOMatrix(coo.shape,
                     np.concatenate([rows[keep], np.asarray(add_r, np.int64)]),
                     np.concatenate([cols[keep], np.asarray(add_c, np.int64)]),
                     np.concatenate([vals[keep], np.ones(len(add_r), np.float32)]))


def spilling_functions(lines):
    """(function, line) of each function whose ptxas report (``-v``)
    shows a spill: ptxas names a function ("Function properties for
    NAME") just before its stack and spill line."""
    out, fn = [], None
    for ln in lines:
        named = re.search(r"Function properties for (\S+)", ln)
        if named:
            fn = named.group(1)
        elif "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln:
            out.append((fn, ln.strip()))
    return out


def library_ms(run_library, heavy, row):
    """Time of the PyTorch call that computes the kernel's function, or
    None (with the reason in ``row``) where the installed PyTorch cannot
    run it on the card."""
    try:
        return cuda_ms(run_library, iters=2 if heavy else 20, warmup=1 if heavy else 2)
    except (RuntimeError, NotImplementedError) as err:
        row["library_error"] = f"{type(err).__name__}: {err}"[:300]
        return None


def g_graph():
    """G: the symmetric 0/1 pattern of synth_power_law(G_N, G_DENSITY,
    seed=0) without self-loops."""
    from repro_torch.data.matrices import synth_power_law
    from repro_torch.graph.analytics import _pattern

    return _pattern(synth_power_law(G_N, G_DENSITY, seed=0), symmetrize=True,
                    drop_diagonal=True)


def spgemm_path(report, launch_counts, launches, variants, timed):
    """Kernel 9 against its plain version on G, then the SpGEMM path
    (triangle_count, GustPlan.spgemm on both layouts, pagerank,
    feature_propagation) with the launch counts zeroed just before it, and
    its results against the dense product and scipy in float64.  Appends
    kernel 9's timing rows to ``timed``; returns what the wall-time split
    needs."""
    import scipy.sparse as sp
    import torch

    import repro_torch
    import repro_torch.kernels.ref as plain
    from repro_torch.core.formats import COOMatrix
    from repro_torch.core.spgemm import _stream_view, row_offsets, row_windows
    from repro_torch.graph import feature_propagation, pagerank, triangle_count
    from repro_torch.kernels.gust_spgemm import gust_spgemm, spgemm_launch_plan
    from repro_torch.kernels.spgemm_sweep import kernel9_split

    t0 = time.perf_counter()
    G = g_graph()
    n = G.shape[0]
    if G.nnz != G_EDGES:
        raise AssertionError(f"G has {G.nnz} edges, not {G_EDGES}")
    gplans = {layout: repro_torch.plan(G, repro_torch.PlanConfig(l=L, layout=layout),
                                       device="cuda") for layout in ("padded", "ragged")}
    default_layout = repro_torch.plan(G, repro_torch.PlanConfig(l=L), device="cuda").layout
    for p in gplans.values():
        p.artifact
    offs = row_offsets(G, L, device="cuda")
    torch.cuda.synchronize()
    sched = gplans["ragged"].sched
    cost = gplans[default_layout].spgemm_cost(G)
    info = {
        "nodes": n, "edges": G.nnz, "k_max": cost.k_max, "windows": sched.num_windows,
        "c_max": int(sched.colors_per_window.max()), "products": cost.products,
        "slots": {k: p.artifact.streamed_slots for k, p in gplans.items()},
        "condensed_b_bytes": cost.b_condensed_bytes, "b_offsets_bytes": offs.nbytes,
        "default_layout": default_layout, "setup_s": time.perf_counter() - t0,
    }
    report["G"] = info
    log(f"G: {n} nodes, {G.nnz} edges, k_max {cost.k_max}, {sched.num_windows} windows, "
        f"C_max {info['c_max']}, {cost.products} partial products, slots "
        f"{info['slots']}, B by row offsets {offs.nbytes} bytes (condensed planes "
        f"{cost.b_condensed_bytes}, not built); default PlanConfig(l={L}) resolves layout "
        f"{default_layout!r}; set-up {info['setup_s']:.1f} s")

    # -- kernel phase: kernel 9 against its plain version -------------------------
    gcsr = torch.sparse_csr_tensor(
        torch.from_numpy(np.concatenate([[0], np.cumsum(G.row_nnz())])).cuda(),
        torch.from_numpy(G.cols).cuda(), torch.from_numpy(G.vals).cuda(), G.shape,
        check_invariants=False)
    rng = np.random.default_rng(0)
    gfloat = COOMatrix(G.shape, G.rows, G.cols, rng.standard_normal(G.nnz).astype(np.float32))
    offs_f = row_offsets(gfloat, L, device="cuda")
    fcsr = torch.sparse_csr_tensor(gcsr.crow_indices(), gcsr.col_indices(),
                                   torch.from_numpy(gfloat.vals).cuda(), G.shape,
                                   check_invariants=False)
    for layout, p in gplans.items():
        art = p.artifact
        _, _, bs = _stream_view(art)
        window = row_windows(bs, art.c_blk)
        kw = dict(num_windows=art.num_windows, l=L, n_out=n)
        cases = [("0/1", art.m_blk, offs, gcsr)]
        if layout == default_layout:
            cases.append(("normal", revalue(art, window, G, gfloat.vals), offs_f, fcsr))
        for values, m_blk, ob, lib_csr in cases:
            args = (bs, m_blk, art.col_blk, art.row_blk, ob.vals, ob.cols)
            pargs = (m_blk, art.col_blk, art.row_blk, window, ob.vals, ob.cols)
            kkw = dict(kw, c_blk=art.c_blk, b_ptr=ob.ptr, real_slots=G.nnz)
            pkw = dict(kw, b_ptr=ob.ptr)
            y_k = gust_spgemm(*args, **kkw)
            y_p = plain.gust_spgemm_ref(*pargs, **pkw)
            torch.cuda.synchronize()
            tag = f"gust_spgemm {layout} {values}"
            if not bool(torch.isfinite(y_k).all()):
                raise AssertionError(f"{tag}: non-finite output")
            err = float((y_k - y_p).abs().max())
            if values == "0/1":
                if not torch.equal(y_k, y_p):
                    raise AssertionError(f"{tag}: differs bitwise from its plain version "
                                         f"(max abs err {err:.3e})")
            else:
                mag = plain.gust_spgemm_ref(m_blk.abs(), art.col_blk, art.row_blk, window,
                                            ob.vals.abs(), ob.cols, **pkw)
                if bool(((y_k - y_p).abs() > TOL_SPGEMM * mag).any()):
                    raise AssertionError(f"{tag}: off its plain version beyond "
                                         f"{TOL_SPGEMM} * (|A|·|B|) (max abs err {err:.3e})")
                del mag
            del y_k, y_p
            row = {"kernel": "gust_spgemm", "load_balance": True, "value_dtype": "float32",
                   "B": 1, "layout": layout, "values": values, "max_abs_err": err,
                   "variant": f"G, {layout} stream, {values} values",
                   "head": (layout, values) == (default_layout, "0/1")}
            if values == "0/1":
                row["bitwise_vs_plain"] = True
            variants.append(row)
            moved = spgemm_bytes(art, m_blk, bs, ob, n)
            run = functools.partial(gust_spgemm, *args, **kkw)
            stats = {}
            gust_spgemm(*args, **kkw, stats=stats)
            row.update(spgemm_launch_plan(torch.device("cuda")))
            per_cta = sorted(stats.pop("cta_longest_unit_cycles"))
            row.update(stats, median_cta_longest_unit_cycles=per_cta[len(per_cta) // 2],
                       shortest_cta_longest_unit_cycles=per_cta[0])
            row.update(kernel9_split(run))
            timed.append((row, run, functools.partial(plain.gust_spgemm_ref, *pargs, **pkw),
                          functools.partial(torch.sparse.mm, lib_csr, lib_csr),
                          (moved, 2 * cost.products)))
            log(f"kernel {tag}: max |kernel - plain| = {err:.3e}"
                + ("; bitwise" if values == "0/1" else f" (within {TOL_SPGEMM} * |A|·|B|)"))
    # -- the path -----------------------------------------------------------------
    for mod, attr in launch_counts.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    tc = triangle_count(G)
    t_tc = time.perf_counter() - t0
    coos = {layout: p.spgemm(G) for layout, p in gplans.items()}
    feats = np.random.default_rng(1).standard_normal((n, G_FEATURES)).astype(np.float32)
    t0 = time.perf_counter()
    pr = pagerank(G)
    t_pr = time.perf_counter() - t0
    t0 = time.perf_counter()
    H = feature_propagation(G, feats, num_layers=2)
    t_fp = time.perf_counter() - t0
    torch.cuda.synchronize()
    path_launches = {name: getattr(mod, attr) for name, (mod, attr) in launch_counts.items()}
    launches["gust_spgemm"] = path_launches["gust_spgemm"]
    info.update(triangle_count_s=t_tc, pagerank_s=t_pr, feature_propagation_s=t_fp,
                path_launches=path_launches)
    log(f"SpGEMM path: triangle_count {t_tc:.2f} s, pagerank {t_pr:.2f} s "
        f"({pr.iterations} iterations), feature_propagation {t_fp:.2f} s; launches "
        f"{path_launches}")
    if path_launches["gust_spgemm"] <= 0:
        raise AssertionError("the SpGEMM path never launched gust_spgemm")

    # -- checks -------------------------------------------------------------------
    s01 = sp.csr_matrix((np.ones(G.nnz), (G.rows, G.cols)), shape=G.shape)
    t0 = time.perf_counter()
    want_tri = int(round(float(s01.multiply(s01 @ s01).sum()) / 6))
    info["scipy_triangles_s"] = time.perf_counter() - t0
    info["triangles"], info["spgemm_nnz"] = tc.triangles, tc.spgemm_nnz
    if tc.triangles != want_tri or tc.triangles != G_TRIANGLES:
        raise AssertionError(f"triangle_count(G) = {tc.triangles}; scipy {want_tri}, "
                             f"expected {G_TRIANGLES}")
    if tc.spgemm_nnz != G_GG_NNZ:
        raise AssertionError(f"triangle_count(G) saw {tc.spgemm_nnz} nonzeros in G·G, "
                             f"not {G_GG_NNZ}")
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    gd = torch.zeros(G.shape, dtype=torch.float32, device=gcsr.device)
    gd[torch.from_numpy(G.rows).cuda(), torch.from_numpy(G.cols).cuda()] = 1.0
    gg = gd @ gd
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    del gd
    for layout, c in coos.items():
        keys = c.rows * np.int64(n) + c.cols
        if not (np.all(np.diff(keys) > 0) and np.all(c.vals != 0)):
            raise AssertionError(f"spgemm {layout}: result is not canonical")
        cd = torch.zeros_like(gg)
        cd[torch.from_numpy(c.rows).cuda(), torch.from_numpy(c.cols).cuda()] = (
            torch.from_numpy(c.vals).cuda())
        if not torch.equal(cd, gg):
            raise AssertionError(f"plan(G, layout={layout!r}).spgemm(G) differs from the "
                                 "dense G·G")
        del cd
    pad, rag = coos["padded"], coos["ragged"]
    if not (np.array_equal(pad.rows, rag.rows) and np.array_equal(pad.cols, rag.cols)
            and np.array_equal(pad.vals, rag.vals)):
        raise AssertionError("spgemm: padded and ragged results differ")
    if pad.nnz != tc.spgemm_nnz:
        raise AssertionError("spgemm nnz differs from triangle_count's product")
    del gg, coos, pad, rag
    pr_want = pagerank_f64(s01)
    pr_l1 = float(np.abs(pr.scores.astype(np.float64) - pr_want).sum())
    if not pr.converged or pr_l1 > 2e-5:
        raise AssertionError(f"pagerank(G): converged={pr.converged}, L1 distance to "
                             f"scipy float64 {pr_l1:.3e} (bound 2e-5)")
    a_hat = normalized_adjacency(s01)
    f64 = feats.astype(np.float64)
    h_want = a_hat @ (a_hat @ f64)
    h_mag = abs(a_hat) @ (abs(a_hat) @ np.abs(f64))
    h_err = np.abs(H.astype(np.float64) - h_want)
    if H.shape != feats.shape or not np.isfinite(H).all() or bool(
            (h_err > TOL_MAIN * h_mag).any()):
        raise AssertionError(f"feature_propagation(G): off scipy float64 beyond "
                             f"{TOL_MAIN} * (|Â|·|Â|·|H|) (max abs err {h_err.max():.3e})")
    info.update(pagerank_l1_vs_scipy=pr_l1, pagerank_iterations=pr.iterations,
                feature_propagation_max_abs_err=float(h_err.max()))
    log(f"SpGEMM path agrees: {tc.triangles} triangles (scipy {want_tri}); "
        f"spgemm == dense G·G bitwise on both layouts, padded == ragged; pagerank L1 "
        f"{pr_l1:.3e} to scipy; feature_propagation max abs err {h_err.max():.3e}")
    return {"G": G, "plan": gplans[default_layout], "info": info}


def spgemm_bytes(art, m_blk, block_starts, offs, n_out):
    """What one SpGEMM must move: A's stream and ``block_starts`` read
    once, B's real entries read once (value and column, 8 bytes each) plus
    one 32-byte sector per row to find its end, the (W, l, n_out) output
    written once."""
    stream = sum(t.numel() * t.element_size()
                 for t in (m_blk, art.col_blk, art.row_blk, block_starts))
    b_real = int((offs.vals != 0).sum()) * 8 + offs.r_rows * 32
    return stream + b_real + art.num_windows * art.l * n_out * 4


def revalue(art, window, G, vals):
    """A's stream with the values ``vals`` of ``G``'s entries (G's own
    order) on its real slots: the stream of the matrix ``(G's pattern,
    vals)``, found through each slot's original (row, column)."""
    import torch

    n = G.shape[1]
    real = art.m_blk != 0
    rows = art.row_perm.long()[window.long()[:, None] * art.l + art.row_blk.long()]
    keys = (rows * n + art.col_blk.long())[real]
    g_keys = torch.from_numpy(G.rows * np.int64(n) + G.cols).cuda()
    at = torch.searchsorted(g_keys, keys)
    if not torch.equal(g_keys[at], keys):
        raise AssertionError("a real slot of the stream is not an entry of G")
    out = torch.zeros(art.m_blk.shape, dtype=torch.float32, device=art.m_blk.device)
    out[real] = torch.from_numpy(vals).cuda()[at]
    return out


def spgemm_wall_split(report, gemm):
    """SpGEMM's wall time on G split into the port's own steps: B's row
    offsets (copy of the COO and the build on the card), the kernel (with
    its pre-pass), the reorder into original rows, the compaction on the
    card and the copy to the host."""
    import torch

    from repro_torch.core.spgemm import (compact, float_artifact, row_offsets, to_host,
                                         to_original_rows, window_product)

    G, p = gemm["G"], gemm["plan"]
    art = float_artifact(p)
    split = {}

    def mark(key, t0):
        torch.cuda.synchronize()
        split[key] = (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    torch.cuda.synchronize()
    start = t0 = time.perf_counter()
    offs = row_offsets(G, art.l, device=art.device)
    t0 = mark("b_offsets_ms", t0)
    y = window_product(art, offs, G.shape[1], real_slots=p.sched.nnz)
    t0 = mark("kernel_ms", t0)
    dense = to_original_rows(art, y, G.shape[0])
    t0 = mark("reorder_ms", t0)
    rows, cols, vals = compact(dense)
    t0 = mark("compaction_ms", t0)
    c = to_host(dense.shape, rows, cols, vals)
    mark("host_copy_ms", t0)
    split["total_ms"] = (time.perf_counter() - start) * 1e3
    split["nnz"] = c.nnz
    split["layout"] = p.layout
    report["spgemm_wall_ms"] = split
    log("spgemm wall time on G (" + p.layout + "): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items() if k.endswith("_ms")))


def pagerank_f64(adj):
    """PageRank of the 0/1 pattern ``adj`` (scipy CSR) in float64, the
    port's iteration run to its fixed point."""
    n = adj.shape[0]
    deg = np.asarray(adj.sum(axis=1)).ravel()
    dangling = deg == 0
    inv = np.where(dangling, 0.0, 1.0 / np.where(dangling, 1.0, deg))
    P = (adj.multiply(inv[:, None])).T.tocsr()
    r = np.full(n, 1.0 / n)
    for _ in range(1000):
        r_new = 0.85 * (P @ r + r[dangling].sum() / n) + 0.15 / n
        r_new /= r_new.sum()
        done = np.abs(r_new - r).sum() < 1e-14
        r = r_new
        if done:
            break
    return r


def normalized_adjacency(adj):
    """``D^{-1/2} (A + I) D^{-1/2}`` of the 0/1 pattern ``adj`` in float64."""
    import scipy.sparse as sp

    s = (adj + sp.identity(adj.shape[0], format="csr")).tocsr()
    d = np.asarray(s.sum(axis=1)).ravel()
    scale = sp.diags(1.0 / np.sqrt(d))
    return (scale @ s @ scale).tocsr()


def dequantized_csr(art):
    """The matrix an int8 padded artifact holds, in original coordinates:
    ``float32(q) * scale`` per slot (the kernels' dequant), built on the
    host from the artifact's leaves."""
    import scipy.sparse as sp

    q = art.m_blk.cpu().numpy()
    keep = q != 0
    t = np.nonzero(keep)[0]
    scale = art.scale_blk.cpu().numpy()[t // art.c_blk]
    vals = (q[keep].astype(np.float32) * scale).astype(np.float64)
    window = t // art.c_pad
    sched_row = window * art.l + art.row_blk.cpu().numpy()[keep].astype(np.int64)
    rows = art.row_perm.cpu().numpy().astype(np.int64)[sched_row]
    cols = art.col_blk.cpu().numpy()[keep].astype(np.int64)
    return sp.csr_matrix((vals, (rows, cols)), shape=art.shape)


if __name__ == "__main__":
    sys.exit(main())
