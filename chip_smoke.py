#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``repro_torch/kernels/csrc`` (one
``nvcc`` per source, in parallel), then drives ten paths of the port,
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
   * ``tune``: ``up.plan.tune(x, ls=(256,))`` at B = 8 over the default
     c_blk 4/8/16, both layouts and both gathers (the default's l=128
     candidates, which reschedule the layer on the host, are left out to
     keep the smoke in its time);
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
   * ``serve.gust``: the first layer (the host schedule of all 96 MLP
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

7. **The encoder-decoder model** ``encdec``: seamless-m4t-medium at its
   published widths and depth (``src/repro/configs/seamless_m4t_medium.py``,
   arXiv:2308.11596: 12 encoder and 12 decoder layers, d_model 1,024, 16
   heads of 64, GELU d_ff 4,096, vocab 256,206 padded to 256,256, tied
   table, ``enc_seq`` 4,096; 614,854,656 parameters from
   ``torch.Generator`` seed 0 on the card), float32 at batch 4 and
   ``seq_len`` 512: source frames (4, 4,096, 1,024) from numpy seed 0
   standing in for the stubbed speech frontend, prompts of 64 tokens, a
   prefill, then 32 greedy decode steps (``LM.prefill`` /
   ``LM.decode_step``; the reference's ``ServeLoop`` feeds no source
   frames, so this path drives the model's own entry points).

8. **Training** ``train``, under ``torch.use_deterministic_algorithms(True)``
   (``CUBLAS_WORKSPACE_CONFIG`` is set before torch is imported; the
   flag is put back after the path), through ``make_train_step`` (AdamW,
   remat, float32):

   * ``train.yi``: yi-6b at its published widths, 8 of 32 layers
     (1,646,333,952 parameters: the float32 AdamW state of all 32 would
     not fit 80 GB), random from ``torch.Generator`` seed 0 on the card,
     batch 2 x 2,048 tokens from the port's ``TokenPipeline``; six steps
     at the launcher's learning rate (1e-3, warmup max(6 // 10, 1)), then
     six at ``AdamWConfig``'s (3e-4), the first of them also as
     ``microbatches=2``, and a seventh under ``torch.profiler``;
   * ``train.cpu_check``: one step at 1 layer (batch 1 x 64) from the same
     parameters on the card and on the CPU;
   * ``train.xlstm``: xlstm-125m at its published widths and depth, batch
     4 x 256, three steps with a checkpoint after step 2 (a temporary
     directory), restored and step 3 run again;
   * ``train.launcher``: ``python -m repro_torch.launch.train --arch
     yi_6b --steps 4 --device cuda`` (reduced config, its defaults).

9. **The multi-device layer** ``shard`` (one card cannot hold k ranks at
   once, so they run one after another):

   * crankseg_2's four ragged plans of path 1 (kernels 2 and 7 on the
     load-balanced schedule, 4 and 8 on the unbalanced one) split by
     block count into k = 1, 2, 4, 8 ranks (``GustPlan.shard``'s layout,
     ``rank_artifact``), each rank's artifact verified, run at B=1 through
     ``GustPlan.rank_spmv`` and reassembled (``emulated_ranks``); then
     each rank's kernel ms (its wrapper on the rank's artifact, CUDA
     events over 20 calls queued behind a spinning kernel,
     ``queued_ms``), blocks, windows and the imbalance;
   * a one-rank NCCL process group (file rendezvous) and its ``data``
     mesh: ``plan.shard(mesh).spmv`` for the four plans,
     ``ring_all_reduce`` and ``compressed_psum`` on a CUDA tensor, and one
     data-parallel ``make_train_step(lm, tc, mesh)`` step of yi-6b at its
     widths, 1 layer, batch 2 x 512, under deterministic algorithms;
   * the dry-run account (``launch/cost_account.account_cell``) of the
     serve (yi-6b), train (yi-6b, 8 layers) and encdec (seamless) cells
     on a (1, 1) mesh.

10. **Tensor, expert and fully-sharded parallelism** ``tp``: four
    processes (``python3 chip_smoke.py tp-rank ...``, ``tp_rank``) share
    the one card, each with ``cuda:0``, as the ranks of a ("data",
    "model") mesh of (2, 2) over gloo (file rendezvous, 60 s group
    timeout; NCCL takes one rank a card).  Each draws the whole state on
    the card in its turn and keeps its shards (``shard_train_state``),
    then runs two sharded steps of ``make_train_step(lm, tc, mesh)``
    (remat, float32): the heads, ``d_ff`` and the vocabulary over "model"
    (tensor parallel), the experts over "model" (expert parallel), the
    stacked leaves over "data" (FSDP, gathered per block):

    * ``tp.yi``: yi-6b at its published widths, 1 layer, batch 2 x 512;
    * ``tp.llama4``: llama4-scout at its published widths, 1 layer (8 of
      16 experts a rank), batch 2 x 256, its table cut to 8,192 rows
      (``TP_MODELS``: the account reckons the published table's step at
      31.0 GB a rank, 124 GB for four).

    The same steps run whole in the smoke's own process from the same
    seeded state (llama4's with each data rank's rows routed on their
    own, ``per_data_rank_step``, as the sharded step routes them).

    Its serve phase (``TP_SERVE``, ``TP_SERVE_MODELS``): the same four
    ranks serve yi-6b and llama4-scout at their published widths, 1 layer
    (llama4's table cut as above), a prefill of 64 tokens and 8 decode
    steps at batch 4, ``seq_len`` 512, float32, each rank holding only its
    shards (``shard_serve_state``: ``param_specs(..., mode="serve")`` and
    ``cache_spec_overrides``) and running ``LM.prefill`` /
    ``LM.decode_step`` / ``decode_step_gust`` with ``place=``: yi-6b dense
    and GUST on (1, 4) (kernel 5, padded) and on (2, 2) (kernel 7, ragged;
    its large serve leaves gathered over "data" per block), llama4 on (1,
    4) (4 experts a rank).  The GUST plans are built once in the smoke's
    process into a ``PlanStore`` and loaded, verified, by every rank.  Each
    run is teacher-forced on the greedy tokens of the same decode run whole
    in the smoke's process, and held to it.

Before its first launch every artifact the smoke builds passes the
artifact verifier (``GustPlan.verify()``, the ``GUST-Pxx`` rules) with no
finding: crankseg_2's eight (padded/ragged × float32/int8 ×
balanced/unbalanced), G's two streams, the three yi-6b MLP layers, the
stacked slices, the store's, the rescheduled and the tuned plans and the
gustified layers of the serving path; a seeded collision on a copy of a
card artifact fires exactly GUST-P14.  Every library's ``ptxas`` report
and every launch plan the smoke used pass the Hopper resource audit
(``repro_torch.analysis.kernel_audit``, ``GUST-Hxx``).  The paper's own
metric, ``baselines.model_gust``'s utilization on crankseg_2's schedules
(the paper's FPGA cycle model, not a card number), is printed beside.

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
  * the resource audit (``GUST-H01``..``H06``): no function of any
    library spills or passes 255 registers or 48 KiB of static shared
    memory, and every launch plan fits the SM's shared memory and
    registers and keeps its grid within its stream;
  * the verifier: no finding on any artifact before its first launch;
    the seeded collision fires exactly GUST-P14; the store's verifying
    warm load colors nothing, a stored file with a padding value flipped
    (it still parses) is a counted corrupt miss, and the plan rebuilt
    fresh equals the original bitwise;
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
    phases); the first decode step at one layer on the card within
    ``2e-4`` of the largest logit of the same step on the CPU's plain path
    (float32, TF32 off); each GUST phase launches its kernel exactly once
    per GUST product (3 x 1 layer x decode steps) and no other kernel,
    so no product ran a plain version; padded == ragged token streams
    bitwise; a GUST decode step within ``1e-4`` of the largest logit of a
    dense decode step on the same pruned MLP weights;
  * the families path, per phase: the arch's published widths; every
    request DONE with no retry, failure or fallback and no kernel
    launched; one request alone equals its mixed stream bitwise (MoE at
    batch 4 = ``min_capacity``: no pair is dropped); the first decode
    step on the card within ``2e-4`` of the largest logit of the CPU's
    plain path with the same first token, at one layer for the MoE archs
    and at the phase's depth for the recurrent ones;
  * the encdec path: the published widths and parameter count; the
    decode of token 64 after the prefill within ``2e-4`` of the largest
    logit of ``train_logits`` at position 64 (the reference's own
    yardstick); rows 0, 2 and 3 bitwise the same in every step when row
    1's frames and tokens change; at 1 encoder and 1 decoder layer, a
    prefill and a decode step on the card within ``2e-4`` of the largest
    logit of the CPU's plain path (a 256-frame source) with the same
    first token; no kernel launched;
  * the train path: every loss finite; at 3e-4 yi-6b's step 6 below its
    step 1 (the 1e-3 run is reported, not gated on learning); the
    microbatches=2 step and the card-vs-CPU step held by
    ``step_agreement`` (loss and gradient norm within 1e-5 relative, m
    within 1e-5 of each leaf's largest, every parameter within the
    reference's ``rtol=2e-4, atol=2e-5`` plus ``lr * min(2, dg / eps)``,
    the most a first AdamW step can make of a gradient difference dg);
    xlstm's resumed losses and state bitwise the uninterrupted run's,
    the checkpoint restored on the CPU bitwise the card's; the launcher's
    JSON line finite; no GUST kernel launched;
  * the shard path: each plan resolves the kernel named above; every
    k's reassembled ranks, and each sharded plan under the NCCL group,
    bitwise the unsharded plan's result; the ring and the compressed sum
    of one rank exact; the data-parallel step's loss and state bitwise
    the plain step's; kernels 2/4/7/8 launched (those launches count
    toward their ``kernels`` rows); the account's parameter, optimizer
    and cache bytes equal, exactly, to the bytes of the trees the serve,
    train and encdec paths allocated.
  * the tp path: every rank's loss and gradient norm within ``1e-5``
    relative of the whole step's, its final parameter shards within
    ``1e-5`` of the whole step's parameters cut the same way, its shards
    of ``local_shape``'s shapes, its parameter and optimizer bytes
    ``tree_bytes_per_device``'s, no whole stacked leaf allocated in its
    first step (an allocation watch); no GUST kernel launched by the whole
    steps; a rank that fails or outlives its timeout fails the path.  Its
    serve phase: every rank's logits of the prefill and of each step
    within ``1e-5`` of the largest |logit| of the whole decode's rows, its
    parameter and cache bytes and (rank 0) its collectives' bytes a
    decode step the account's, a GUST run's kernel (5 or 7) launched on
    every rank from store-loaded plans, no kernel in a dense run.

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
line; for the encdec path the encoder, prefill and decode-step ms, a
profile of 8 decode steps, peak memory and a step's bytes bound, on an
``{"encdec": {...}}`` line; for the train path the losses, step ms (CUDA
events), tokens/s, the step's matmul FLOPs and their rate beside the f32
peak, a profiled step (device ms, ops, idle share), the peak memory
beside the state's reckoning, the checkpoint's bytes and seconds and the
launcher's line, on a ``{"train": {...}}`` line; for the shard path the
per-rank times and imbalance per plan and k, the DP step, and per
account cell the bytes, the reckoned peak beside ``max_memory_allocated``
and the matmul FLOPs, on a ``{"shard": {...}}`` line; for the tp path per
model and rank the step ms, the peak memory beside the account's, the
collective bytes a step by collective and the transport (which
collectives went through the host), and per serve run and rank the
prefill and decode-step ms, the peak memory beside the account's, the
bytes a decode step by collective and the kernel launches, on a
``{"tp": {...}}`` line; the
audit's report and an ``{"audit":
{...}}`` line, the verifier's seconds per artifact, the paper metric;
the card's name; and as its last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero without a CUDA device.
"""

import contextlib
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


def audited(report, plan):
    """Keep ``plan`` (a launch plan the smoke read) for the resource audit
    at the end; return it."""
    report.setdefault("launch_plans", []).append(plan)
    return plan


def verified(report, tag, plan):
    """Run the artifact verifier over ``plan``'s artifact (a GustPlan or
    an artifact) before its first launch: no finding, or the smoke fails.
    Records the seconds (the host copy of the leaves included)."""
    import torch

    from repro_torch.analysis.verify import verify

    t0 = time.perf_counter()
    findings = verify(plan)
    seconds = time.perf_counter() - t0
    if findings:
        raise AssertionError(f"verify {tag}: {len(findings)} finding(s): "
                             + "; ".join(str(f) for f in findings[:5]))
    art = getattr(plan, "artifact", plan)
    report.setdefault("verify", {})[tag] = {"seconds": seconds,
                                            "slots": art.streamed_slots}
    torch.cuda.synchronize()
    return plan


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
    # deterministic cuBLAS products for the train path; cuBLAS reads this
    # when its first handle is made
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
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
    from repro_torch.analysis.kernel_audit import audit_kernels

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
    # every library's ptxas report (kept beside a cached build too): no
    # spill, registers and static shared memory within the card's limits
    early = audit_kernels()
    report["ptxas"] = early.to_dict()
    for lib, info in _build.build_log.items():
        log(f"build {lib}: {info['seconds']:.1f} s, max "
            f"{report['ptxas']['max_registers'][lib]} registers")
    if early.findings:
        raise AssertionError("resource audit of the builds: "
                             + "; ".join(str(f) for f in early.findings))
    log(f"build: {report['build_s']:.1f} s; {early.to_dict()['functions']} functions "
        "audited from ptxas: no spill, registers and static shared memory in bounds")

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

    # -- the verifier: every artifact before its first launch ---------------------
    seen = {}
    for (mode, lb, layout, vdt), p in plans.items():
        if id(p.artifact) not in seen:
            seen[id(p.artifact)] = f"crankseg_2/lb={lb}/{layout}/{vdt}"
            verified(report, seen[id(p.artifact)], p)
    log("verify: " + ", ".join(f"{k} {v['seconds']:.2f} s ({v['slots']} slots)"
                               for k, v in report["verify"].items()) + "; no finding")
    report["seeded_collision"] = seeded_collision(plans["default", True, "padded",
                                                        "float32"].artifact)
    log(f"verify: a seeded collision on a copy of the balanced padded artifact fires "
        f"{report['seeded_collision']['rules']} ({report['seeded_collision']['count']} "
        "slots)")
    report["paper_model"] = paper_model(coo, cache)
    log("paper model (the paper's FPGA cycle model, baselines.model_gust, not a card "
        f"number) on crankseg_2 at l={L}: " + ", ".join(
            f"{k}: {v['cycles']:.0f} cycles, utilization {v['utilization']:.4f}"
            for k, v in report["paper_model"].items()))

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
                    row.update(audited(report, spread_launch_plan(
                        art.m_blk, args[1], art.row_blk, xp, l=art.l, c_blk=art.c_blk,
                        gather=gather, pipeline=SPREAD[name])))
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

    # -- path 7: the encoder-decoder model, seamless-m4t-medium at full size ---------
    t0 = time.perf_counter()
    encdec = encdec_path(report, launch_counts)
    report["encdec_seconds"] = encdec["seconds"] = time.perf_counter() - t0
    log(f"encdec path: {report['encdec_seconds']:.1f} s")

    # -- path 8: training, yi-6b at full width (8 layers) and xlstm-125m -------------
    t0 = time.perf_counter()
    train = train_path(report, launch_counts)
    report["train_seconds"] = train["seconds"] = time.perf_counter() - t0
    log(f"train path: {report['train_seconds']:.1f} s")

    # -- path 9: the multi-device layer: ranks on the card, a one-rank NCCL group -----
    t0 = time.perf_counter()
    shard = shard_path(report, launch_counts, {"plans": plans, "v": v})
    report["shard_seconds"] = shard["seconds"] = time.perf_counter() - t0
    for name, count in shard["launches"].items():
        launches[name] += count
    log(f"shard path: {report['shard_seconds']:.1f} s")

    # -- path 10: tensor, expert and fully-sharded parallelism, ranks on the card -----
    t0 = time.perf_counter()
    tp = report["tp"] = tp_path(report, launch_counts)
    report["tp_seconds"] = tp["seconds"] = time.perf_counter() - t0
    for name, count in tp["launches"].items():
        launches[name] += count
    log(f"tp path: {report['tp_seconds']:.1f} s")

    # -- the resource audit: every library and every launch plan used ----------------
    audit = audit_kernels(plans=report["launch_plans"])
    log(audit.report())
    report["audit"] = audit.to_dict()
    if audit.findings:
        raise AssertionError(f"resource audit: {len(audit.findings)} finding(s)")
    verify_s = [v["seconds"] for v in report["verify"].values()]
    report["verify_seconds"] = sum(verify_s)
    log(f"verify: {len(verify_s)} artifacts, no finding, {sum(verify_s):.1f} s in all "
        f"(largest {max(verify_s):.2f} s)")

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
    print(json.dumps({"encdec": encdec}))
    print(json.dumps({"train": train}))
    print(json.dumps({"shard": {k: v for k, v in shard.items() if k != "ranks"}}))
    print(json.dumps({"tp": tp}))
    print(json.dumps({"audit": report["audit"],
                      "verify": {"artifacts": len(verify_s),
                                 "seconds": report["verify_seconds"],
                                 "seeded_collision": report["seeded_collision"]["rules"]},
                      "paper_model": report["paper_model"]}))
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
            verified(report, f"yi-6b/{name}", lin.plan)
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
                row.update(audited(report, spread_launch_plan(
                    art.m_blk, args[1], art.row_blk, xp, l=art.l, c_blk=art.c_blk,
                    gather=p.gather_mode, pipeline=p._pipeline())))
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
            warm_store = repro_torch.PlanStore(tmp, verify="load")
            t0 = time.perf_counter()
            warm = repro_torch.plan(up["coo"], cfg, cache=ScheduleCache(), store=warm_store)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0  # the verifier on load included
            if dict(sched_counters) != before or not warm._store_loaded:
                raise AssertionError("store: the verifying warm load colored or missed "
                                     f"({before} -> {dict(sched_counters)})")
            if not leaves_equal(warm.artifact, cold.artifact):
                raise AssertionError("store: warm leaves differ from the cold plan's")
            for b in (1, BATCH):
                x = xs[b][:, :n_up].T.contiguous()
                if not torch.equal(warm.spmm(x), cold.spmm(x)):
                    raise AssertionError(f"store: warm spmm differs at B={b}")
            stats = warm_store.stats()
            # a stored file that still parses, with a padding value flipped:
            # the verifying store counts a corrupt miss and the plan is
            # rebuilt fresh (the layer's schedule cached), bit for bit
            flipped = flip_padding_value(cold_store, cold_store.keys()[0])
            checking = repro_torch.PlanStore(tmp, verify="load")
            rebuilt = repro_torch.plan(up["coo"], cfg, cache=up["cache"], store=checking)
            if rebuilt._store_loaded or (checking.corrupt, checking.misses) != (1, 1):
                raise AssertionError(f"store: the flipped file was not a counted corrupt "
                                     f"miss ({checking.stats()})")
            verified(report, "yi-6b/up/store-rebuilt", rebuilt)
            if not leaves_equal(rebuilt.artifact, cold.artifact):
                raise AssertionError("store: the rebuilt plan differs from the original")
            flipped_store = checking.stats()
        log(f"store: {file_bytes} bytes, cold {cold_s:.2f} s, warm {warm_s:.2f} s with "
            "verify='load'; zero coloring on the warm load, leaves and spmm bitwise; a "
            f"file with a padding value flipped ({flipped}) is a counted corrupt miss, "
            "rebuilt fresh bit for bit")
        return {"file_bytes": file_bytes, "cold_s": cold_s, "warm_s": warm_s,
                "warm_store": stats, "writes": cold_store.writes,
                "flipped_rules": flipped, "flipped_store": flipped_store}

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
                if gather == "auto":  # the local slices hold the same leaves
                    verified(report, f"yi-6b/stack/{i}", sl)
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
        tuned = up["lin"].plan.tune(x, ls=(L,))
        tune_s = time.perf_counter() - t0
        res = tuned.tuning
        verified(report, "yi-6b/up/tuned", tuned)
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
        verified(report, "crankseg_2/rescheduled", p2)
        verified(report, "crankseg_2/rescheduled-fresh", fresh)
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
             gust_layers=1, profile_steps=8)
#: Tolerances, of the largest |logit|: the card's first decode step at one
#: layer against the CPU's plain path (float32 products summed in another
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
    return dict(profile_split(prof, steps, wall_ms, step_ms), launches=launches)


def profile_split(prof, steps, wall_ms, step_ms):
    """A ``torch.profiler`` window of ``steps`` decode steps: device ms a
    step by kernel and by group, device ops a step, and the idle share
    ``1 - device / wall`` against the window's wall ms a step and against
    ``step_ms``, the unprofiled run's median step."""
    by_kernel, launched = {}, 0
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = evt.cuda_time_total
        if total:  # names cut to 100 characters: add, kernels may share a prefix
            key = evt.key[:100]
            by_kernel[key] = by_kernel.get(key, 0.0) + total / steps / 1e3
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
    return {"steps": steps,
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
    at one layer agrees with the CPU's plain path.  ``serve.gust``: the
    first layer, gustified at ``GustServeConfig()`` (padded, kernel 5)
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
    torch.cuda.reset_peak_memory_stats()
    loop = ServeLoop(lm, params, sc)
    streams, dense = serve_run(loop, prompts, launch_counts, None)
    dense["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["tree_bytes"] = {"params": tree_nbytes(params), "caches": tree_nbytes(loop.caches)}
    solo_equals(loop, prompts, streams, 1, launch_counts, None)
    dense["profile"] = decode_profile(loop, prompts, SERVE["profile_steps"],
                                      dense["decode_step_ms"]["median"], launch_counts,
                                      None)
    del loop
    # the first decode step at the GUST phases' depth, on the card and on the CPU
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
        f"== mixed bitwise; {SERVE['gust_layers']}-layer decode step card vs CPU max abs err {err:.3e} "
        f"(max |logit| {scale:.3e}); profile "
        f"{json.dumps({k: v for k, v in dense['profile'].items() if k != 'top_kernels_ms'})}")

    # -- serve.gust: the first layer, gustified padded then ragged -------------------
    gust_streams = {}
    for layout in ("padded", "ragged"):
        gcfg = GustServeConfig(ragged=layout == "ragged")
        t0 = time.perf_counter()
        loop = ServeLoop(lm2, params2, dataclasses.replace(sc, gust=gcfg))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        plans = loop.gust_tree["plans"]
        for name, ps in plans.items():
            for i, p in enumerate(ps):
                verified(report, f"serve.gust_{layout}/{name}/{i}", p)
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
        log(f"serve.gust {layout}: {SERVE['gust_layers']} layer, gustify {build_s:.1f} s "
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


#: seamless-m4t-medium as the encdec path drives it (src/repro/configs/
#: seamless_m4t_medium.py, arXiv:2308.11596): the published widths and
#: depth it must have, its parameter count, and the traffic.
SEAMLESS_WIDTHS = dict(d_model=1024, n_heads=16, n_kv=16, head_dim=64, d_ff=4096,
                       vocab=256_206, padded_vocab=256_256, n_layers=12, n_enc_layers=12,
                       enc_seq=4096, mlp_kind="gelu", tie_embeddings=True)
SEAMLESS_PARAMS = 614_854_656
ENCDEC = dict(batch=4, seq_len=512, prompt_len=64, max_new=32, timed=3, profile_steps=8,
              cpu_frames=256)
#: Decode after prefill against the full forward, of the largest |logit|
#: (the reference's own yardstick, tests/test_models.py).
TOL_DECODE_VS_FORWARD = 2e-4


def tree_nbytes(tree):
    """Bytes of every tensor of ``tree``."""
    from repro_torch.models.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def event_ms(fn):
    """(fn(), its milliseconds between two CUDA events, synchronized)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def encdec_layers(params, n):
    """The parameter tree of the first ``n`` encoder and decoder layers
    (views)."""
    from repro_torch.models.tree import tree_map

    cut = {part: {"reps": tuple(tree_map(lambda a: a[:n], r)
                                for r in params[part]["reps"]), "tail": []}
           for part in ("encoder", "decoder")}
    return dict(params, **cut)


def greedy(lm, params, frames, prompts, steps, seq_len):
    """Prefill then ``steps`` greedy decode steps on the card, each timed
    with CUDA events; returns the logits of the prefill's last position and
    of every step, the prefill ms, the step ms and the caches."""
    import torch

    caches = lm.init_caches(prompts.shape[0], seq_len, torch.float32, device=frames.device)
    (first, caches), prefill_ms = event_ms(lambda: lm.prefill(
        params, {"src_frames": frames, "tokens": prompts}, caches, dtype=torch.float32))
    logits = [first[:, -1]]
    step_ms = []
    for i in range(steps):
        tok = torch.argmax(logits[-1], dim=-1).to(torch.int32)[:, None]
        (out, caches), ms = event_ms(lambda: lm.decode_step(
            params, caches, tok, prompts.shape[1] + i, dtype=torch.float32))
        logits.append(out[:, 0])
        step_ms.append(ms)
    return logits, prefill_ms, step_ms, caches


def encdec_path(report, launch_counts):
    """seamless-m4t-medium at its published widths and depth on the card
    (random weights from ``torch.Generator`` seed 0), float32 at batch 4:
    the encoder over 4,096 source frames, a prefill of 64-token prompts,
    32 greedy decode steps.  Gates: decode == the full forward at position
    64, rows independent bitwise, the card == the CPU's plain path at 1 +
    1 layers, no kernel launched.  Returns the ``encdec`` line's summary."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.serving import CachePolicy, cache_bytes

    dev = torch.device(SERVE_DEVICE)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the float32 products would not be float32")
    cfg = get_arch("seamless_m4t_medium")
    widths = {k: getattr(cfg, k) for k in SEAMLESS_WIDTHS}
    if widths != SEAMLESS_WIDTHS:
        raise AssertionError(f"seamless widths {widths} != the published {SEAMLESS_WIDTHS}")
    lm = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()  # what the earlier paths still hold
    zero_launches(launch_counts)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "params": lm.param_count(params),
           "start_memory_bytes": start_bytes}
    if out["params"] != SEAMLESS_PARAMS:
        raise AssertionError(f"seamless: {out['params']} parameters, not {SEAMLESS_PARAMS}")
    b, seq_len, steps = ENCDEC["batch"], ENCDEC["seq_len"], ENCDEC["max_new"]
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((b, cfg.enc_seq, cfg.d_model))
                              .astype(np.float32)).to(dev)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (b, ENCDEC["prompt_len"]))
                               .astype(np.int32)).to(dev)
    out["cache_bytes"] = cache_bytes(lm, b, seq_len, CachePolicy("float32"))
    caches = lm.init_caches(b, seq_len, torch.float32, device="meta")
    out["cross_cache_bytes"] = sum(
        c[k].numel() * 4 for c in caches["reps"] for k in ("ck", "cv"))
    # what a decode step must read once: the decoder, the tied table (the
    # logits), the final norm and every cache leaf; beside it, every
    # parameter (the encoder's too) with the caches
    step_params = sum(x.numel() for x in tree_leaves(
        (params["decoder"], params["embed"], params["final_norm"])))
    out["decode_bytes"] = step_params * 4 + out["cache_bytes"]
    out["decode_bytes_bound_ms"] = out["decode_bytes"] / HBM_BYTES_PER_S * 1e3
    out["all_params_bytes_bound_ms"] = (out["params"] * 4 + out["cache_bytes"]) / \
        HBM_BYTES_PER_S * 1e3

    enc_ms = [event_ms(lambda: lm._encode(params, frames))[1]
              for _ in range(ENCDEC["timed"])]
    out["encoder_ms"] = float(np.median(enc_ms))
    t0 = time.perf_counter()
    logits, prefill_ms, step_ms, caches = greedy(lm, params, frames, prompts, steps, seq_len)
    out["tree_bytes"] = {"params": tree_nbytes(params), "caches": tree_nbytes(caches)}
    out["generate_s"] = time.perf_counter() - t0
    out["prefill_ms"] = prefill_ms
    out["decode_step_ms"] = {"median": float(np.median(step_ms)), "min": float(min(step_ms)),
                             "max": float(max(step_ms)), "mean": float(np.mean(step_ms))}
    finite = all(bool(torch.isfinite(x[:, :cfg.vocab]).all()) for x in logits)
    shapes = {tuple(x.shape) for x in logits}
    if not finite or shapes != {(b, cfg.padded_vocab)}:
        raise AssertionError(f"encdec: logits finite={finite}, shapes {shapes}")

    # decode of token 64 after the prefill == the full forward at position 64
    tok64 = torch.argmax(logits[0], dim=-1).to(torch.int32)[:, None]
    full, _ = lm.train_logits(params, {"src_frames": frames,
                                       "tokens": torch.cat([prompts, tok64], dim=1)},
                              dtype=torch.float32)
    want, got = full[:, -1, :cfg.vocab], logits[1][:, :cfg.vocab]
    err = float((want - got).abs().max())
    scale = float(want.abs().max())
    del full
    if not np.isfinite(err) or err > TOL_DECODE_VS_FORWARD * scale:
        raise AssertionError(f"encdec: decode of token 64 is {err:.3e} off the full "
                             f"forward (max |logit| {scale:.3e})")
    out["decode_vs_forward"] = {"max_abs_err": err, "max_abs_logit": scale}

    # rows are independent: change row 1's frames and tokens
    other = np.random.default_rng(1)
    frames2, prompts2 = frames.clone(), prompts.clone()
    frames2[1] = torch.from_numpy(other.standard_normal((cfg.enc_seq, cfg.d_model))
                                  .astype(np.float32)).to(dev)
    prompts2[1] = torch.from_numpy(other.integers(0, cfg.vocab, ENCDEC["prompt_len"])
                                   .astype(np.int32)).to(dev)
    logits2, _, _, caches2 = greedy(lm, params, frames2, prompts2, steps, seq_len)
    keep = [0, 2, 3]
    for i, (a, c) in enumerate(zip(logits, logits2)):
        if not torch.equal(a[keep], c[keep]):
            raise AssertionError(f"encdec: step {i}: rows 0, 2, 3 changed when row 1's "
                                 "frames and tokens did")
    if torch.equal(logits[0][1], logits2[0][1]):
        raise AssertionError("encdec: row 1's logits did not change with its input")
    del logits, logits2, caches

    # torch.profiler over 8 further decode steps
    k = ENCDEC["profile_steps"]
    tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    pos0 = ENCDEC["prompt_len"] + steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(k):
            _, caches2 = lm.decode_step(params, caches2, tok, pos0 + i, dtype=torch.float32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / k
    out["profile"] = profile_split(prof, k, wall_ms, out["decode_step_ms"]["median"])
    del caches2
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()

    # the card against the CPU's plain path at 1 encoder + 1 decoder layer
    lm1 = build_model(dataclasses.replace(cfg, n_layers=1, n_enc_layers=1))
    p1 = encdec_layers(params, 1)
    src = frames[:1, :ENCDEC["cpu_frames"]]
    got = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        p = p1 if d == dev else tree_map(lambda a: a.cpu(), p1)
        c = lm1.init_caches(1, seq_len, torch.float32, device=d)
        first, c = lm1.prefill(p, {"src_frames": src.to(d), "tokens": prompts[:1].to(d)}, c,
                               dtype=torch.float32)
        t = torch.argmax(first[:, -1], dim=-1).to(torch.int32)[:, None]
        step, _ = lm1.decode_step(p, c, t, ENCDEC["prompt_len"], dtype=torch.float32)
        got[name] = (first.cpu(), t.cpu(), step.cpu())
        del p, c
    if not torch.equal(got["card"][1], got["cpu"][1]):
        raise AssertionError("encdec: card and CPU prefill pick different first tokens")
    checks = {}
    for i, what in ((0, "prefill"), (2, "decode")):
        card, host = got["card"][i][..., :cfg.vocab], got["cpu"][i][..., :cfg.vocab]
        e, sc = float((card - host).abs().max()), float(host.abs().max())
        if not np.isfinite(e) or e > TOL_SERVE_CPU * sc:
            raise AssertionError(f"encdec: the 1+1-layer {what} on the card is {e:.3e} "
                                 f"off the CPU's (max |logit| {sc:.3e})")
        checks[what] = {"max_abs_err": e, "max_abs_logit": sc}
    out["cpu_check"] = dict(checks, layers="1+1", frames=ENCDEC["cpu_frames"])
    launches = read_launches(launch_counts)
    if launches:
        raise AssertionError(f"encdec: a GUST kernel launched ({launches})")
    del params, p1, frames, frames2
    report["encdec"] = out
    prof_ = out["profile"]
    log(f"encdec: seamless-m4t-medium {widths}, {out['params']} parameters, init "
        f"{out['init_s']:.1f} s; caches {out['cache_bytes']} bytes (ck/cv "
        f"{out['cross_cache_bytes']}); encoder {out['encoder_ms']:.1f} ms, prefill "
        f"{prefill_ms:.1f} ms, decode step {json.dumps(out['decode_step_ms'])} ms (bytes "
        f"bound {out['decode_bytes_bound_ms']:.3f} ms, every parameter "
        f"{out['all_params_bytes_bound_ms']:.3f} ms); decode vs forward "
        f"{err:.3e} (max |logit| {scale:.3e}); rows 0, 2, 3 bitwise when row 1 changes; "
        f"card vs CPU (1+1 layers) {json.dumps(checks)}; no kernel; peak memory "
        f"{out['peak_memory_bytes']} bytes ({start_bytes} at the start); profile "
        f"{json.dumps({k_: v for k_, v in prof_.items() if k_ != 'top_kernels_ms'})}")
    return {"arch": "seamless_m4t_medium", "layers": "12+12", "params": out["params"],
            "encoder_ms": out["encoder_ms"], "prefill_ms": prefill_ms,
            "decode_step_ms": out["decode_step_ms"]["median"],
            "decode_bytes_bound_ms": out["decode_bytes_bound_ms"],
            "device_ms_per_step": prof_["device_ms_per_step"],
            "device_ops_per_step": prof_["device_ops_per_step"],
            "idle_share": prof_["idle_share"],
            "peak_memory_bytes": out["peak_memory_bytes"], "start_memory_bytes": start_bytes,
            "decode_vs_forward_max_abs_err": err,
            "cpu_check_max_abs_err": checks["decode"]["max_abs_err"]}


#: The training path (path 8): yi-6b at its published widths, 8 of 32
#: layers (the f32 AdamW state of all 32, 16 bytes a parameter, would not
#: fit 80 GB), the card-vs-CPU step at 1 layer, xlstm-125m whole.
TRAIN = dict(layers=8, batch=2, seq_len=2048, steps=6, cpu_layers=1, cpu_batch=1,
             cpu_seq_len=64, xlstm_batch=4, xlstm_seq_len=256, xlstm_steps=3,
             xlstm_ckpt_after=2, launcher_steps=4)
#: The gated run's learning rate: ``AdamWConfig``'s own default.  The
#: launcher's 1e-3 (with its warmup of max(steps // 10, 1) = 1 step, so
#: that step 1 takes the full rate) is also run, reported and not gated
#: on learning: at this width its first sign-like AdamW steps raise the
#: loss for the whole run (both packages do the same at smaller widths,
#: ``tests/test_torch_train_step.py``).
TRAIN_LR, LAUNCHER_LR = 3e-4, 1e-3
#: cuBLAS's workspace setting for deterministic products, set before the
#: first cuBLAS handle exists (``main``).
CUBLAS_WORKSPACE = ":4096:8"
#: The reference's own accumulation tolerance (tests/test_training.py).
TOL_ACCUM = dict(rtol=2e-4, atol=2e-5)
#: Two runs of one step from the same state (microbatches 2 against 1;
#: the card against the CPU) sum their products in other orders: the
#: loss and the gradient norm within this relative tolerance, and m (0.1
#: times the clipped gradient after a first step) within it of each
#: leaf's largest |m|.
TOL_STEP = 1e-5


def step_agreement(a, b, ma, mb, lr, eps, b1, tag):
    """Hold two first AdamW steps from one state against each other
    (``a``, ``b``: new states; ``ma``, ``mb``: their metrics): the loss and
    ``grad_norm`` within ``TOL_STEP`` relative; every leaf of m within
    ``TOL_STEP`` of its largest magnitude; every parameter within the reference's
    ``TOL_ACCUM`` plus ``lr * min(2, dg / eps)``, where dg is the leaf's
    largest gradient difference (``|Δm| / (1 - b1)``).  A first AdamW step
    moves an element by ``lr * g / (|g| + eps)``, whose slope in g is at
    most ``1 / eps``: an element whose gradient is within rounding of
    zero may move anywhere in ``[-lr, lr]`` on either side, and no element
    by more than ``lr * dg / eps``.  Returns the worst ratios to the
    bounds, and under ``params_vs_reference_tolerance`` (not a gate) the
    worst parameter against ``TOL_ACCUM`` alone."""
    import torch

    from repro_torch.models.tree import tree_leaves

    worst = {}
    for k in ("loss", "grad_norm"):
        x, y = float(ma[k]), float(mb[k])
        worst[k] = abs(x - y) / (TOL_STEP * abs(y))
    worst["m"] = worst["params"] = 0.0
    plain = 0.0
    leaves = zip(tree_leaves(a["params"]), tree_leaves(b["params"]),
                 tree_leaves(a["opt"]["m"]), tree_leaves(b["opt"]["m"]))
    for pa, pb, m_a, m_b in leaves:
        pa, m_a = pa.to(pb.device), m_a.to(pb.device)
        dm = float((m_a - m_b).abs().max())
        scale = float(m_b.abs().max())
        worst["m"] = max(worst["m"], dm / (TOL_STEP * scale) if scale else float(dm > 0) * 2)
        slack = lr * min(2.0, dm / (1 - b1) / eps)
        ref_bound = TOL_ACCUM["atol"] + TOL_ACCUM["rtol"] * pb.abs()
        worst["params"] = max(worst["params"],
                              float(((pa - pb).abs() / (ref_bound + slack)).max()))
        plain = max(plain, float(((pa - pb).abs() / ref_bound).max()))
        del pa, m_a
    torch.cuda.synchronize()
    bad = {k: v for k, v in worst.items() if not (v <= 1.0)}
    if bad:
        raise AssertionError(f"train: {tag}: beyond the stated tolerance {bad}")
    return dict(worst, params_vs_reference_tolerance=plain)


def train_flops(cfg, batch, seq_len, remat):
    """Matmul FLOPs of one train step of a dense ``global`` stack, from the
    shapes: per layer the q, k, v, o projections, the full (S, S) scores
    and their product with V (the direct path computes every entry, the
    masked ones too) and the three SwiGLU products; the tied logits; the
    backward twice the forward; with remat the stack's forward once more.
    Elementwise work is not counted."""
    t = batch * seq_len
    d, hd, kvd = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
    layer = (2 * t * d * hd * 2 + 2 * t * d * kvd * 2
             + 2 * 2 * batch * cfg.n_heads * seq_len * seq_len * cfg.head_dim
             + 3 * 2 * t * d * cfg.d_ff)
    stack = cfg.n_layers * layer
    logits = 2 * t * d * cfg.padded_vocab
    return 3 * (stack + logits) + (stack if remat else 0)


def train_batch(vocab, batch, seq_len, step, dev):
    """Batch ``step`` of the port's ``TokenPipeline`` (seed 0) on ``dev``."""
    import torch

    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

    pipe = TokenPipeline(PipelineConfig(vocab_size=vocab, seq_len=seq_len,
                                        global_batch=batch))
    return {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(step).items()}


def train_steps(step_fn, run, batches):
    """Run ``step_fn`` over ``batches`` from ``run["state"]``, replacing it
    after each step (no caller holds a state a step was given, so only
    one old state is alive at a time); returns (losses, each step's ms by
    CUDA events)."""
    losses, ms = [], []
    for batch in batches:
        (run["state"], m), t = event_ms(lambda: step_fn(run["state"], batch))
        losses.append(float(m["loss"]))
        ms.append(t)
    return losses, ms


def train_path(report, launch_counts):
    """Training on the card under deterministic algorithms: (a) yi-6b at
    its published widths, 8 of 32 layers, six steps of ``make_train_step``
    (remat, f32, batch 2 x 2,048) at the launcher's learning rate, then at
    ``AdamWConfig``'s, with a microbatches=2 step, a profiled step and the
    peak memory; (b) one step at 1 layer, card against CPU; (c) xlstm-125m
    at full width and depth, a checkpoint after step 2 and a bitwise
    resume; (d) the launcher's CLI.  Returns the ``train`` line's
    summary."""
    import dataclasses
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.training import (AdamWConfig, TrainConfig, init_train_state,
                                      make_train_step, restore_checkpoint, save_checkpoint)

    dev = torch.device(SERVE_DEVICE)
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != CUBLAS_WORKSPACE:
        raise AssertionError("CUBLAS_WORKSPACE_CONFIG is not set: cuBLAS would not be "
                             "deterministic")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the float32 products would not be float32")
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    out = report.setdefault("train", {})
    gc.collect()
    torch.cuda.empty_cache()
    out["start_memory_bytes"] = torch.cuda.memory_allocated()
    zero_launches(launch_counts)

    # -- (a) yi-6b at its published widths, 8 of 32 layers ------------------------
    base = get_arch("yi_6b")
    widths = {k: getattr(base, k) for k in YI_WIDTHS}
    if widths != YI_WIDTHS:
        raise AssertionError(f"yi-6b widths {widths} != the published {YI_WIDTHS}")
    cfg = dataclasses.replace(base, n_layers=TRAIN["layers"])
    lm = build_model(cfg)
    b, s, n = TRAIN["batch"], TRAIN["seq_len"], TRAIN["steps"]
    batches = [train_batch(cfg.vocab, b, s, i, dev) for i in range(n + 1)]

    def config(lr, microbatches=1):
        return TrainConfig(opt=AdamWConfig(lr=lr, warmup_steps=max(n // 10, 1), total_steps=n),
                           microbatches=microbatches, dtype="float32", remat=True)

    def fresh(tc):
        return init_train_state(lm, torch.Generator(device=dev).manual_seed(0), tc, device=dev)

    yi = {"arch": "yi_6b", "layers": cfg.n_layers, "of_layers": base.n_layers,
          "batch": b, "seq_len": s}
    run = {"state": fresh(config(LAUNCHER_LR))}
    yi["params"] = lm.param_count(run["state"]["params"])
    losses, _ = train_steps(make_train_step(lm, config(LAUNCHER_LR)), run, batches[:n])
    yi["launcher_lr"] = {"lr": LAUNCHER_LR, "losses": losses}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: yi-6b at lr {LAUNCHER_LR}: losses {losses}")
    del run["state"]
    gc.collect()
    torch.cuda.empty_cache()

    tc = config(TRAIN_LR)
    run["state"] = fresh(tc)
    yi["tree_bytes"] = {"params": tree_nbytes(run["state"]["params"]),
                        "optimizer": tree_nbytes(run["state"]["opt"])}
    # microbatches=2 against 1: the same state and batch
    s2, m2 = make_train_step(lm, config(TRAIN_LR, 2))(run["state"], batches[0])
    s2 = {"params": s2["params"], "opt": {"m": s2["opt"]["m"]}}  # v is not compared
    step_fn = make_train_step(lm, tc)
    (run["state"], m1), first_ms = event_ms(lambda: step_fn(run["state"], batches[0]))
    yi["microbatches_2_vs_1"] = step_agreement(s2, run["state"], m2, m1, float(m1["lr"]),
                                               tc.opt.eps, tc.opt.b1, "microbatches 2 vs 1")
    del s2
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    yi["steps_start_memory_bytes"] = torch.cuda.memory_allocated()
    losses, ms = train_steps(step_fn, run, batches[1:n])
    losses, ms = [float(m1["loss"])] + losses, [first_ms] + ms
    yi["peak_memory_bytes"] = torch.cuda.max_memory_allocated()  # steps 2-6
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: yi-6b at lr {TRAIN_LR}: losses {losses}")
    yi["lr"], yi["losses"] = TRAIN_LR, losses
    yi["step_ms"] = {"median": float(np.median(ms)), "min": float(min(ms)),
                     "max": float(max(ms)), "all": ms}
    yi["tokens_per_s"] = b * s / (yi["step_ms"]["median"] / 1e3)
    yi["flops_per_step"] = train_flops(cfg, b, s, remat=True)
    yi["tflop_per_s"] = yi["flops_per_step"] / (yi["step_ms"]["median"] / 1e3) / 1e12
    yi["f32_peak_tflop_per_s"] = FP32_FLOP_PER_S / 1e12
    # the state (params, m, v), the gradients and the new state: 7 x 4 bytes
    # a parameter; the activations come on top
    yi["state_bytes_reckoned"] = 7 * 4 * yi["params"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run["state"], m = step_fn(run["state"], batches[n])
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    yi["profile"] = profile_split(prof, 1, wall_ms, yi["step_ms"]["median"])
    launches = read_launches(launch_counts)
    if launches:
        raise AssertionError(f"train: a GUST kernel launched ({launches})")
    del run["state"], step_fn, batches
    gc.collect()
    torch.cuda.empty_cache()
    out["yi"] = yi

    # -- (b) one step at 1 layer on the card and on the CPU, the same params ------
    lm1 = build_model(dataclasses.replace(base, n_layers=TRAIN["cpu_layers"]))
    tc1 = TrainConfig(opt=AdamWConfig(lr=LAUNCHER_LR, warmup_steps=1, total_steps=n),
                      dtype="float32", remat=True)
    card = init_train_state(lm1, torch.Generator(device=dev).manual_seed(1), tc1, device=dev)
    host = tree_map(lambda t: t.cpu(), card)
    batch = train_batch(cfg.vocab, TRAIN["cpu_batch"], TRAIN["cpu_seq_len"], 0, "cpu")
    t0 = time.perf_counter()
    host, mh = make_train_step(lm1, tc1)(host, batch)
    cpu_s = time.perf_counter() - t0
    card, mc = make_train_step(lm1, tc1)(card, {k: v.to(dev) for k, v in batch.items()})
    out["cpu_check"] = {"layers": TRAIN["cpu_layers"], "batch": TRAIN["cpu_batch"],
                        "seq_len": TRAIN["cpu_seq_len"], "cpu_step_s": cpu_s,
                        "loss": [float(mc["loss"]), float(mh["loss"])],
                        "grad_norm": [float(mc["grad_norm"]), float(mh["grad_norm"])],
                        "worst_vs_bound": step_agreement(host, card, mh, mc, float(mc["lr"]),
                                                         tc1.opt.eps, tc1.opt.b1,
                                                         "card vs CPU")}
    del card, host
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) xlstm-125m at full width and depth: checkpoint and bitwise resume ------
    arch, xwidths, _, _ = FAMILIES["xlstm"]
    xcfg = get_arch(arch)
    got = {k: getattr(xcfg, k) for k in xwidths}
    if got != xwidths:
        raise AssertionError(f"train: {arch} widths {got} != the published {xwidths}")
    xlm = build_model(xcfg)
    xn, after = TRAIN["xlstm_steps"], TRAIN["xlstm_ckpt_after"]
    xtc = TrainConfig(opt=AdamWConfig(lr=LAUNCHER_LR, warmup_steps=max(xn // 10, 1),
                                      total_steps=xn), dtype="float32", remat=True)
    xb = [train_batch(xcfg.vocab, TRAIN["xlstm_batch"], TRAIN["xlstm_seq_len"], i, dev)
          for i in range(xn)]
    xstep = make_train_step(xlm, xtc)
    xrun = {"state": init_train_state(xlm, torch.Generator(device=dev).manual_seed(0), xtc,
                                      device=dev)}
    xl = {"arch": arch, "params": xlm.param_count(xrun["state"]["params"]),
          "batch": TRAIN["xlstm_batch"], "seq_len": TRAIN["xlstm_seq_len"]}
    losses, ms = train_steps(xstep, xrun, xb[:after])
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt, after, xrun["state"], extra={"step": after})
        xl["save_s"] = time.perf_counter() - t0
        xl["checkpoint_bytes"] = sum(os.path.getsize(os.path.join(r, f))
                                     for r, _, fs in os.walk(path) for f in fs)
        tail, tail_ms = train_steps(xstep, xrun, xb[after:])
        like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                        xrun["state"])
        t0 = time.perf_counter()
        resumed, extra = restore_checkpoint(ckpt, after, like, device=dev)
        torch.cuda.synchronize()
        xl["restore_s"] = time.perf_counter() - t0
        on_cpu, _ = restore_checkpoint(ckpt, after, like, device="cpu")
    if extra != {"step": after} or not all(
            torch.equal(x.cpu(), y) for x, y in zip(tree_leaves(resumed), tree_leaves(on_cpu))):
        raise AssertionError("train: the checkpoint restored on the card and on the CPU "
                             "differ")
    del on_cpu
    rrun = {"state": resumed}
    del resumed
    again, again_ms = train_steps(xstep, rrun, xb[after:])
    if again != tail or not all(torch.equal(x, y) for x, y in
                                zip(tree_leaves(rrun["state"]), tree_leaves(xrun["state"]))):
        raise AssertionError(f"train: {arch}: the resumed steps {again} differ from the "
                             f"uninterrupted {tail}")
    xl["losses"], xl["resumed_losses"] = losses + tail, again
    if not all(np.isfinite(xl["losses"])):
        raise AssertionError(f"train: {arch}: losses {xl['losses']}")
    all_ms = ms + tail_ms + again_ms
    xl["step_ms"] = {"median": float(np.median(all_ms)), "min": float(min(all_ms)),
                     "max": float(max(all_ms))}
    launches = read_launches(launch_counts)
    if launches:
        raise AssertionError(f"train: a GUST kernel launched ({launches})")
    del xrun, rrun, xstep, xb
    gc.collect()
    torch.cuda.empty_cache()
    out["xlstm"] = xl

    # -- (d) the launcher's CLI, reduced config, its defaults ----------------------
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi_6b", "--steps",
         str(TRAIN["launcher_steps"]), "--device", "cuda"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if cli.returncode != 0:
        raise AssertionError(f"train: the launcher exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    line = json.loads(cli.stdout.strip().splitlines()[-1])
    if set(line) != {"first_loss", "last_loss"} or not all(np.isfinite(list(line.values()))):
        raise AssertionError(f"train: the launcher printed {line}")
    out["launcher"] = dict(line, seconds=time.perf_counter() - t0)
    torch.use_deterministic_algorithms(deterministic)

    prof_ = yi["profile"]
    log(f"train: yi-6b {widths} at {cfg.n_layers} of {base.n_layers} layers, {yi['params']} "
        f"parameters; lr {LAUNCHER_LR}: losses {yi['launcher_lr']['losses']}; lr {TRAIN_LR}: "
        f"losses {yi['losses']}; step {json.dumps(yi['step_ms'])} ms, {yi['tokens_per_s']:.0f} "
        f"tokens/s, {yi['flops_per_step'] / 1e12:.2f} TFLOP a step = "
        f"{yi['tflop_per_s']:.1f} TFLOP/s (f32 peak {yi['f32_peak_tflop_per_s']:.0f}); "
        f"microbatches 2 vs 1 {json.dumps(yi['microbatches_2_vs_1'])}; profile "
        f"{json.dumps({k: v for k, v in prof_.items() if k != 'top_kernels_ms'})}; peak "
        f"{yi['peak_memory_bytes']} bytes (state, grads, new state reckoned "
        f"{yi['state_bytes_reckoned']}); card vs CPU {json.dumps(out['cpu_check'])}; "
        f"{arch}: losses {xl['losses']}, resumed {again} bitwise, checkpoint "
        f"{xl['checkpoint_bytes']} bytes, save {xl['save_s']:.2f} s, restore "
        f"{xl['restore_s']:.2f} s, step {json.dumps(xl['step_ms'])} ms; launcher "
        f"{json.dumps(out['launcher'])}; no kernel")
    return {"yi_params": yi["params"], "yi_layers": cfg.n_layers,
            "yi_losses": yi["losses"], "yi_launcher_lr_losses": yi["launcher_lr"]["losses"],
            "yi_step_ms": yi["step_ms"]["median"], "yi_tokens_per_s": yi["tokens_per_s"],
            "yi_tflop_per_s": yi["tflop_per_s"], "yi_flops_per_step": yi["flops_per_step"],
            "yi_device_ms": prof_["device_ms_per_step"],
            "yi_device_ops": prof_["device_ops_per_step"], "yi_idle_share": prof_["idle_share"],
            "yi_peak_memory_bytes": yi["peak_memory_bytes"],
            "yi_state_bytes_reckoned": yi["state_bytes_reckoned"],
            "cpu_check_worst_vs_bound": out["cpu_check"]["worst_vs_bound"],
            "xlstm_losses": xl["losses"], "xlstm_resumed_bitwise": True,
            "xlstm_step_ms": xl["step_ms"]["median"],
            "xlstm_checkpoint_bytes": xl["checkpoint_bytes"], "xlstm_save_s": xl["save_s"],
            "xlstm_restore_s": xl["restore_s"], "launcher": out["launcher"]}


#: The shard path's rank counts, emulated one rank after another on the card.
SHARD_KS = (1, 2, 4, 8)
#: The crankseg_2 plans the shard path splits, (mode, load_balance) of the
#: main path's plans -> the kernel each rank's artifact runs through.
SHARD_PLANS = {("single", True): "gust_spmv_ragged",
               ("default", True): "gust_spmv_ragged_db",
               ("single-local", False): "gust_spmv_ragged_local",
               ("default", False): "gust_spmv_ragged_local_db"}
#: The data-parallel step under the one-rank NCCL group: yi-6b at its
#: widths, 1 layer, batch 2 x 512.
SHARD_TRAIN = dict(layers=1, batch=2, seq_len=512)


def emulated_ranks(p, v, k):
    """``p``'s ragged artifact as ``k`` ranks, run one after another on
    ``p``'s device: each rank's artifact (``rank_artifact``) through
    ``GustPlan.rank_spmv``, the padded outputs concatenated in rank order
    (what the all-gather gives), then ``GustPlan.reassemble``.  Returns (y,
    the rank artifacts (None for a rank without a window), the layout)."""
    import torch

    from repro_torch.core.plan import _shard_layout, rank_artifact

    lay = _shard_layout(p.artifact, k)
    arts = [rank_artifact(p.artifact, lay, d) for d in range(k)]
    y_dev = torch.cat([p.rank_spmv(a, v, lay.w_max) for a in arts])
    return p.reassemble(y_dev, lay), arts, lay


def account_cells(report):
    """The cells this smoke ran, for the dry-run account: name -> (model,
    kind, batch, seq_len, dtypes, the bytes of the trees the path
    allocated, the path's peak memory)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model

    f32 = dict(param_dtype=torch.float32, cache_dtype=torch.float32,
               compute_dtype=torch.float32)
    yi = get_arch("yi_6b")
    yi_train = report["train"]["yi"]
    return {
        "serve_yi": (build_model(yi), "decode", SERVE["batch"], SERVE["seq_len"], f32,
                     report["serve"]["tree_bytes"],
                     report["serve"]["dense"]["peak_memory_bytes"]),
        "train_yi": (build_model(dataclasses.replace(yi, n_layers=TRAIN["layers"])), "train",
                     TRAIN["batch"], TRAIN["seq_len"], f32, yi_train["tree_bytes"],
                     yi_train["peak_memory_bytes"]),
        "serve_seamless": (build_model(get_arch("seamless_m4t_medium")), "decode",
                           ENCDEC["batch"], ENCDEC["seq_len"], f32,
                           report["encdec"]["tree_bytes"],
                           report["encdec"]["peak_memory_bytes"]),
    }


#: Cycles of the spinning kernel ``queued_ms`` puts ahead of the timed
#: calls (about 10 ms at the H100's clocks: longer than the host takes to
#: enqueue 20 calls).
QUEUE_SLEEP_CYCLES = 20_000_000


def queued_ms(run, iters=20):
    """Milliseconds of one call of ``run`` on the card by CUDA events, the
    calls enqueued behind a spinning kernel so that they run back to back
    on the card: the host's launch cost, which paces back-to-back calls
    shorter than it, drops out (a call that synchronizes would bring it
    back, never the spin: the start event follows the spin)."""
    import torch

    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def shard_path(report, launch_counts, crank):
    """The multi-device layer on one card.  (a) crankseg_2's balanced and
    unbalanced ragged plans split into k = 1, 2, 4, 8 ranks run one after
    another (each rank's artifact verified first), reassembled bitwise to
    the unsharded plan; (b) under a one-rank NCCL group, ``plan.shard(mesh)
    .spmv`` bitwise the unsharded plan, the collectives on the card, a
    data-parallel yi-6b step (1 layer) bitwise the plain step; then the
    per-rank times.  (c) The dry-run account of the cells this smoke ran,
    its parameter, optimizer and cache bytes equal to the trees' exactly."""
    import dataclasses
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.core.plan import _shard_layout, rank_artifact
    from repro_torch.distributed.collectives import compressed_psum, ring_all_reduce
    from repro_torch.distributed.sharding import MeshLayout
    from repro_torch.kernels.ops import _prep_x
    from repro_torch.launch.cost_account import account_cell
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.tree import tree_leaves
    from repro_torch.training import AdamWConfig, TrainConfig, init_train_state, make_train_step
    from repro_torch.training.compression import _quant

    dev = torch.device(SERVE_DEVICE)
    out = {"ks": list(SHARD_KS), "ranks": {}, "plans": {}}
    v = torch.from_numpy(crank["v"]).to(dev)
    plans = {key: crank["plans"][key[0], key[1], "ragged", "float32"] for key in SHARD_PLANS}
    for (mode, lb), name in SHARD_PLANS.items():
        if plan_kernel(plans[mode, lb]) != name:
            raise AssertionError(f"shard: the {mode} lb={lb} plan resolves "
                                 f"{plan_kernel(plans[mode, lb])}, not {name}")

    # -- (a) ranks emulated one after another: each artifact verified first ---------
    whole = {key: p.spmv(v) for key, p in plans.items()}
    torch.cuda.synchronize()
    rank_arts, layouts = {}, {}
    for (mode, lb), p in plans.items():
        for k in SHARD_KS:
            if (lb, k) not in layouts:
                lay = layouts[lb, k] = _shard_layout(p.artifact, k)
                rank_arts[lb, k] = [rank_artifact(p.artifact, lay, d) for d in range(k)]
                for d, a in enumerate(rank_arts[lb, k]):
                    if a is not None:
                        verified(report, f"shard/crankseg_2/lb={lb}/k={k}/rank={d}", a)
    zero_launches(launch_counts)
    for (mode, lb), p in plans.items():
        for k in SHARD_KS:
            y, _, _ = emulated_ranks(p, v, k)
            if not torch.equal(y, whole[mode, lb]):
                raise AssertionError(f"shard: {mode} lb={lb} k={k}: the reassembled ranks "
                                     "differ from the unsharded plan")

    # -- (b) a one-rank NCCL group: the sharded plan, the collectives, a DP step ---
    if dev.type == "cuda":
        # the communicator's device, set before the mesh is made
        torch.cuda.set_device(torch.cuda.current_device())
    with tempfile.TemporaryDirectory() as rdv:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{rdv}/rdv", rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=120))
        try:
            mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("data",))
            for key, p in plans.items():
                if not torch.equal(p.shard(mesh).spmv(v), whole[key]):
                    raise AssertionError(f"shard: {key}: plan.shard(mesh).spmv differs from "
                                         "the unsharded plan under the NCCL group")
            launches = read_launches(launch_counts)
            group = mesh.get_group("data")
            x = torch.from_numpy(np.random.default_rng(1).standard_normal((1000, 7))
                                 .astype(np.float32)).to(dev)
            red, res = compressed_psum(x, torch.zeros_like(x), group)
            _, _, deq = _quant(x, 8)
            if not (torch.equal(ring_all_reduce(x, group), x) and torch.equal(red, deq)
                    and torch.equal(res, x - deq)):
                raise AssertionError("shard: the collectives of one rank are not the identity")
            cfg = dataclasses.replace(get_arch("yi_6b"), n_layers=SHARD_TRAIN["layers"])
            lm = build_model(cfg)
            tc = TrainConfig(opt=AdamWConfig(lr=LAUNCHER_LR, warmup_steps=1, total_steps=2),
                             dtype="float32", remat=True)
            state = init_train_state(lm, torch.Generator(device=dev).manual_seed(2), tc,
                                     device=dev)
            batch = train_batch(cfg.vocab, SHARD_TRAIN["batch"], SHARD_TRAIN["seq_len"], 0,
                                dev)
            deterministic = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True)
            plain, mp = make_train_step(lm, tc)(state, batch)
            (dp, md), dp_ms = event_ms(lambda: make_train_step(lm, tc, mesh)(state, batch))
            torch.use_deterministic_algorithms(deterministic)
            same = float(mp["loss"]) == float(md["loss"]) and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(plain), tree_leaves(dp)))
            if not same:
                raise AssertionError("shard: the data-parallel step at world 1 differs from "
                                     "the plain step")
            out["dp_step"] = {"layers": cfg.n_layers, "batch": SHARD_TRAIN["batch"],
                              "seq_len": SHARD_TRAIN["seq_len"], "loss": float(md["loss"]),
                              "ms": dp_ms, "bitwise_vs_plain": True}
            del state, plain, dp, batch
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    for name in SHARD_PLANS.values():
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"shard: the path never launched {name}")
    out["launches"] = launches

    # -- per-rank kernel times (after the counted run) ----------------------------
    # each rank's kernel on its artifact, 20 calls queued behind a spinning
    # kernel (``queued_ms``: the card's own time; back to back, calls this
    # short are paced by the host's launch cost)
    xp = _prep_x(v[:, None], v.shape[0], L)
    for (mode, lb), p in plans.items():
        name = SHARD_PLANS[mode, lb]
        kernel, _ = wrappers()[name]

        def times(art):
            args, _, kw = kernel_args(name, art)
            return queued_ms(functools.partial(kernel, *args, xp, **kw))

        whole_ms = times(p.artifact)
        row = {"kernel": name, "whole_queued_ms": whole_ms, "k": {}}
        for k in SHARD_KS:
            lay = layouts[lb, k]
            ms = [times(a) if a is not None else 0.0 for a in rank_arts[lb, k]]
            blocks = [int(b) for b in lay.b_cnt]
            row["k"][str(k)] = {
                "blocks": blocks, "windows": [int(w) for w in lay.w_cnt],
                "rank_queued_ms": ms, "imbalance": max(blocks) / (sum(blocks) / k),
                "max_rank_queued_ms": max(ms), "queued_speedup_bound": whole_ms / max(ms)}
        out["plans"][f"{mode}/lb={lb}"] = row
        log(f"shard {mode} lb={lb} ({name}): whole {whole_ms:.4f} ms queued; " + "; ".join(
            f"k={k}: max rank {r['max_rank_queued_ms']:.4f} ms, imbalance "
            f"{r['imbalance']:.3f}, bound {r['queued_speedup_bound']:.2f}x"
            for k, r in row["k"].items()))
    out["ranks"] = {f"lb={lb}/k={k}": len([a for a in arts if a is not None])
                    for (lb, k), arts in rank_arts.items()}

    # -- (c) the dry-run account against the trees the smoke allocated ------------
    one = MeshLayout((1, 1), ("data", "model"))
    out["account"] = {}
    for name, (lm, kind, b, seq_len, dtypes, allocated, peak) in account_cells(report).items():
        t0 = time.perf_counter()
        rec = account_cell(lm, kind, b, seq_len, one, **dtypes)
        got = {part: rec["bytes_per_device"][part] for part in allocated}
        if got != allocated:
            raise AssertionError(f"shard: the account of {name} reckons {got}, the smoke "
                                 f"allocated {allocated}")
        out["account"][name] = {
            "bytes": got, "bytes_equal_allocated": True,
            "reckoned_peak_bytes": rec["peak_bytes"], "reckoned_temp_bytes": rec["peak_temp_bytes"],
            "measured_peak_bytes": peak, "matmul_flops": rec["matmul_flops_per_device"],
            "memory_limit": rec["memory_limit"], "seconds": time.perf_counter() - t0}
        log(f"shard account {name}: bytes {got} equal the allocated trees; reckoned peak "
            f"{rec['peak_bytes']} (temporaries {rec['peak_temp_bytes']}), measured "
            f"max_memory_allocated {peak}; {rec['matmul_flops_per_device']} matmul FLOPs")
    log(f"shard: NCCL one-rank group: sharded spmv == unsharded bitwise; ring and "
        f"compressed sums of one rank exact; DP step == plain bitwise "
        f"({out['dp_step']['ms']:.1f} ms); launches {launches}")
    return out


#: The ``tp`` path: ``TP["world"]`` processes share the one card, each with
#: ``cuda:0``, as the ranks of a ("data", "model") mesh over gloo (file
#: rendezvous, a group timeout); each model's steps run whole in the
#: smoke's own process too, from the same seeded state.
TP = dict(mesh=(2, 2), world=4, steps=2, seed=3, group_timeout_s=60, rank_timeout_s=420)
#: The models at their published widths, 1 layer each.  llama4-scout's
#: table is cut to 8,192 rows: at its published 202,048 the account
#: reckons 31.0 GB a rank on (2, 2) (four ranks 124 GB; the whole step
#: 95.2 GB), and 1 layer is the least depth; 8,192 rows reckon 17.1 GB a
#: rank.  ``yardstick``: the whole step it is held to ("single":
#: ``make_train_step(lm, tc)``; "per_data_rank": the same step with each
#: data rank's rows routed on their own, as the sharded step's MoE routes
#: them, composed from ``LM.loss_fn``: ``per_data_rank_step``).
TP_MODELS = {
    "yi": dict(arch="yi_6b", layers=1, batch=2, seq_len=512, vocab=None,
               yardstick="single", reduced=False),
    "llama4": dict(arch="llama4_scout_17b_a16e", layers=1, batch=2, seq_len=256,
                   vocab=8192, yardstick="per_data_rank", reduced=False),
}
#: The sharded steps against the whole ones: loss and gradient norm
#: relative, every parameter absolute.
TOL_TP = 1e-5
#: The ``tp`` path's serve phase: on the same four ranks, a prefill of a
#: ``prompt_len``-token prompt and ``steps`` decode steps at batch 4,
#: ``seq_len`` 512, float32, teacher-forced on the greedy tokens of the same
#: decode run whole in the smoke's process (``TP_SERVE_MODELS``: 1 layer at
#: the published widths, llama4's table cut as ``TP_MODELS``'; ``runs``: the
#: meshes and modes, "gust_padded" / "gust_ragged" the MLP through kernel 5
#: / 7 at ``GustServeConfig()``, its plans built once here into a
#: ``PlanStore`` and loaded, verified, by every rank).  ``gust``: the
#: ``GustServeConfig`` fields (none: the defaults).  The prompt fills the
#: cache past the first slot of every model rank's share of the length
#: (four shares of 128 positions on (1, 4), two of 256 on (2, 2)), so the
#: flash decode combines live partial softmaxes from every rank, and the
#: decode steps write slots that a rank other than the first owns.
TP_SERVE = dict(batch=4, seq_len=512, prompt_len=448, steps=8, seed=0, gust={})
TP_SERVE_MODELS = {
    "yi": dict(arch="yi_6b", layers=1, vocab=None, reduced=False,
               runs=(((1, 4), "dense"), ((1, 4), "gust_padded"), ((2, 2), "dense"),
                     ((2, 2), "gust_ragged"))),
    "llama4": dict(arch="llama4_scout_17b_a16e", layers=1, vocab=8192, reduced=False,
                   runs=(((1, 4), "dense"),)),
}
#: A rank's logits against the whole decode's, of the largest |logit|.
TOL_TP_SERVE = 1e-5


def first_step(state):
    """Host copies of a state's parameters and first moments: what
    ``step_agreement`` holds of a rank's first step."""
    from repro_torch.models.tree import tree_map

    return {"params": tree_map(lambda t: t.cpu(), state["params"]),
            "m": tree_map(lambda t: t.cpu(), state["opt"]["m"])}


def host_ms(fn):
    """(fn(), its milliseconds on the host's clock): ``event_ms`` where
    there is no card."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def tp_model(spec, steps):
    """(config, model, train config of ``steps`` steps) of a ``TP_MODELS``
    entry (``reduced``: the arch's reduced widths, for a rehearsal on the
    CPU)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.training import AdamWConfig, TrainConfig

    cut = {"n_layers": spec["layers"]}
    if spec["vocab"]:
        cut["vocab"] = spec["vocab"]
    base = get_arch(spec["arch"])
    cfg = dataclasses.replace(base.reduced() if spec["reduced"] else base, **cut)
    tc = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps),
                     dtype="float32", remat=True)
    return cfg, build_model(cfg), tc


def per_data_rank_step(lm, tc, state, batch, dp):
    """The whole step with the rows of each of ``dp`` data ranks routed on
    their own: each rank's loss (its rows' masked sum over every row's
    count, its aux weighing 1/dp) through ``LM.loss_fn``, the gradients
    summed, then AdamW; what the data-parallel and the sharded steps
    compute for an MoE arch."""
    import torch

    from repro_torch.models.tree import tree_leaves, tree_unflatten
    from repro_torch.training.optimizer import adamw_update

    params = state["params"]
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    rows = batch["tokens"].shape[0] // dp
    denom = batch["loss_mask"].sum()
    loss, grads = 0.0, None
    for r in range(dp):
        mine = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
        with torch.enable_grad():
            part, _ = lm.loss_fn(tree_unflatten(params, live), mine, dtype=tc.compute_dtype,
                                 remat=tc.remat, denom=denom, shards=dp)
            g = torch.autograd.grad(part, live, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x for p, x in zip(live, g)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss = loss + part.detach()
    params2, opt2, om = adamw_update(tc.opt, params, tree_unflatten(params, grads),
                                     state["opt"])
    return {"params": params2, "opt": opt2}, {"loss": loss, **om}


def allocations():
    """A ``TorchDispatchMode`` recording, in ``.seen``, the shape of every
    tensor an op run under it allocates (an output over an input's
    storage, a view, is not counted, nor a tensor on the meta device,
    which holds no storage), and in ``.ops`` the ops' names."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves as leaves

    class Allocations(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen, self.ops = set(), set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.ops.add(str(func))
            inputs = {t.untyped_storage()._cdata for t in leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)}
            for t in leaves(out):
                if (isinstance(t, torch.Tensor) and t.device.type != "meta"
                        and t.untyped_storage()._cdata not in inputs):
                    self.seen.add(tuple(t.shape))
            return out

    return Allocations()


def split_leaves(tree, specs, mesh):
    """(path, whole shape) of each leaf of ``tree`` that ``mesh`` splits
    under its spec in ``specs``."""
    from repro_torch.distributed.sharding import local_shape, map_with_path
    from repro_torch.models.tree import tree_map

    paths, flat = [], []
    map_with_path(lambda path, leaf: paths.append(path), tree)
    tree_map(lambda leaf, spec: flat.append((tuple(leaf.shape), spec)), tree, specs)
    return [(path, shape) for path, (shape, spec) in zip(paths, flat)
            if local_shape(shape, spec, mesh) != shape]


def whole_stacked_shapes(params, specs, mesh, local):
    """The whole shapes of the stacked ``(R, ...)`` leaves that ``mesh``
    splits, less those that some local leaf also has (``local``: an
    allocation of such a shape would be ambiguous)."""
    return {shape for path, shape in split_leaves(params, specs, mesh)
            if "/reps/" in f"/{path}/"} - local


def whole_cache_shapes(caches, specs, mesh, local):
    """The whole shapes of the cache leaves that ``mesh`` splits, and of
    one layer's slice of each rep-stacked one but a cross-attention's
    ``ck``/``cv`` (the prefill projects the whole memory, which every
    rank's heads attend over, before it keeps the rank's positions), less
    ``local`` (as :func:`whole_stacked_shapes`)."""
    out = set()
    for path, shape in split_leaves(caches, specs, mesh):
        out.add(shape)
        if "/reps/" in f"/{path}/" and path.rsplit("/", 1)[-1] not in ("ck", "cv"):
            out.add(shape[1:])
    return out - local


def live_slots(caches, place):
    """The fewest written positions that this rank holds in any attention
    cache whose length the placement splits over "model": the ``pos``
    leaf is whole on every rank (the rule replicates it), the rank holds
    its ``model``-th share of the slots.  None without such a cache."""
    import torch

    counts = []

    def walk(node):
        if isinstance(node, dict):
            if "k" in node and "pos" in node:
                c, cl = node["pos"].shape[-1], node["k"].shape[-3]
                if cl < c and node["pos"].numel():  # a stack of no repetitions holds none
                    first = place.model.rank * cl
                    counts.append(int((node["pos"][..., first:first + cl] >= 0).sum()))
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    with torch.no_grad():
        walk(caches)
    return min(counts) if counts else None


def other_blocks(held):
    """The card's allocated blocks (``torch.cuda.memory_snapshot``) that
    hold none of the tensors of ``held``: their sizes, largest first."""
    import torch

    from repro_torch.models.tree import tree_leaves

    ptrs = {t.untyped_storage().data_ptr() for t in tree_leaves(held) if t.numel()}
    return sorted((b["size"] for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
                   if b["state"] == "active_allocated" and b["address"] not in ptrs),
                  reverse=True)


def tp_serve_gust(mode, gust, store=None):
    """The ``GustServeConfig`` of a serve run's mode (None: dense)."""
    from repro_torch.serving import GustServeConfig

    if mode == "dense":
        return None
    extra = {} if store is None else {"plan_store": store, "store_verify": "load"}
    return GustServeConfig(ragged=mode == "gust_ragged", **gust, **extra)


def tp_serve_prompt(vocab, dev):
    """The serve phase's prompt batch, numpy seed 0."""
    import torch

    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, vocab, (TP_SERVE["batch"], TP_SERVE["prompt_len"]))
                            .astype(np.int32)).to(dev)


def tp_serve_decode(lm, params, caches, prompt, tokens, gust, place=None, timed=None,
                    after_prefill=None, watch=None):
    """A prefill of ``prompt`` and a decode step for each of ``tokens``
    (None: the greedy token of the step before), float32; returns (the
    logits of the prefill's last position and of every step, host copies,
    the tokens fed, the caches after the last step).  ``timed``: a dict
    that receives the prefill ms and each step's ms (CUDA events on the
    card); ``after_prefill(caches)`` runs between the prefill and the first
    step; ``watch``: a context entered around the prefill and the first
    step (an allocation watch, whose hook on every op costs host time)."""
    import torch

    from repro_torch.serving import decode_step_gust

    watched = watch if watch is not None else contextlib.nullcontext()
    clock = event_ms if torch.cuda.is_available() and prompt.is_cuda else host_ms
    with watched:
        (first, caches), ms = clock(lambda: lm.prefill(params, {"tokens": prompt}, caches,
                                                       dtype=torch.float32, place=place))
    logits, fed, step_ms = [first[:, -1].cpu()], [], []
    if after_prefill is not None:
        after_prefill(caches)
    for t in range(TP_SERVE["steps"]):
        tok = (torch.argmax(logits[-1], dim=-1).to(torch.int32)[:, None].to(prompt.device)
               if tokens is None else tokens[t].to(prompt.device))
        fed.append(tok.cpu())
        pos = TP_SERVE["prompt_len"] + t
        with watched if t == 0 else contextlib.nullcontext():
            if gust is None:
                (out, caches), step = clock(lambda: lm.decode_step(
                    params, caches, tok, pos, dtype=torch.float32, place=place))
            else:
                (out, caches), step = clock(lambda: decode_step_gust(
                    lm, params, gust, caches, tok, pos, dtype=torch.float32, place=place))
        logits.append(out[:, 0].cpu())
        step_ms.append(step)
    if timed is not None:
        timed.update(prefill_ms=ms, step_ms=step_ms)
    return logits, torch.stack(fed), caches


def tp_serve_whole(report, launch_counts, rdv, dev):
    """The serve phase's yardsticks in the smoke's process, before the
    ranks start: each model's whole decode (greedy), dense and, for the
    GUST modes, with its MLP gustified at ``GustServeConfig()`` into the
    ``PlanStore`` at ``<rdv>/store`` (every plan verified before its first
    launch); the greedy tokens go to ``<rdv>/tp_serve_tokens.pt`` for the
    ranks.  Returns model -> mode -> {"logits", "tokens", ms}, and the
    kernels this process launched."""
    import torch

    from repro_torch.core.plan_store import PlanStore
    from repro_torch.serving import gustify

    out, tokens, launched = {}, {}, {}
    store = PlanStore(os.path.join(rdv, "store"))
    for name, spec in TP_SERVE_MODELS.items():
        cfg, lm, _ = tp_model(spec, TP_SERVE["steps"])
        params = lm.init(torch.Generator(device=dev).manual_seed(TP_SERVE["seed"]), device=dev)
        prompt = tp_serve_prompt(cfg.vocab, dev)
        for mode in sorted({m for _, m in spec["runs"]}):
            gcfg = tp_serve_gust(mode, TP_SERVE["gust"])
            gust = None
            if gcfg is not None:
                gust = gustify(lm, params, gcfg, store=store)
                for mat, plans in gust["plans"].items():
                    for i, p in enumerate(plans):
                        verified(report, f"tp.serve.{name}.{mode}.{mat}.{i}", p)
            zero_launches(launch_counts)
            caches = lm.init_caches(TP_SERVE["batch"], TP_SERVE["seq_len"], torch.float32,
                                    device=dev)
            timed = {}
            logits, fed, _ = tp_serve_decode(lm, params, caches, prompt, None, gust,
                                             timed=timed)
            for k, v in read_launches(launch_counts).items():
                launched[k] = launched.get(k, 0) + v
            out.setdefault(name, {})[mode] = dict(logits=logits, tokens=fed, **timed)
            tokens.setdefault(name, {})[mode] = fed
            del caches, gust
        del params
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(tokens, os.path.join(rdv, "tp_serve_tokens.pt"))
    return out, launched


def tp_serve_rank(rank, rdv, dev, conf):
    """A rank's serve phase (``tp_rank``, after its train steps): per
    model the whole parameters drawn on the card, then per run its shards
    of them and of fresh caches made at their local shapes
    (``init_serve_state`` over the run's mesh, under an allocation watch
    that the prefill and the first step run under too), a prefill and the
    decode steps teacher-forced on the whole decode's tokens
    (``LM.decode_step`` or ``decode_step_gust`` with ``place=``; the GUST
    plans from the parent's store, verified on load), timed with CUDA
    events; the memory resident before the prefill (and the allocated
    blocks that hold no shard), the prefill's and the decode steps' peaks,
    the positions written in each rank's share of the cache, the bytes each
    collective sent and the kernels launched; each run's logits to
    ``<rdv>/tp_serve.<model>.<i>.<rank>.pt``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import collectives
    from repro_torch.models.tree import tree_leaves
    from repro_torch.serving import gustify, init_serve_state

    serve, models = conf["TP_SERVE"], conf["TP_SERVE_MODELS"]
    cuda = dev.type == "cuda"
    tokens = torch.load(os.path.join(rdv, "tp_serve_tokens.pt"))
    launch_counts, meshes, out = counters(), {}, {}
    for name, spec in models.items():
        cfg, lm, _ = tp_model(spec, TP_SERVE["steps"])
        prompt = tp_serve_prompt(cfg.vocab, dev)
        rows = out[name] = []
        for i, (shape, mode) in enumerate(spec["runs"]):
            shape = tuple(shape)
            if shape not in meshes:  # every rank makes the meshes in the same order
                meshes[shape] = init_device_mesh(dev.type, shape,
                                                 mesh_dim_names=("data", "model"))
            # the run's shards and plans from the whole parameters, drawn anew
            # and freed before it starts: it holds what a rank of its mesh holds;
            # its caches are made shard by shard, under the allocation watch
            t0 = time.perf_counter()
            params = lm.init(torch.Generator(device=dev).manual_seed(serve["seed"]),
                             device=dev)
            gcfg = tp_serve_gust(mode, serve["gust"], os.path.join(rdv, "store"))
            gust = None if gcfg is None else gustify(lm, params, gcfg)
            watch = allocations()
            with watch:
                state = init_serve_state(lm, params, meshes[shape], serve["batch"],
                                         serve["seq_len"], torch.float32)
            local = {tuple(x.shape) for x in tree_leaves((state.params, state.caches))}
            meta = lm.init_caches(serve["batch"], serve["seq_len"], torch.float32,
                                  device="meta")
            watched = (whole_cache_shapes(meta, state.place.cache, meshes[shape], local)
                       | whole_stacked_shapes(params, state.place.specs, meshes[shape], local))
            del params
            gc.collect()
            torch.cuda.empty_cache()
            gust_s = time.perf_counter() - t0
            held = tree_nbytes(state.params) + tree_nbytes(state.caches)
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated() if cuda else None
            others = other_blocks((state.params, state.caches)) if cuda else []
            zero_launches(launch_counts)
            collectives.reset_traffic()
            timed, prefill_traffic, after = {}, {}, {}

            def after_prefill(caches):  # the decode steps' traffic and peak apart
                prefill_traffic.update({op: dict(r) for op, r in collectives.traffic.items()})
                collectives.reset_traffic()
                after["live_slots"] = live_slots(caches, state.place)
                if cuda:
                    torch.cuda.synchronize()
                    after["peak"] = torch.cuda.max_memory_allocated()
                    torch.cuda.reset_peak_memory_stats()

            logits, _, caches = tp_serve_decode(lm, state.params, state.caches, prompt,
                                                tokens[name][mode], gust, state.place, timed,
                                                after_prefill, watch)
            torch.save(logits, os.path.join(rdv, f"tp_serve.{name}.{i}.{rank}.pt"))
            steps = serve["steps"]
            rows.append({
                "mesh": list(shape), "mode": mode, "rows": state.place.rows,
                "prefill_ms": timed["prefill_ms"], "step_ms": timed["step_ms"],
                "param_cache_bytes": held,
                "resident_bytes": resident, "other_blocks": others,
                "prefill_peak_bytes": after.get("peak"),
                "peak_memory_bytes": torch.cuda.max_memory_allocated() if cuda else None,
                "live_slots_after_prefill": after["live_slots"],
                "live_slots_at_end": live_slots(caches, state.place),
                "whole_watched": len(watched),
                "whole_made": sorted(list(x) for x in watched & watch.seen),
                "traffic": {op: dict(row) for op, row in collectives.traffic.items()},
                "prefill_traffic": prefill_traffic,
                "launches": read_launches(launch_counts),
                "shard_and_gustify_s": gust_s,
                "plan_store": None if gust is None else gust["stats"].get("plan_store")})
            print(f"tp-rank {rank} serve {name} {shape} {mode}: prefill "
                  f"{timed['prefill_ms']:.1f} ms, steps {[round(x, 1) for x in timed['step_ms']]}"
                  f" ms over {steps} steps; resident {resident}, other blocks {others}",
                  flush=True)
            del state, gust, caches
            gc.collect()
            torch.cuda.empty_cache()
    return out


def tp_rank(rank, world, rdv, device):
    """One rank of the ``tp`` path (``python3 chip_smoke.py tp-rank <rank>
    <world> <dir> <device>``): joins the gloo group, and per model of the
    ``tp_config.json`` its parent wrote (``TP``, ``TP_MODELS``) draws the
    whole state on the card in its turn (one rank at a time: four whole
    states would not fit), keeps its shards, runs the sharded steps and
    writes its numbers to ``<dir>/tp.<rank>.json`` and its final
    parameter shards to ``<dir>/tp.<model>.<rank>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import local_shape, tree_bytes_per_device
    from repro_torch.distributed.tensor_parallel import mesh_axes
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.train_loop import shard_train_state

    with open(os.path.join(rdv, "tp_config.json")) as f:
        conf = json.load(f)
    tp, models = conf["TP"], conf["TP_MODELS"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"  # else a rehearsal on the CPU: host clock, no memory stats

    def mem():
        if not cuda:
            return None
        return {"allocated": torch.cuda.memory_allocated(),
                "reserved": torch.cuda.memory_reserved(),
                "peak": torch.cuda.max_memory_allocated()}
    if cuda:
        dev = torch.device("cuda", 0 if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{rdv}/rdv", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=tp["group_timeout_s"]))
    try:
        mesh = init_device_mesh(dev.type, tuple(tp["mesh"]), mesh_dim_names=("data", "model"))
        out = {"rank": rank, "coords": {n: a.rank for n, a in mesh_axes(mesh).items()},
               "models": {}}
        for name, spec in models.items():
            cfg, lm, tc = tp_model(spec, tp["steps"])
            sharded = None
            for turn in range(world):
                if turn == rank:
                    whole = init_train_state(
                        lm, torch.Generator(device=dev).manual_seed(tp["seed"]), tc, device=dev)
                    sharded = shard_train_state(whole, mesh)
                    del whole
                    gc.collect()
                    torch.cuda.empty_cache()
                dist.barrier()
            memory = {"sharded": mem()}
            print(f"tp-rank {rank} {name}: shards cut, memory {memory['sharded']}", flush=True)
            meta = lm.init(None)
            shapes = []
            tree_map(lambda loc, w, s: shapes.append(
                [list(loc.shape), list(local_shape(tuple(w.shape), s, mesh))]),
                sharded["params"], meta, sharded.specs)
            held = sum(tree_nbytes(sharded[k]) for k in ("params",)) + tree_nbytes(
                {"m": sharded["opt"]["m"], "v": sharded["opt"]["v"]})
            stacks = whole_stacked_shapes(meta, sharded.specs, mesh,
                                          {tuple(x.shape) for x in tree_leaves(sharded)})
            batches = [train_batch(cfg.vocab, spec["batch"], spec["seq_len"], i, dev)
                       for i in range(tp["steps"])]
            step = make_train_step(lm, tc, mesh)
            run = {"state": sharded}
            del sharded
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            collectives.reset_traffic()
            # the first step under the allocation watch, timed apart (the
            # watch's Python hook on every op costs host time)
            watch, rows = allocations(), []
            for i, b in enumerate(batches):
                with watch if i == 0 else contextlib.nullcontext():
                    (run["state"], m), ms = (event_ms if cuda else host_ms)(
                        lambda: step(run["state"], b))
                rows.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                             "ms": ms, "watched": i == 0})
                if i == 0:  # the first step's parameters and m, held by step_agreement
                    torch.save(first_step(run["state"]), os.path.join(rdv, f"tp.{name}.{rank}.pt"))
                memory[f"step_{i}"] = mem()
                print(f"tp-rank {rank} {name}: step {i} {rows[-1]}, memory "
                      f"{memory[f'step_{i}']}", flush=True)
            out["models"][name] = {
                "steps": rows, "shapes": shapes,
                "param_opt_bytes": held,
                "param_opt_bytes_reckoned": 3 * tree_bytes_per_device(meta, run["state"].specs,
                                                                      mesh),
                "peak_memory_bytes": torch.cuda.max_memory_allocated() if cuda else None,
                "memory": memory,
                "traffic_per_step": {op: {k: v / tp["steps"] for k, v in row.items()}
                                     for op, row in collectives.traffic.items()},
                "whole_stacks": sorted(list(s) for s in stacks),
                "whole_stacks_made": sorted(list(s) for s in stacks & watch.seen),
                "watch_saw_backward": any("backward" in op for op in watch.ops)}
            del run, batches
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        out["serve"] = tp_serve_rank(rank, rdv, dev, conf)
        with open(os.path.join(rdv, f"tp.{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def tp_serve_account(whole):
    """The account of each serve run (``account_cell``'s decode cell on
    the run's mesh, float32): its bytes a rank, peak and traffic a step."""
    import torch

    from repro_torch.distributed.sharding import MeshLayout
    from repro_torch.launch.cost_account import account_cell
    from repro_torch.serving import dryrun_specs

    out = {"models": {}}
    f32 = dict(param_dtype=torch.float32, cache_dtype=torch.float32,
               compute_dtype=torch.float32)
    for name, spec in TP_SERVE_MODELS.items():
        cfg, lm, _ = tp_model(spec, TP_SERVE["steps"])
        runs = []
        for shape, mode in spec["runs"]:
            gcfg = tp_serve_gust(mode, TP_SERVE["gust"])
            t0 = time.perf_counter()
            rec = account_cell(lm, "decode", TP_SERVE["batch"], TP_SERVE["seq_len"],
                               MeshLayout(tuple(shape), ("data", "model")),
                               gust_specs=None if gcfg is None else dryrun_specs(lm, gcfg),
                               **f32)
            runs.append({"mesh": list(shape), "mode": mode, "account": {
                "param_cache_bytes_a_rank": rec["bytes_per_device"]["params"]
                + rec["bytes_per_device"]["caches"],
                "arguments_a_rank": rec["bytes_per_device"]["arguments"],
                "peak_bytes_a_rank": rec["peak_bytes"], "traffic_a_step": rec["traffic"],
                "seconds": time.perf_counter() - t0}})
        w = whole[name]
        out["models"][name] = {
            "arch": spec["arch"], "layers": cfg.n_layers, "vocab": cfg.vocab,
            "params": lm.param_count(lm.init(None)), "runs": runs,
            "whole": {mode: {"prefill_ms": v["prefill_ms"], "step_ms": v["step_ms"]}
                      for mode, v in w.items()}}
    return out


def tp_serve_gates(out, whole, ranks, rdv):
    """Each serve run on every rank: its logits within ``TOL_TP_SERVE`` of
    the largest |logit| of the whole decode's rows, its parameter and cache
    bytes and its collectives' bytes a step the account's, positions
    written in its share of every split cache length before the first
    step, no whole split cache leaf or stacked parameter allocated from
    its set-up through the first step, and a GUST run's kernel launched
    (its plans from the store: no schedule on a rank)."""
    import torch

    for name, row in out["models"].items():
        for i, run in enumerate(row["runs"]):
            want = whole[name][run["mode"]]["logits"]
            acct = run["account"]
            run["ranks"] = []
            worst = 0.0
            for rk in ranks:
                got = rk["serve"][name][i]
                tag = f"tp serve {name} {run['mesh']} {run['mode']} rank {rk['rank']}"
                logits = torch.load(os.path.join(rdv, f"tp_serve.{name}.{i}.{rk['rank']}.pt"))
                first, n = got["rows"] if got["rows"] else (0, TP_SERVE["batch"])
                for t, (g, w) in enumerate(zip(logits, want)):
                    w = w[first:first + n]
                    err = float((g - w).abs().max()) / float(w.abs().max())
                    worst = max(worst, err)
                    if not err <= TOL_TP_SERVE:
                        raise AssertionError(f"{tag} step {t}: logits {err:.3e} of the "
                                             f"largest from the whole decode's")
                if not got["live_slots_after_prefill"]:
                    raise AssertionError(f"{tag}: {got['live_slots_after_prefill']} positions "
                                         f"written in its share of the cache before the "
                                         f"first step")
                if not got["whole_watched"] or got["whole_made"]:
                    raise AssertionError(f"{tag}: whole leaves allocated {got['whole_made']} "
                                         f"of {got['whole_watched']} watched")
                if got["param_cache_bytes"] != acct["param_cache_bytes_a_rank"]:
                    raise AssertionError(f"{tag}: holds {got['param_cache_bytes']} bytes of "
                                         f"parameters and caches, the account "
                                         f"{acct['param_cache_bytes_a_rank']}")
                steps = TP_SERVE["steps"]
                per_step = {op: {k: v / steps for k, v in r.items()}
                            for op, r in got["traffic"].items()}
                if rk["rank"] == 0 and per_step != {op: {k: float(v) for k, v in r.items()}
                                                    for op, r in acct["traffic_a_step"].items()}:
                    raise AssertionError(f"{tag}: sent {per_step} a step, the account "
                                         f"{acct['traffic_a_step']}")
                if run["mode"] != "dense":
                    kernel = "gust_spmv_ragged_db" if run["mode"] == "gust_ragged" \
                        else "gust_spmv_db"
                    if not got["launches"].get(kernel):
                        raise AssertionError(f"{tag}: launched {got['launches']}, not {kernel}")
                    hits = (got["plan_store"] or {}).get("hits", 0)
                    if hits != 3:
                        raise AssertionError(f"{tag}: {hits} of 3 plans from the store "
                                             f"({got['plan_store']})")
                elif got["launches"]:
                    raise AssertionError(f"{tag}: the dense decode launched {got['launches']}")
                run["ranks"].append({k: got[k] for k in (
                    "rows", "prefill_ms", "step_ms", "peak_memory_bytes", "prefill_peak_bytes",
                    "resident_bytes", "other_blocks", "param_cache_bytes", "launches",
                    "live_slots_after_prefill", "live_slots_at_end", "whole_watched",
                    "shard_and_gustify_s", "prefill_traffic")} | {
                    "rank": rk["rank"], "traffic_a_step": per_step,
                    "collective_bytes_a_step": sum(r["bytes"] for r in per_step.values())})
            run["max_rel_logit_err"] = worst
            for rk in run["ranks"]:  # beside the account: less the cuBLAS workspaces and plans
                rk["peak_less_other_blocks"] = (None if rk["peak_memory_bytes"] is None else
                                                rk["peak_memory_bytes"] - sum(rk["other_blocks"]))
            r0 = run["ranks"][0]
            log(f"tp serve {name} ({row['arch']}, {row['layers']} layer) on {run['mesh']} "
                f"{run['mode']}: logits within {worst:.2e} of the whole decode's; rank 0 "
                f"prefill {r0['prefill_ms']:.1f} ms, median step "
                f"{sorted(r0['step_ms'])[len(r0['step_ms']) // 2]:.1f} ms (whole "
                f"{sorted(whole[name][run['mode']]['step_ms'])[TP_SERVE['steps'] // 2]:.1f}), "
                f"decode peak {r0['peak_memory_bytes']} bytes, less the blocks holding no "
                f"shard {r0['peak_less_other_blocks']} (account {acct['peak_bytes_a_rank']}; "
                f"those blocks {r0['other_blocks'][:6]}), prefill peak "
                f"{r0['prefill_peak_bytes']}, live slots after the prefill "
                f"{[r['live_slots_after_prefill'] for r in run['ranks']]}, "
                f"{r0['collective_bytes_a_step']:.0f} bytes sent a step (the account's), "
                f"launches {r0['launches']}")


def tp_path(report, launch_counts):
    """Tensor, expert and fully-sharded parallelism on the one card: (a)
    the account reckons each model's bytes a rank; (b) ``TP["world"]``
    rank processes (``tp_rank``) form the ("data", "model") mesh over gloo
    and run the sharded steps while this process holds nothing on the
    card; (c) each model steps whole in this process (its yardstick), from
    the same seeded state; (d) every rank's loss and gradient norm within
    ``TOL_TP`` of the yardstick's, its final parameter shards within
    ``TOL_TP`` of the yardstick's parameters cut the same way, its shards
    ``local_shape``'s, its parameter and optimizer bytes the account's
    (``tree_bytes_per_device``), and no whole stacked leaf allocated."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed.collectives import HOST_STAGED
    from repro_torch.distributed.sharding import MeshLayout, param_specs
    from repro_torch.distributed.tensor_parallel import Axis, shard_tree
    from repro_torch.launch.cost_account import account_cell
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.tree import tree_leaves
    from repro_torch.training import init_train_state, make_train_step

    dev = torch.device(SERVE_DEVICE)
    layout = MeshLayout(TP["mesh"], ("data", "model"))
    out = {"mesh": list(TP["mesh"]), "world": TP["world"], "backend": "gloo",
           "steps": TP["steps"], "models": {}}

    # -- (a) the account's bytes a rank --------------------------------------------
    f32 = dict(param_dtype=torch.float32, cache_dtype=torch.float32,
               compute_dtype=torch.float32)
    for name, spec in TP_MODELS.items():
        cfg, lm, _ = tp_model(spec, TP["steps"])
        t0 = time.perf_counter()
        rec = account_cell(lm, "train", spec["batch"], spec["seq_len"], layout, **f32)
        row = out["models"][name] = {
            "arch": spec["arch"], "layers": cfg.n_layers, "vocab": cfg.vocab,
            "batch": spec["batch"], "seq_len": spec["seq_len"],
            "params": lm.param_count(lm.init(None)), "yardstick": spec["yardstick"],
            "account": {"peak_bytes_a_rank": rec["peak_bytes"],
                        "arguments_a_rank": rec["bytes_per_device"]["arguments"],
                        "collective_bytes_a_step": rec["collective_bytes"]}}
        if spec["vocab"]:  # what the published table would need
            published = dataclasses.replace(cfg, vocab=get_arch(spec["arch"]).vocab)
            full = account_cell(build_model(published), "train", spec["batch"],
                                spec["seq_len"], layout, **f32)
            row["account"]["published_vocab_peak_bytes_a_rank"] = full["peak_bytes"]
        row["account"]["seconds"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as rdv:
        # -- (a') the serve phase's whole decodes and their account ----------------------
        t0 = time.perf_counter()
        serve_whole, serve_launched = tp_serve_whole(report, launch_counts, rdv, dev)
        out["serve"] = tp_serve_account(serve_whole)
        out["serve"]["whole_seconds"] = time.perf_counter() - t0

        # -- (b) the ranks, sharing the card --------------------------------------------
        gc.collect()
        torch.cuda.empty_cache()
        out["parent_memory_bytes"] = {"allocated": torch.cuda.memory_allocated(),
                                      "reserved": torch.cuda.memory_reserved()}
        with open(os.path.join(rdv, "tp_config.json"), "w") as f:
            json.dump({"TP": TP, "TP_MODELS": TP_MODELS, "TP_SERVE": TP_SERVE,
                       "TP_SERVE_MODELS": TP_SERVE_MODELS}, f)
        t0 = time.perf_counter()
        cmd = [sys.executable, os.path.abspath(__file__), "tp-rank"]
        env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        procs = [subprocess.Popen(cmd + [str(r), str(TP["world"]), rdv, str(dev)], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(TP["world"])]
        tails = []
        try:
            for p in procs:
                text, _ = p.communicate(timeout=TP["rank_timeout_s"])
                tails.append(text[-3000:])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        bad = [(r, p.returncode, t) for r, (p, t) in enumerate(zip(procs, tails))
               if p.returncode]
        if bad:
            raise AssertionError(f"tp: ranks failed: {bad}")
        ranks = []
        for r in range(TP["world"]):
            with open(os.path.join(rdv, f"tp.{r}.json")) as f:
                ranks.append(json.load(f))
        out["ranks_seconds"] = time.perf_counter() - t0

        # -- (c) each model whole in this process, then (d) its gates ------------------
        for name, spec in TP_MODELS.items():
            cfg, lm, tc = tp_model(spec, TP["steps"])
            zero_launches(launch_counts)
            run = {"state": init_train_state(
                lm, torch.Generator(device=dev).manual_seed(TP["seed"]), tc, device=dev)}
            step = (make_train_step(lm, tc) if spec["yardstick"] == "single" else
                    functools.partial(per_data_rank_step, lm, tc, dp=TP["mesh"][0]))
            rows = []
            for i in range(TP["steps"]):
                batch = train_batch(cfg.vocab, spec["batch"], spec["seq_len"], i, dev)
                (run["state"], m), ms = event_ms(lambda: step(run["state"], batch))
                rows.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                             "lr": float(m["lr"]), "ms": ms})
                if i == 0:  # kept on the card for the gates
                    yard = {"params": run["state"]["params"], "m": run["state"]["opt"]["m"]}
            del run, batch, m
            launched = read_launches(launch_counts)
            if launched:
                raise AssertionError(f"tp: the whole {name} steps launched GUST kernels "
                                     f"{launched}")
            row = out["models"][name]
            row["whole_steps"] = rows
            specs = param_specs(yard["params"], layout, mode="train")
            row["ranks"] = []
            worst = 0.0
            for rk in ranks:
                got = rk["models"][name]
                tag = f"tp {name} rank {rk['rank']}"
                for i, (a, b) in enumerate(zip(got["steps"], rows)):
                    for k in ("loss", "grad_norm"):
                        if not abs(a[k] - b[k]) <= TOL_TP * abs(b[k]):
                            raise AssertionError(f"{tag} step {i}: {k} {a[k]} against the "
                                                 f"whole step's {b[k]}")
                if any(loc != want for loc, want in got["shapes"]):
                    raise AssertionError(f"{tag}: a shard is not local_shape's")
                if got["param_opt_bytes"] != got["param_opt_bytes_reckoned"]:
                    raise AssertionError(f"{tag}: holds {got['param_opt_bytes']} bytes of "
                                         f"parameters and optimizer, the account "
                                         f"{got['param_opt_bytes_reckoned']}")
                if got["whole_stacks_made"]:
                    raise AssertionError(f"{tag}: whole stacked leaves allocated "
                                         f"{got['whole_stacks_made']} of {got['whole_stacks']}")
                axes = {n: Axis(n, None, c, dict(zip(("data", "model"), TP["mesh"]))[n])
                        for n, c in rk["coords"].items()}
                cut = {part: shard_tree(yard[part], specs, axes) for part in ("params", "m")}
                shards = torch.load(os.path.join(rdv, f"tp.{name}.{rk['rank']}.pt"),
                                    map_location=dev)
                live = [i for i, x in enumerate(tree_leaves(cut["params"])) if x.numel()]

                def held(tree):
                    leaves = tree_leaves(tree)
                    return [leaves[i] for i in live]

                agreement = step_agreement(
                    {"params": held(shards["params"]), "opt": {"m": held(shards["m"])}},
                    {"params": held(cut["params"]), "opt": {"m": held(cut["m"])}},
                    got["steps"][0], rows[0], rows[0]["lr"], tc.opt.eps, tc.opt.b1,
                    f"{tag} step 0")
                err = max(float((a - b).abs().max()) for a, b in
                          zip(held(shards["params"]), held(cut["params"])))
                worst = max(worst, err)
                row["ranks"].append({
                    "rank": rk["rank"], "coords": rk["coords"],
                    "step_ms": [s["ms"] for s in got["steps"]],
                    "peak_memory_bytes": got["peak_memory_bytes"],
                    "memory": got["memory"],
                    "param_opt_bytes": got["param_opt_bytes"],
                    "collective_bytes_a_step": sum(t["bytes"] for t in
                                                   got["traffic_per_step"].values()),
                    "traffic_per_step": got["traffic_per_step"],
                    "whole_stacks_watched": len(got["whole_stacks"]),
                    "watch_saw_backward": got["watch_saw_backward"],
                    "step_agreement": agreement, "max_abs_param_err": err})
                del shards, cut
            del yard
            gc.collect()
            torch.cuda.empty_cache()
            row["loss"] = [s["loss"] for s in ranks[0]["models"][name]["steps"]]
            row["grad_norm"] = [s["grad_norm"] for s in ranks[0]["models"][name]["steps"]]
            row["max_abs_param_err_step_0"] = worst
            r0 = row["ranks"][0]
            log(f"tp {name}: {spec['arch']} {row['layers']} layer, vocab {row['vocab']}, "
                f"{row['params']} parameters, batch {spec['batch']} x {spec['seq_len']} on "
                f"{TP['mesh']}: losses {row['loss']} (whole {[s['loss'] for s in rows]}), "
                f"the first step's state held by step_agreement (rank 0 "
                f"{json.dumps(r0['step_agreement'])}; parameters within {worst:.3e}); "
                f"rank 0 step ms {r0['step_ms']}, peak {r0['peak_memory_bytes']} bytes "
                f"(account {row['account']['peak_bytes_a_rank']}), "
                f"{r0['collective_bytes_a_step']:.0f} collective bytes a step (account "
                f"{row['account']['collective_bytes_a_step']:.0f})")

        # -- (e) the serve phase's gates --------------------------------------------------
        tp_serve_gates(out["serve"], serve_whole, ranks, rdv)
    out["launches"] = dict(serve_launched)
    for rk in ranks:
        for runs in rk["serve"].values():
            for run in runs:
                for k, v in run["launches"].items():
                    out["launches"][k] = out["launches"].get(k, 0) + v
    used = {op for rk in ranks for m in rk["models"].values() for op in m["traffic_per_step"]}
    used |= {op for rk in ranks for runs in rk["serve"].values() for run in runs
             for op in run["traffic"]}
    out["transport"] = {"backend": "gloo",
                        "through_host": sorted(used & set(HOST_STAGED.get("gloo", ()))),
                        "on_card": sorted(used - set(HOST_STAGED.get("gloo", ())))}
    log(f"tp: {TP['world']} ranks on one card, mesh {TP['mesh']}, transport "
        f"{json.dumps(out['transport'])}; ranks {out['ranks_seconds']:.1f} s; this process "
        f"held {json.dumps(out['parent_memory_bytes'])} bytes meanwhile")
    return out


def seeded_collision(art):
    """GUST-P14 on a copy of a card artifact: the second real slot of the
    first stream row holding two takes the first one's adder.  The
    verifier must fire that rule and no other."""
    import dataclasses

    import torch

    from repro_torch.analysis.verify import verify

    real = art.m_blk != 0
    r = int(torch.nonzero(real.sum(dim=1) >= 2)[0, 0])
    j1, j2 = (int(j) for j in torch.nonzero(real[r])[:2, 0])
    row = art.row_blk.clone()
    row[r, j2] = row[r, j1]
    findings = verify(dataclasses.replace(art, row_blk=row))
    rules = sorted({f.rule for f in findings})
    if rules != ["GUST-P14"]:
        raise AssertionError(f"a seeded collision fired {rules}, not GUST-P14")
    return {"rules": rules, "row": r, "lanes": [j1, j2], "count": findings[0].count}


def paper_model(coo, cache):
    """The paper's own metric on crankseg_2: ``baselines.model_gust``'s
    cycles and utilization (2·nnz over 2·l units × cycles) for both
    schedules, through the smoke's ScheduleCache (nothing is scheduled
    twice).  The paper's FPGA cycle model, not a measurement of the card."""
    from repro_torch.core.baselines import model_gust
    from repro_torch.core.scheduler import sched_counters

    before = dict(sched_counters)
    out = {}
    for lb in (True, False):
        r = model_gust(coo, L, load_balance=lb, cache=cache, device="cuda")
        out[r.design] = {"cycles": r.cycles, "utilization": r.utilization}
    if dict(sched_counters) != before:
        raise AssertionError("paper model: a schedule was computed again")
    return out


def flip_padding_value(store, key):
    """Re-put the record under ``key`` with one padding value flipped to
    1.0, in a window's padding rows after another padding row (the
    reference's GUST-P01 mutation): the file still parses.  Returns the
    rules the verifier fires on the flipped leaves."""
    import torch

    from repro_torch.analysis.verify import verify

    rec = store.get(key)
    spec = rec["spec"]
    meta = spec["meta"]
    if meta[0] == "ragged":
        raise AssertionError("flip_padding_value takes a padded artifact")
    c_pad, c_blk = meta[2], meta[5]
    leaves = {k: v.clone() for k, v in spec["leaves"].items()}
    m, seg = leaves["m_blk"], leaves["seg_blk"]
    zero = (m == 0).all(dim=1)
    r = torch.arange(m.shape[0])
    cand = zero & torch.roll(zero, 1) & (r % c_pad != 0) & (seg[r // c_blk, 0] == 0)
    if not bool(cand.any()):
        raise AssertionError("no padding row after a padding row to flip")
    m[int(torch.nonzero(cand)[-1, 0]), 0] = 1.0
    rules = sorted({f.rule for f in verify(leaves, meta)})
    if rules != ["GUST-P01"]:
        raise AssertionError(f"the flipped padding value fired {rules}, not GUST-P01")
    store.put(key, {"leaves": leaves, "meta": meta, "config": spec["config"]},
              tuning=rec["tuning"], summary=rec["summary"])
    return rules


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
    for layout, p in gplans.items():
        verified(report, f"G/{layout}", p)
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
            row.update(audited(report, spgemm_launch_plan(torch.device("cuda"))))
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
    if sys.argv[1:2] == ["tp-rank"]:  # one rank of the tp path
        sys.exit(tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())
