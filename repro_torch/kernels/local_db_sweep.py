"""Time the kernels of the spread template against the designs they
replaced and against variants of its source, and split their time.

    python -m repro_torch.kernels.local_db_sweep [--iters 20] [--parent DIR]

Every SpMV kernel of the port is an instance of one template,
``csrc/gust_spread.cuh``: kernels 1/2 (``csrc/gust_spmv.cu``, resident,
register prefetch), 5/7 (``csrc/gust_spmv_db.cu``, resident, the
bulk-copy stream ring), 3/4 (``csrc/gust_spmv_local.cu``, segment-local,
one x-tile stage) and 6/8 (``csrc/gust_spmv_local_db.cu``, two).  The
script builds variants of that header, made by editing its text (each
edit must apply, or the script stops), each with the sources of the
libraries it names, into ``build/kernels/sweep_local_db/``.  With
``--parent DIR``, a checkout of another commit (for example the parent's
``git archive`` unpacked under ``build/``, which the copy to the card
keeps), it also builds that checkout's sources of the same four
libraries, so that its design of every SpMV kernel is timed beside this
one on the same card; its entry points are called with the arguments of
the design before this one (``PARENT_SIGNATURES``: kernels 2 and 5 there
run one CTA per window and take no scratch).

On crankseg_2 at its published size (``l=256, c_blk=8``, both layouts;
f32 and int8 at B=1 and B=8) it times with CUDA events (mean of
``--iters`` after 2 warm-ups):

* on both schedules, the resident kernels of the layout: 1 and 5
  (padded) or 2 and 7 (ragged), each beside the parent's build of the
  same kernel and the variants built for its library;
* on the unbalanced schedule (where the default plan resolves the
  segment-local gather), also kernels 3/4 and 6/8, their variants and
  the parent's builds.

Each kernel and each parent kernel is timed again at the end of its row,
for the spread between calls; each kernel is split into its two kernels
with ``torch.profiler`` (``spread_partials``, the block kernel, and
``spread_fold``), and its launch plan (CTAs per SM, grid, stream stages)
is recorded.  Every kernel, every parent kernel and every variant marked
bitwise must equal this tree's kernel 1 (padded) or 2 (ragged) bitwise on
the same artifact.

* Design variants: ``stream_registers`` (kernels 5/7 with the stream
  ring off at B > 1 too: the register prefetch of kernels 1/2, in the
  same library), ``ring_b1`` (kernels 5/7 with the ring at B=1 too),
  ``ring_bytes`` (kernels 1/2 holding the shared memory of the ring
  without using it, so their CTAs per SM and L1 are the ring's),
  ``half_chunk`` (kernels 5/7 with chunks of 4 cycles at B=1 and 2 at
  B=8, not 8 and 4: at l=256 a ring CTA then takes 28 KB, not 56, and
  more CTAs fit on an SM, for twice the barriers per block),
  ``cap_x2`` (kernels 3/4's one stage with the bytes of 6/8's two: 4
  tiles at B=8 instead of 2, and 3 CTAs per SM instead of 4),
  ``serial_count`` (a block's staged tiles counted by a serial scan of
  its table row, not a warp ballot), ``regs_x2`` (a second set of slot
  registers, loaded before the products instead of after them),
  ``prefetch_l2_2`` (a ``prefetch.global.L2`` of the stream two blocks
  ahead), ``fold16`` (16 loads in flight in the fold, not 8),
  ``ctas_cap5`` (at most 5 CTAs per SM, where the occupancy calculator
  allows kernel 1 six at f32 B=1),
  ``scalar_out`` / ``scalar_x`` / ``scalar_tiles`` / ``scalar_rows`` (at
  B=8, a block tile's row written to the scratch, a local slot's x row
  read from x, from the staged tile, or all rows, 4 bytes at a time
  instead of 16).
* Diagnostics, wrong on purpose and timed only: ``diag_no_scratch``
  (block tiles not written), ``diag_no_tiles`` (nothing staged: every
  local slot reads x directly), ``diag_no_products`` (stream loads only).

Needs a CUDA card; prints one JSON object per row and writes all of them
to ``chiprun_out/local_db_sweep.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import _build
from . import gust_spmv as k_pad
from . import gust_spmv_ragged as k_rag
from ._sweep import bind_other, edited, ms, nvcc_all, profile_split, swapped
from .gust_spmv import run_kernel, spread_launch_plan

L, C_BLK = 256, 8
#: The template every spread kernel's source includes; the variants edit it.
HEADER = "gust_spread.cuh"
#: pipeline -> library of the segment-local kernels (3/4, 6/8).
LIBS = {"single": "gust_spmv_local", "double": "gust_spmv_local_db"}
#: The entry points of the parent's libraries that the sweep calls: those
#: of kernels 2 and 5 with the argtypes of their one-CTA-per-window design
#: (no scratch, no block count), the others as this tree's.
PARENT_SIGNATURES = {
    "gust_spmv": {
        "gust_spmv_padded": _build.SIGNATURES["gust_spmv"]["gust_spmv_padded"],
        # m, col, row, scale, x, y, block_starts, vdt, idt, W, l, c_blk, b, stream
        "gust_spmv_ragged": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    },
    "gust_spmv_db": {
        # m, col, row, scale, x, y, vdt, idt, W, blocks_per_window, l, c_blk, b, stream
        "gust_spmv_db_padded": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        "gust_spmv_db_ragged": _build.SIGNATURES["gust_spmv_db"]["gust_spmv_db_ragged"],
    },
    **{lib: {f"{lib}_{layout}": _build.SIGNATURES[lib][f"{lib}_{layout}"]
             for layout in ("padded", "ragged")} for lib in LIBS.values()},
}
#: (layout, family) of the parent's kernels that take no scratch.
PARENT_NO_SCRATCH = {("ragged", "single"), ("padded", "double")}

_STREAM_REGISTERS = [("    if (ring_fits<V, I>(l, m, cols, row)) {", "    if (false) {")]
_RING_B1 = [("constexpr bool kRingAt = RING > 0 && BT > 1;", "constexpr bool kRingAt = RING > 0;")]
_RING_BYTES = [(
    "    return smem_layout(l, BT, cc, p.cap, STAGES, RING, sizeof(V), sizeof(I)).total;",
    "    return smem_layout(l, BT, cc, p.cap, STAGES, 2, sizeof(V), sizeof(I)).total;")]
_HALF_CHUNK = [("  return BT == 1 ? 8 : 4;", "  return BT == 1 ? 4 : 2;")]

_CAP_X2 = [("kStageBytes / (l * BT * 4)", "2 * kStageBytes / (l * BT * 4)")]
_SERIAL_COUNT = [(
    """    if (l % 32 == 0) {
      const int lane = j & 31;
      const bool up = lane >= 1 && lane < row_n && r[lane] > r[lane - 1];
      return __ffs(~__ballot_sync(0xffffffffu, up) & ~1u) - 1;
    }
""", "")]
_REGS_X2 = [
    ("""  V v[KC];
  I cl[KC], rw[KC];
  float s = 1.f;""", """  V v[KC], nv[KC];
  I cl[KC], rw[KC], ncl[KC], nrw[KC];
  float s = 1.f, ns = 1.f;"""),
    ("if (QUANT) s = scale[t];", "if (QUANT) ns = scale[t];"),
    ("        v[i] = m[base", "        nv[i] = m[base"),
    ("        cl[i] = cols[base", "        ncl[i] = cols[base"),
    ("        rw[i] = row[base", "        nrw[i] = row[base"),
    ("""    const int lim = n_cur * l;
""", """    const int lim = n_cur * l;
    s = ns;
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      v[i] = nv[i];
      cl[i] = ncl[i];
      rw[i] = nrw[i];
    }
    const bool last = ci + 1 == nchunk;
    if (!last || t + 1 < tb) load_chunk(last ? t + 1 : t, last ? 0 : c0 + cc);
"""),
    ("""    const bool last = ci + 1 == nchunk;
    if constexpr (RING == 0) {
      // the next chunk's slots fly through the barrier and the sums
      if (!last || t + 1 < tb) load_chunk(last ? t + 1 : t, last ? 0 : c0 + cc);
    }
    __syncthreads();""", """    __syncthreads();"""),
]
_PREFETCH_L2_2 = [
    ("""#pragma unroll
      for (int k = 0; k < BT; ++k) acc[k] = 0.f;""", """      if (t + 2 < tb) {
        const size_t f = (size_t)(t + 2) * c_blk * l, n = (size_t)c_blk * l;
        const char* leaf[3] = {reinterpret_cast<const char*>(m + f),
                               reinterpret_cast<const char*>(cols + f),
                               reinterpret_cast<const char*>(row + f)};
        const size_t bytes[3] = {n * sizeof(V), n * sizeof(I), n * sizeof(I)};
        for (int q = 0; q < 3; ++q) {
          for (size_t o = (size_t)j * 128; o < bytes[q]; o += (size_t)nt * 128) {
            asm volatile("prefetch.global.L2 [%0];" ::"l"(leaf[q] + o));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < BT; ++k) acc[k] = 0.f;"""),
]
_FOLD16 = [(
    """    for (; t + 8 <= t1; t += 8) {  // eight loads in flight, added in order
      float q[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = __ldg(p + (size_t)(t + i) * per_w);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = __fadd_rn(acc, q[i]);""",
    """    for (; t + 16 <= t1; t += 16) {
      float q[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) q[i] = __ldg(p + (size_t)(t + i) * per_w);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc = __fadd_rn(acc, q[i]);""")]
_NO_SCRATCH = [("      store_row<BT>(part + ((size_t)t * l + j) * b + b0, bt, acc);",
                """      if (acc[0] != acc[0])
        store_row<BT>(part + ((size_t)t * l + j) * b + b0, bt, acc);""")]
_NO_TILES = [
    ("""            n_next = staged(slot ^ 1);
            fetch_tiles(slot ^ 1, n_next);""", "            n_next = 0;"),
    ("""    n_cur = staged(0);
    fetch_tiles(0, n_cur);""", "    n_cur = 0;"),
    ("""          n_cur = staged(slot);
          fetch_tiles(slot, n_cur);""", "          n_cur = 0;"),
]
_NO_PRODUCTS = [("""        const float val = load_value<QUANT>(slot_v(i), s);
        if (val != 0.f) {""", """        const float val = load_value<QUANT>(slot_v(i), s);
        if (val == 12345.f && slot_c(i) == 7 && slot_r(i) == 3) {""")]

_CTAS_CAP5 = [("""  if (p.ctas_per_sm < 1) return cudaErrorInvalidConfiguration;
""", """  if (p.ctas_per_sm < 1) return cudaErrorInvalidConfiguration;
  p.ctas_per_sm = std::min(p.ctas_per_sm, 5);
""")]
_SCALAR_ROWS = [("if constexpr (BT % 4 == 0)", "if constexpr (BT < 0)")]
_SCALAR_OUT = [(
    "      store_row<BT>(part + ((size_t)t * l + j) * b + b0, bt, acc);",
    """      float* out = part + ((size_t)t * l + j) * b + b0;
#pragma unroll
      for (int k = 0; k < BT; ++k) {
        if (k < bt) out[k] = acc[k];
      }""")]
_SCALAR_X = [(
    "            mul_row<BT, true>(dst, l, val, x + ((size_t)seg * l + c % l) * b + b0, bt);",
    """            const float* xr = x + ((size_t)seg * l + c % l) * b + b0;
#pragma unroll
            for (int k = 0; k < BT; ++k) {
              if (k < bt) dst[k * l] = __fmul_rn(val, __ldg(xr + k));
            }""")]
_SCALAR_TILES = [(
    "            mul_row<BT, false>(dst, l, val, tiles + c * bt, bt);",
    """#pragma unroll
            for (int k = 0; k < BT; ++k) {
              if (k < bt) dst[k * l] = __fmul_rn(val, tiles[c * bt + k]);
            }""")]
LOCAL = tuple(LIBS.values())
#: name -> (text edits of HEADER, bitwise-checked, libraries built); a
#: variant built for gust_spmv runs as kernel 1.
VARIANTS = {
    "stream_registers": (_STREAM_REGISTERS, True, ("gust_spmv_db",)),
    "ring_b1": (_RING_B1, True, ("gust_spmv_db",)),
    "ring_bytes": (_RING_BYTES, True, ("gust_spmv",)),
    "half_chunk": (_HALF_CHUNK, True, ("gust_spmv_db",)),
    "cap_x2": (_CAP_X2, True, ("gust_spmv_local",)),
    "serial_count": (_SERIAL_COUNT, True, ("gust_spmv_local_db",)),
    "regs_x2": (_REGS_X2, True, ("gust_spmv_local_db",)),
    "prefetch_l2_2": (_PREFETCH_L2_2, True, LOCAL),
    "fold16": (_FOLD16, True, ("gust_spmv", "gust_spmv_local_db")),
    "ctas_cap5": (_CTAS_CAP5, True, ("gust_spmv",)),
    "scalar_rows": (_SCALAR_ROWS, True, ("gust_spmv",) + LOCAL),
    "scalar_out": (_SCALAR_OUT, True, LOCAL),
    "scalar_x": (_SCALAR_X, True, LOCAL),
    "scalar_tiles": (_SCALAR_TILES, True, LOCAL),
    "diag_no_scratch": (_NO_SCRATCH, False, ("gust_spmv", "gust_spmv_db") + LOCAL),
    "diag_no_tiles": (_NO_TILES, False, LOCAL),
    "diag_no_products": (_NO_PRODUCTS, False, ("gust_spmv", "gust_spmv_db") + LOCAL),
}


def edited_header(edits) -> str:
    """HEADER's text with ``edits`` applied; raises if one finds no text."""
    return edited((_build.CSRC / HEADER).read_text(), edits, HEADER)


def _spills(log):
    return [ln.strip() for ln in log.splitlines()
            if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]


def _build_variants(parent):
    """(name, library) -> (ctypes library, ptxas lines with spills) of each
    variant (the library's source beside the edited header: a quoted
    include finds it first; ``csrc/`` for the other headers), and with
    ``parent`` (a checkout's root) ``("parent", library)`` for that
    checkout's builds of the four SpMV libraries."""
    out_dir = _build.BUILD_DIR / "sweep_local_db"
    jobs = {}
    for name, (edits, _, libs) in VARIANTS.items():
        vdir = out_dir / name
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / HEADER).write_text(edited_header(edits))
        for lib in libs:
            cu = vdir / _build.SOURCES[lib]
            shutil.copyfile(_build.CSRC / _build.SOURCES[lib], cu)
            jobs[name, lib] = (cu, vdir / f"lib{lib}.so", ["-I", str(_build.CSRC)])
    if parent is not None:
        csrc = Path(parent).resolve() / "repro_torch" / "kernels" / "csrc"
        for lib in PARENT_SIGNATURES:
            jobs["parent", lib] = (csrc / _build.SOURCES[lib],
                                   out_dir / "parent" / f"lib{lib}.so", [])
    logs = nvcc_all(jobs)
    libs = {}
    for (name, lib), (_, so, _) in jobs.items():
        bound = (bind_other(so, PARENT_SIGNATURES[lib]) if name == "parent"
                 else _build.bind(so, lib))
        libs[name, lib] = (bound, _spills(logs[name, lib]))
    return libs


def _profile_split(fn):
    """Device microseconds per call of the two kernels of one call."""
    tags = ("spread_partials", "spread_fold")
    split = profile_split(fn, tags, calls=10)
    return {f"{tag}_us": split[tag] * 1e3 for tag in tags if split[tag]}


def _kernels(art, xp, kw):
    """family -> (library, wrapper call, call of the parent's build) of the
    kernels timed on ``art``: ``single`` / ``double`` (kernels 1 / 5 on a
    padded artifact, 2 / 7 on a ragged one) and ``local_single`` /
    ``local_double`` (3/4, 6/8).  The parent's kernels 2 and 5 are called
    through their own entry points, without a scratch; its others take
    this tree's arguments."""
    stream = (art.m_blk, art.col_blk, art.row_blk)
    local = (art.m_blk, art.col_loc, art.row_blk, art.seg_blk)
    if hasattr(art, "block_starts"):
        blocks = (art.block_window, art.block_starts)
        calls = {
            "single": ("gust_spmv", lambda: k_rag.gust_spmv_ragged(*stream, *blocks, xp, **kw)),
            "double": ("gust_spmv_db", lambda: k_rag.gust_spmv_ragged_db(
                *stream, *blocks, xp, **kw)),
            "local_single": (LIBS["single"], lambda: k_rag.gust_spmv_ragged_local(
                *local, *blocks, xp, **kw)),
            "local_double": (LIBS["double"], lambda: k_rag.gust_spmv_ragged_local_db(
                *local, *blocks, xp, **kw)),
        }
        old = lambda: run_kernel("gust_spmv", "gust_spmv_ragged", *stream, xp,
                                 blocks=art.block_starts, **kw)
        layout = "ragged"
    else:
        bpw = art.m_blk.shape[0] // (art.num_windows * art.c_blk)
        calls = {
            "single": ("gust_spmv", lambda: k_pad.gust_spmv(*stream, xp, **kw)),
            "double": ("gust_spmv_db", lambda: k_pad.gust_spmv_db(*stream, xp, **kw)),
            "local_single": (LIBS["single"], lambda: k_pad.gust_spmv_local(*local, xp, **kw)),
            "local_double": (LIBS["double"], lambda: k_pad.gust_spmv_local_db(
                *local, xp, **kw)),
        }
        old = lambda: run_kernel("gust_spmv_db", "gust_spmv_db_padded", *stream, xp,
                                 blocks=bpw, **kw)
        layout = "padded"
    return {fam: (lib, run, old if (layout, fam) in PARENT_NO_SCRATCH else run)
            for fam, (lib, run) in calls.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parent", default=None,
                    help="root of another checkout whose SpMV kernels to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("local_db_sweep: needs a CUDA device", file=sys.stderr)
        return 1

    import repro_torch
    from repro_torch.core.packing import ScheduleCache
    from repro_torch.data.matrices import REAL_WORLD_SUITE, make_real_world_surrogate
    from repro_torch.kernels.ops import _prep_x

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build([*LIBS.values(), "gust_spmv", "gust_spmv_db"])
    variants = _build_variants(args.parent)
    build_s = time.perf_counter() - t0
    coo = make_real_world_surrogate(REAL_WORLD_SUITE[0], scale=1.0, seed=0)
    n = coo.shape[1]
    cache = ScheduleCache()
    for lb in (True, False):  # before any tensor touches the card
        cache.schedule(coo, L, load_balance=lb)
    rng = np.random.default_rng(0)
    xs = {b: _prep_x(torch.from_numpy(rng.standard_normal((n, b)).astype(np.float32)).cuda(),
                     n, L) for b in (1, 8)}
    rows = []
    for lb in (True, False):
        for layout in ("padded", "ragged"):
            for vdt, b in (("float32", 1), ("int8", 1), ("float32", 8), ("int8", 8)):
                cfg = repro_torch.PlanConfig(l=L, c_blk=C_BLK, layout=layout,
                                             value_dtype=vdt, load_balance=lb)
                art = repro_torch.plan(coo, cfg, cache=cache, device="cuda").artifact
                kw = dict(num_windows=art.num_windows, l=art.l, c_blk=art.c_blk,
                          scale_blk=art.scale_blk)
                row = {"load_balance": lb, "layout": layout, "value_dtype": vdt, "B": b}
                rows.append(_time_row(row, _kernels(art, xs[b], kw), art, xs[b],
                                      variants, args.iters))
                print(json.dumps(row), flush=True)
    report = {"nvidia_smi": smi, "build_s": build_s, "parent": args.parent, "rows": rows,
              "spilling": {f"{name}/{lib}": spills
                           for (name, lib), (_, spills) in variants.items()}}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "local_db_sweep.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


def _time_row(row, kernels, art, xp, variants, iters):
    """Fill ``row`` with the times of one artifact's kernels (see the
    module's note); raises if one differs bitwise from kernel 1 / 2."""
    tag = f"load_balance={row['load_balance']} {row['layout']} {row['value_dtype']} B={row['B']}"
    want = kernels["single"][1]()
    yard = 1 if row["layout"] == "padded" else 2
    families = ["single", "double"] + ([] if row["load_balance"] else
                                       ["local_single", "local_double"])
    plans = {lib: key for key, lib in k_pad._SPREAD_LIBS.items()}
    for fam in families:
        lib, run, run_parent = kernels[fam]
        if not torch.equal(run(), want):
            raise AssertionError(f"{tag}: the {fam} kernel differs bitwise from kernel {yard}")
        row[f"{fam}_ms"] = ms(run, iters)
        row.update({f"{fam}_{k}": v for k, v in _profile_split(run).items()})
        gather, pipeline = plans[lib]
        plan = spread_launch_plan(art.m_blk, art.col_loc if gather == "local" else art.col_blk,
                                  art.row_blk, xp, l=art.l, c_blk=art.c_blk, gather=gather,
                                  pipeline=pipeline)
        for key in ("ctas_per_sm", "grid_x", "stream_stages"):
            row[f"{fam}_{key}"] = plan[key]
        parent = variants.get(("parent", lib))
        if parent is not None:
            if not torch.equal(swapped(lib, parent[0], run_parent), want):
                raise AssertionError(f"{tag}: the parent's {fam} kernel differs bitwise "
                                     f"from kernel {yard}")
            row[f"parent_{fam}_ms"] = swapped(lib, parent[0], lambda: ms(run_parent, iters))
        for (name, vlib), (bound, _) in variants.items():
            if vlib != lib or name == "parent":
                continue
            if VARIANTS[name][1] and not torch.equal(swapped(lib, bound, run), want):
                raise AssertionError(f"{tag}: variant {name} ({lib}) differs bitwise from "
                                     f"kernel {yard}")
            row[f"{fam}_{name}_ms"] = swapped(lib, bound, lambda: ms(run, iters))
        row[f"{fam}_again_ms"] = ms(run, iters)
        if parent is not None:
            row[f"parent_{fam}_again_ms"] = swapped(lib, parent[0],
                                                     lambda: ms(run_parent, iters))
    return row


if __name__ == "__main__":
    sys.exit(main())
