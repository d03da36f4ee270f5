"""Time kernels 3/4 and 6/8 against variants of their shared source, and
split their time.

    python -m repro_torch.kernels.local_db_sweep [--iters 20]

Kernels 3/4 (``csrc/gust_spmv_local.cu``, one x-tile stage) and 6/8
(``csrc/gust_spmv_local_db.cu``, two) are instances of one template,
``csrc/gust_local_spread.cuh``.  The script builds variants of that
header, made by editing its text (each edit must apply, or the script
stops), each with the sources of the pipelines it names, into
``build/kernels/sweep_local_db/``.  Then on crankseg_2 at its published
size (``load_balance=False``, ``l=256, c_blk=8``, both layouts; f32 and
int8 at B=1 and B=8) it times with CUDA events (mean of ``--iters``
after 2 warm-ups) kernels 5/7, and for each pipeline the kept kernel and
each of its variants, the kept kernel twice (first and last) for the
spread between calls.

* Design variants, each held bitwise to kernel 1/2: ``cap_x2`` (kernels
  3/4's one stage with the bytes of 6/8's two: 4 tiles at B=8 instead of
  2, and 3 CTAs per SM instead of 4), ``serial_count`` (a
  block's staged tiles counted by a serial scan of its table row, not a
  warp ballot), ``regs_x2`` (a second set of slot registers, loaded
  before the products instead of after them), ``prefetch_l2_2`` (a
  ``prefetch.global.L2`` of the stream two blocks ahead), ``fold16`` (16
  loads in flight in the fold, not 8), ``scalar_out`` / ``scalar_x`` /
  ``scalar_tiles`` / ``scalar_rows`` (at B=8, a block tile's row written
  to the scratch, a slot's x row read from x, from the staged tile, or
  all three, 4 bytes at a time instead of 16).
* Diagnostics, wrong on purpose and timed only: ``diag_no_scratch``
  (block tiles not written), ``diag_no_tiles`` (nothing staged: every
  slot reads x directly), ``diag_no_products`` (stream loads only).

It also splits each kept kernel's time into its two kernels with
``torch.profiler`` (``local_partials``, the block kernel, and
``local_fold``).  Needs a CUDA card; prints one JSON object per row and
writes all of them to ``chiprun_out/local_db_sweep.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from . import _build
from . import gust_spmv as k_pad
from . import gust_spmv_ragged as k_rag
from .chunk_sweep import _ms

L, C_BLK = 256, 8
#: The template both pipelines' sources include; the variants edit it.
HEADER = "gust_local_spread.cuh"
#: pipeline -> library (kernels 3/4, kernels 6/8).
LIBS = {"single": "gust_spmv_local", "double": "gust_spmv_local_db"}

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
    ("        cl[i] = col_loc[base", "        ncl[i] = col_loc[base"),
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
    if (!last || t + 1 < tb) load_chunk(last ? t + 1 : t, last ? 0 : c0 + cc);
    __syncthreads();""", """    __syncthreads();"""),
]
_PREFETCH_L2_2 = [
    ("""#pragma unroll
      for (int k = 0; k < BT; ++k) acc[k] = 0.f;""", """      if (t + 2 < tb) {
        const size_t f = (size_t)(t + 2) * c_blk * l, n = (size_t)c_blk * l;
        const char* leaf[3] = {reinterpret_cast<const char*>(m + f),
                               reinterpret_cast<const char*>(col_loc + f),
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
    ("""          n_next = staged(slot ^ 1);
          fetch_tiles(slot ^ 1, n_next);""", "          n_next = 0;"),
    ("""    n_cur = staged(0);
    fetch_tiles(0, n_cur);""", "    n_cur = 0;"),
    ("""        n_cur = staged(slot);
        fetch_tiles(slot, n_cur);""", "        n_cur = 0;"),
]
_NO_PRODUCTS = [("""        const float val = load_value<QUANT>(v[i], s);
        if (val != 0.f) {""", """        const float val = load_value<QUANT>(v[i], s);
        if (val == 12345.f && static_cast<int>(cl[i]) == 7 &&
            static_cast<int>(rw[i]) == 3) {""")]

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
BOTH = tuple(LIBS)
#: name -> (text edits of HEADER, bitwise-checked, pipelines built)
VARIANTS = {
    "cap_x2": (_CAP_X2, True, ("single",)),
    "serial_count": (_SERIAL_COUNT, True, ("double",)),
    "regs_x2": (_REGS_X2, True, ("double",)),
    "prefetch_l2_2": (_PREFETCH_L2_2, True, BOTH),
    "fold16": (_FOLD16, True, ("double",)),
    "scalar_rows": (_SCALAR_ROWS, True, BOTH),
    "scalar_out": (_SCALAR_OUT, True, BOTH),
    "scalar_x": (_SCALAR_X, True, BOTH),
    "scalar_tiles": (_SCALAR_TILES, True, BOTH),
    "diag_no_scratch": (_NO_SCRATCH, False, BOTH),
    "diag_no_tiles": (_NO_TILES, False, BOTH),
    "diag_no_products": (_NO_PRODUCTS, False, BOTH),
}


def edited_header(edits) -> str:
    """HEADER's text with ``edits`` applied; raises if one finds no text."""
    text = (_build.CSRC / HEADER).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError("an edit no longer applies to " + HEADER)
        text = text.replace(old, new)
    return text


def _build_variants():
    """(name, pipeline) -> (ctypes library, ptxas lines with spills) of each
    variant: the pipeline's source beside the edited header (a quoted
    include finds it first), ``csrc/`` for the other headers."""
    out_dir = _build.BUILD_DIR / "sweep_local_db"
    procs = {}
    for name, (edits, _, pipelines) in VARIANTS.items():
        vdir = out_dir / name
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / HEADER).write_text(edited_header(edits))
        for pipeline in pipelines:
            lib = LIBS[pipeline]
            cu, so = vdir / _build.SOURCES[lib], vdir / f"lib{lib}.so"
            shutil.copyfile(_build.CSRC / _build.SOURCES[lib], cu)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                   str(cu)]
            procs[name, pipeline] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for (name, pipeline), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name} ({pipeline}):\n{log}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        libs[name, pipeline] = (_build.bind(so, LIBS[pipeline]), spills)
    return libs


def _profile_split(fn):
    """Device microseconds per call of the two kernels of one call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        for tag in ("local_partials", "local_fold"):
            if tag in evt.key:
                total = getattr(evt, "device_time_total", None)
                if total is None:
                    total = evt.cuda_time_total
                split[f"{tag}_us"] = total / max(evt.count, 1)
    return split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
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
    variants = _build_variants()
    build_s = time.perf_counter() - t0
    kept = {lib: _build.load(lib) for lib in LIBS.values()}
    coo = make_real_world_surrogate(REAL_WORLD_SUITE[0], scale=1.0, seed=0)
    n = coo.shape[1]
    cache = ScheduleCache()
    cache.schedule(coo, L, load_balance=False)  # before any tensor touches the card
    rng = np.random.default_rng(0)
    xs = {b: _prep_x(torch.from_numpy(rng.standard_normal((n, b)).astype(np.float32)).cuda(),
                     n, L) for b in (1, 8)}
    rows = []
    for layout in ("padded", "ragged"):
        for vdt, b in (("float32", 1), ("int8", 1), ("float32", 8), ("int8", 8)):
            cfg = repro_torch.PlanConfig(l=L, c_blk=C_BLK, layout=layout, value_dtype=vdt,
                                         load_balance=False)
            art = repro_torch.plan(coo, cfg, cache=cache, device="cuda").artifact
            kw = dict(num_windows=art.num_windows, l=art.l, c_blk=art.c_blk,
                      scale_blk=art.scale_blk)
            xp = xs[b]
            if layout == "ragged":
                blocks = (art.block_window, art.block_starts)
                yard = lambda: k_rag.gust_spmv_ragged(  # noqa: E731
                    art.m_blk, art.col_blk, art.row_blk, *blocks, xp, **kw)
                resident = lambda: k_rag.gust_spmv_ragged_db(  # noqa: E731
                    art.m_blk, art.col_blk, art.row_blk, *blocks, xp, **kw)
                local = {p: lambda fn=fn: fn(  # noqa: E731
                    art.m_blk, art.col_loc, art.row_blk, art.seg_blk, *blocks, xp, **kw)
                    for p, fn in (("single", k_rag.gust_spmv_ragged_local),
                                  ("double", k_rag.gust_spmv_ragged_local_db))}
            else:
                yard = lambda: k_pad.gust_spmv(  # noqa: E731
                    art.m_blk, art.col_blk, art.row_blk, xp, **kw)
                resident = lambda: k_pad.gust_spmv_db(  # noqa: E731
                    art.m_blk, art.col_blk, art.row_blk, xp, **kw)
                local = {p: lambda fn=fn: fn(  # noqa: E731
                    art.m_blk, art.col_loc, art.row_blk, art.seg_blk, xp, **kw)
                    for p, fn in (("single", k_pad.gust_spmv_local),
                                  ("double", k_pad.gust_spmv_local_db))}
            want = yard()
            row = {"layout": layout, "value_dtype": vdt, "B": b,
                   "resident_db_ms": _ms(resident, args.iters)}
            for pipeline, run in local.items():
                lib = LIBS[pipeline]
                if not torch.equal(run(), want):
                    raise AssertionError(f"{layout} {vdt} B={b}: the kept {pipeline} kernel "
                                         "differs bitwise from kernel 1/2")
                row[f"{pipeline}_ms"] = _ms(run, args.iters)
                row.update({f"{pipeline}_{k}": v for k, v in _profile_split(run).items()})
                for (name, vp), (vlib, _) in variants.items():
                    if vp != pipeline:
                        continue
                    _build._LIBS[lib] = vlib
                    if VARIANTS[name][1] and not torch.equal(run(), want):
                        raise AssertionError(f"variant {name} ({pipeline}): differs bitwise "
                                             "from kernel 1/2")
                    row[f"{pipeline}_{name}_ms"] = _ms(run, args.iters)
                _build._LIBS[lib] = kept[lib]
                row[f"{pipeline}_again_ms"] = _ms(run, args.iters)
            rows.append(row)
            print(json.dumps(row), flush=True)
    report = {"nvidia_smi": smi, "build_s": build_s, "rows": rows,
              "spilling": {f"{name}/{p}": spills
                           for (name, p), (_, spills) in variants.items()}}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "local_db_sweep.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
