"""Time the SpGEMM kernel (9) and the Buffer Filler (10) against another
commit's build and against variants of the SpGEMM kernel's source.

    python -m repro_torch.kernels.spgemm_sweep [--iters 5] [--parent DIR]

``--parent DIR`` is a checkout of another commit (for example the
parent's ``git archive`` unpacked under ``build/``, which the copy to the
card keeps): its ``gust_spgemm.cu`` and ``gather_fill.cu`` are built into
``build/kernels/sweep_spgemm/parent/`` and called with the entry points
of the design before this one (``PARENT_SIGNATURES``: kernel 9 there
takes B as condensed planes and a row-length scratch, and runs one CTA
per window).

Kernel 9 runs on G, the symmetric 0/1 pattern of ``synth_power_law(16384,
1e-3, seed=0)`` without self-loops (377,508 edges), times itself (``G·G``)
and, with standard normal values (seed 0) on the same pattern, times
itself again, on both layouts at ``l=256``.  For each (layout, values)
row: this tree's kernel with B by row offsets (as the SpGEMM path gives
it), split by ``torch.profiler`` into its pre-pass and its row-tile
kernel, with its longest unit, the median over its CTAs of each CTA's
longest unit, and the longest slot-loading and product phases of a unit,
in clock cycles; the same with B as the condensed planes (time only);
the kernel's workspace with its copy of A's real slots sized by A's
nonzeros (as the path sizes it) and by the stream's slots; each build of
:data:`VARIANTS` (time, row-tile time, longest unit, median
over CTAs of each CTA's longest unit), the tile widths of 512 and 2,048
output columns among them; the parent's build; cuSPARSE
(``torch.sparse.mm``); and this tree's kernel and the parent again at
the end of the row, for the spread between calls.  Every result must
equal every other bitwise, the parent's build and every variant but the
``diag_`` ones included, or the script stops.

Kernel 10 runs on the balanced padded stream of crankseg_2 (the
structure-matched surrogate at its published size, ``l=256, c_blk=8``)
at B = 1 and 8, beside the parent's build and ``index_select``; each
result must equal ``x[col]`` bitwise.

Times are CUDA events, the mean of ``--iters`` calls after 2 warm-ups.
Needs a CUDA card; prints one JSON object per row and writes all of them
to ``chiprun_out/spgemm_sweep.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import _build
from ._sweep import bind_other, edited, ms, nvcc_all, profile_split, swapped
from .gather_fill import gather_fill
from .gust_spgemm import _workspace_bytes, gust_spgemm

L, C_BLK = 256, 8
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: The entry points of the parent's libraries that the sweep calls.
PARENT_SIGNATURES = {
    "gust_spgemm": {
        # m, col, row, block_starts, b_vals, b_cols, lengths, y, vdt, idt, W,
        # l, c_blk, r_rows, k_max, n_out, stream
        "gust_spgemm": [_P] * 8 + [_I] * 8 + [_P],
    },
    "gather_fill": {
        # col, x, out, idt, slots, b, stream
        "gather_fill": [_P] * 3 + [_I, _L, _I, _P],
    },
}
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 0, torch.int16: 1}
#: Builds of this tree's ``gust_spgemm.cu`` with edits to its row-tile
#: kernel: name -> (edits, whether the result must stay bitwise).  The
#: ``diag_`` ones are wrong on purpose and timed only.
VARIANTS = {
    # a warp's tile of 512 or 2,048 output columns, not 1,024
    "tile_512": ((("constexpr int kTileCols = 1024;", "constexpr int kTileCols = 512;"),),
                 True),
    "tile_2048": ((("constexpr int kTileCols = 1024;", "constexpr int kTileCols = 2048;"),),
                  True),
    # a persistent grid of 1 or 2 CTAs per SM, not the occupancy's
    "grid_1_per_sm": ((("*grid = *ctas_per_sm * sms;", "*grid = sms;"),), True),
    "grid_2_per_sm": ((("*grid = *ctas_per_sm * sms;", "*grid = 2 * sms;"),), True),
    # no __syncwarp between two rounds of products
    "diag_no_syncwarp": ((("  __syncwarp();  // the next round reads what this one wrote",
                           ""),), False),
    # no tile written to y
    "diag_no_store": ((("__stcs(", "if (false) __stcs("),), False),
}


def _build_others(parent):
    """``{variant: lib}`` for every entry of :data:`VARIANTS` (the edited
    source under ``build/kernels/sweep_spgemm/<name>/``, bound as this
    tree's library) and, with ``parent``, ``{"parent": {library: lib}}``,
    the parent checkout's builds bound with ``PARENT_SIGNATURES``; the
    ``nvcc`` runs started together."""
    out_dir = _build.BUILD_DIR / "sweep_spgemm"
    cu_name = _build.SOURCES["gust_spgemm"]
    source = (_build.CSRC / cu_name).read_text()
    jobs = {}
    for name, (edits, _) in VARIANTS.items():
        cu = out_dir / name / cu_name
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(edited(source, edits, f"{cu_name} (variant {name})"))
        jobs[name, "gust_spgemm"] = (cu, cu.with_name("libgust_spgemm.so"),
                                     ["-I", str(_build.CSRC)])
    if parent is not None:
        csrc = Path(parent).resolve() / "repro_torch" / "kernels" / "csrc"
        for lib in PARENT_SIGNATURES:
            jobs["parent", lib] = (csrc / _build.SOURCES[lib],
                                   out_dir / "parent" / f"lib{lib}.so", [])
    nvcc_all(jobs)
    libs = {"parent": {}} if parent is not None else {}
    for (name, lib), (_, so, _) in jobs.items():
        if name == "parent":
            libs["parent"][lib] = bind_other(so, PARENT_SIGNATURES[lib])
        else:
            libs[name] = _build.bind(so, lib)
    return libs


def _call(lib, fn, *args):
    err = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                             for a in args], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's {fn} failed (cudaError {err})")


def kernel9_split(fn):
    """Device milliseconds per call of kernel 9's pre-pass (``prepass_ms``:
    its six small kernels and the memsets of one call, each apart under
    ``prepass_kernels``) and of its row-tile kernel (``row_tiles_ms``)."""
    split = profile_split(fn, ("row_tiles_kernel",))
    return {"prepass_ms": split["other"], "row_tiles_ms": split["row_tiles_kernel"],
            "prepass_kernels": split["other_kernels"]}


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _g_graphs():
    """G (0/1) and the same pattern with standard normal values (seed 0)."""
    from ..core.formats import COOMatrix
    from ..data.matrices import synth_power_law
    from ..graph.analytics import _pattern

    g = _pattern(synth_power_law(16384, 1e-3, seed=0), symmetrize=True, drop_diagonal=True)
    vals = np.random.default_rng(0).standard_normal(g.nnz).astype(np.float32)
    return {"0/1": g, "normal": COOMatrix(g.shape, g.rows, g.cols, vals)}


def spgemm_rows(others, iters):
    """Kernel 9's rows (see the module note); ``others`` from
    :func:`_build_others`."""
    parent = others.get("parent")
    from ..core.packing import ScheduleCache
    from ..core.plan import PlanConfig, plan
    from ..core.spgemm import _stream_view, condense_rows, row_offsets

    rows, cache = [], ScheduleCache()
    for values, g in _g_graphs().items():
        n = g.shape[1]
        offs = row_offsets(g, L, device="cuda")
        cond = condense_rows(g, L, device="cuda")
        csr = torch.sparse_csr_tensor(offs.ptr[:n + 1], offs.cols.long(), offs.vals, g.shape,
                                      check_invariants=False)
        library_ms = ms(lambda: torch.sparse.mm(csr, csr), 2)
        for layout in ("padded", "ragged"):
            art = plan(g, PlanConfig(l=L, layout=layout), cache=cache, device="cuda").artifact
            _, _, bs = _stream_view(art)
            stream = (bs, art.m_blk, art.col_blk, art.row_blk)
            kw = dict(num_windows=art.num_windows, l=L, n_out=n, c_blk=art.c_blk,
                      real_slots=g.nnz)

            def run(planes=False, **extra):
                b = (cond.vals, cond.cols) if planes else (offs.vals, offs.cols)
                return gust_spgemm(*stream, *b, b_ptr=None if planes else offs.ptr, **kw,
                                   **extra)

            row = {"kernel": "gust_spgemm", "layout": layout, "values": values,
                   "slots": art.streamed_slots, "library_ms": library_ms}
            for key, slots in (("workspace_bytes", g.nnz),
                               ("workspace_bytes_by_stream", art.m_blk.numel())):
                row[key] = _workspace_bytes(art.num_windows, L, art.c_blk, art.m_blk.shape[0],
                                            offs.r_rows, n, slots)
            stats = {}
            want = run(stats=stats)
            per_cta = sorted(stats.pop("cta_longest_unit_cycles"))
            row.update(stats, median_cta_longest_unit_cycles=per_cta[len(per_cta) // 2])
            row["ms"] = ms(run, iters)
            split = kernel9_split(run)
            row.update(prepass_ms=split["prepass_ms"], row_tiles_ms=split["row_tiles_ms"])
            if not _same_bits(run(planes=True), want):
                raise AssertionError(f"{layout} {values}: the planes carrier differs bitwise")
            row["planes_ms"] = ms(lambda: run(planes=True), iters)
            for name, (_, bitwise) in VARIANTS.items():
                stats = {}
                y = swapped("gust_spgemm", others[name], lambda: run(stats=stats))
                if bitwise and not _same_bits(y, want):
                    raise AssertionError(f"{layout} {values}: variant {name} differs bitwise")
                per_cta = sorted(stats["cta_longest_unit_cycles"])
                row[f"{name}_ms"] = swapped("gust_spgemm", others[name],
                                            lambda: ms(run, iters))
                row[f"{name}_row_tiles_ms"] = swapped(
                    "gust_spgemm", others[name], lambda: kernel9_split(run))["row_tiles_ms"]
                row[f"{name}_longest_unit_cycles"] = stats["longest_unit_cycles"]
                row[f"{name}_median_cta_longest_unit_cycles"] = per_cta[len(per_cta) // 2]
            if parent is not None:
                lengths = torch.empty(cond.r_rows, dtype=torch.int32, device="cuda")
                y_par = torch.empty_like(want)

                def run_parent():
                    _call(parent["gust_spgemm"], "gust_spgemm", *stream[1:], bs, cond.vals,
                          cond.cols, lengths, y_par, _CODES[art.m_blk.dtype],
                          _CODES[art.col_blk.dtype], art.num_windows, L, art.c_blk,
                          cond.r_rows, cond.k_max, n)

                run_parent()
                torch.cuda.synchronize()
                if not _same_bits(y_par, want):
                    raise AssertionError(f"{layout} {values}: differs bitwise from the "
                                         "parent's build")
                row["bitwise_vs_parent"] = True
                row["parent_ms"] = ms(run_parent, iters)
            row["again_ms"] = ms(run, iters)
            if parent is not None:
                row["parent_again_ms"] = ms(run_parent, iters)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def fill_rows(parent, iters):
    """Kernel 10's rows on crankseg_2's balanced padded stream."""
    from ..core.packing import pack_schedule
    from ..core.scheduler import schedule
    from ..data.matrices import REAL_WORLD_SUITE, make_real_world_surrogate
    from .ops import _prep_x

    coo = make_real_world_surrogate(REAL_WORLD_SUITE[0], scale=1.0, seed=0)
    col = pack_schedule(schedule(coo, L, load_balance=True), C_BLK, "float32", "int32",
                        device="cuda").col_blk
    n = coo.shape[1]
    rows = []
    for b in (1, 8):
        x = torch.from_numpy(np.random.default_rng(b).standard_normal((n, b))
                             .astype(np.float32)).cuda()
        xp = _prep_x(x, n, L)
        want = xp[col.long()]
        if not torch.equal(gather_fill(col, xp), want):
            raise AssertionError(f"gather_fill B={b} differs from x[col]")
        row = {"kernel": "gather_fill", "B": b, "slots": col.numel(),
               "ms": ms(lambda: gather_fill(col, xp), iters * 4),
               "library_ms": ms(lambda: xp.index_select(0, col.view(-1)), iters * 4)}
        if parent is not None:
            out = torch.empty_like(want)

            def run_parent():
                _call(parent["gather_fill"], "gather_fill", col, xp, out, 0, col.numel(), b)

            run_parent()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"the parent's gather_fill B={b} differs from x[col]")
            row["parent_ms"] = ms(run_parent, iters * 4)
            row["again_ms"] = ms(lambda: gather_fill(col, xp), iters * 4)
            row["parent_again_ms"] = ms(run_parent, iters * 4)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--parent", default=None,
                    help="a checkout of another commit whose kernels 9 and 10 are "
                         "timed beside this tree's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spgemm_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build(["gust_spgemm", "gather_fill"])
    others = _build_others(args.parent)
    report = {"nvidia_smi": smi, "build_s": time.perf_counter() - t0, "parent": args.parent,
              "iters": args.iters}
    report["rows"] = (spgemm_rows(others, args.iters)
                      + fill_rows(others.get("parent"), args.iters))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "spgemm_sweep.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
