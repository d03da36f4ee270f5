"""Sweep the stage height of the double-buffered padded resident kernel 5
at B > 1.

    python -m repro_torch.kernels.chunk_sweep [--caps 8,4,2,1] [--iters 20]

Builds ``csrc/gust_spmv_db.cu`` once per cap with ``-DGUST_DB_WIDE_CHUNK``
(the most cycles per pipeline unit of kernel 5 when B > 1; each unit is
one of its two shared-memory stages, so the cap sets the CTA's shared
memory; kernel 7 in the same source has no stage) into
``build/kernels/sweep/``, then times kernel 5 of each build on crankseg_2
at its published size (load-balanced schedule, ``l=256, c_blk=8``, f32
and int8, B=1 and B=8) beside kernel 1 of the regular build, with CUDA
events (mean of ``--iters`` after 2 warm-ups).  Every variant must equal
kernel 1 bitwise.  Needs a CUDA card; prints
one JSON object and writes it to ``chiprun_out/chunk_sweep.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import _build
from . import gust_spmv as k_pad

L, C_BLK, BATCH = 256, 8, 8


def _ms(fn, iters):
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _build_caps(caps):
    """cap -> ctypes library of gust_spmv_db.cu built with that cap."""
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / _build.SOURCES["gust_spmv_db"]
    procs = {}
    for cap in caps:
        out = out_dir / f"libgust_spmv_db_cap{cap}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DGUST_DB_WIDE_CHUNK={cap}",
               "-o", str(out), str(src)]
        procs[cap] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for cap, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for cap {cap}:\n{log}")
        libs[cap] = _build.bind(out, "gust_spmv_db")
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--caps", default="8,4,2,1")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chunk_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    caps = [int(c) for c in args.caps.split(",")]

    import repro_torch
    from repro_torch.core.packing import ScheduleCache
    from repro_torch.data.matrices import REAL_WORLD_SUITE, make_real_world_surrogate
    from repro_torch.kernels.ops import _prep_x

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build()
    libs = _build_caps(caps)
    build_s = time.perf_counter() - t0
    spec = REAL_WORLD_SUITE[0]
    coo = make_real_world_surrogate(spec, scale=1.0, seed=0)
    n = coo.shape[1]
    cache = ScheduleCache()
    cache.schedule(coo, L, load_balance=True)  # before any tensor touches the card
    rng = np.random.default_rng(0)
    xs = {b: _prep_x(torch.from_numpy(rng.standard_normal((n, b)).astype(np.float32)).cuda(),
                     n, L) for b in (1, BATCH)}
    regular = _build.load("gust_spmv_db")
    rows = []
    for vdt in ("float32", "int8"):
        cfg = repro_torch.PlanConfig(l=L, c_blk=C_BLK, layout="padded", value_dtype=vdt,
                                     gather="resident", pipeline="double")
        art = repro_torch.plan(coo, cfg, cache=cache, device="cuda").artifact
        kw = dict(num_windows=art.num_windows, l=art.l, c_blk=art.c_blk,
                  scale_blk=art.scale_blk)
        single = lambda xp: k_pad.gust_spmv(  # noqa: E731
            art.m_blk, art.col_blk, art.row_blk, xp, **kw)
        double = lambda xp: k_pad.gust_spmv_db(  # noqa: E731
            art.m_blk, art.col_blk, art.row_blk, xp, **kw)
        for b, xp in xs.items():
            row = {"layout": "padded", "value_dtype": vdt, "B": b,
                   "single_ms": _ms(lambda: single(xp), args.iters)}
            want = single(xp)
            for cap in caps:
                _build._LIBS["gust_spmv_db"] = libs[cap]
                if not torch.equal(double(xp), want):
                    raise AssertionError(f"cap {cap} {vdt} B={b}: differs "
                                         "bitwise from kernel 1")
                row[f"cap{cap}_ms"] = _ms(lambda: double(xp), args.iters)
            _build._LIBS["gust_spmv_db"] = regular
            rows.append(row)
            print(json.dumps(row), flush=True)
    report = {"nvidia_smi": smi, "build_s": build_s, "caps": caps, "rows": rows}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chunk_sweep.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
