#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``repro_torch/kernels/csrc``, then
drives the port's main path — ``repro_torch.plan(M, PlanConfig(...))``
``.spmv(v)`` / ``.spmm(X)`` — on the Table-3 matrix ``crankseg_2`` at its
published size (63,838 x 63,838, 14,148,858 nonzeros; the repository's
structure-matched surrogate, seed 0) with ``l=256, c_blk=8``, both
layouts (padded, ragged) and both value types (float32, int8), resident
gather and single-buffered kernels.

Checks, each fatal:
  * every kernel against its plain PyTorch version on the card, at the
    main path's shapes (B = 1 and 8): per element
    ``|kernel - plain| <= 1e-5 * (|M|·|x|)`` (sums are reordered: the
    plain version's ``index_add_`` uses atomics on the card);
  * the main path went through both kernels (launch counts, zeroed just
    before it, are > 0);
  * its results against scipy in float64, per row
    ``|y - M·x| <= 1e-4 * (|M|·|x|)`` (int8: against the dequantized
    matrix), finite and of the expected shape; padded == ragged bitwise.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(times from CUDA events, bounds from this run's bytes), and as its last
line ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero without a CUDA device.
"""

import functools
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
REPLACES = {
    "gust_spmv": "src/repro/kernels/gust_spmv.py:238",
    "gust_spmv_ragged": "src/repro/kernels/gust_spmv_ragged.py:113",
}
SOURCE = "repro_torch/kernels/csrc/gust_spmv.cu"


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds of ``fn`` per call on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stream_args(art):
    """Positional and keyword arguments of a kernel wrapper (minus x)."""
    args = (art.m_blk, art.col_blk, art.row_blk)
    if hasattr(art, "block_starts"):
        args += (art.block_window, art.block_starts)
    kw = dict(num_windows=art.num_windows, l=art.l, c_blk=art.c_blk,
              scale_blk=art.scale_blk)
    return args, kw


def bytes_and_ops(art, xp, b, nnz):
    """What one kernel call must move and compute: each input it reads
    once (the stream, the scales, ``block_starts``, x), the (W, l, B)
    output written once; a multiply and an add per nonzero and vector
    column, plus the int8 dequant multiply per nonzero."""
    read = [art.m_blk, art.col_blk, art.row_blk, art.scale_blk,
            getattr(art, "block_starts", None), xp]  # block_window: unread
    moved = sum(t.numel() * t.element_size() for t in read if t is not None)
    moved += art.num_windows * art.l * b * 4
    ops = nnz * b * 2 + (nnz if art.scale_blk is not None else 0)
    return moved, ops


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1

    import scipy.sparse as sp

    import repro_torch
    import repro_torch.kernels.gust_spmv as k_pad
    import repro_torch.kernels.gust_spmv_ragged as k_rag
    import repro_torch.kernels.ref as plain
    from repro_torch.core.packing import ScheduleCache
    from repro_torch.core.scheduler import sched_counters
    from repro_torch.data.matrices import REAL_WORLD_SUITE, make_real_world_surrogate
    from repro_torch.kernels import _build
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

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    report["build_s"] = time.perf_counter() - t0
    ptxas = [ln.strip() for info in _build.build_log.values()
             for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    report["ptxas"] = ptxas
    log(f"build: {report['build_s']:.1f} s, {len(ptxas)} ptxas lines")

    # -- matrix, schedule, packs ---------------------------------------------
    spec = REAL_WORLD_SUITE[0]
    t0 = time.perf_counter()
    coo = make_real_world_surrogate(spec, scale=1.0, seed=0)
    report["generate_s"] = time.perf_counter() - t0
    m, n = coo.shape
    if (m, n, coo.nnz) != (spec.dim, spec.dim, spec.nnz):
        raise AssertionError(f"{spec.name}: got {m}x{n}, {coo.nnz} nnz")
    cache = ScheduleCache()
    t0 = time.perf_counter()
    cache.schedule(coo, L)  # before any tensor touches the card
    report["schedule_s"] = time.perf_counter() - t0
    report["sched_counters"] = dict(sched_counters)
    log(f"{spec.name}: {m}x{n}, {coo.nnz} nnz; generate {report['generate_s']:.1f} s, "
        f"schedule {report['schedule_s']:.1f} s")

    plans, t0 = {}, time.perf_counter()
    for layout in ("padded", "ragged"):
        for vdt in ("float32", "int8"):
            cfg = repro_torch.PlanConfig(l=L, c_blk=C_BLK, layout=layout,
                                         gather="resident", pipeline="single",
                                         value_dtype=vdt)
            p = repro_torch.plan(coo, cfg, cache=cache, device="cuda")
            p.artifact  # pack now, outside the timed main path
            plans[layout, vdt] = p
    torch.cuda.synchronize()
    report["pack_s"] = time.perf_counter() - t0
    report["streams"] = {
        f"{k[0]}/{k[1]}": {"slots": p.artifact.streamed_slots,
                           "bytes": p.artifact.stream_bytes}
        for k, p in plans.items()
    }
    log(f"packs: {report['pack_s']:.1f} s; {json.dumps(report['streams'])}")

    rng = np.random.default_rng(0)
    v = rng.standard_normal(n).astype(np.float32)
    X = rng.standard_normal((n, BATCH)).astype(np.float32)
    wrappers = {"padded": ("gust_spmv", k_pad.gust_spmv, plain.gust_spmv_ref),
                "ragged": ("gust_spmv_ragged", k_rag.gust_spmv_ragged,
                           plain.gust_spmv_ragged_ref)}

    # -- kernel phase: each kernel against its plain version -------------------
    variants, timed = [], []
    for (layout, vdt), p in plans.items():
        name, kernel, ref = wrappers[layout]
        art = p.artifact
        args, kw = stream_args(art)
        # the plain ragged version steers blocks by block_window, the kernel
        # by block_starts
        pargs = args if layout == "padded" else args[:4]
        abs_args = (art.m_blk.abs(),) + pargs[1:]
        for b, x in ((1, v[:, None]), (BATCH, X)):
            xp = _prep_x(torch.from_numpy(x).cuda(), n, L)
            y_k = kernel(*args, xp, **kw)
            y_p = ref(*pargs, xp, **kw)
            mag = ref(*abs_args, xp.abs(), **kw)
            torch.cuda.synchronize()
            err = (y_k - y_p).abs()
            if not bool(torch.isfinite(y_k).all()) or bool(
                (err > TOL_KERNEL * mag).any()
            ):
                raise AssertionError(
                    f"{name} {vdt} B={b}: kernel disagrees with its plain version "
                    f"(max abs err {float(err.max()):.3e})"
                )
            row = {"kernel": name, "value_dtype": vdt, "B": b,
                   "max_abs_err": float(err.max())}
            if b == 1:  # on the CPU the plain version sums in the kernel's order
                cpu_kw = dict(kw, scale_blk=None if art.scale_blk is None
                              else art.scale_blk.cpu())
                row["bitwise_vs_cpu_plain"] = bool(torch.equal(
                    y_k.cpu(), ref(*[a.cpu() for a in pargs], xp.cpu(), **cpu_kw)))
            variants.append(row)
            timed.append((
                row,
                functools.partial(kernel, *args, xp, **kw),
                functools.partial(ref, *pargs, xp, **kw),
                xp[:n].contiguous(),
                bytes_and_ops(art, xp, b, coo.nnz),
            ))
            log(f"kernel {name} {vdt} B={b}: max |kernel - plain| = "
                f"{row['max_abs_err']:.3e}"
                + (f", bitwise vs CPU plain: {row['bitwise_vs_cpu_plain']}"
                   if b == 1 else ""))

    # -- main path ---------------------------------------------------------------
    k_pad.launches = 0
    k_rag.launches = 0
    outs = {}
    t0 = time.perf_counter()
    for key, p in plans.items():
        outs[key] = (p.spmv(v), p.spmm(X))
    torch.cuda.synchronize()
    report["main_path_s"] = time.perf_counter() - t0
    launches = {"gust_spmv": k_pad.launches, "gust_spmv_ragged": k_rag.launches}
    log(f"main path: {report['main_path_s']:.3f} s, launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")

    csr = sp.csr_matrix((coo.vals.astype(np.float64), (coo.rows, coo.cols)), shape=(m, n))
    dequant = {"float32": csr, "int8": dequantized_csr(plans["padded", "int8"].artifact)}
    checks = {}
    for (layout, vdt), (y, Y) in outs.items():
        mat = dequant[vdt]
        for tag, got, x in (("spmv", y, v), ("spmm", Y, X)):
            got = got.cpu().numpy().astype(np.float64)
            want_shape = (m,) if tag == "spmv" else (m, BATCH)
            if got.shape != want_shape or not np.isfinite(got).all():
                raise AssertionError(f"{layout}/{vdt} {tag}: shape {got.shape} or non-finite")
            x64 = x.astype(np.float64)
            want = mat @ x64
            bound = TOL_MAIN * (abs(mat) @ np.abs(x64))
            worst = float(np.max(np.abs(got - want) - bound))
            if worst > 0:
                raise AssertionError(f"{layout}/{vdt} {tag}: off scipy by {worst:.3e} "
                                     "beyond the per-row bound")
            checks[f"{layout}/{vdt}/{tag}"] = float(np.max(np.abs(got - want)))
    for vdt in ("float32", "int8"):
        for i, tag in enumerate(("spmv", "spmm")):
            if not torch.equal(outs["padded", vdt][i], outs["ragged", vdt][i]):
                raise AssertionError(f"{vdt} {tag}: padded and ragged differ")
    report["max_abs_err_vs_scipy"] = checks
    log(f"main path agrees with scipy (max abs err {max(checks.values()):.3e}); "
        "padded == ragged bitwise")

    # -- timing ------------------------------------------------------------------------
    crow = torch.from_numpy(csr.indptr).cuda()
    ccol = torch.from_numpy(csr.indices.astype(np.int64)).cuda()
    cval = torch.from_numpy(csr.data.astype(np.float32)).cuda()
    lib_csr = torch.sparse_csr_tensor(crow, ccol, cval, (m, n), check_invariants=False)
    for row, run_kernel, run_plain, xd, (moved, ops) in timed:
        row["ms"] = cuda_ms(run_kernel, iters=20)
        row["plain_ms"] = cuda_ms(run_plain, iters=5, warmup=1)
        row["library_ms"] = cuda_ms(lambda: lib_csr @ xd, iters=20)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        row["bytes"], row["ops"] = moved, ops
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        if power_w is not None and power_w < FULL_POWER_W:
            row["bound_ms_at_power_limit"] = row["bound_ms"] * FULL_POWER_W / power_w
        log(f"time {row['kernel']} {row['value_dtype']} B={row['B']}: kernel "
            f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms")
    report["variants"] = variants

    kernels = []
    for name in ("gust_spmv", "gust_spmv_ragged"):
        head = next(r for r in variants if r["kernel"] == name
                    and r["value_dtype"] == "float32" and r["B"] == 1)
        entry = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in variants if r["kernel"] == name),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "variant": "float32 values, B=1",
        }
        if "bound_ms_at_power_limit" in head:
            entry["bound_ms_at_power_limit"] = head["bound_ms_at_power_limit"]
        kernels.append(entry)
    report["kernels"] = kernels

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


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
