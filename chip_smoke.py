#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``repro_torch/kernels/csrc``, then
drives the port's main path — ``repro_torch.plan(M, PlanConfig(...))``
``.spmv(v)`` / ``.spmm(X)`` — on the Table-3 matrix ``crankseg_2`` at its
published size (63,838 x 63,838, 14,148,858 nonzeros; the repository's
structure-matched surrogate, seed 0) with ``l=256, c_blk=8``, both
layouts (padded, ragged) and both value types (float32, int8):

  * the resident single-buffered plans (``gather="resident",
    pipeline="single"``, load-balanced schedule): kernels
    ``gust_spmv`` and ``gust_spmv_ragged``;
  * the default plans (``gather`` and ``pipeline`` left at ``"auto"``)
    over the load-balanced schedule, where the gather resolves resident
    (kernels ``gust_spmv_db``, ``gust_spmv_ragged_db``), and over the
    unbalanced one (``load_balance=False``), where it resolves
    segment-local (``gust_spmv_local_db``, ``gust_spmv_ragged_local_db``).

Checks, each fatal:
  * every kernel against its plain PyTorch version on the card, at the
    main path's shapes (B = 1 and 8): per element
    ``|kernel - plain| <= 1e-5 * (|M|·|x|)`` (sums are reordered: the
    plain version's ``index_add_`` uses atomics on the card); at B=1
    bitwise against the plain version run on the CPU (the kernel's own
    order); each double-buffered or segment-local kernel bitwise against
    the single-buffered resident kernel of its layout on the same
    artifact;
  * the default plans resolve the gather named above;
  * the main path went through all six kernels (launch counts, zeroed
    just before it, are > 0);
  * its results against scipy in float64, per row
    ``|y - M·x| <= 1e-4 * (|M|·|x|)`` (int8: against the dequantized
    matrix), finite and of the expected shape; padded == ragged bitwise
    for each schedule; the default plans == the resident single plans
    bitwise on the load-balanced schedule.

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
SOURCES = {
    "gust_spmv.cu": "repro_torch/kernels/csrc/gust_spmv.cu",
    "gust_spmv_db.cu": "repro_torch/kernels/csrc/gust_spmv_db.cu",
}
#: name -> (layout, gather, source, TPU kernel it replaces)
KERNELS = {
    "gust_spmv": ("padded", "resident", "gust_spmv.cu",
                  "src/repro/kernels/gust_spmv.py:238"),
    "gust_spmv_ragged": ("ragged", "resident", "gust_spmv.cu",
                         "src/repro/kernels/gust_spmv_ragged.py:113"),
    "gust_spmv_db": ("padded", "resident", "gust_spmv_db.cu",
                     "src/repro/kernels/gust_spmv.py:504"),
    "gust_spmv_local_db": ("padded", "local", "gust_spmv_db.cu",
                           "src/repro/kernels/gust_spmv.py:620"),
    "gust_spmv_ragged_db": ("ragged", "resident", "gust_spmv_db.cu",
                            "src/repro/kernels/gust_spmv_ragged.py:324"),
    "gust_spmv_ragged_local_db": ("ragged", "local", "gust_spmv_db.cu",
                                  "src/repro/kernels/gust_spmv_ragged.py:430"),
}
#: The single-buffered resident kernel of each layout: the bitwise
#: yardstick of the double-buffered and segment-local ones.
YARDSTICK = {"padded": "gust_spmv", "ragged": "gust_spmv_ragged"}
#: Which schedules each kernel's phase runs on (load_balance values): the
#: resident kernels on both, so that local and resident stand side by side
#: on the unbalanced artifact; the local ones where the default picks them.
PHASE_SCHEDULES = {"resident": (True, False), "local": (False,)}


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


def wrappers():
    """name -> (wrapper, plain version)."""
    import repro_torch.kernels.gust_spmv as k_pad
    import repro_torch.kernels.gust_spmv_ragged as k_rag
    import repro_torch.kernels.ref as plain

    return {
        "gust_spmv": (k_pad.gust_spmv, plain.gust_spmv_ref),
        "gust_spmv_ragged": (k_rag.gust_spmv_ragged, plain.gust_spmv_ragged_ref),
        "gust_spmv_db": (k_pad.gust_spmv_db, plain.gust_spmv_ref),
        "gust_spmv_local_db": (k_pad.gust_spmv_local_db, plain.gust_spmv_local_ref),
        "gust_spmv_ragged_db": (k_rag.gust_spmv_ragged_db, plain.gust_spmv_ragged_ref),
        "gust_spmv_ragged_local_db": (k_rag.gust_spmv_ragged_local_db,
                                      plain.gust_spmv_ragged_local_ref),
    }


def counters():
    """name -> (module, attribute) of each kernel's launch count."""
    import repro_torch.kernels.gust_spmv as k_pad
    import repro_torch.kernels.gust_spmv_ragged as k_rag

    return {
        "gust_spmv": (k_pad, "launches"),
        "gust_spmv_ragged": (k_rag, "launches"),
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
        spills = [ln.strip() for ln in lines
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        report["ptxas"][lib] = {"seconds": info["seconds"], "kernels": len(regs),
                                "max_registers": max(regs, default=None),
                                "spilling": spills}
        log(f"build {lib}: {info['seconds']:.1f} s, {len(regs)} kernels, "
            f"max {max(regs, default=0)} registers, {len(spills)} with spills")
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
                        xp[:n].contiguous(),
                        bytes_and_ops(name, art, xp, b, coo.nnz),
                    ))
                    row["x_tile_bytes"] = x_tile_bytes(name, art, b)
                    log(f"kernel {tag}: max |kernel - plain| = {row['max_abs_err']:.3e}; "
                        + ", ".join(k for k, val in row.items()
                                    if k.startswith("bitwise") and val))
    del cpu_plain

    # -- main path ---------------------------------------------------------------
    for mod, attr in launch_counts.values():
        setattr(mod, attr, 0)
    outs = {}
    t0 = time.perf_counter()
    for key, p in plans.items():
        outs[key] = (p.spmv(v), p.spmm(X))
    torch.cuda.synchronize()
    report["main_path_s"] = time.perf_counter() - t0
    launches = {name: getattr(mod, attr) for name, (mod, attr) in launch_counts.items()}
    log(f"main path: {report['main_path_s']:.3f} s, launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")

    csr = sp.csr_matrix((coo.vals.astype(np.float64), (coo.rows, coo.cols)), shape=(m, n))
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
    for mode, lb in (("single", True), ("default", True), ("default", False)):
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
    report["max_abs_err_vs_scipy"] = checks
    log(f"main path agrees with scipy (max abs err {max(checks.values()):.3e}); "
        "padded == ragged bitwise; default == single bitwise (load-balanced)")

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
        log(f"time {row['kernel']} load_balance={row['load_balance']} "
            f"{row['value_dtype']} B={row['B']}: kernel {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']:.4f} ms")
    report["variants"] = variants

    kernels = []
    for name, (layout, gather, source, replaces) in KERNELS.items():
        lb = PHASE_SCHEDULES[gather][0]
        head = next(r for r in variants if r["kernel"] == name and r["load_balance"] == lb
                    and r["value_dtype"] == "float32" and r["B"] == 1)
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[source],
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in variants if r["kernel"] == name),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "variant": f"float32 values, B=1, load_balance={lb}",
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
