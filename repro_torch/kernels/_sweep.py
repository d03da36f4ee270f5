"""What the kernel sweeps (``local_db_sweep``, ``spgemm_sweep``) and
``chip_smoke.py`` share: times from CUDA events, device times split by
kernel name from ``torch.profiler``, parallel ``nvcc`` builds of edited
sources and of another checkout's, and calls through another build of a
library.  Every function but :func:`edited` needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from . import _build


def ms(fn, iters, warmup=2):
    """Mean milliseconds of ``fn`` per call over ``iters`` calls after
    ``warmup`` calls, from CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_split(fn, tags, calls=3):
    """Device milliseconds per call of ``fn``'s kernels, from
    ``torch.profiler`` over ``calls`` calls after one: for each of
    ``tags`` the kernels whose names hold it, under ``"other"`` the rest
    (memsets and copies included), and each of the rest apart under
    ``"other_kernels"`` (name cut to 80 characters)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {tag: 0.0 for tag in tags}
    split.update(other=0.0, other_kernels={})
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = evt.cuda_time_total
        t = total / calls / 1e3
        if not t:
            continue
        tag = next((tag for tag in tags if tag in evt.key), None)
        if tag is not None:
            split[tag] += t
        else:
            split["other"] += t
            split["other_kernels"][evt.key[:80]] = t
    return split


def edited(text, edits, what):
    """``text`` with each ``(old, new)`` of ``edits`` applied; raises if an
    ``old`` is not in it (``what`` names the text in the message)."""
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"an edit no longer applies to {what}")
        text = text.replace(old, new)
    return text


def nvcc_all(jobs):
    """Build every ``key -> (source, library path, extra nvcc flags)`` of
    ``jobs`` with the port's ``nvcc`` flags, all started together; returns
    ``key -> nvcc's output`` and raises on the first build that fails."""
    procs = {}
    for key, (cu, so, extra) in jobs.items():
        so.parent.mkdir(parents=True, exist_ok=True)
        procs[key] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for key, proc in procs.items():
        logs[key], _ = proc.communicate()
    for key, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{logs[key]}")
    return logs


def bind_other(so, signatures):
    """Load library ``so`` built from another checkout, its entry points
    typed by ``signatures`` (name -> argtypes, each returning an int)."""
    bound = ctypes.CDLL(str(so))
    for fn, argtypes in signatures.items():
        getattr(bound, fn).argtypes = argtypes
        getattr(bound, fn).restype = ctypes.c_int
    bound.gust_error_string.argtypes = [ctypes.c_int]
    bound.gust_error_string.restype = ctypes.c_char_p
    return bound


def swapped(lib, bound, fn):
    """Call ``fn`` with the port's library ``lib`` bound to ``bound``."""
    kept = _build.load(lib)
    _build._LIBS[lib] = bound
    try:
        return fn()
    finally:
        _build._LIBS[lib] = kept
