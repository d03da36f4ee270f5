"""Build the port's CUDA kernels from ``csrc/`` at first use, and bind them.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``: a build takes seconds, where a source
that includes PyTorch's headers (``torch.utils.cpp_extension.load``)
takes minutes.  Libraries land in ``build/kernels/`` at the repository
root (listed in ``.gitignore``) under a name that carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and never loaded stale.  Beside each library
lies ``ptxas``' report of its build (``-Xptxas=-v``: registers, spills,
shared memory per function), so a cached library can be audited too
(``repro_torch.analysis.kernel_audit``).  Nothing is built or imported
when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["BUILD_DIR", "SOURCES", "build", "bind", "load", "build_log", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: Library name -> source in ``csrc/``.
SOURCES = {
    "gust_spmv": "gust_spmv.cu",
    "gust_spmv_local": "gust_spmv_local.cu",
    "gust_spmv_db": "gust_spmv_db.cu",
    "gust_spmv_local_db": "gust_spmv_local_db.cu",
    "gust_spgemm": "gust_spgemm.cu",
    "gather_fill": "gather_fill.cu",
}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


#: The launch plan entry point of every library built on
#: ``csrc/gust_spread.cuh``: m, cols, row, vdt, idt, T, l, c_blk, b, out[7].
_PLAN = [_P] * 3 + [_I] * 6 + [_P]


def _resident_spread(prefix: str) -> Dict[str, list]:
    """The entry points of a library built on ``csrc/gust_spread.cuh``
    with the resident gather."""
    return {
        # m, col, row, scale, x, y, partials, vdt, idt, W, T,
        # blocks_per_window, l, c_blk, b, stream
        f"{prefix}_padded": [_P] * 7 + [_I] * 8 + [_P],
        # m, col, row, scale, x, y, partials, block_starts, vdt, idt, W, T,
        # l, c_blk, b, stream
        f"{prefix}_ragged": [_P] * 8 + [_I] * 7 + [_P],
        f"{prefix}_plan": _PLAN,
    }


def _local_spread(prefix: str) -> Dict[str, list]:
    """The entry points of a library built on ``csrc/gust_spread.cuh``
    with the segment-local gather."""
    return {
        # m, col_loc, row, seg_blk, scale, x, y, partials, vdt, idt, W, T,
        # blocks_per_window, l, c_blk, s_blk, b, stream
        f"{prefix}_padded": [_P] * 8 + [_I] * 9 + [_P],
        # m, col_loc, row, seg_blk, scale, x, y, partials, block_starts, vdt,
        # idt, W, T, l, c_blk, s_blk, b, stream
        f"{prefix}_ragged": [_P] * 9 + [_I] * 8 + [_P],
        f"{prefix}_plan": _PLAN,
    }

#: C entry points of each library: name -> argtypes (all return an int,
#: the launch's cudaError_t).
SIGNATURES = {
    "gust_spmv": _resident_spread("gust_spmv"),
    "gust_spmv_local": _local_spread("gust_spmv_local"),
    "gust_spgemm": {
        # m, col, row, block_starts, b_vals, b_cols, b_ptr, work, y, stats,
        # vdt, idt, W, l, c_blk, rows, r_rows, k_max, n_out, slots, stream
        "gust_spgemm": [_P] * 10 + [_I] * 9 + [_L, _P],
        # W, l, c_blk, rows, r_rows, n_out, slots, bytes[1]
        "gust_spgemm_workspace": [_I, _I, _I, _L, _I, _I, _L, _P],
        # out[5]
        "gust_spgemm_plan": [_P],
    },
    "gather_fill": {
        # col, x, out, idt, slots, b, stream
        "gather_fill": [_P] * 3 + [_I, _L, _I, _P],
    },
    "gust_spmv_db": _resident_spread("gust_spmv_db"),
    "gust_spmv_local_db": _local_spread("gust_spmv_local_db"),
}

#: Library name -> {"seconds", "log"} of the builds this process ran
#: (the log holds ptxas' register and shared-memory report).
build_log: Dict[str, Dict] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _report_path(lib: Path) -> Path:
    """Where ``ptxas``' report of the library at ``lib`` lies."""
    return lib.with_name(f"{lib.name}.ptxas.txt")


def ptxas_report(name: str) -> str:
    """``ptxas``' report (``-v``) of the current build of library
    ``name``, built first if needed."""
    return _report_path(build([name])[name]).read_text()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH): "
            "the port's kernels are compiled from source at first use"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every library in ``names`` (default: all) that is not built
    yet: one ``nvcc`` per source, all started together.  Returns the
    library paths; raises with the compiler's output if a build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = _lib_path(name)
        if out.exists() and _report_path(out).exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        report = _report_path(out)
        report_tmp = report.with_name(f"{report.name}.{os.getpid()}.tmp")
        report_tmp.write_text(log)
        os.replace(report_tmp, report)  # the report first: a library never lacks one
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        build_log[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _lib_path(name) for name in names}


def bind(path: Path, name: str) -> ctypes.CDLL:
    """The shared library at ``path`` with the C entry points of library
    ``name`` (a build of its source, or of a variant of it) typed."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.gust_error_string.argtypes = [ctypes.c_int]
    lib.gust_error_string.restype = ctypes.c_char_p
    return lib


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built first if needed."""
    if name not in _LIBS:
        _LIBS[name] = bind(build([name])[name], name)
    return _LIBS[name]
