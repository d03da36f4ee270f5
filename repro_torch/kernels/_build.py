"""Build the port's CUDA kernels from ``csrc/`` at first use, and bind them.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``: a build takes seconds, where a source
that includes PyTorch's headers (``torch.utils.cpp_extension.load``)
takes minutes.  Libraries land in ``build/kernels/`` at the repository
root (listed in ``.gitignore``) under a name that carries a hash of the
source and the flags, so an edited source is rebuilt and never loaded
stale.  Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["BUILD_DIR", "SOURCES", "build", "load", "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: Library name -> source in ``csrc/``.
SOURCES = {"gust_spmv": "gust_spmv.cu"}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int

#: C entry points of each library: name -> argtypes (all return an int,
#: the launch's cudaError_t).
SIGNATURES = {
    "gust_spmv": {
        # m, col, row, scale, x, y, vdt, idt, W, blocks_per_window, l,
        # c_blk, b, stream
        "gust_spmv_padded": [_P] * 6 + [_I] * 7 + [_P],
        # m, col, row, scale, x, y, block_starts, vdt, idt, W, l, c_blk, b,
        # stream
        "gust_spmv_ragged": [_P] * 7 + [_I] * 6 + [_P],
    },
}

#: Library name -> {"seconds", "log"} of the builds this process ran
#: (the log holds ptxas' register and shared-memory report).
build_log: Dict[str, Dict] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


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
        if out.exists():
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
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        build_log[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built first if needed."""
    if name not in _LIBS:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.gust_error_string.argtypes = [ctypes.c_int]
        lib.gust_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]
