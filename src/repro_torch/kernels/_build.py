"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled by `nvcc`
into its own shared library and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The build happens at the first CUDA call, never at import: the CPU tests
import every module on machines without `nvcc`.  The library name carries a
hash of the source, so an edited kernel is never served from a stale build.
`build_all()` starts one `nvcc` per source, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("segment_reduce", "tile_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
# C entry points and their ctypes signatures; every one returns the
# cudaError_t of cudaGetLastError() after its launches
SIGNATURES = {
    "segment_reduce": {
        "segment_reduce_launch": [ctypes.c_int, ctypes.c_int, _P, _P, _P,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_int, _P],
    },
    "tile_matmul": {
        "tile_matmul_launch": [ctypes.c_int, _P, *[ctypes.c_longlong] * 4,
                               _P, _P, _P, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    },
}

_LIBS: dict = {}     # name → loaded library, once per process


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc, on the machine with the card")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, final) or None when
    the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a concurrent build sees all or none


def build_all(names=SOURCES) -> dict:
    """Compile every named kernel library in parallel; returns the seconds
    from the start until each build finished (0.0 when already built)."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    secs = {}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
        secs[n] = 0.0 if job is None else time.perf_counter() - t0
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        msg = getattr(load(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")
