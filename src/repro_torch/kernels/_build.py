"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled by `nvcc`
into its own shared library and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -I csrc -o build/lib<name>-<hash>.so csrc/<name>.cu

`-I csrc` lets a source include the shared `csrc/*.cuh` headers.  The build
happens at the first CUDA call, never at import: the CPU tests import every
module on machines without `nvcc`.  The library name carries a hash of the
source, of every header and of the flags, so an edited kernel or header is
never served from a stale build.
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
SOURCES = ("segment_reduce", "tile_matmul", "flash_attention",
           "selective_scan", "flash_attention_bwd", "selective_scan_bwd",
           "adamw")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)     # a host array of device pointers
_LLP = ctypes.POINTER(ctypes.c_longlong)  # a host array of lengths
_IP = ctypes.POINTER(ctypes.c_int)        # a host array of ints
# C entry points and their ctypes signatures; every one returns the
# cudaError_t of cudaGetLastError() after its launches
SIGNATURES = {
    "segment_reduce": {
        "segment_reduce_launch": [ctypes.c_int, ctypes.c_int, _P, _P, _P,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_int, _P,
                                  ctypes.c_int, _P, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int],
        "segment_reduce_launch_rows": [ctypes.c_int, ctypes.c_int, _P, _P, _P,
                                       ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_longlong, ctypes.c_int, _P,
                                       ctypes.c_int, _P, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_int, _P,
                                       ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int],
        "segment_reduce_launch_lanes": [ctypes.c_int, ctypes.c_int, _PP,
                                        _PP, _PP, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_int, _P,
                                        ctypes.c_int, _P, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_int, _P,
                                        ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int],
        "segment_reduce_wide_launch": [ctypes.c_int, ctypes.c_int, _P, _P, _P,
                                       ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_longlong, ctypes.c_int, _P,
                                       ctypes.c_int, _P, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _P, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_int],
    },
    "tile_matmul": {
        "tile_matmul_launch": [ctypes.c_int, _P, *[ctypes.c_longlong] * 4,
                               _P, _P, _P, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    },
    "flash_attention": {
        "flash_attention_launch": [ctypes.c_int, _P, _P, _P, _P,
                                   *[ctypes.c_int] * 4, ctypes.c_float,
                                   ctypes.c_int, ctypes.c_int, _P],
        "flash_attention_lse_launch": [ctypes.c_int, *[_P] * 5,
                                       *[ctypes.c_int] * 4, ctypes.c_float,
                                       ctypes.c_int, ctypes.c_int, _P],
        "flash_attention_wg_launch": [*[_P] * 5, *[ctypes.c_int] * 4,
                                      ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int, _P],
    },
    "selective_scan": {
        "selective_scan_launch": [*[_P] * 6, *[ctypes.c_int] * 4, _P],
        "selective_scan_n1_launch": [*[_P] * 7, *[ctypes.c_int] * 4, _P],
        "selective_scan_fused_launch": [*[_P] * 5, ctypes.c_int, *[_P] * 3,
                                        *[ctypes.c_int] * 4, _P],
        "selective_scan_fused_ckpt_launch": [*[_P] * 5, ctypes.c_int,
                                             *[_P] * 4, *[ctypes.c_int] * 4,
                                             _P],
        "selective_scan_ckpt_steps": [],
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_launch": [ctypes.c_int, *[_P] * 10,
                                       *[ctypes.c_int] * 4, ctypes.c_float,
                                       ctypes.c_int, ctypes.c_int, _P],
    },
    "selective_scan_bwd": {
        "selective_scan_bwd_launch": [*[_P] * 5, ctypes.c_int, *[_P] * 10,
                                      *[ctypes.c_int] * 4, _P],
        "selective_scan_n1_bwd_launch": [*[_P] * 9, *[ctypes.c_int] * 4,
                                         _P],
    },
    "adamw": {
        "adamw_norm_launch": [_PP, _LLP, _IP, ctypes.c_int, _P, _P, _P,
                              ctypes.c_float, ctypes.c_float, _P],
        "adamw_update_launch": [_PP, _PP, _PP, _PP, _LLP, _IP, ctypes.c_int,
                                *[_P] * 4, *[ctypes.c_float] * 6, _P],
        "adamw_chunk_elems": [],
        "adamw_max_leaves": [],
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


def _lib_path(name: str, csrc=None) -> Path:
    csrc = CSRC if csrc is None else Path(csrc)
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def nvcc_command(name: str, out: Path, csrc=None, extra=()) -> list:
    """The nvcc command line that builds `<csrc>/<name>.cu` (the package's
    own `csrc` by default) into `out`."""
    csrc = CSRC if csrc is None else Path(csrc)
    return [nvcc(), *NVCC_FLAGS, "-I", str(csrc), *extra, "-o", str(out),
            str(csrc / f"{name}.cu")]


def _start(name: str, csrc=None):
    """Start nvcc for one source; returns (process, tmp, final) or None when
    the library is already built."""
    out = _lib_path(name, csrc)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(nvcc_command(name, tmp, csrc),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a concurrent build sees all or none


def build_all(names=SOURCES, csrc=None) -> dict:
    """Compile every named kernel library of `csrc` in parallel; returns the
    seconds from the start until each build finished (0.0 when already
    built)."""
    t0 = time.perf_counter()
    jobs = {n: _start(n, csrc) for n in names}
    secs = {}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
        secs[n] = 0.0 if job is None else time.perf_counter() - t0
    return secs


def load(name: str, csrc=None) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use.  The
    wrappers launch the one of the package's own `csrc`; another directory
    (an earlier version of the sources, to time against) is built and
    loaded beside it, and served by the wrappers only while `_LIBS` holds
    it under `name`."""
    own = csrc is None or Path(csrc) == CSRC
    lib = _LIBS.get(name) if own else None
    if lib is not None:
        return lib
    build_all((name,), csrc)
    lib = ctypes.CDLL(str(_lib_path(name, csrc)))
    for fn, argtypes in SIGNATURES[name].items():
        if not own and not hasattr(lib, fn):
            continue          # an earlier version may lack a newer entry
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    if own:
        _LIBS[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        msg = getattr(load(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")
