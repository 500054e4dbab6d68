"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``; the wrappers pass
``data_ptr()`` pointers and PyTorch's current stream.  The sources
include no PyTorch header, so a build takes seconds; all sources compile
at once, one ``nvcc`` process each.

Libraries land in ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of their source and the shared headers
(``csrc/*.cuh``), so an edited source rebuilds and an unchanged one loads
as it is.  Nothing is compiled when
this module is imported: the first kernel call (or :func:`build_all`)
builds.
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("leaf_insert", "probe")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# C signatures of the exported functions: the launchers return a
# cudaError_t, the size queries a size_t
_SIGNATURES = {
    "leaf_insert": {
        "higgs_leaf_insert": [_P] * 13 + [_I] * 5 + [_P, _P],
    },
    "probe": {
        "higgs_edge_probe_levels": [_P, _I] + [_P] * 7 + [_I] * 4 + [_P],
        "higgs_vertex_probe": [_P] * 7 + [_U, _U, _I, _I, _P, _P]
        + [_I] * 5 + [_P],
        "higgs_vertex_probe_workspace": ([_I] * 4, ctypes.c_size_t),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}      # ptxas report of each build


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (the plain versions run on CPU tensors)")
    return nvcc


def _lib_path(name: str) -> Path:
    # the shared headers count: an edited header rebuilds every source
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every missing library, all ``nvcc`` processes at once;
    returns the wall seconds spent.  Raises with the compiler's output
    if any build fails."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, sig in _SIGNATURES[name].items():
            argtypes, restype = sig if isinstance(sig, tuple) \
                else (sig, ctypes.c_int)
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a failed launch (the C launcher returns cudaGetLastError:
    a refused launch never runs and a later synchronize would not say)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
