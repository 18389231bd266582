"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` holds one kernel behind a plain C entry point. At
first use it is compiled with nvcc for Hopper (``sm_90a``) into
``stlpose_tpu_torch/_build/lib<name>-<hash>.so`` (the hash is of the
source and flags, so an edited source rebuilds) and loaded with ctypes.
No PyTorch headers are included, so a build takes seconds.

``--fmad=false`` keeps nvcc from contracting a multiply and an add into
one FMA: the kernels then round exactly where their plain PyTorch versions
(which run one rounded op at a time) do, and the two can be held to each
other tightly. The kernels are memory-bound, so the FMAs are not missed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# every kernel source under csrc/, by name (csrc/<name>.cu)
SOURCES = ("decode", "warp", "roi_align", "quantize", "warp_two_pass", "nms",
           "roi_align_backward", "int8_conv")

_loaded: dict[str, ctypes.CDLL] = {}
_launchers: dict = {}
P, I32, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the port's CUDA kernels cannot be built")
    return path


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together. Returns {name: ptxas log} for the
    sources compiled by this call. Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = _target(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s shared library, built and loaded on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_target(name)[1])
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes, restype):
    """The host-side C function ``symbol`` of kernel ``name`` (a size
    query, no launch), bound once per process."""
    key = (name, symbol)
    if key not in _launchers:
        fn = getattr(library(name), symbol)
        fn.restype = restype
        fn.argtypes = list(argtypes)
        _launchers[key] = fn
    return _launchers[key]


def launcher(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of kernel ``name`` (built and loaded on first
    use) as a callable that raises on a non-zero ``cudaError_t``. Pointer
    and stream arguments must be declared ``c_void_p``, or ctypes would
    pass them as 32-bit ints. Bound once per process."""
    key = (name, symbol)
    if key in _launchers:
        return _launchers[key]
    lib = library(name)
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)

    def launch(*args):
        err = fn(*args)
        if err != 0:
            msg = lib.cuda_error_string(err).decode()
            raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")

    _launchers[key] = launch
    return launch
