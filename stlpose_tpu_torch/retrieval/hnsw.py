"""ctypes binding for the native HNSW index (``native/hnsw.cpp``).

Port of ``stlpose_tpu/retrieval/hnsw.py``, with the same hnswlib-like
surface: ``Index(space, dim)``, ``init_index``, ``set_ef``,
``get_current_count``, ``add_items``, ``knn_query``, ``save_index``,
``load_index``. The source is the port's own copy of the JAX package's
``hnsw.cpp``; at first use it is compiled with ``g++`` and the JAX
package's Makefile flags (``CXXFLAGS``) into
``stlpose_tpu_torch/_build/libstlpose_hnsw-<hash>.so``, the hash being of
the source and the flags, and loaded with ctypes. The level generator is
seeded (``rng_(100)``) and the build single-threaded, so the same source
and flags on one machine give the JAX package's graph bit for bit.
``-march=native`` ties the library to the machine that built it:
``_build/`` is not carried from one machine to another.

Differences from the JAX package, on purpose:

- a failed build raises (``RuntimeError`` with the compiler's output)
  instead of turning the index into a silent exact numpy search;
- that search stays as the plain function :func:`exact_knn`, which the
  tests and ``chip_smoke.py`` hold the index against;
- ``load_index`` still reads an ``.npz`` index written by the JAX
  package's numpy backend (data and labels; queries on it are exact).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "hnsw.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native",
            "-shared"]
CXX = "g++"
_SPACES = {"l2": 0, "cosine": 1}
_LIB = None


def library_path() -> str:
    """Where the library of the current source and flags is built."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXXFLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libstlpose_hnsw-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile ``native/hnsw.cpp`` unless its library exists; raises with
    the compiler's output if the build fails. Returns the library path."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found on PATH; the native HNSW "
                           "index cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SRC} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build())
    lib.hnsw_create.restype = ctypes.c_void_p
    lib.hnsw_create.argtypes = [ctypes.c_int] * 5
    lib.hnsw_free.argtypes = [ctypes.c_void_p]
    lib.hnsw_set_ef.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hnsw_size.argtypes = [ctypes.c_void_p]
    lib.hnsw_size.restype = ctypes.c_int
    lib.hnsw_add_items.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.hnsw_knn_query.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float)]
    lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hnsw_save.restype = ctypes.c_int
    lib.hnsw_load.argtypes = [ctypes.c_char_p]
    lib.hnsw_load.restype = ctypes.c_void_p
    _LIB = lib
    return lib


def exact_knn(data, queries, k: int, space: str = "l2", labels=None):
    """Exact k nearest neighbours by brute force, in the index's distances
    (squared L2, or 1 - cosine similarity): (ids int64 (nq, k), distances
    float32 (nq, k)), the JAX package's numpy search."""
    data = np.asarray(data, np.float32)
    queries = np.asarray(queries, np.float32)
    if queries.ndim == 1:
        queries = queries[None, :]
    labels = (np.arange(len(data)) if labels is None
              else np.asarray(labels))
    if space == "l2":
        d = ((queries[:, None, :] - data[None]) ** 2).sum(-1)
    else:
        qn = queries / np.maximum(
            np.linalg.norm(queries, axis=1, keepdims=True), 1e-30)
        dn = data / np.maximum(
            np.linalg.norm(data, axis=1, keepdims=True), 1e-30)
        d = 1.0 - qn @ dn.T
    order = np.argsort(d, axis=1)[:, :k]
    dists = np.take_along_axis(d, order, axis=1).astype(np.float32)
    return labels[order].astype(np.int64), dists


class Index:
    """HNSW index over float32 vectors (hnswlib-compatible surface)."""

    def __init__(self, space: str = "l2", dim: int = 0):
        if space not in _SPACES:
            raise ValueError(f"space must be one of {list(_SPACES)}, "
                             f"got {space!r}")
        self.space = space
        self.dim = dim
        self._lib = _load_lib()
        self._handle = None
        self._ef = 10
        # an .npz index of the JAX package's numpy backend, once loaded
        self._np_data = None
        self._np_labels = None

    # ----------------------------------------------------------- lifecycle
    def init_index(self, max_elements: int, ef_construction: int = 200,
                   M: int = 16):
        self._handle = self._lib.hnsw_create(
            _SPACES[self.space], self.dim, max_elements, M, ef_construction)

    def set_ef(self, ef: int):
        self._ef = ef
        if self._handle is not None:
            self._lib.hnsw_set_ef(self._handle, ef)

    def get_current_count(self) -> int:
        if self._handle is not None:
            return self._lib.hnsw_size(self._handle)
        return 0 if self._np_data is None else len(self._np_data)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.hnsw_free(self._handle)
            self._handle = None

    # ------------------------------------------------------------- inserts
    def add_items(self, data, labels=None):
        if self._handle is None:
            raise RuntimeError("add_items: call init_index first")
        data = np.ascontiguousarray(np.asarray(data, np.float32))
        if data.ndim == 1:
            data = data[None, :]
        n = len(data)
        if labels is None:
            start = self.get_current_count()
            labels = np.arange(start, start + n)
        labels = np.ascontiguousarray(np.asarray(labels, np.int32))
        if data.ndim != 2 or data.shape[1] != self.dim or \
                labels.shape != (n,):
            raise ValueError(f"add_items: expected (n, {self.dim}) data and "
                             f"n labels, got {data.shape} and "
                             f"{labels.shape}")
        self._lib.hnsw_add_items(
            self._handle,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)

    # -------------------------------------------------------------- search
    def knn_query(self, queries, k: int = 1):
        queries = np.ascontiguousarray(np.asarray(queries, np.float32))
        if queries.ndim == 1:
            queries = queries[None, :]
        if self._handle is None:
            return exact_knn(self._np_data, queries, k, self.space,
                             self._np_labels)
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(f"knn_query: expected (nq, {self.dim}) "
                             f"queries, got {queries.shape}")
        nq = len(queries)
        ids = np.zeros((nq, k), np.int32)
        dists = np.zeros((nq, k), np.float32)
        self._lib.hnsw_knn_query(
            self._handle,
            queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nq, k,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return ids.astype(np.int64), dists

    # ----------------------------------------------------------------- io
    def save_index(self, path: str):
        if self._handle is None:
            raise RuntimeError("save_index: the index holds no graph")
        if self._lib.hnsw_save(self._handle, path.encode()) != 0:
            raise IOError(f"failed to save index to {path}")

    def load_index(self, path: str, max_elements: int = 0):
        if not path.endswith(".npz") and os.path.exists(path):
            self._handle = self._lib.hnsw_load(path.encode())
            if not self._handle:
                raise IOError(f"failed to load index from {path}")
            return
        # the JAX package's numpy backend saves ``path`` + ".npz"
        blob = np.load(path if path.endswith(".npz") else path + ".npz",
                       allow_pickle=False)
        self._np_data = blob["data"]
        self._np_labels = blob["labels"]
