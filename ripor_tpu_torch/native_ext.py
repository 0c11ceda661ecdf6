"""ctypes bindings for the C++ host components (native/ripor_native.cc).

A copy of ripor_tpu/native_ext.py: the port imports no ripor_tpu module.
Both load the same library, native/libripor_native.so, by path.

Auto-builds the shared library on first use (make -C native); every entry
point returns None without it, and its callers then take their numpy
path (host code: the trie build and the trec metrics, not the device).
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libripor_native.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


class _TrieOut(ctypes.Structure):
    _fields_ = [
        ("children", ctypes.POINTER(ctypes.c_int32)),
        ("num_internal", ctypes.c_int64),
        ("unique_codes", ctypes.POINTER(ctypes.c_int32)),
        ("num_groups", ctypes.c_int64),
        ("group_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("group_docids", ctypes.POINTER(ctypes.c_int32)),
    ]


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.trie_build.restype = ctypes.c_int
    lib.trie_build.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(_TrieOut)]
    lib.eval_metrics.restype = ctypes.c_int
    lib.eval_metrics.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double)]
    lib.ripor_free.restype = None
    lib.ripor_free.argtypes = [ctypes.c_void_p]
    lib.hnsw_build.restype = ctypes.c_void_p
    lib.hnsw_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64]
    lib.hnsw_search.restype = ctypes.c_int
    lib.hnsw_search.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
    lib.hnsw_save.restype = ctypes.c_int
    lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hnsw_load.restype = ctypes.c_void_p
    lib.hnsw_load.argtypes = [ctypes.c_char_p]
    lib.hnsw_size.restype = ctypes.c_int64
    lib.hnsw_size.argtypes = [ctypes.c_void_p]
    lib.hnsw_dim.restype = ctypes.c_int32
    lib.hnsw_dim.argtypes = [ctypes.c_void_p]
    lib.hnsw_free.restype = None
    lib.hnsw_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return load_native() is not None


def _copy_and_free(lib, ptr, shape, dtype):
    n = int(np.prod(shape))
    ctype = {np.int32: ctypes.c_int32, np.int64: ctypes.c_int64}[dtype]
    arr = np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype)), (n,)).copy().reshape(shape)
    lib.ripor_free(ptr)
    return arr.astype(dtype)


def trie_build_native(codes: np.ndarray, K: int):
    """C++ trie builder -> same tuple contents as trie/build.py::build_trie.
    Returns None when the native library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.int32)
    N, M = codes.shape
    out = _TrieOut()
    rc = lib.trie_build(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(N), ctypes.c_int32(M), ctypes.c_int32(K),
        ctypes.byref(out))
    if rc != 0:
        return None
    children = _copy_and_free(lib, out.children,
                              (int(out.num_internal), K), np.int32)
    unique_codes = _copy_and_free(lib, out.unique_codes,
                                  (int(out.num_groups), M), np.int32)
    group_offsets = _copy_and_free(lib, out.group_offsets,
                                   (int(out.num_groups) + 1,), np.int64)
    group_docids = _copy_and_free(lib, out.group_docids, (N,), np.int32)
    return children, unique_codes, group_offsets, group_docids


_METRIC_IDS = {"mrr": 0, "recall": 1, "ndcg_cut": 2}


def eval_metrics_native(run: Dict[str, Dict[str, float]],
                        qrel: Dict[str, Dict[str, int]],
                        metric: str, k: int) -> Optional[float]:
    """C++ trec metrics over run/qrel dicts. None if native unavailable.

    docid strings are encoded as int64 rank keys preserving string order
    (trec tie-breaking is by docid string)."""
    lib = load_native()
    if lib is None:
        return None
    qids = [q for q in run if q in qrel]
    if not qids:
        return 0.0
    all_docids = sorted({d for q in qids for d in run[q]}
                        | {d for q in qids for d in qrel[q]})
    key_of = {d: i for i, d in enumerate(all_docids)}

    run_keys, run_scores, run_off = [], [], [0]
    qrel_keys, qrel_rels, qrel_off = [], [], [0]
    for q in qids:
        for d, s in run[q].items():
            run_keys.append(key_of[d])
            run_scores.append(s)
        run_off.append(len(run_keys))
        for d, r in qrel[q].items():
            qrel_keys.append(key_of[d])
            qrel_rels.append(r)
        qrel_off.append(len(qrel_keys))

    rk = np.asarray(run_keys, np.int64)
    rsc = np.asarray(run_scores, np.float32)
    ro = np.asarray(run_off, np.int64)
    qk = np.asarray(qrel_keys, np.int64)
    qr = np.asarray(qrel_rels, np.int32)
    qo = np.asarray(qrel_off, np.int64)
    out = np.zeros(len(qids), np.float64)
    rc = lib.eval_metrics(
        rk.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rsc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ro.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qk.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        qo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(qids)), ctypes.c_int32(k),
        ctypes.c_int32(_METRIC_IDS[metric]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        return None
    valid = out[out >= 0.0]  # recall marks no-rel queries with -1
    return float(valid.mean()) if len(valid) else 0.0


class HnswHandle:
    """RAII wrapper over the C++ HNSW graph (native/hnsw.cc)."""

    def __init__(self, ptr: int):
        self._lib = load_native()
        self._ptr = ctypes.c_void_p(ptr)

    def __del__(self):
        if getattr(self, "_ptr", None) and self._lib is not None:
            self._lib.hnsw_free(self._ptr)
            self._ptr = None

    @property
    def size(self) -> int:
        return int(self._lib.hnsw_size(self._ptr))

    @property
    def dim(self) -> int:
        return int(self._lib.hnsw_dim(self._ptr))


def hnsw_build_native(vecs: np.ndarray, num_links: int = 32,
                      ef_construct: int = 128, n_threads: int = 0,
                      seed: int = 0) -> Optional[HnswHandle]:
    """Build an inner-product HNSW graph. None if native unavailable."""
    lib = load_native()
    if lib is None:
        return None
    vecs = np.ascontiguousarray(vecs, np.float32)
    N, d = vecs.shape
    ptr = lib.hnsw_build(
        vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(N), ctypes.c_int32(d), ctypes.c_int32(num_links),
        ctypes.c_int32(ef_construct), ctypes.c_int32(n_threads),
        ctypes.c_uint64(seed))
    return HnswHandle(ptr) if ptr else None


def hnsw_search_native(handle: HnswHandle, queries: np.ndarray, k: int,
                       ef_search: int = 0, n_threads: int = 0
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Search the graph: returns (ids [nq,k] int64, scores [nq,k] f32)."""
    lib = load_native()
    if lib is None or handle is None:
        return None
    queries = np.ascontiguousarray(queries, np.float32)
    nq = queries.shape[0]
    ids = np.empty((nq, k), np.int64)
    scores = np.empty((nq, k), np.float32)
    rc = lib.hnsw_search(
        handle._ptr, queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(nq), ctypes.c_int32(k),
        ctypes.c_int32(ef_search or max(64, k)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int32(n_threads))
    if rc != 0:
        return None
    return ids, scores


def hnsw_save_native(handle: HnswHandle, path: str) -> bool:
    lib = load_native()
    if lib is None or handle is None:
        return False
    return lib.hnsw_save(handle._ptr, path.encode()) == 0


def hnsw_load_native(path: str) -> Optional[HnswHandle]:
    lib = load_native()
    if lib is None:
        return None
    ptr = lib.hnsw_load(path.encode())
    return HnswHandle(ptr) if ptr else None
