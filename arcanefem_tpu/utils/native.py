"""ctypes binding to the native (C++) runtime library.

The reference's host-side runtime (sparsity builders, DoF numbering) is
C++ compiled by CMake (femutils/CMakeLists.txt); ours is a small shared
library built by native/Makefile and loaded here.  Auto-builds on first
import if the toolchain is available; consumers fall back to the pure-NumPy
implementations when the library is absent.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libafem_native.so")

_lib = None
_tried = False


def library():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-s", "-C", _NATIVE_DIR],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.afem_topo_build.restype = ctypes.c_void_p
    lib.afem_topo_build.argtypes = [
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.afem_topo_width.restype = ctypes.c_int32
    lib.afem_topo_width.argtypes = [ctypes.c_void_p]
    lib.afem_topo_nnz.restype = ctypes.c_int64
    lib.afem_topo_nnz.argtypes = [ctypes.c_void_p]
    lib.afem_topo_fill.restype = None
    lib.afem_topo_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
    lib.afem_topo_free.restype = None
    lib.afem_topo_free.argtypes = [ctypes.c_void_p]
    # AMG-setup kernels (amg_setup.cpp) — rebuild a stale library
    if not hasattr(lib, "afem_amg_strength_filter"):
        try:
            subprocess.run(["make", "-s", "-B", "-C", _NATIVE_DIR],
                           check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(_LIB_PATH)
        except Exception:
            _lib = lib
            return _lib
    if hasattr(lib, "afem_amg_strength_filter"):
        lib.afem_amg_strength_filter.restype = ctypes.c_int64
        lib.afem_amg_strength_filter.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.afem_amg_smooth_p.restype = ctypes.c_int64
        lib.afem_amg_smooth_p.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_double, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return _lib


def amg_strength_filter_native(indptr: np.ndarray, cols: np.ndarray,
                               data: np.ndarray, theta: float):
    """Fused strength graph + filtered operator (amg_setup.cpp).

    Returns (s_indptr i64, s_cols i32, af_data f64, ddf f64) or None when
    the library is unavailable (caller runs the scipy path).  af_data has
    A's pattern with weak off-diagonals as exact zeros and their values
    lumped onto the diagonal entry."""
    lib = library()
    if lib is None or not hasattr(lib, "afem_amg_strength_filter"):
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    n = len(indptr) - 1
    nnz = len(cols)
    s_indptr = np.empty(n + 1, np.int64)
    s_cols = np.empty(nnz, np.int32)
    af_data = np.empty(nnz, np.float64)
    ddf = np.empty(n, np.float64)
    snnz = lib.afem_amg_strength_filter(
        n, indptr.ctypes.data_as(ctypes.c_void_p),
        cols.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p), theta,
        s_indptr.ctypes.data_as(ctypes.c_void_p),
        s_cols.ctypes.data_as(ctypes.c_void_p),
        af_data.ctypes.data_as(ctypes.c_void_p),
        ddf.ctypes.data_as(ctypes.c_void_p),
    )
    if snnz < 0:
        return None  # a row without a diagonal entry — scipy path handles
    return s_indptr, s_cols[:snnz].copy(), af_data, ddf


def amg_smooth_p_native(indptr: np.ndarray, cols: np.ndarray,
                        af_data: np.ndarray, ddf: np.ndarray, c: float,
                        agg: np.ndarray, na: int, kmax: int, rel: float,
                        rescale: bool):
    """Fused P = (I - c Dinv_f A_f) T + truncate_rows (amg_setup.cpp).

    Scalar tentative only (T[i, agg[i]] = 1).  Returns
    (p_indptr i64, p_cols i32, p_data f64) or None."""
    lib = library()
    if lib is None or not hasattr(lib, "afem_amg_smooth_p"):
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    af_data = np.ascontiguousarray(af_data, np.float64)
    ddf = np.ascontiguousarray(ddf, np.float64)
    agg = np.ascontiguousarray(agg, np.int64)
    n = len(indptr) - 1
    cap = n * int(kmax)
    p_indptr = np.empty(n + 1, np.int64)
    p_cols = np.empty(cap, np.int32)
    p_data = np.empty(cap, np.float64)
    pnnz = lib.afem_amg_smooth_p(
        n, indptr.ctypes.data_as(ctypes.c_void_p),
        cols.ctypes.data_as(ctypes.c_void_p),
        af_data.ctypes.data_as(ctypes.c_void_p),
        ddf.ctypes.data_as(ctypes.c_void_p), c,
        agg.ctypes.data_as(ctypes.c_void_p), na, kmax, rel,
        1 if rescale else 0,
        p_indptr.ctypes.data_as(ctypes.c_void_p),
        p_cols.ctypes.data_as(ctypes.c_void_p),
        p_data.ctypes.data_as(ctypes.c_void_p),
    )
    return p_indptr, p_cols[:pnnz].copy(), p_data[:pnnz].copy()


def build_topology_native(n_nodes: int, buckets: dict, pad_width_to: int):
    """Native counterpart of sparse.topology.build_topology.

    Returns the same tuple of arrays or None if the library is unavailable.
    """
    lib = library()
    if lib is None:
        return None
    names = list(buckets)
    conns = [np.ascontiguousarray(buckets[k], np.int32) for k in names]
    ptrs = (ctypes.c_void_p * len(conns))(
        *[c.ctypes.data_as(ctypes.c_void_p) for c in conns]
    )
    ncs = (ctypes.c_int64 * len(conns))(*[c.shape[0] for c in conns])
    npcs = (ctypes.c_int32 * len(conns))(*[c.shape[1] for c in conns])
    h = lib.afem_topo_build(n_nodes, len(conns), ptrs, ncs, npcs, pad_width_to)
    if not h:
        return None
    try:
        width = lib.afem_topo_width(h)
        nnz = lib.afem_topo_nnz(h)
        row_ptr = np.empty(n_nodes + 1, np.int64)
        csr_cols = np.empty(nnz, np.int32)
        csr_to_ell = np.empty(nnz, np.int32)
        diag_slot = np.empty(n_nodes, np.int32)
        ell_cols = np.empty((n_nodes, width), np.int32)
        ell_valid = np.empty((n_nodes, width), np.uint8)
        smaps = [
            np.empty((c.shape[0], c.shape[1], c.shape[1]), np.int32)
            for c in conns
        ]
        sm_ptrs = (ctypes.c_void_p * len(conns))(
            *[m.ctypes.data_as(ctypes.c_void_p) for m in smaps]
        )
        lib.afem_topo_fill(
            h,
            row_ptr.ctypes.data_as(ctypes.c_void_p),
            csr_cols.ctypes.data_as(ctypes.c_void_p),
            csr_to_ell.ctypes.data_as(ctypes.c_void_p),
            diag_slot.ctypes.data_as(ctypes.c_void_p),
            ell_cols.ctypes.data_as(ctypes.c_void_p),
            ell_valid.ctypes.data_as(ctypes.c_void_p),
            ctypes.cast(sm_ptrs, ctypes.c_void_p),
        )
    finally:
        lib.afem_topo_free(h)
    return (
        width, row_ptr, csr_cols, csr_to_ell, diag_slot,
        ell_cols, ell_valid.astype(bool),
        {name: m for name, m in zip(names, smaps)},
    )
