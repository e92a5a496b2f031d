"""ctypes bridge to the native C++ setup engine (native/setup_engine.cpp).

Builds the shared library on first use (g++ -O3 -fopenmp) into this
package's build directory (fem/_build/, keyed by a hash of the source) and
falls back to the vectorized numpy implementation when no toolchain is
available; `load_library()` returns None then.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _repo_root():
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def load_library():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(_repo_root(), "native", "setup_engine.cpp")
    try:
        with open(src, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        build_dir = os.path.join(os.path.dirname(__file__), "_build")
        so = os.path.join(build_dir, f"libmimi_setup_{tag}.so")
        if not os.path.exists(so):
            os.makedirs(build_dir, exist_ok=True)
            tmp = so + f".{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-fopenmp", src, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.CalledProcessError):
        return None

    i64 = ctypes.c_int64
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.tensor_tables.argtypes = [
        i64,
        pi, pi, pi, pi,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
        pd, pi, pd, pd, pd,
    ]
    lib.tensor_tables.restype = None
    lib.geometry_tables.argtypes = [
        i64, i64, i64, i64, pi, pd, pd, pd, pd, pd,
    ]
    lib.geometry_tables.restype = None
    _LIB = lib
    return lib


def geometry_tables_native(conn, dN_du, wq, x_ref):
    """J/detJ/J^-1/dN_dX in one native pass; returns (dN_dX, w_detJ) or
    None."""
    lib = load_library()
    if lib is None:
        return None
    n_el, n_q, n_dof, dim = dN_du.shape
    if n_dof > 64:  # fixed-size element coordinate buffer in the C++ side
        return None
    conn = np.ascontiguousarray(conn, np.int64)
    dN_du = np.ascontiguousarray(dN_du, np.float64)
    wq = np.ascontiguousarray(wq, np.float64)
    x_ref = np.ascontiguousarray(x_ref, np.float64)
    dN_dX = np.zeros_like(dN_du)
    w_detJ = np.zeros((n_el, n_q))
    lib.geometry_tables(
        n_el, n_q, n_dof, dim, conn, dN_du, wq, x_ref, dN_dX, w_detJ
    )
    return dN_dX, w_detJ


def tensor_tables_native(tabs, weights_flat, n_ctrl):
    """Same contract as fem.space._tensor_basis_numpy, computed natively.

    tabs: per-dim (starts, uq, wq, B, D) arrays.  Returns (conn, N, dN,
    WQ) or None if the library is unavailable.
    """
    lib = load_library()
    if lib is None:
        return None
    d = len(tabs)
    spans = np.array([t[0].shape[0] for t in tabs], np.int64)
    n_g = np.array([t[1].shape[1] for t in tabs], np.int64)
    pp1 = np.array([t[3].shape[2] for t in tabs], np.int64)
    ncs = np.array(n_ctrl, np.int64)
    n_el = int(spans.prod())
    n_q = int(n_g.prod())
    n_dof = int(pp1.prod())

    starts_arr = [np.ascontiguousarray(t[0], np.int64) for t in tabs]
    B_arr = [np.ascontiguousarray(t[3], np.float64) for t in tabs]
    D_arr = [np.ascontiguousarray(t[4], np.float64) for t in tabs]
    wq_arr = [np.ascontiguousarray(t[2], np.float64) for t in tabs]

    def ptrs(arrs):
        return (ctypes.c_void_p * len(arrs))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs]
        )

    conn = np.zeros((n_el, n_dof), np.int64)
    N = np.zeros((n_el, n_q, n_dof))
    dN = np.zeros((n_el, n_q, n_dof, d))
    WQ = np.zeros((n_el, n_q))
    w_flat = np.ascontiguousarray(weights_flat, np.float64)
    lib.tensor_tables(
        d, spans, n_g, pp1, ncs,
        ptrs(starts_arr), ptrs(B_arr), ptrs(D_arr), ptrs(wq_arr),
        w_flat, conn, N, dN, WQ,
    )
    return conn, N, dN, WQ
