"""Build and load the CUDA kernels (ops/csrc/*.cu, with the headers
ops/csrc/*.cuh they share).

nvcc compiles the sources into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), keyed by a hash
of the sources and flags, into ops/_build/: one nvcc per source, all
started together, then one link.  The library is loaded with ctypes;
every pointer and the stream are passed as c_void_p.  Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [
    os.path.join(_HERE, "csrc", name)
    for name in ("sweeps_sf.cu", "sweeps_sf_hyper.cu", "sweeps_sf_finite.cu", "sweeps_sf_p3.cu",
                 "sweeps_sf_hyper_p3.cu", "sweeps_sf_finite_p3.cu", "sweeps_dense.cu",
                 "sweeps_dense_j2.cu", "sweeps_dense_finite.cu", "sweeps_dense_bf16.cu",
                 "sweeps_dense_j2_bf16.cu", "sweeps_dense_finite_bf16.cu",
                 "fused_neohookean.cu")
]
HEADERS = [
    os.path.join(_HERE, "csrc", name)
    for name in ("materials.cuh", "j2.cuh", "dense_common.cuh", "sf_common.cuh", "dual.cuh",
                 "finite.cuh", "launch.cuh")
]
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
# sources built with -fmad=false: each product and sum rounded on its own,
# as the plain version's separate torch operations round them.  With fused
# multiply-adds the dense finite-strain kernels' float32 tangent planes
# differ from their plain twin's by up to 1.7e-4 of their group's max at the
# contact press's law, each side about as far from float64; without, by
# 3e-7, at 0-22% more time (scripts/witness_finite_planes.py, PERF.md); its
# bfloat16 twin rounds the same float32 planes
NO_FMAD = ("sweeps_dense_finite.cu", "sweeps_dense_finite_bf16.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
# the entry points compiled at each sf shape
_SF_NAMES = ("_sf", "_sf_hyper", "_sf_finite", "_sf_sym", "_sf_full")
# the dense entry points with a bfloat16 twin (suffix _bf16: the block, and
# the matvec's dN and N, as __nv_bfloat16*, 2-byte data behind a c_void_p)
_BF16_NAMES = ("assemble_dense", "matvec_dense", "assemble_dense_j2", "matvec_dense_cauchy",
               "assemble_dense_finite", "matvec_dense_full")

_LIB = None
# seconds and compiler output of the last build in this process
BUILD_INFO = {"seconds": None, "cached": None, "log": ""}


def nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def flags_of(src):
    """nvcc's flags for the source `src`."""
    return FLAGS + (["-fmad=false"] if os.path.basename(src) in NO_FMAD else [])


def _tag():
    h = hashlib.sha256(" ".join(FLAGS + list(NO_FMAD)).encode())
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile (unless this exact build exists) and return the .so path."""
    so = os.path.join(BUILD_DIR, f"libmimi_sweeps_{_tag()}.so")
    t0 = time.perf_counter()
    if os.path.exists(so):
        BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=True, log="")
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}"
    objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
    procs = [
        subprocess.Popen(
            [nvcc(), *flags_of(src), "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [f"{src}: nvcc failed ({p.returncode})" for src, p in zip(SOURCES, procs) if p.returncode]
    if not failed:
        link = subprocess.run(
            [nvcc(), "-shared", "-o", f"{tmp}.tmp", *objs], capture_output=True, text=True
        )
        log += link.stdout + link.stderr
        if link.returncode:
            failed.append(f"link failed ({link.returncode})")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed) + f":\n{log}")
    os.replace(f"{tmp}.tmp", so)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False, log=log)
    return so


def bind(lib):
    """Set the ctypes signatures of the kernel library's C entry points
    (the sf ones at each shape of sweeps.SF_SHAPES, named with its suffix;
    the dense assembles and matvecs also as their bfloat16 twins, suffix
    _bf16, with the same signature: every pointer is a c_void_p)."""
    from .sweeps import SF_SHAPES, _HyperParams, _J2Params, sf_suffix

    vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    sigs = {
        # sf: ..., n_el, stream
        "residual_sf": [vp] * 16 + [_J2Params, cf, ci, ll, vp],
        "assemble_sf": [vp] * 17 + [ci, ci, _J2Params, cf, ci, ll, vp],
        "matvec_sf": [vp] * 10 + [ci, vp, cf, cf, ci, cf, ll, vp],
        "residual_sf_hyper": [vp] * 12 + [_HyperParams, cf, ci, ll, vp],
        "assemble_sf_hyper": [vp] * 13 + [ci, ci, _HyperParams, cf, ci, ll, vp],
        "matvec_sf_sym": [vp] * 10 + [ci, vp, cf, cf, ci, cf, ll, vp],
        "residual_sf_finite": [vp] * 16 + [_J2Params, cf, ci, ll, vp],
        "assemble_sf_finite": [vp] * 17 + [ci, _J2Params, cf, ci, ll, vp],
        "matvec_sf_full": [vp] * 10 + [ci, vp, cf, cf, ci, cf, ll, vp],
        # dense: ..., dim, p, n_el, stream
        "residual_dense": [vp] * 7 + [_HyperParams, cf, ci, ci, ci, ll, vp],
        "assemble_dense": [vp] * 8 + [ci, _HyperParams, cf, ci, ci, ci, ll, vp],
        "matvec_dense": [vp] * 6 + [cf, cf, ci, cf, ci, ci, ll, vp],
        "residual_dense_j2": [vp] * 11 + [_J2Params, cf, ci, ci, ci, ll, vp],
        "assemble_dense_j2": [vp] * 12 + [ci, _J2Params, cf, ci, ci, ci, ll, vp],
        "matvec_dense_cauchy": [vp] * 6 + [cf, cf, ci, cf, ci, ci, ll, vp],
        "residual_dense_finite": [vp] * 11 + [_J2Params, cf, ci, ci, ci, ll, vp],
        "assemble_dense_finite": [vp] * 12 + [_J2Params, cf, ci, ci, ci, ll, vp],
        "matvec_dense_full": [vp] * 6 + [cf, cf, ci, cf, ci, ci, ll, vp],
        "neohookean_residual": [vp] * 4 + [cf, cf, ll, vp],
        "neohookean_tangent_apply": [vp] * 5 + [cf, cf, ll, vp],
    }
    for name, args in sigs.items():
        if name.endswith(_SF_NAMES):
            suffixes = [sf_suffix(*shape) for shape in SF_SHAPES]
        else:
            suffixes = ["", "_bf16"] if name in _BF16_NAMES else [""]
        for suffix in suffixes:
            fn = getattr(lib, f"mimi_{name}{suffix}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def load():
    """The loaded kernel library with its ctypes signatures."""
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(build()))
    return _LIB
