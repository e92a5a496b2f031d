"""Build and load the CUDA kernels (ops/csrc/*.cu, with the headers
ops/csrc/*.cuh they share), one library per kind of tables and element
shape, built the first time that shape is asked for.

The sources are templates on the element's shape; nvcc compiles them at
one shape per library, the shape set by macros:
  - "sf" (sweeps_sf.cu, sweeps_sf_hyper.cu, sweeps_sf_finite.cu) at
    (p + 1, n_g): MIMI_SF_P1 nodes and MIMI_SF_NG Gauss points per axis;
  - "dense" (sweeps_dense*.cu with their bfloat16 twins, and
    fused_neohookean.cu) at (dim, nd, n_q): MIMI_DENSE_DIM,
    MIMI_DENSE_ND dofs and MIMI_DENSE_NQ points per element (any degree,
    quadrature order, or degrees that differ per axis).
This is the counterpart of the reference tracing one Pallas kernel per
shape.  Each library has a plain C interface (no PyTorch headers, so a
build takes seconds to a minute), is keyed by a hash of the sources,
headers, flags and shape and cached in ops/_build/, and is loaded with
ctypes (every pointer and the stream as c_void_p).  The sources of the
shapes asked for compile in parallel, one nvcc each, on a pool of
`JOBS` processes (`start` queues a shape's sources, `load` waits for
them and links).  Nothing here runs at import time.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
# the sources of each kind of library
KIND_SOURCES = {
    "sf": ("sweeps_sf.cu", "sweeps_sf_hyper.cu", "sweeps_sf_finite.cu"),
    "dense": ("sweeps_dense.cu", "sweeps_dense_j2.cu", "sweeps_dense_finite.cu",
              "sweeps_dense_bf16.cu", "sweeps_dense_j2_bf16.cu", "sweeps_dense_finite_bf16.cu",
              "fused_neohookean.cu"),
}
SOURCES = [os.path.join(CSRC, name) for names in KIND_SOURCES.values() for name in names]
HEADERS = [
    os.path.join(CSRC, name)
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
# nvcc processes at a time, each at a lower priority than the caller (nice
# 10): half the cores but one, so that shapes compiled in the background
# leave the caller room (at cpu_count - 1 jobs, 7 on the H100 machine's 8
# cores, chip_smoke.py's host-bound phases ran 20-40% slower beside them,
# at 4 still ~15%)
JOBS = max(1, (os.cpu_count() or 4) // 2 - 1)
# the dense entry points with a bfloat16 twin (suffix _bf16: the block, and
# the matvec's dN and N, as __nv_bfloat16*, 2-byte data behind a c_void_p)
_BF16_NAMES = ("assemble_dense", "matvec_dense", "assemble_dense_j2", "matvec_dense_cauchy",
               "assemble_dense_finite", "matvec_dense_full")

# per (kind, shape): the loaded library, the queued compiles, and the
# seconds from `start` to the end of its last compile, whether it was
# cached, each source's nvcc seconds and the compiler output of its build
_LIBS = {}
_JOBS = {}
BUILD_INFO = {}
_POOL = None


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
    """nvcc's flags for the source `src` (without the shape's defines)."""
    return FLAGS + (["-fmad=false"] if os.path.basename(src) in NO_FMAD else [])


def key_of(kind, shape):
    """(kind, shape) as the build keys it: "sf" with (p + 1, n_g) or
    "dense" with (dim, nd, n_q), positive integers; ValueError otherwise."""
    shape = tuple(int(v) for v in shape)
    n = {"sf": 2, "dense": 3}.get(kind)
    if n is None or len(shape) != n or min(shape) < 1 or (kind == "dense"
                                                          and shape[0] not in (2, 3)):
        raise ValueError(f"no kernel library of kind {kind!r} at shape {shape}")
    return kind, shape


def defines(kind, shape):
    """The macros that set a library's shape."""
    kind, shape = key_of(kind, shape)
    names = (("MIMI_SF_P1", "MIMI_SF_NG") if kind == "sf"
             else ("MIMI_DENSE_DIM", "MIMI_DENSE_ND", "MIMI_DENSE_NQ"))
    return [f"-D{n}={v}" for n, v in zip(names, shape)]


def _tag(kind, shape):
    h = hashlib.sha256(" ".join(FLAGS + list(NO_FMAD) + defines(kind, shape)).encode())
    for src in [os.path.join(CSRC, n) for n in KIND_SOURCES[kind]] + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(kind, shape):
    kind, shape = key_of(kind, shape)
    return os.path.join(BUILD_DIR, f"libmimi_{kind}_{'_'.join(map(str, shape))}_"
                                   f"{_tag(kind, shape)}.so")


def _compile(cmd):
    if shutil.which("nice"):
        cmd = ["nice", "-n", "10", *cmd]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t1 = time.perf_counter()
    return p.returncode, p.stdout, t1 - t0, t1


def _queue(key, csrc, so, flags):
    """Submit the compiles of the `key` library's sources in `csrc` (nvcc
    flags `flags(src)`) for the library `so` to the pool of JOBS nvcc
    processes: (so, the time queued, [(source, object, future)])."""
    global _POOL
    if _POOL is None:
        _POOL = concurrent.futures.ThreadPoolExecutor(JOBS)
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp, jobs = f"{so}.{os.getpid()}", []
    for i, name in enumerate(KIND_SOURCES[key[0]]):
        src, obj = os.path.join(csrc, name), f"{tmp}.{i}.o"
        cmd = [nvcc(), *flags(src), *defines(*key), "-c", "-o", obj, src]
        jobs.append((src, obj, _POOL.submit(_compile, cmd)))
    return so, time.perf_counter(), jobs


def _link(key, queued):
    """Wait for `queued` compiles (from _queue) and link them: (the
    library's path, its build info: seconds from queueing to the end of the
    last compile, whether it was cached, each source's nvcc seconds, the
    compiler output).  RuntimeError naming every failed source."""
    so, t0, jobs = queued
    if not jobs:
        return so, {"seconds": 0.0, "cached": True, "nvcc": {}, "log": ""}
    results = [(src, obj, job.result()) for src, obj, job in jobs]
    log = "".join(out for _, _, (_, out, _, _) in results)
    failed = [f"{src} {' '.join(defines(*key))}: nvcc failed ({rc})"
              for src, _, (rc, _, _, _) in results if rc]
    objs = [obj for _, obj, _ in results]
    if not failed:
        link = subprocess.run([nvcc(), "-shared", "-o", f"{so}.{os.getpid()}.tmp", *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode:
            failed.append(f"link failed ({link.returncode})")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed) + f":\n{log}")
    os.replace(f"{so}.{os.getpid()}.tmp", so)
    return so, {"seconds": max(end for _, _, (_, _, _, end) in results) - t0,
                "cached": False, "log": log,
                "nvcc": {os.path.basename(src): sec for src, _, (_, _, sec, _) in results}}


def start(keys):
    """Queue the compiles of each (kind, shape) in `keys` not built or
    queued yet (a cached library needs none), in order, on the pool of
    JOBS nvcc processes; returns at once."""
    for kind, shape in keys:
        key = key_of(kind, shape)
        if key in _JOBS or key in _LIBS:
            continue
        so = library_path(*key)
        _JOBS[key] = ((so, time.perf_counter(), []) if os.path.exists(so)
                      else _queue(key, CSRC, so, flags_of))


def pending():
    """How many queued compiles have not ended yet."""
    return sum(not job.done() for _, _, jobs in _JOBS.values() for _, _, job in jobs)


def _finish(key):
    """Wait for the key's compiles, link them into its library and record
    its BUILD_INFO; returns the library's path."""
    try:
        so, BUILD_INFO[key] = _link(key, _JOBS[key])
    except RuntimeError:
        del _JOBS[key]
        raise
    return so


def bind(lib, kind):
    """Set the ctypes signatures of a `kind` library's C entry points (the
    dense assembles and matvecs also as their bfloat16 twins, suffix _bf16,
    with the same signature: every pointer is a c_void_p)."""
    from .sweeps import _HyperParams, _J2Params

    vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    sigs = {
        "sf": {  # ..., n_el, stream
            "residual_sf": [vp] * 16 + [_J2Params, cf, ci, ll, vp],
            "assemble_sf": [vp] * 17 + [ci, ci, _J2Params, cf, ci, ll, vp],
            "matvec_sf": [vp] * 10 + [ci, vp, cf, cf, ci, cf, ll, vp],
            "residual_sf_hyper": [vp] * 12 + [_HyperParams, cf, ci, ll, vp],
            "assemble_sf_hyper": [vp] * 13 + [ci, ci, _HyperParams, cf, ci, ll, vp],
            "matvec_sf_sym": [vp] * 10 + [ci, vp, cf, cf, ci, cf, ll, vp],
            "residual_sf_finite": [vp] * 16 + [_J2Params, cf, ci, ll, vp],
            "assemble_sf_finite": [vp] * 17 + [ci, _J2Params, cf, ci, ll, vp],
            "matvec_sf_full": [vp] * 10 + [ci, vp, cf, cf, ci, cf, ll, vp],
        },
        "dense": {  # ..., dim, nd, n_q, n_el, stream
            "residual_dense": [vp] * 7 + [_HyperParams, cf, ci, ci, ci, ci, ll, vp],
            "assemble_dense": [vp] * 8 + [ci, _HyperParams, cf, ci, ci, ci, ci, ll, vp],
            "matvec_dense": [vp] * 6 + [cf, cf, ci, cf, ci, ci, ci, ll, vp],
            "residual_dense_j2": [vp] * 11 + [_J2Params, cf, ci, ci, ci, ci, ll, vp],
            "assemble_dense_j2": [vp] * 12 + [ci, _J2Params, cf, ci, ci, ci, ci, ll, vp],
            "matvec_dense_cauchy": [vp] * 6 + [cf, cf, ci, cf, ci, ci, ci, ll, vp],
            "residual_dense_finite": [vp] * 11 + [_J2Params, cf, ci, ci, ci, ci, ll, vp],
            "assemble_dense_finite": [vp] * 12 + [_J2Params, cf, ci, ci, ci, ci, ll, vp],
            "matvec_dense_full": [vp] * 6 + [cf, cf, ci, cf, ci, ci, ci, ll, vp],
            "neohookean_residual": [vp] * 4 + [cf, cf, ci, ci, ci, ll, vp],
            "neohookean_tangent_apply": [vp] * 5 + [cf, cf, ci, ci, ci, ll, vp],
        },
    }[kind]
    for name, args in sigs.items():
        for suffix in ["", "_bf16"] if name in _BF16_NAMES else [""]:
            fn = getattr(lib, f"mimi_{name}{suffix}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def load(kind, shape):
    """The loaded `kind` library at `shape` with its ctypes signatures,
    built from the sources at its first request (or found in
    ops/_build/)."""
    key = key_of(kind, shape)
    if key not in _LIBS:
        start([key])
        _LIBS[key] = bind(ctypes.CDLL(_finish(key)), key[0])
    return _LIBS[key]


def prebuild(keys):
    """Build and load every (kind, shape) of `keys`, their compiles all
    queued before the first wait; returns {key: library}."""
    keys = [key_of(*k) for k in keys]
    start(keys)
    return {k: load(*k) for k in keys}


def build_tree(csrc, out, keys, flags=flags_of):
    """Compile another tree of the sources (another version's ops/csrc, or
    these with other nvcc flags: `flags(src)`) at each (kind, shape) of
    `keys` into libraries under `out`, bound with this build's signatures
    (the tree's C entry points must match them): ({key: library}, compiler
    output).  For A/B scripts; nothing is cached."""
    keys = [key_of(*k) for k in keys]
    queued = {k: _queue(k, csrc, os.path.join(out, f"lib_{k[0]}_{'_'.join(map(str, k[1]))}.so"),
                        flags) for k in keys}
    libs, log = {}, ""
    for k, q in queued.items():
        so, info = _link(k, q)
        log += info["log"]
        libs[k] = bind(ctypes.CDLL(so), k[0])
    return libs, log
