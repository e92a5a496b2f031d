"""The port's CUDA sources (mimi_tpu_torch/ops/csrc/*.cu) built as host C++.

The card's compiler is not here, so g++ builds each source against the
host stand-ins of mimi_tpu_torch/ops/csrc/host_stub/ (the qualifiers
compile away, __ldg is a load, the single-rounding intrinsics are IEEE
float operations).  A copy of the sources has every launch
`kernel<<<grid, block, shared, stream>>>(args)` rewritten into a call of
the stub's mimi_host_launch, which runs the blocks one at a time, each
with one host thread per thread of the block: __shared__ storage is shared
by the block's threads and __syncthreads() is a barrier of them, so the
sf residual kernel, whose threads reduce through shared memory, runs as
on the card.  Each source must compile at each shape of HOST_SHAPES (the
defines of ops/build.py: the default shapes and shapes outside them, sf
p = 1, p = 4 at 6 and 8 Gauss points per axis and p = 2 at 3, dense 2D
p = 4, 3D p = 1, p = 4 and p = 6, 2D degrees [3, 2]), so that a template
that breaks at a new shape fails here first; a launch past the card's
limits (1024 threads, 227 KB of shared memory a block) fails here as
there; the objects of one kind and shape are linked
into one library with the C entry points of ops/build.py, and the dense
finite-strain kernels (sweeps_dense_finite.cu) run on CPU tensors at 4
elements (2D, p = 3), the viscous dense kernels (sym and cauchy, 2D and
3D), the viscous hyperelastic sf kernels with a float32 or bfloat16 block
(sweeps_sf_hyper.cu) and the J2-family sf and dense kernels at a few
elements, the sf residual and assemble of J2 also on a partial tile and on
full tiles with a ragged tail, the sf matvec of every storage, viscous or
not, float32 or bfloat16 block, at p = 2 and p = 3 on a ragged last tile,
J2Simo's and J2Log's viscous and bfloat16
full-storage kernels and the full block of J2, J2Linear and the
hyperelastic materials, sf and dense, J2Simo's and J2Log's dense residual
and assemble (dense_slot_kernel, one thread per element and point slot)
at the driven shapes on a ragged last tile, and J2Log's sf and dense
sweeps on a batch with one point past the fast log series' range (one
series decision a sweep), against their plain versions (the J2
family's as the kernels' twin, the radial return at 40 trips:
materials.kernel_solver_mode).  The dense residual and assemble on
point slots (dense_slot_kernel: J2, J2Linear and J2Simo at (2, 16, 25))
are also held to the one-thread kernel built beside them, bit by bit, and
the tiled ones on owners and a flux warp (dense_residual_tile_kernel) run
at path I's and path L's shapes on a ragged last tile.  The fused
neo-Hookean tangent apply on owners and a flux warp runs at each shape of
torch_shapes.FUSED_APPLY_SHAPES against its plain version and the dense
matvec, and 3D J2's residual and assemble at J2_UNTILED_3D_SHAPES against
plain and, inviscid (dense_ring_kernel), bit by bit against the one-thread
kernel.  Skips where no g++ is found.
"""

import concurrent.futures
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import mimi_tpu_torch as mt
from mimi_tpu_torch.fem import soa
from mimi_tpu_torch.materials import kernel_solver_mode
from mimi_tpu_torch.materials import logm as tlogm
from mimi_tpu_torch.ops import build as kbuild
from mimi_tpu_torch.ops import sweeps as tsw
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)
from torch_shapes import DENSE_SHAPES, FUSED_APPLY_SHAPES, J2_UNTILED_3D_SHAPES, SF_SHAPES

CSRC = os.path.join(os.path.dirname(kbuild.__file__), "csrc")
STUB = os.path.join(CSRC, "host_stub")
DATA = os.path.join(os.path.dirname(__file__), "data")
BALKEN = os.path.join(DATA, "balken.mesh")
MESH = os.path.join(DATA, "cube-nurbs.mesh")
SOURCES = [os.path.basename(s) for s in kbuild.SOURCES]
CXX = ["-std=c++20", "-O1", "-fPIC", "-pthread", "-ffp-contract=off", "-w"]
# the shapes every source of a kind is built at: the earlier paths' shapes and
# sf (2, 3) (p = 1), (5, 6) (p = 4), (3, 3) (p = 2 at quadrature order 5),
# (5, 8) (p = 4 at quadrature order 14: the axis matvec's tile of 8),
# dense (2, 25, 36) (2D p = 4), (3, 8, 27) (3D p = 1), (3, 125, 216) (3D
# p = 4), (2, 12, 20) (2D degrees [3, 2]), (3, 216, 343) (3D p = 5: the
# finite-strain tile's fields past a block's shared memory), (3, 343, 512)
# (3D p = 6: the tiled matvec's owner warps capped at 16, the fused
# tangent apply's w read from device memory), (2, 9, 9) (2D p = 2 at
# quadrature order 5: a shape of FUSED_APPLY_SHAPES)
HOST_SHAPES = {
    "sf": SF_SHAPES + ((2, 3), (5, 6), (3, 3), (5, 8)),
    "dense": tuple(tsw.dense_key(d, p) for d, p in DENSE_SHAPES)
    + ((2, 25, 36), (3, 8, 27), (3, 125, 216), (2, 12, 20), (3, 216, 343), (3, 343, 512),
       (2, 9, 9)),
}
HOST_UNITS = [(kind, shape, name) for kind, shapes in HOST_SHAPES.items() for shape in shapes
              for name in kbuild.KIND_SOURCES[kind]]


def _statement_start(text, i):
    """Index just after the `;`, `{` or `}` before position i."""
    return max(text.rfind(c, 0, i) for c in ";{}") + 1


def _matching_paren(text, i):
    """Index of the `)` that closes the `(` at position i."""
    depth = 0
    for j in range(i, len(text)):
        depth += {"(": 1, ")": -1}.get(text[j], 0)
        if depth == 0:
            return j
    raise ValueError("unbalanced parentheses")


def _split_top(args):
    """The comma-separated parts of `args` outside any parentheses."""
    parts, depth, cur = [], 0, ""
    for c in args:
        depth += {"(": 1, ")": -1}.get(c, 0)
        if c == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += c
    return parts + [cur]


def serial_launches(text):
    """`kernel<<<grid, block, shared, stream>>>(args)` -> a call of the
    stub's mimi_host_launch running `kernel(args)` as the grid's blocks, one
    after the other, each on one host thread per thread of the block, with
    the launch's `shared` bytes of dynamic shared memory."""
    while "<<<" in text:
        i = text.index("<<<")
        start = _statement_start(text, i)
        j = text.index(">>>", i)
        grid, block, shared = (_split_top(text[i + 3:j]) + ["0"])[:3]
        k = text.index("(", j)
        end = _matching_paren(text, k)
        kernel, args = text[start:i].strip(), text[k + 1:end]
        loop = (f" {{ const unsigned mimi_g = ({grid}), mimi_b = ({block});"
                f" const size_t mimi_s = ({shared});"
                f" mimi_host_launch(mimi_g, mimi_b, mimi_s, [&] {{ {kernel}({args}); }}); }}")
        text = text[:start] + loop + text[end + 1:]
    return text


def _unit_obj(dest, kind, shape, name):
    return os.path.join(dest, f"{name}.{kind}_{'_'.join(map(str, shape))}.o")


def host_build(dest, units=HOST_UNITS, jobs=8):
    """Copy the sources and headers into `dest` with host launches, and
    compile each (kind, shape, source) of `units` with g++, `jobs` at a
    time, the shape set by ops/build.py's defines.  Returns {(kind, shape,
    source): (return code, compiler output)}; the objects are at
    _unit_obj."""
    for name in os.listdir(CSRC):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name)) as f:
                text = serial_launches(f.read())
            with open(os.path.join(dest, name), "w") as f:
                f.write(text)

    def compile_unit(unit):
        kind, shape, name = unit
        r = subprocess.run(
            ["g++", *CXX, *kbuild.defines(kind, shape), "-x", "c++", "-I", STUB, "-I", dest,
             "-c", "-o", _unit_obj(dest, *unit), os.path.join(dest, name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=900,
        )
        return r.returncode, r.stdout

    with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        return dict(zip(units, pool.map(compile_unit, units)))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host to build the CUDA sources as C++")
    dest = str(tmp_path_factory.mktemp("csrc_host"))
    return dest, host_build(dest)


@pytest.fixture(scope="module")
def libs(built):
    """libs(kind, shape): the host library of one kind and shape (its
    sources' objects linked), bound with ops/build.py's signatures."""
    dest, results = built
    loaded = {}

    def get(kind, shape):
        key = kbuild.key_of(kind, shape)
        if key not in loaded:
            units = [(key[0], key[1], name) for name in kbuild.KIND_SOURCES[key[0]]]
            failed = [u for u in units if results[u][0]]
            assert not failed, f"sources that do not compile: {failed}"
            so = os.path.join(dest, f"libmimi_{key[0]}_{'_'.join(map(str, key[1]))}_host.so")
            r = subprocess.run(["g++", "-shared", "-o", so,
                                *[_unit_obj(dest, *u) for u in units]],
                               capture_output=True, text=True)
            assert r.returncode == 0, r.stderr
            loaded[key] = kbuild.bind(ctypes.CDLL(so), key[0])
        return loaded[key]

    return get


def test_serial_launch_rewrite():
    text = ("int f(long long E, void* s) {\n  k<A, B>\n      <<<grid_for(E), BLOCK, 0, "
            "(cudaStream_t)s>>>(x, g(y, z), E);\n  return 0;\n}")
    out = serial_launches(text)
    assert "<<<" not in out and "k<A, B>(x, g(y, z), E);" in out
    assert "mimi_g = (grid_for(E)), mimi_b = ( BLOCK)" in out
    assert re.search(r"\{ const unsigned mimi_g", out)


BLOCK_SUM = r"""
#include <cstdio>
#include "cuda_runtime.h"
constexpr int NT = 64, NB = 3;
__global__ void block_sum(const float* x, float* out) {
  __shared__ float s[NT];
  const unsigned t = threadIdx.x;
  s[t] = x[blockIdx.x * NT + t];
  __syncthreads();
  for (unsigned h = NT / 2; h > 0; h /= 2) {  // each step reads other threads' sums
    if (t < h) s[t] += s[t + h];
    __syncthreads();
  }
  if (t == 0) out[blockIdx.x] = s[0];
}
int main() {
  float x[NB * NT], out[NB];
  for (int i = 0; i < NB * NT; ++i) x[i] = (float)(i + 1);
  block_sum<<<NB, NT, 0, (cudaStream_t)nullptr>>>(x, out);
  for (int b = 0; b < NB; ++b) std::printf("%.1f ", out[b]);
  return 0;
}
"""


def test_host_launch_runs_a_block_cooperatively(tmp_path):
    """The stub runs a block's threads together: a kernel that sums each
    block's 64 values by a tree through shared memory, with a barrier
    after every step, gives the exact sums (integers in float32) for
    three blocks that reuse the same shared array."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host to build the CUDA sources as C++")
    src, exe = tmp_path / "block_sum.cpp", tmp_path / "block_sum"
    src.write_text(serial_launches(BLOCK_SUM))
    assert "<<<" not in src.read_text()
    r = subprocess.run(["g++", *CXX, "-I", STUB, "-o", str(exe), str(src)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    sums = [float(v) for v in subprocess.run([str(exe)], capture_output=True, text=True,
                                             check=True, timeout=60).stdout.split()]
    assert sums == [float(sum(range(64 * b + 1, 64 * b + 65))) for b in range(3)]


@pytest.mark.parametrize("kind, shape, source", HOST_UNITS,
                         ids=[f"{n}@{'_'.join(map(str, s))}" for _, s, n in HOST_UNITS])
def test_source_compiles_as_host_cpp(built, kind, shape, source):
    _, results = built
    rc, log = results[(kind, shape, source)]
    assert rc == 0, f"g++ could not build {source} at {kind} {shape}:\n{log[-4000:]}"


def test_only_the_dense_finite_source_builds_without_fused_multiply_add():
    """nvcc builds the dense finite-strain kernels (sweeps_dense_finite.cu
    and its bfloat16 twin) with -fmad=false (each product and sum rounded
    on its own, as their plain twin's torch operations round them) and
    every other source with its default."""
    for src in kbuild.SOURCES:
        flags = kbuild.flags_of(src)
        assert flags[: len(kbuild.FLAGS)] == kbuild.FLAGS
        assert ("-fmad=false" in flags) == (os.path.basename(src) in (
            "sweeps_dense_finite.cu", "sweeps_dense_finite_bf16.cu"))


def _material(name):
    mat = getattr(mt, name)()
    mat.density = 1.0
    mat.viscosity = -1.0
    mat.melting_temperature = 1500.0
    mat.initial_temperature = 20.0
    mat.specific_heat = 450.0
    mat.set_young_poisson(2100.0, 0.3)
    h = mt.JohnsonCookTemperatureAndRateDependentHardening()
    h.A, h.B, h.n, h.m = 70.0, 140.0, 0.2835, 1.3558
    h.eps0_dot = 0.004
    h.reference_temperature = 20.0
    mat.hardening = h
    return mat


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


@pytest.mark.parametrize("name", list(tsw.FULL_KERNELS))
def test_dense_finite_kernels_on_cpu_tensors(libs, name):
    """The three dense finite-strain kernels of the host build on the
    golden cantilever's 2D p = 3 tables at 4 elements (float32), on a
    plastic history, against the plain versions at 1e-5 of scale; the
    16 planes at 1e-5 of their max."""
    prob = mt.build_problem(BALKEN, 2, 1, _material(name), [(2, 0), (2, 1)], {1: -3.0},
                            rho_inf=0.5, device="cpu", dtype=torch.float32)
    mat, dN, N, wq = prob.material, prob.dense["dN_t"], prob.dense["N_t"], prob.wdet_t
    E, nq, nd = prob.n_el, prob.n_q, dN.shape[0]
    rng = np.random.default_rng(3)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    u0, u_el = (f32(0.04 * rng.standard_normal((2, nd, E))) for _ in range(2))
    a_el, w_el = f32(rng.standard_normal((2, nd, E))), f32(rng.standard_normal((2, nd, E)))
    dt, rho, fac0 = 0.2, 1.0, 0.01
    F0 = soa.add_diag(tsw.dense_grad(u0, dN), 1.0)
    state = mat.accumulate_soa(F0, {k: v.clone() for k, v in prob.state0.items()}, dt)
    state = {k: v.contiguous() for k, v in state.items()}
    assert float(state["eqps"].max()) > 0.0
    mat_id, _, leaves = tsw.FULL_KERNELS[name]
    st = [_ptr(state[k]) for k in leaves] + [_ptr(None)] * (4 - len(leaves))
    prm = tsw._j2_params(mat, dt, rho, family=tuple(tsw.FULL_KERNELS))
    head = (_ptr(u_el), _ptr(a_el), _ptr(None), _ptr(dN), _ptr(N), _ptr(wq), *st)
    shape = (ctypes.c_int(2), ctypes.c_int(nd), ctypes.c_int(nq), ctypes.c_longlong(E),
             ctypes.c_void_p(None))
    lib = libs("dense", (2, nd, nq))
    out, out_a = torch.empty(2, nd, E), torch.empty(2, nd, E)
    C = torch.empty(16, nq, E)
    tail = (prm, ctypes.c_float(0.0), mat_id)
    assert lib.mimi_residual_dense_finite(*head, _ptr(out), *tail, *shape) == 0
    assert lib.mimi_assemble_dense_finite(*head, _ptr(out_a), _ptr(C), *tail, *shape) == 0
    args = (u_el, a_el, state, dN, N, wq, mat, dt, rho)
    with kernel_solver_mode():
        y = tsw.residual_dense_plain(*args)
        y_a, C_p = tsw.assemble_dense_plain(*args)
    assert float((out - y).abs().max()) <= 1e-5 * float(y.abs().max())
    assert float((out_a - y_a).abs().max()) <= 1e-5 * float(y_a.abs().max())
    assert float((C - C_p).abs().max()) <= 1e-5 * float(C_p.abs().max())
    mv = torch.empty(2, nd, E)
    assert lib.mimi_matvec_dense_full(_ptr(w_el), _ptr(dN), _ptr(N), _ptr(wq), _ptr(C_p),
                                      _ptr(mv), rho, fac0, 0, 0.0, *shape) == 0
    mv_p = tsw.matvec_dense_plain(w_el, dN, N, wq, C_p, rho, fac0, storage="full")
    assert float((mv - mv_p).abs().max()) <= 1e-5 * float(mv_p.abs().max())


def _hyper(name, viscosity=100.0):
    mat = getattr(mt, name)()
    mat.density = 1e3
    mat.viscosity = viscosity
    mat.set_young_poisson(1e6, 0.3)
    return mat


@pytest.mark.parametrize(
    "case",
    ["nh_2d_p2", "stvk_2d_p3", "nh_3d_p2", "j2_2d_p2", "j2_3d_p2"],
)
def test_dense_viscous_kernels_on_cpu_tensors(libs, case):
    """The viscous dense residual, assemble and matvec of the host build
    (sym and cauchy storages, 2D and 3D) on CPU tensors at a few elements,
    float32, against the plain versions with v_el and fac1 mu_v at 1e-5 of
    scale; the planes at 1e-5 of their max.  The viscous flux is a real
    part of each output (the inviscid kernel differs by far more)."""
    tag, d, p = case.split("_")
    dim, deg = int(d[0]), int(p[1])
    if dim == 2:
        mesh, clamp, elev, subd = (os.path.join(DATA, "two-patch-square.mesh"),
                                   [(2, 0), (2, 1)], deg - 1, 1)
    else:
        mesh, clamp, elev, subd = (os.path.join(DATA, "two-patch-cube.mesh"),
                                   [(0, 0), (0, 1), (0, 2)], 1, 0)
    mat = _material("J2") if tag == "j2" else _hyper(
        "CompressibleOgdenNeoHookean" if tag == "nh" else "StVenantKirchhoff")
    mat.viscosity = 100.0
    prob = mt.build_problem(mesh, elev, subd, mat, clamp, {}, rho_inf=0.5, device="cpu",
                            dtype=torch.float32)
    dN, N, wq, E, nq = prob.dense["dN_t"], prob.dense["N_t"], prob.wdet_t, prob.n_el, prob.n_q
    nd = dN.shape[0]
    assert (dim, nd) == (prob.dim, (deg + 1) ** dim)
    rng = np.random.default_rng(4)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    u_el, a_el, v_el, w_el = (f32(s * rng.standard_normal((dim, nd, E)))
                              for s in (0.02, 1.0, 50.0, 1.0))
    state = None
    if tag == "j2":
        state = {k: v.clone() for k, v in prob.state0.items()}
        state["eqps"] = f32(0.01 * rng.random((nq, E)))
    dt, rho, fac0, mu_v, fac1_mu_v = 0.01, float(mat.density), 1e-6, 100.0, 50.0
    shape = (ctypes.c_int(dim), ctypes.c_int(nd), ctypes.c_int(nq), ctypes.c_longlong(E),
             ctypes.c_void_p(None))
    lib = libs("dense", (dim, nd, nq))
    storage = tsw.tangent_storage(mat)
    head = (_ptr(u_el), _ptr(a_el), _ptr(v_el), _ptr(dN), _ptr(N), _ptr(wq))
    if tag == "j2":
        head += tuple(_ptr(state[k]) for k in ("plastic_strain", "eqps", "temperature"))
        head += (_ptr(None),)  # J2 has no back stress
        tail = (tsw._j2_params(mat, dt, rho), ctypes.c_float(mu_v), ctypes.c_int(0))
        fns = (lib.mimi_residual_dense_j2, lib.mimi_assemble_dense_j2, lib.mimi_matvec_dense_cauchy)
    else:
        prm, mat_id, _ = tsw._hyper_params(mat, rho)
        tail = (prm, ctypes.c_float(mu_v), ctypes.c_int(mat_id))
        fns = (lib.mimi_residual_dense, lib.mimi_assemble_dense, lib.mimi_matvec_dense)
    out, out_a = torch.empty(dim, nd, E), torch.empty(dim, nd, E)
    C = torch.empty(tsw.n_planes(storage, dim), nq, E)
    assert fns[0](*head, _ptr(out), *tail, *shape) == 0
    assert fns[1](*head, _ptr(out_a), _ptr(C), 0, *tail, *shape) == 0  # not the full block
    args = (u_el, a_el, state, dN, N, wq, mat, dt, rho)
    with kernel_solver_mode():
        y = tsw.residual_dense_plain(*args, v_el=v_el, mu_v=mu_v)
        y_a, C_p = tsw.assemble_dense_plain(*args, v_el=v_el, mu_v=mu_v)
        y0 = tsw.residual_dense_plain(*args)
    assert float((out - y).abs().max()) <= 1e-5 * float(y.abs().max())
    assert float((out_a - y_a).abs().max()) <= 1e-5 * float(y_a.abs().max())
    assert float((y0 - y).abs().max()) > 1e-2 * float(y.abs().max())
    assert float((C - C_p).abs().max()) <= 1e-5 * float(C_p.abs().max())
    mv = torch.empty(dim, nd, E)
    assert fns[2](_ptr(w_el), _ptr(dN), _ptr(N), _ptr(wq), _ptr(C_p), _ptr(mv), rho, fac0, 1,
                  fac1_mu_v, *shape) == 0
    mv_p = tsw.matvec_dense_plain(w_el, dN, N, wq, C_p, rho, fac0, fac1_mu_v, storage=storage)
    mv0 = tsw.matvec_dense_plain(w_el, dN, N, wq, C_p, rho, fac0, storage=storage)
    assert float((mv - mv_p).abs().max()) <= 1e-5 * float(mv_p.abs().max())
    assert float((mv0 - mv_p).abs().max()) > 1e-2 * float(mv_p.abs().max())


@pytest.mark.parametrize("name", ["CompressibleOgdenNeoHookean", "StVenantKirchhoff"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_sf_hyper_viscous_kernels_on_cpu_tensors(libs, name, bf16):
    """The viscous hyperelastic sf residual and assemble (the 45 planes in
    float32 or bfloat16) and the viscous sym matvec of the host build on
    the 2^3 cube's tables, float32, against the plain versions: residuals
    and matvec at 1e-5 of scale, float32 planes at 1e-5 of their max; a
    bfloat16 plane within one bfloat16 step (2^-7) of the plain version's
    float32 plane rounded to bfloat16 (the kernel rounds its own float32
    plane, which agrees with the plain one to float32 rounding of F)."""
    mat = _hyper(name)
    prob = mt.build_problem(MESH, 1, 1, mat, [(1, 0), (1, 1), (1, 2)], {}, rho_inf=0.5,
                            device="cpu", dtype=torch.float32)
    tabs, jinv, wq, E = prob.sf["tables"], prob.sf["jinv"], prob.wdet_t, prob.n_el
    lib = libs("sf", (3, 4))
    rng = np.random.default_rng(5)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    u_el, a_el, v_el, w_el = (f32(s * rng.standard_normal((3, 27, E)))
                              for s in (0.02, 1.0, 50.0, 1.0))
    rho, fac0, mu_v, fac1_mu_v = 1e3, 1e-6, 100.0, 50.0
    c_dtype = torch.bfloat16 if bf16 else torch.float32
    prm, mat_id, _ = tsw._hyper_params(mat, rho)
    head = (_ptr(u_el), _ptr(a_el), _ptr(v_el), *[_ptr(t) for t in tabs], _ptr(jinv), _ptr(wq))
    tail = (prm, ctypes.c_float(mu_v), ctypes.c_int(mat_id), ctypes.c_longlong(E),
            ctypes.c_void_p(None))
    out, out_a = torch.empty(3, 27, E), torch.empty(3, 27, E)
    C = torch.empty(45, 64, E, dtype=c_dtype)
    assert lib.mimi_residual_sf_hyper(*head, _ptr(out), *tail) == 0
    assert lib.mimi_assemble_sf_hyper(*head, _ptr(out_a), _ptr(C), int(bf16), 0, *tail) == 0
    args = (u_el, a_el, None, tabs, jinv, wq, mat, 0.01, rho)
    y = tsw.residual_sf_plain(*args, v_el=v_el, mu_v=mu_v)
    y_a, C_p = tsw.assemble_sf_plain(*args, v_el=v_el, mu_v=mu_v)
    assert float((out - y).abs().max()) <= 1e-5 * float(y.abs().max())
    assert float((out_a - y_a).abs().max()) <= 1e-5 * float(y_a.abs().max())
    scale = float(C_p.abs().max())
    if bf16:
        err = float((C.float() - C_p.to(torch.bfloat16).float()).abs().max())
        assert err <= 2.0**-7 * scale
    else:
        assert float((C - C_p).abs().max()) <= 1e-5 * scale
    Cb = C_p.to(c_dtype)
    mv = torch.empty(3, 27, E)
    assert lib.mimi_matvec_sf_sym(_ptr(w_el), *[_ptr(t) for t in tabs], _ptr(jinv), _ptr(wq),
                                  _ptr(Cb), int(bf16), _ptr(mv), rho, fac0, 1, fac1_mu_v,
                                  ctypes.c_longlong(E), ctypes.c_void_p(None)) == 0
    mv_p = tsw.matvec_sf_plain(w_el, tabs, jinv, wq, Cb, rho, fac0, fac1_mu_v, storage="sym")
    assert float((mv - mv_p).abs().max()) <= 1e-5 * float(mv_p.abs().max())


def test_j2_params_mirror_matches_the_c_struct(built):
    """ops/sweeps.py _J2Params lays its fields where g++ lays those of
    csrc/j2.cuh's J2Params: every offset and the size (a mismatch would
    corrupt every J2-family launch)."""
    dest = built[0]
    names = [name for name, _ in tsw._J2Params._fields_]
    src = os.path.join(dest, "j2_params_layout.cpp")
    with open(src, "w") as f:
        f.write('#include <cstddef>\n#include <cstdio>\n#include "j2.cuh"\nint main() {\n')
        f.write('  std::printf("%zu", sizeof(J2Params));\n')
        for name in names:
            f.write(f'  std::printf(" %zu", offsetof(J2Params, {name}));\n')
        f.write("  return 0;\n}\n")
    exe = os.path.join(dest, "j2_params_layout")
    r = subprocess.run(["g++", *CXX, "-I", STUB, "-I", dest, "-o", exe, src],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    size, *offsets = map(int, subprocess.run([exe], capture_output=True, text=True,
                                             check=True).stdout.split())
    assert size == ctypes.sizeof(tsw._J2Params)
    assert offsets == [getattr(tsw._J2Params, name).offset for name in names]


@pytest.fixture
def host_sweeps(libs, monkeypatch):
    """ops/sweeps.py's kernel wrappers on CPU tensors through the host
    build: the library of the tables' kind and shape, no device check,
    launches on no stream."""
    def launch(fn, name, *args):
        tsw.LAUNCHES[name] += 1
        err = fn(*args, ctypes.c_void_p(None))
        assert err == 0, f"{name} returned {err}"

    monkeypatch.setattr(kbuild, "load", libs)
    monkeypatch.setattr(tsw, "_check_device", lambda device: None)
    monkeypatch.setattr(tsw, "_launch", launch)
    tsw.reset_launches()
    return tsw


def _law(name):
    """The PowerLaw of the reference's kernel test (sigma_y 10, n 2 -- the
    exponent 1/2 that torch evaluates as a square root -- eps0 1e-3) or a
    Voce law with the same initial yield."""
    if name == "pow":
        h = mt.PowerLawHardening()
        h.sigma_y, h.n, h.eps0 = 10.0, 2.0, 1e-3
    else:
        h = mt.VoceHardening()
        h.sigma_y, h.sigma_sat, h.strain_constant = 10.0, 30.0, 0.02
    return h


def _j2_family(name, law=None, viscosity=-1.0):
    if name == "J2Linear":
        mat = mt.J2Linear()
        mat.sigma_y, mat.isotropic_hardening, mat.kinematic_hardening = 5.0, 50.0, 30.0
        mat.density, mat.viscosity = 1.0, viscosity
        mat.set_young_poisson(2100.0, 0.3)
        return mat
    mat = _material(name)
    mat.viscosity = viscosity
    mat.hardening = _law(law)
    return mat


def _host_problem(kind, dim, deg, mat):
    """A few elements of sum-factorized (the 2^3 cube) or dense tables in
    (dim, deg), float32, on the CPU."""
    if kind == "sf":
        mesh, clamp, elev, subd = MESH, [(1, 0), (1, 1), (1, 2)], 1, 1
    elif dim == 2:
        mesh, clamp, elev, subd = BALKEN, [(2, 0), (2, 1)], deg - 1, 1
    else:
        mesh, clamp, elev, subd = (os.path.join(DATA, "two-patch-cube.mesh"),
                                   [(0, 0), (0, 1), (0, 2)], deg - 1, 0)
    prob = mt.build_problem(mesh, elev, subd, mat, clamp, {}, rho_inf=0.5, device="cpu",
                            dtype=torch.float32)
    assert (prob.sf is not None) == (kind == "sf") and prob.dim == dim
    return prob


def _plastic_inputs(prob, rng, amplitude):
    """Random element fields and a random plastic history (the state after
    one plain accumulate_soa at a random F, eqps raised by up to 1e-3): u_el,
    a_el, v_el, w_el, state."""
    mat, dim, E = prob.material, prob.dim, prob.n_el
    tables = (prob.sf["tables"], prob.sf["jinv"]) if prob.sf else (prob.dense["dN_t"],)
    grad = (lambda u: tsw.sf_grad(u, *tables)) if prob.sf else (lambda u: tsw.dense_grad(u, *tables))
    nd = prob.sf["pp1"] ** 3 if prob.sf else prob.dense["dN_t"].shape[0]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    u0, u_el = (f32(amplitude * rng.standard_normal((dim, nd, E))) for _ in range(2))
    a_el, v_el, w_el = (f32(rng.standard_normal((dim, nd, E))) for _ in range(3))
    state = mat.accumulate_soa(soa.add_diag(grad(u0), 1.0),
                               {k: v.clone() for k, v in prob.state0.items()}, 0.05)
    state = {k: v.contiguous() for k, v in state.items()}
    assert float(state["eqps"].max()) > 0.0
    state["eqps"] = state["eqps"] + f32(1e-3 * rng.random(state["eqps"].shape))
    return u_el, a_el, v_el, w_el, state


def _hold_host_sweeps(sw, prob, f, visc, bf16, matvec=True, storage=None, plane_bar=1e-5):
    """The material's residual, assemble (the block in `storage`, default
    the material's own) and (with `matvec`) matvec kernels of the host
    build through the wrappers' own marshalling against the plain versions
    (the J2 family's return at the kernels' 40 trips): residuals and matvec
    at 1e-5 of scale, float32 planes at `plane_bar` of their max, bfloat16 planes
    within one bfloat16 step (2^-7) of the plain float32 planes rounded to
    bfloat16; on dense tables the bfloat16 matvec reads bfloat16 copies of
    dN and N."""
    mat, wq = prob.material, prob.wdet_t
    u_el, a_el, v_el, w_el, state = f
    dt, rho, fac0 = 0.05, float(mat.density), 1e-6
    mu_v = 100.0 if visc else 0.0
    vk = dict(v_el=v_el, mu_v=mu_v) if visc else {}
    c_dtype = torch.bfloat16 if bf16 else torch.float32
    storage = storage or sw.tangent_storage(mat)
    if prob.sf is not None:
        tables = (prob.sf["tables"], prob.sf["jinv"])
        sweep, mv_kernel = sw._sf_sweep, sw._sf_matvec
        plain = (sw.residual_sf_plain, sw.assemble_sf_plain, sw.matvec_sf_plain)
        kind = "sf"
    else:
        tables = (prob.dense["dN_t"], prob.dense["N_t"])
        sweep = sw._dense_sweep
        plain = (sw.residual_dense_plain, sw.assemble_dense_plain, sw.matvec_dense_plain)
        kind = "dense"
    args = (u_el, a_el, state, *tables, wq, mat, dt, rho)
    y = sweep(False, *args, **vk)
    ak = dict(vk, storage=storage, c_dtype=c_dtype)
    y_a, C = sweep(True, *args, **ak)
    with kernel_solver_mode():
        y_p = plain[0](*args, **vk)
        y_ap, C_p = plain[1](*args, **ak)
    assert C.shape[0] == sw.n_planes(storage, prob.dim)
    assert float((y - y_p).abs().max()) <= 1e-5 * float(y_p.abs().max())
    assert float((y_a - y_ap).abs().max()) <= 1e-5 * float(y_ap.abs().max())
    scale = float(C_p.float().abs().max())
    if bf16:
        assert C.dtype == torch.bfloat16
        _, C32 = sweep(True, *args, **dict(ak, c_dtype=torch.float32))
        assert torch.equal(C, C32.to(torch.bfloat16))
        assert float((C.float() - C_p.float()).abs().max()) <= 2.0**-7 * scale
    else:
        assert float((C - C_p).abs().max()) <= plane_bar * scale
    dN = tables[0]
    p = ((prob.sf["pp1"], prob.sf["n_g"]) if kind == "sf"
         else (dN.shape[1], dN.shape[0], dN.shape[2]))  # the tables' shape key
    names = sw.kernel_counters(mat, kind, prob.dim, p, visc, bf16, storage)
    assert sw.LAUNCHES[names[0]] == 1 and sw.LAUNCHES[names[1]] == 1
    if not matvec:
        return C_p
    Cb = C_p.to(c_dtype)
    fm = 50.0 if visc else None
    if kind == "sf":
        mv = mv_kernel(w_el, *tables, wq, Cb, rho, fac0, fm, storage)
    else:
        tables = tuple(t.to(c_dtype) for t in tables)  # the matvec's table streams
        mv = sw._dense_matvec(w_el, *tables, wq, Cb, rho, fac0, storage, fm)
    mv_p = plain[2](w_el, *tables, wq, Cb, rho, fac0, fm, storage=storage)
    assert float((mv - mv_p).abs().max()) <= 1e-5 * float(mv_p.abs().max())
    assert sw.LAUNCHES[sw.matvec_counter(kind, storage, prob.dim, p, visc, bf16)] == 1
    return C_p


J2LIN_CASES = ([("sf", 3, 2, visc, bf16) for visc in (False, True) for bf16 in (False, True)]
               + [("dense", d, p, visc, False) for d, p in DENSE_SHAPES
                  for visc in (False, True)])


@pytest.mark.parametrize(
    "kind, dim, deg, visc, bf16", J2LIN_CASES,
    ids=[f"{k}_{d}d_p{p}{'_visc' if v else ''}{'_bf16' if b else ''}"
         for k, d, p, v, b in J2LIN_CASES])
def test_j2linear_kernels_on_cpu_tensors(host_sweeps, kind, dim, deg, visc, bf16):
    """J2Linear's residual, assemble and matvec of the host build on a few
    elements of each table kind and shape, inviscid and viscous, with a
    float32 or (sf) bfloat16 block, on a random plastic history with a
    deviatoric back stress, against the plain versions; the kernels'
    counters are J2Linear's."""
    prob = _host_problem(kind, dim, deg, _j2_family("J2Linear"))
    f = _plastic_inputs(prob, np.random.default_rng(6), 0.002 if dim == 2 else 0.001)
    tables = (prob.sf["tables"], prob.sf["jinv"]) if prob.sf else (prob.dense["dN_t"],)
    grad = tsw.sf_grad(f[0], *tables) if prob.sf else tsw.dense_grad(f[0], *tables)
    share = float((prob.material._common_soa(soa.add_diag(grad, 1.0), f[4])[3] > 0)
                  .float().mean())
    assert 0.1 < share < 0.9, share
    beta = f[4]["beta"]
    assert float(beta.abs().max()) > 0.0
    assert float(soa.trace(beta).abs().max()) <= 1e-6 * float(beta.abs().max())
    _hold_host_sweeps(host_sweeps, prob, f, visc, bf16)


LAW_CASES = [(name, law, kind) for name in ("J2", "J2Simo", "J2Log")
             for law in ("pow", "voce") for kind in ("sf", "dense")]


@pytest.mark.parametrize("name, law, kind", LAW_CASES,
                         ids=[f"{n}_{law}_{k}" for n, law, k in LAW_CASES])
def test_j2_family_laws_on_cpu_tensors(host_sweeps, name, law, kind):
    """J2, J2Simo and J2Log with the PowerLaw and the Voce law through the
    host build's residual and assemble on a few sum-factorized (3D p = 2) or
    dense (2D p = 3) elements on a random plastic history, against the plain
    versions; the counters carry the law's tag."""
    dim, deg = (3, 2) if kind == "sf" else (2, 3)
    prob = _host_problem(kind, dim, deg, _j2_family(name, law))
    f = _plastic_inputs(prob, np.random.default_rng(7), 0.002 if kind == "sf" else 0.004)
    assert host_sweeps.kernel_tag(prob.material).endswith(f"-{law}")
    _hold_host_sweeps(host_sweeps, prob, f, False, False, matvec=False)


TILE_CASES = [(spans, visc, bf16) for spans in (3, 5) for visc, bf16 in ((False, False),
                                                                          (True, True))]


@pytest.mark.parametrize("spans, visc, bf16", TILE_CASES,
                         ids=[f"{n}^3{'_visc_bf16' if v else ''}" for n, v, _ in TILE_CASES])
def test_j2_sf_tiles_on_cpu_tensors(host_sweeps, spans, visc, bf16):
    """J2 with Johnson-Cook hardening through the host build's sf residual,
    assemble and matvec on a random plastic history, inviscid with a
    float32 block and viscous with a bfloat16 block (the contact press's
    variant), against the plain versions: at 3^3 = 27 elements the residual
    kernel's one tile of 32 is partial, at 5^3 = 125 three full tiles are
    followed by a ragged one of 29 elements."""
    mat = _material("J2")
    prob = mt.build_problem(MESH, 1, 0, mat, [(1, 0), (1, 1), (1, 2)], {}, rho_inf=0.5,
                            device="cpu", dtype=torch.float32, refine_spans=spans)
    assert prob.sf is not None and prob.n_el == spans**3
    f = _plastic_inputs(prob, np.random.default_rng(8), 0.03 / spans)
    F = soa.add_diag(tsw.sf_grad(f[0], prob.sf["tables"], prob.sf["jinv"]), 1.0)
    share = float(prob.material._return_map(F, f[4], 0.05)[4].float().mean())
    assert 0.1 < share < 0.9, share
    _hold_host_sweeps(host_sweeps, prob, f, visc, bf16)


def _press_law(name, viscosity=100.0):
    """J2Simo or J2Log with the contact press's Johnson-Cook law (A 700,
    B 1400), E 1e6, density 1e3 and viscosity."""
    mat = _material(name)
    mat.hardening.A, mat.hardening.B = 700.0, 1400.0
    mat.density, mat.viscosity = 1e3, viscosity
    mat.set_young_poisson(1e6, 0.3)
    return mat


FINITE_CASES = ([("sf", 3, 2, name, visc, bf16) for name in tsw.FULL_KERNELS
                 for visc, bf16 in ((True, False), (True, True), (False, True))]
                + [("dense", d, p, name, True, False) for d, p in DENSE_SHAPES
                   for name in tsw.FULL_KERNELS])


@pytest.mark.parametrize(
    "kind, dim, deg, name, visc, bf16", FINITE_CASES,
    ids=[f"{n}_{k}_{d}d_p{p}{'_visc' if v else ''}{'_bf16' if b else ''}"
         for k, d, p, n, v, b in FINITE_CASES])
def test_finite_viscous_bf16_kernels_on_cpu_tensors(host_sweeps, kind, dim, deg, name, visc,
                                                    bf16):
    """J2Simo's and J2Log's viscous residual, their full assemble viscous or
    with a bfloat16 block and the matvec on it, sf and at every dense shape,
    on a random plastic history of the press's law, against the plain
    versions; the counters are the new instantiations'."""
    prob = _host_problem(kind, dim, deg, _press_law(name))
    f = _plastic_inputs(prob, np.random.default_rng(9), 0.002 if kind == "sf" else 0.004)
    _hold_host_sweeps(host_sweeps, prob, f, visc, bf16)


def _hyper_inputs(prob, rng):
    nd = prob.sf["pp1"] ** 3 if prob.sf else prob.dense["dN_t"].shape[0]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return tuple(f32(s * rng.standard_normal((prob.dim, nd, prob.n_el)))
                 for s in (0.02, 1.0, 1.0, 1.0)) + (None,)


OTHERS = ("J2", "J2Linear", "CompressibleOgdenNeoHookean", "StVenantKirchhoff")
FULL_OTHER_CASES = ([("sf", 3, 2, name, visc, bf16) for name in OTHERS
                     for visc in (False, True) for bf16 in (False, True)]
                    + [("dense", d, p, name, visc, False) for d, p in DENSE_SHAPES
                       for name in OTHERS for visc in (False, True)])


@pytest.mark.parametrize(
    "kind, dim, deg, name, visc, bf16", FULL_OTHER_CASES,
    ids=[f"{n}_{k}_{d}d_p{p}{'_visc' if v else ''}{'_bf16' if b else ''}"
         for k, d, p, n, v, b in FULL_OTHER_CASES])
def test_full_block_of_other_materials_on_cpu_tensors(host_sweeps, kind, dim, deg, name, visc,
                                                      bf16):
    """The full block (81 planes in 3D, 16 in 2D) that J2, J2Linear and the
    hyperelastic materials write on request, sf and at every dense shape,
    inviscid and viscous, float32 and (sf) bfloat16, and the full matvec on
    it, against the plain full planes: J2 and J2Linear on a random plastic
    history, the hyperelastic materials at strains of a few percent."""
    mat = _j2_family(name, "pow") if name.startswith("J2") else _hyper(name, -1.0)
    if name == "J2":
        mat = _material("J2")
        mat.hardening.A = 5.0
    prob = _host_problem(kind, dim, deg, mat)
    rng = np.random.default_rng(10)
    if mat.has_state:
        f = _plastic_inputs(prob, rng, 0.002 if kind == "sf" else 0.004)
    else:
        f = _hyper_inputs(prob, rng)
    _hold_host_sweeps(host_sweeps, prob, f, visc, bf16, storage="full")


def _first_elements(prob, n):
    """The problem restricted to its first n elements (the sweeps are per
    element): tables, w det J and the initial state."""
    import dataclasses

    cut = lambda t: t[..., :n].contiguous()  # noqa: E731
    sf = dense = None
    if prob.sf is not None:
        sf = dict(prob.sf, tables=[cut(t) for t in prob.sf["tables"]], jinv=cut(prob.sf["jinv"]))
    else:
        dense = {k: cut(v) for k, v in prob.dense.items()}
    state0 = None if prob.state0 is None else {k: cut(v) for k, v in prob.state0.items()}
    return dataclasses.replace(prob, n_el=n, sf=sf, dense=dense, wdet_t=cut(prob.wdet_t),
                               state0=state0)


P3_CASES = [(kind, name, visc, bf16) for kind in ("sf", "dense")
            for name, visc, bf16 in (("J2", False, False),
                                     ("CompressibleOgdenNeoHookean", True, True),
                                     ("J2Simo", False, False))]


@pytest.mark.parametrize(
    "kind, name, visc, bf16", P3_CASES,
    ids=[f"{k}_{n}{'_visc' if v else ''}{'_bf16' if b else ''}" for k, n, v, b in P3_CASES])
def test_p3_kernels_on_cpu_tensors(host_sweeps, kind, name, visc, bf16):
    """The p = 3 kernels of the host build (the sf ones of the _p3 sources
    at 4 nodes and 5 Gauss points per axis, the dense (3, 3) ones) on 40
    elements, through the wrappers' own marshalling, against the plain
    versions: J2 on a random plastic history (the return at 40 trips),
    the viscous neo-Hookean with a bfloat16 block (float32 on dense
    tables, whose block is float32 only), J2Simo's full block.  On sf
    tables the residual kernel's 40 elements are one full tile of 32 and
    a ragged one of 8; the counters carry the shape."""
    if name == "J2":
        mat = _material("J2")
        mat.hardening.A = 5.0
    elif name == "J2Simo":
        mat = _press_law("J2Simo", viscosity=-1.0)
    else:
        mat = _hyper(name)
    if kind == "sf":
        prob = mt.build_problem(os.path.join(DATA, "cube-nurbs-3.mesh"), 0, 0, mat,
                                [(1, 0), (1, 1), (1, 2)], {}, rho_inf=0.5, device="cpu",
                                dtype=torch.float32, refine_spans=4)
        assert (prob.sf["pp1"], prob.sf["n_g"], prob.n_q) == (4, 5, 125)
    else:
        prob = mt.build_problem(os.path.join(DATA, "two-patch-cube.mesh"), 2, 0, mat,
                                [(0, 0), (0, 1), (0, 2)], {}, rho_inf=0.5, device="cpu",
                                dtype=torch.float32, refine_spans=3)
        assert prob.dense["dN_t"].shape[:3] == (64, 3, 125)
        bf16 = False
    prob = _first_elements(prob, 40)
    rng = np.random.default_rng(12)
    if mat.has_state:
        f = _plastic_inputs(prob, rng, 0.002 if kind == "sf" else 0.004)
        F = soa.add_diag(tsw.sf_grad(f[0], prob.sf["tables"], prob.sf["jinv"]) if prob.sf
                         else tsw.dense_grad(f[0], prob.dense["dN_t"]), 1.0)
        ret = mat._return_map(F, f[4], 0.05) if name == "J2" else mat._return_map_soa(F, f[4], 0.05)
        share = float(ret[4].float().mean())
        # J2 on both branches of the return; J2Simo (its press law yields at
        # a strain of 7e-4) past yield at nearly every point, as the p = 2
        # kernels' check above holds it
        assert share > 0.1 and (name != "J2" or share < 0.95), share
    else:
        f = _hyper_inputs(prob, rng)
    _hold_host_sweeps(host_sweeps, prob, f, visc, bf16)
    assert host_sweeps.kernel_counters(prob.material, kind, 3, 3, visc, bf16)[0].endswith("@3d_p3")


MATVEC_CASES = [(p, storage, visc, bf16) for p in (2, 3, 4)
                for storage in ("cauchy", "sym", "full")
                for visc in (False, True) for bf16 in (False, True)]


def _hold_sf_matvec(host_sweeps, p, n, storage, visc, bf16, order=-1):
    """The sf matvec of the host build on the first n elements of the
    cube at degree p (quadrature order `order`, -1 the default) against
    matvec_sf_plain at 1e-5 of scale, the block's planes random (the matvec
    is linear in them); the mass, the block's and the viscous terms each
    move the output by more than 10% of its max at these factors."""
    mesh, elev, spans = {2: ("cube-nurbs.mesh", 1, 5), 3: ("cube-nurbs-3.mesh", 0, 4),
                         4: ("cube-nurbs-3.mesh", 1, 4)}[p]
    prob = mt.build_problem(os.path.join(DATA, mesh), elev, 0, _hyper("StVenantKirchhoff"),
                            [(1, 0), (1, 1), (1, 2)], {}, rho_inf=0.5, device="cpu",
                            dtype=torch.float32, refine_spans=spans, quadrature_order=order)
    prob = _first_elements(prob, n)
    assert prob.sf["pp1"] == p + 1
    rng = np.random.default_rng(13)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    w_el = f32(rng.standard_normal((3, (p + 1) ** 3, n)))
    Cb = f32(rng.standard_normal((host_sweeps.n_planes(storage), prob.n_q, n)))
    Cb = Cb.to(torch.bfloat16 if bf16 else torch.float32)
    tables = (prob.sf["tables"], prob.sf["jinv"], prob.wdet_t)
    args = (1e2, 1.0, 1.0 if visc else None)  # rho, fac0, fac1 mu_v
    mv = host_sweeps._sf_matvec(w_el, *tables, Cb, *args, storage)
    mv_p = host_sweeps.matvec_sf_plain(w_el, *tables, Cb, *args, storage=storage)
    assert float((mv - mv_p).abs().max()) <= 1e-5 * float(mv_p.abs().max())
    for k in range(3 if visc else 2):
        off = tuple(None if i == k == 2 else 0.0 if i == k else a for i, a in enumerate(args))
        mv0 = host_sweeps.matvec_sf_plain(w_el, *tables, Cb, *off, storage=storage)
        assert float((mv_p - mv0).abs().max()) > 0.1 * float(mv_p.abs().max())
    key = (p + 1, prob.sf["tables"][0].shape[0])  # (p + 1, Gauss points per axis)
    name = host_sweeps.matvec_counter("sf", storage, 3, key, visc, bf16)
    assert host_sweeps.LAUNCHES[name] == 1
    return prob


@pytest.mark.parametrize(
    "p, storage, visc, bf16", MATVEC_CASES,
    ids=[f"p{p}_{s}{'_visc' if v else ''}{'_bf16' if b else ''}"
         for p, s, v, b in MATVEC_CASES])
def test_sf_matvec_tiles_on_cpu_tensors(host_sweeps, p, storage, visc, bf16):
    """The sf matvec of the host build with every storage, inviscid and
    viscous, a float32 or bfloat16 block, against matvec_sf_plain at 1e-5 of
    scale, on a ragged last tile.  At p = 2 and p = 3 the tiled kernel (one
    thread per element and point slot, the points' fluxes reduced by the
    nodes' owners through shared memory; 125 = 3 x 32 + 29 elements at
    p = 2, 45 = 32 + 13 at p = 3); at p = 4 the kernel that contracts axis
    by axis (sf_axis_matvec_kernel: tiles of 16 elements; 45 = 2 x 16 + 13
    elements of cube-nurbs-3.mesh elevated by 1).  The block's planes are
    random (the matvec is linear in them)."""
    n = {2: 125, 3: 45, 4: 45}[p]
    assert n % 32 != 0 and n % 16 != 0
    _hold_sf_matvec(host_sweeps, p, n, storage, visc, bf16)


# p = 4 at quadrature order 14, 8 Gauss points per axis: 16 elements of the
# axis matvec take more shared memory than a block may have, so its tile is
# 8 elements
AXIS8_CASES = [("cauchy", False, False), ("sym", True, True), ("full", True, False),
               ("full", False, True)]


@pytest.mark.parametrize(
    "storage, visc, bf16", AXIS8_CASES,
    ids=[f"{s}{'_visc' if v else ''}{'_bf16' if b else ''}" for s, v, b in AXIS8_CASES])
def test_sf_axis_matvec_at_8_gauss_points_on_cpu_tensors(host_sweeps, storage, visc, bf16):
    """The p = 4 sf matvec at 8 Gauss points per axis (SfShape<5, 8>: 512
    points, tiles of 8 elements, 138.2 KB of shared memory a block, within
    the 227 KB the host build's launch allows as the card does) against
    matvec_sf_plain at 1e-5 of scale, on 21 = 2 x 8 + 5 elements: each
    storage, inviscid and viscous, float32 or bfloat16 block."""
    prob = _hold_sf_matvec(host_sweeps, 4, 21, storage, visc, bf16, order=14)
    assert prob.n_q == 8**3 and prob.sf["tables"][0].shape[:2] == (8, 5)


# the sf residual and assemble from p = 4 on (sf_axis_residual_kernel):
# (shape, material, viscous, bfloat16 block, storage; None the material's)
AXIS_RESIDUAL_CASES = [((5, 6), "J2", False, False, None),
                       ((5, 6), "J2Linear", True, False, None),
                       ((5, 6), "CompressibleOgdenNeoHookean", True, True, None),
                       ((5, 6), "StVenantKirchhoff", False, False, None),
                       ((5, 6), "J2Simo", False, False, None),
                       ((5, 6), "J2Log", False, False, None),
                       ((5, 6), "J2", False, True, "full"),
                       ((5, 8), "J2", True, True, None),
                       ((5, 8), "J2Log", False, False, None)]


def _axis_material(name):
    """J2 (Johnson-Cook, A 5) and J2Linear yielding at strains of a few
    1e-3, J2Simo and J2Log with the press's law, the hyperelastic
    materials."""
    if name == "J2":
        mat = _material("J2")
        mat.hardening.A = 5.0
        return mat
    if name == "J2Linear":
        return _j2_family(name)
    if name in tsw.FULL_KERNELS:
        return _press_law(name, viscosity=-1.0)
    return _hyper(name)


@pytest.mark.parametrize(
    "key, name, visc, bf16, storage", AXIS_RESIDUAL_CASES,
    ids=[f"{k[0]}_{k[1]}_{n}{'_visc' if v else ''}{'_bf16' if b else ''}{'_' + s if s else ''}"
         for k, n, v, b, s in AXIS_RESIDUAL_CASES])
def test_sf_axis_residual_on_cpu_tensors(host_sweeps, libs, key, name, visc, bf16, storage):
    """The sf residual and assemble from p = 4 on (sf_axis_residual_kernel:
    axis by axis, tiles of 16 elements at SfShape<5, 6>, 8 viscous; of 8
    at SfShape<5, 8>, p = 4 at 8 Gauss points per axis, 4 viscous) of the
    host build through the wrappers' own marshalling against the plain
    versions, on a ragged last tile (45 = 2 x 16 + 13 elements of
    cube-nurbs-3.mesh elevated by 1; 21 = 2 x 8 + 5 at (5, 8)): J2 and
    J2Linear on a random plastic history, the hyperelastic materials at
    strains of a few percent, J2Simo's and J2Log's full block (J2Log with one
    point past its fast log series' range: both launches run, the deep one
    for every point), the full block of J2.  Residuals at 1e-5 of scale,
    float32 planes at 1e-4 of their max (the card's bar: one group for
    the full block), bfloat16 planes within 2^-7; the matvec on the plain
    block at 1e-5."""
    mat = _axis_material(name)
    n = {(5, 6): 45, (5, 8): 21}[key]
    prob = mt.build_problem(os.path.join(DATA, "cube-nurbs-3.mesh"), 1, 0, mat,
                            [(1, 0), (1, 1), (1, 2)], {}, rho_inf=0.5, device="cpu",
                            dtype=torch.float32, refine_spans=4,
                            quadrature_order=14 if key == (5, 8) else -1)
    prob = _first_elements(prob, n)
    assert (prob.sf["pp1"], prob.sf["n_g"]) == key
    rng = np.random.default_rng(25)
    if mat.has_state:
        f = _plastic_inputs(prob, rng, 0.002)
    else:
        f = _hyper_inputs(prob, rng)
    if name == "J2Log":
        f = (*f[:4], _stretch_one_point(f[4]))
        deep = getattr(libs("sf", key), "mimi_logm_deep_sf_finite")
        deep.argtypes = [ctypes.c_void_p]
        count = ctypes.c_longlong(0)
        assert deep(ctypes.byref(count)) == 0
        n0 = count.value
    _hold_host_sweeps(host_sweeps, prob, f, visc, bf16, storage=storage, plane_bar=1e-4)
    if name == "J2Log":  # the residual's and the assemble's deep launches ran
        assert deep(ctypes.byref(count)) == 0 and count.value == n0 + 2


TILED_MATVEC_CASES = ([((3, 64, 125), storage, visc, bf16) for storage in ("sym", "cauchy", "full")
                       for visc in (False, True) for bf16 in (False, True)]
                      + [(key, storage, visc, bf16) for key in ((2, 25, 36), (3, 125, 216))
                         for storage, visc, bf16 in (("sym", False, False), ("full", True, True))])


@pytest.mark.parametrize(
    "key, storage, visc, bf16", TILED_MATVEC_CASES,
    ids=[f"{'_'.join(map(str, k))}_{s}{'_visc' if v else ''}{'_bf16' if b else ''}"
         for k, s, v, b in TILED_MATVEC_CASES])
def test_dense_tiled_matvec_on_cpu_tensors(host_sweeps, key, storage, visc, bf16):
    """The tiled dense matvec of the host build (dense_matvec_tile_kernel:
    the nodes' owners load dN and N once a point, the gradient's partials
    reduced through shared memory) against matvec_dense_plain at 1e-5 of
    scale, on 40 = 32 + 8 elements (a ragged last tile of the kernel's 32):
    every storage, inviscid and viscous, float32 or bfloat16 block and
    tables at (3, 64, 125) (the two-patch cube elevated by 2), the sym
    float32 and viscous full bfloat16 ones at (2, 25, 36) (the cantilever
    elevated by 3) and (3, 125, 216) (the cube elevated by 3).  The planes
    are random; the mass, the block's and the viscous terms each move the
    output by more than 10% of its max."""
    if key[0] == 2:
        prob = mt.build_problem(BALKEN, 3, 3, _hyper("StVenantKirchhoff"), [(2, 0), (2, 1)], {},
                                rho_inf=0.5, device="cpu", dtype=torch.float32)
    else:
        prob = mt.build_problem(os.path.join(DATA, "two-patch-cube.mesh"), {64: 2, 125: 3}[key[1]], 0,
                                _hyper("StVenantKirchhoff"), [(0, 0), (0, 1), (0, 2)], {},
                                rho_inf=0.5, device="cpu", dtype=torch.float32, refine_spans=3)
    prob = _first_elements(prob, 40)
    assert (prob.dim, *prob.dense["dN_t"].shape[:1], prob.n_q) == key
    ct = torch.bfloat16 if bf16 else torch.float32
    dN, N = prob.dense["dN_t"].to(ct), prob.dense["N_t"].to(ct)
    rng = np.random.default_rng(16)
    w_el = torch.tensor(rng.standard_normal((key[0], key[1], 40)), dtype=torch.float32)
    Cb = torch.tensor(rng.standard_normal((host_sweeps.n_planes(storage, key[0]), key[2], 40)),
                      dtype=torch.float32).to(ct)
    args = (1e2, 1.0, 1.0 if visc else None)  # rho, fac0, fac1 mu_v
    mv = host_sweeps._dense_matvec(w_el, dN, N, prob.wdet_t, Cb, args[0], args[1], storage,
                                   args[2])
    mv_p = host_sweeps.matvec_dense_plain(w_el, dN, N, prob.wdet_t, Cb, *args, storage=storage)
    assert float((mv - mv_p).abs().max()) <= 1e-5 * float(mv_p.abs().max())
    for k in range(3 if visc else 2):
        off = tuple(None if i == k == 2 else 0.0 if i == k else a for i, a in enumerate(args))
        mv0 = host_sweeps.matvec_dense_plain(w_el, dN, N, prob.wdet_t, Cb, *off, storage=storage)
        assert float((mv_p - mv0).abs().max()) > 0.1 * float(mv_p.abs().max())
    name = host_sweeps.matvec_counter("dense", storage, key[0], key, visc, bf16)
    assert host_sweeps.LAUNCHES[name] == 1


# one bfloat16 instantiation of each bfloat16 dense source: (source, material,
# dim, degree, viscous)
DENSE_BF16_CASES = [("sweeps_dense_bf16.cu", "CompressibleOgdenNeoHookean", 2, 2, True),
                    ("sweeps_dense_j2_bf16.cu", "J2", 3, 2, False),
                    ("sweeps_dense_finite_bf16.cu", "J2Simo", 2, 3, True)]


@pytest.mark.parametrize("source, name, dim, deg, visc", DENSE_BF16_CASES,
                         ids=[c[0].split(".")[0] for c in DENSE_BF16_CASES])
def test_dense_bf16_kernels_on_cpu_tensors(host_sweeps, source, name, dim, deg, visc):
    """The bfloat16 dense assemble and matvec of each bfloat16 source
    (sweeps_dense_bf16.cu: the neo-Hookean sym block, viscous, 2D p = 2;
    sweeps_dense_j2_bf16.cu: J2's Cauchy block, 3D p = 2;
    sweeps_dense_finite_bf16.cu: J2Simo's full block, viscous, 2D p = 3)
    against their plain versions: the assemble's residual at 1e-5 of scale,
    its block equal to the float32 kernel's rounded to nearest even and
    within 2^-7 of the plain planes' max, the matvec on bfloat16 copies of
    dN and N at 1e-5 of scale; the counters are the `_bf16` entry points'."""
    assert source in SOURCES
    if name.startswith("J2"):
        mat = _j2_family(name, "pow") if name == "J2" else _press_law(name)
        prob = _host_problem("dense", dim, deg, mat)
        f = _plastic_inputs(prob, np.random.default_rng(12), 0.004)
    else:
        prob = _host_problem("dense", dim, deg, _hyper(name))
        f = _hyper_inputs(prob, np.random.default_rng(12))
    _hold_host_sweeps(host_sweeps, prob, f, visc, True)


def _new_shape_problem(key, mat):
    """A few elements of the tables of a shape outside the defaults, float32
    on the CPU: sf (2, 3) p = 1 at 4^3, (5, 6) p = 4 at 2^3, (3, 3) p = 2
    at quadrature order 5 at 3^3; dense (2, 25, 36) 2D p = 4 at 2^2,
    (3, 8, 27) 3D p = 1 at 2 x 2^3, (3, 125, 216) 3D p = 4 at 2 x 1^3,
    (2, 12, 20) 2D degrees [3, 2] at 2^2, (3, 343, 512) 3D p = 6 at
    2 x 1^3 (the tiled residual's a read from device memory: u and a
    staged would pass a block's 227 KB)."""
    from mimi_tpu_torch.nurbs.mesh_io import read_mfem_nurbs_mesh, single_patch_mesh
    from mimi_tpu_torch.nurbs.topology import build_patch_from_mesh

    cube3, two = os.path.join(DATA, "cube-nurbs-3.mesh"), os.path.join(DATA, "two-patch-cube.mesh")
    clamp3, clamp2 = [(1, 0), (1, 1), (1, 2)], [(2, 0), (2, 1)]
    if key == (2, 12, 20):
        template = read_mfem_nurbs_mesh(BALKEN)
        patch = build_patch_from_mesh(template)[0]
        patch.elevate_axis(0, 2)
        patch.elevate_axis(1, 1)
        mixed = single_patch_mesh(template, patch.degrees, patch.knot_vectors,
                                  patch.control_points, patch.weights)
    mesh, elevate, subdivide, spans, order, clamp = {
        (2, 3): (MESH, 0, 0, 4, -1, clamp3), (5, 6): (cube3, 1, 0, 2, -1, clamp3),
        (3, 3): (MESH, 1, 0, 3, 5, clamp3), (2, 25, 36): (BALKEN, 3, 1, None, -1, clamp2),
        (3, 8, 27): (two, 0, 0, 2, -1, [(0, 0), (0, 1), (0, 2)]),
        (3, 125, 216): (two, 3, 0, 1, -1, [(0, 0), (0, 1), (0, 2)]),
        (3, 343, 512): (two, 5, 0, 1, -1, [(0, 0), (0, 1), (0, 2)]),
        (2, 12, 20): (None, 0, 1, None, -1, clamp2),
    }[key]
    prob = mt.build_problem(mixed if mesh is None else mesh, elevate, subdivide, mat, clamp, {},
                            rho_inf=0.5, device="cpu", dtype=torch.float32, refine_spans=spans,
                            quadrature_order=order)
    got = ((prob.sf["pp1"], prob.sf["n_g"]) if len(key) == 2
           else (prob.dim, prob.dense["dN_t"].shape[0], prob.n_q))
    assert got == key
    return prob


NEW_SHAPE_CASES = [(key, name, visc, bf16)
                   for key in ((2, 3), (5, 6), (3, 3), (2, 25, 36), (3, 8, 27), (3, 125, 216),
                               (2, 12, 20), (3, 343, 512))
                   for name, visc, bf16 in (("J2", False, False),
                                            ("CompressibleOgdenNeoHookean", True, True),
                                            ("J2Simo", False, False))]


@pytest.mark.parametrize(
    "key, name, visc, bf16", NEW_SHAPE_CASES,
    ids=[f"{'_'.join(map(str, k))}_{n}{'_visc' if v else ''}{'_bf16' if b else ''}"
         for k, n, v, b in NEW_SHAPE_CASES])
def test_new_shape_kernels_on_cpu_tensors(host_sweeps, key, name, visc, bf16):
    """The kernels of the host build at shapes outside the defaults (each
    built from the sources at that shape, HOST_SHAPES), through the
    wrappers' own marshalling, against the plain versions: J2 on a random
    plastic history (the return at 40 trips), the viscous neo-Hookean with a
    bfloat16 block (on dense tables the bfloat16 assemble and the matvec on
    bfloat16 copies of dN and N), J2Simo's full block; the counters carry
    the shape (`_shape_suffix`)."""
    if name == "J2":
        mat = _material("J2")
        mat.hardening.A = 5.0
    elif name == "J2Simo":
        mat = _press_law("J2Simo", viscosity=-1.0)
    else:
        mat = _hyper(name)
    prob = _new_shape_problem(key, mat)
    rng = np.random.default_rng(14)
    if mat.has_state:
        f = _plastic_inputs(prob, rng, 0.002 if len(key) == 2 else 0.004)
    else:
        f = _hyper_inputs(prob, rng)
    _hold_host_sweeps(host_sweeps, prob, f, visc, bf16)
    kind = "sf" if len(key) == 2 else "dense"
    assert host_sweeps.kernel_counters(prob.material, kind, prob.dim, key)[0].endswith(
        host_sweeps._shape_suffix(prob.dim, key))


def test_fused_kernels_at_a_new_shape_on_cpu_tensors(libs):
    """The fused neo-Hookean residual and matrix-free tangent apply of the
    host build at (3, 125, 216) (3D p = 4: the residual on dense_tile_kernel
    with 8 point slots, the tangent apply on 16 owner warps and a flux warp)
    on 2 elements against their plain versions at 1e-5 / 1e-4 of scale, and
    their wrong-shape call refused."""
    from mimi_tpu_torch.ops import fused_neohookean as fused

    mat = _hyper("CompressibleOgdenNeoHookean", -1.0)
    prob = _new_shape_problem((3, 125, 216), mat)
    dN, wq, E = prob.dense["dN_t"], prob.wdet_t, prob.n_el
    rng = np.random.default_rng(15)
    u_el, w_el = (torch.tensor(s * rng.standard_normal((3, 125, E)), dtype=torch.float32)
                  for s in (0.02, 1.0))
    lib = libs("dense", (3, 125, 216))
    lam, mu = ctypes.c_float(mat.lambda_), ctypes.c_float(mat.mu)
    shape = (ctypes.c_int(3), ctypes.c_int(125), ctypes.c_int(216), ctypes.c_longlong(E),
             ctypes.c_void_p(None))
    r, y = torch.empty(3, 125, E), torch.empty(3, 125, E)
    assert lib.mimi_neohookean_residual(_ptr(u_el), _ptr(dN), _ptr(wq), _ptr(r), lam, mu,
                                        *shape) == 0
    assert lib.mimi_neohookean_tangent_apply(_ptr(u_el), _ptr(w_el), _ptr(dN), _ptr(wq), _ptr(y),
                                             lam, mu, *shape) == 0
    r_p = fused.neohookean_residual_plain(u_el, dN, wq, mat.lambda_, mat.mu)
    y_p = fused.neohookean_tangent_apply_plain(u_el, w_el, dN, wq, mat.lambda_, mat.mu)
    assert float((r - r_p).abs().max()) <= 1e-5 * float(r_p.abs().max())
    assert float((y - y_p).abs().max()) <= 1e-4 * float(y_p.abs().max())
    wrong = (ctypes.c_int(3), ctypes.c_int(27), ctypes.c_int(64), ctypes.c_longlong(E),
             ctypes.c_void_p(None))
    assert lib.mimi_neohookean_residual(_ptr(u_el), _ptr(dN), _ptr(wq), _ptr(r), lam, mu,
                                        *wrong) != 0


# the dense shapes that the finite-strain drives run: 3D p = 2, the golden
# cantilever's 2D p = 3, the 2D p = 2 drives; and 3D p = 5, where the
# tile's staged fields would pass the 227 KB a block may have (the host
# stub refuses such a launch, as the card does)
FINITE_TILE_KEYS = ((3, 27, 64), (2, 16, 25), (2, 9, 16), (3, 216, 343))
FINITE_TILE_CASES = [(key, name, visc, bf16) for key in FINITE_TILE_KEYS
                     for name in tsw.FULL_KERNELS for visc in (False, True)
                     for bf16 in (False, True)]


def _finite_tile_problem(key, mat, n=40):
    """The first n elements of dense tables at `key`: the two-patch cube
    (2 x 3^3 elements) or the golden cantilever's mesh (8^2 elements) at
    the key's degree; 40 = one tile of 32 and a ragged one of 8."""
    dim, nd, _ = key
    if dim == 3:
        elevate = round(nd ** (1 / 3)) - 2
        prob = mt.build_problem(os.path.join(DATA, "two-patch-cube.mesh"), elevate, 0, mat,
                                [(0, 0), (0, 1), (0, 2)], {}, rho_inf=0.5, device="cpu",
                                dtype=torch.float32, refine_spans=3)
    else:
        prob = mt.build_problem(BALKEN, round(nd**0.5) - 2, 3, mat, [(2, 0), (2, 1)], {},
                                rho_inf=0.5, device="cpu", dtype=torch.float32)
    assert tuple(prob.dense["dN_t"].shape[:3]) == (nd, dim, key[2])
    return _first_elements(prob, n)


@pytest.mark.parametrize(
    "key, name, visc, bf16", FINITE_TILE_CASES,
    ids=[f"{n}_{k[0]}_{k[1]}_{k[2]}{'_visc' if v else ''}{'_bf16' if b else ''}"
         for k, n, v, b in FINITE_TILE_CASES])
def test_dense_finite_point_slots_on_cpu_tensors(host_sweeps, key, name, visc, bf16):
    """J2Simo's and J2Log's dense residual and assemble of the host build
    (dense_slot_kernel: one thread per element and point slot, the
    tangent's columns dealt over the warps) at the driven shapes and 3D p = 5,
    inviscid and viscous, with a float32 or bfloat16 block, on 40 elements
    (a full tile and a ragged one) of a random plastic history of the
    press's law, against the plain versions: residuals at 1e-5 of scale,
    float32 planes at 1e-5 of their max (at p = 5 the card's bar, 1e-4:
    over its 13,720 points J2Simo's body, cbrtf against torch's x ** (1/3),
    rounds up to 1.2e-5 from the plain version's, and both sit 5e-5 from
    float64), bfloat16 planes within 2^-7."""
    prob = _finite_tile_problem(key, _press_law(name))
    f = _plastic_inputs(prob, np.random.default_rng(16), 0.002 if key[0] == 3 else 0.004)
    _hold_host_sweeps(host_sweeps, prob, f, visc, bf16, matvec=False,
                      plane_bar=1e-4 if key == (3, 216, 343) else 1e-5)


def _stretch_one_point(state, e=0, q=0):
    """J2Log's history with Fp^-1 = diag(20, 1(, 1)) at point q of element
    e: that point's series argument leaves the fast range (||X||_F 0.59 in
    2D, 0.79 in 3D), not the deep one."""
    st = {k: v.clone() for k, v in state.items()}
    dim = st["Fp_inv"].shape[0]
    st["Fp_inv"][:, :, q, e] = torch.diag(torch.tensor([20.0] + [1.0] * (dim - 1)))
    return st


def _later_elements(x):
    """x without its element 0 (the last axis of every tensor), through
    dicts and lists; anything without a shape passes as it is."""
    if isinstance(x, dict):
        return {k: _later_elements(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_later_elements(v) for v in x]
    return x[..., 1:].contiguous() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("kind", ["sf", "dense"])
def test_j2log_sweeps_take_one_log_series(host_sweeps, libs, kind):
    """J2Log's residual and assemble of the host build, sf (3D p = 2, 8
    elements) and dense (2D p = 3, 40 elements), on a random plastic
    history with one point of the batch past the log series' fast range:
    the kernels take the deep series at every point, as the plain version
    does for the batch (one decision a sweep, the reference's lax.cond).
    Every output (that point's too) is held against the plain version at
    1e-5 of its scale, and at the in-range elements 10 times closer to the
    plain version's deep series than its fast series is (the plain version
    on those elements alone, all in range), so that a kernel that decides
    per point fails.  The device counter of deep sweeps counts both sweeps,
    and none on the batch without the point."""
    mat = _press_law("J2Log", viscosity=-1.0)
    if kind == "sf":
        prob = _host_problem("sf", 3, 2, mat)
        lib, getter = libs("sf", (3, 4)), "mimi_logm_deep_sf_finite"
    else:
        prob = _finite_tile_problem((2, 16, 25), mat)
        lib, getter = libs("dense", (2, 16, 25)), "mimi_logm_deep_dense_finite"
    fn = getattr(lib, getter)
    fn.argtypes = [ctypes.c_void_p]
    count = ctypes.c_longlong(0)

    def deep_sweeps():
        assert fn(ctypes.byref(count)) == 0
        return count.value

    u_el, a_el, _, _, state = _plastic_inputs(prob, np.random.default_rng(17), 0.004)
    tables = ((prob.sf["tables"], prob.sf["jinv"]) if kind == "sf"
              else (prob.dense["dN_t"], prob.dense["N_t"]))
    sweep = host_sweeps._sf_sweep if kind == "sf" else host_sweeps._dense_sweep
    plain = ((host_sweeps.residual_sf_plain, host_sweeps.assemble_sf_plain) if kind == "sf"
             else (host_sweeps.residual_dense_plain, host_sweeps.assemble_dense_plain))
    dt, rho = 0.05, float(mat.density)
    n0 = deep_sweeps()
    in_range = (u_el, a_el, state, *tables, prob.wdet_t, mat, dt, rho)
    sweep(False, *in_range)
    sweep(True, *in_range)
    assert deep_sweeps() == n0
    args = (u_el, a_el, _stretch_one_point(state), *tables, prob.wdet_t, mat, dt, rho)
    outs = (sweep(False, *args), *sweep(True, *args))
    assert deep_sweeps() == n0 + 2
    later = [_later_elements(a) for a in args]
    with kernel_solver_mode():
        refs = (plain[0](*args), *plain[1](*args))
        fast = (plain[0](*later), *plain[1](*later))
    for got, ref, alt in zip(outs, refs, fast):
        assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(ref).all())
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-5 * scale
        # at the in-range elements (element 0 holds the stretched point,
        # NaN in the fast series) the kernel is 10 times closer to the deep
        # series than the fast series is
        err = float((got[..., 1:] - ref[..., 1:]).abs().max())
        gap = float((alt - ref[..., 1:]).abs().max())
        assert 10.0 * err < gap, (err / scale, gap / scale)


@pytest.mark.parametrize("kind", ["sf", "dense"])
@pytest.mark.parametrize("name", ["J2Simo", "J2Log"])
def test_finite_planes_at_a_subnormal_q_on_cpu_tensors(host_sweeps, name, kind):
    """J2Simo's and J2Log's residual and assemble of the host build, sf (3D
    p = 2, 8 elements) and dense (3, 27, 64) (8 elements), at u = 0 with the
    history J2Log's Fp^-1 (J2Simo's F_old) = I + 1e-23 e_01 at the even
    elements and I plus a seeded draw of the same size at the odd ones:
    every point elastic, q ~ 1e-20, q^2 subnormal in float32, where the flow
    direction's derivative 1.5 q' / q^2 overflows.  The planes are finite and
    equal to the plain version's at 1e-4 of their max, the residual at 1e-5
    of scale."""
    mat = _press_law(name, viscosity=-1.0)
    if kind == "sf":
        prob = _host_problem("sf", 3, 2, mat)
        tables, nd = (prob.sf["tables"], prob.sf["jinv"]), 27
        sweep, plain = host_sweeps._sf_sweep, host_sweeps.assemble_sf_plain
    else:
        prob = _finite_tile_problem((3, 27, 64), mat, n=8)
        tables, nd = (prob.dense["dN_t"], prob.dense["N_t"]), 27
        sweep, plain = host_sweeps._dense_sweep, host_sweeps.assemble_dense_plain
    E, nq = prob.n_el, prob.n_q
    shear = np.zeros((3, 3, nq, E), np.float32)
    shear[0, 1, :, ::2] = 1e-23
    shear[:, :, :, 1::2] = 1e-23 * np.random.default_rng(26).standard_normal((3, 3, nq, E // 2))
    state = {k: v.clone() for k, v in prob.state0.items()}
    leaf = "Fp_inv" if name == "J2Log" else "F_old"
    state[leaf] = state[leaf] + torch.tensor(shear)
    u_el = torch.zeros(3, nd, E)
    a_el = torch.tensor(np.random.default_rng(27).standard_normal((3, nd, E)), dtype=torch.float32)
    args = (u_el, a_el, state, *tables, prob.wdet_t, mat, 0.05, float(mat.density))
    y, C = sweep(True, *args)
    with kernel_solver_mode():
        y_p, C_p = plain(*args)
    assert bool(torch.isfinite(C_p).all()) and bool(torch.isfinite(C).all())
    assert float((y - y_p).abs().max()) <= 1e-5 * float(y_p.abs().max())
    assert float((C - C_p).abs().max()) <= 1e-4 * float(C_p.abs().max())


# dense_residual_kernel (one thread per element, the element's output sums
# in registers) on the material of the included source, built beside that
# source's point-slot kernels: the design dense_slot_kernel replaced, to
# hold the point slots to it bit by bit (and 3D J2's dense_ring_kernel,
# which replaced it up to 27 dofs, inviscid)
ONE_THREAD = r"""
#include <type_traits>
#include "@SOURCE@"

extern "C" int one_thread_sweep(const float* u_el, const float* a_el, const float* dN,
                                const float* N, const float* wq, const float* s0,
                                const float* s1, const float* s2, const float* s3, float* out,
                                float* cout, int tangent, int full, J2Params p, int material,
                                long long E) {
  constexpr int DIM = Dense::DIM;
  const auto go = [&](const auto& m, auto store) {
    using Mat = std::decay_t<decltype(m)>;
    using Store = decltype(store);
    if (tangent)
      return launch_dense_residual<Mat, Store, Dense, true>(u_el, a_el, dN, N, wq, out, cout, m,
                                                            p.rho, E, nullptr);
    return launch_dense_residual<Mat, Store, Dense, false>(u_el, a_el, dN, N, wq, out, cout, m,
                                                           p.rho, E, nullptr);
  };
  @MATERIALS@
}
"""
ONE_THREAD_MATERIALS = {
    "sweeps_dense_j2.cu": """if (material == 0) {
    const DenseJ2<DIM, false> m{p, s0, s1, s2, s3};
    return full ? go(m, FullStorage<DIM>{}) : go(m, CauchyStorage<DIM>{});
  }
  const DenseJ2<DIM, true> m{p, s0, s1, s2, s3};
  return full ? go(m, FullStorage<DIM>{}) : go(m, CauchyStorage<DIM>{});""",
    "sweeps_dense_finite.cu": """J2SimoMat<DIM> m;
  m.p = p;
  m.be_old = s0;
  m.F_old = s1;
  m.eqps = s2;
  m.temp = s3;
  return go(m, FullStorage<DIM>{});""",
}


@pytest.fixture(scope="module")
def one_thread(built):
    """one_thread(source, key): the host build of ONE_THREAD on `source` at
    the dense shape `key`, by default the golden cantilever's (2, 16, 25)."""
    dest, loaded = built[0], {}

    def get(source, key=(2, 16, 25)):
        if (source, key) not in loaded:
            tag = f"{source}_{'_'.join(map(str, key))}"
            src = os.path.join(dest, f"one_thread_{tag}.cpp")
            with open(src, "w") as f:
                f.write(ONE_THREAD.replace("@SOURCE@", source).replace(
                    "@MATERIALS@", ONE_THREAD_MATERIALS[source]))
            so = os.path.join(dest, f"one_thread_{tag}.so")
            r = subprocess.run(["g++", *CXX, *kbuild.defines("dense", key), "-shared",
                                "-I", STUB, "-I", dest, "-o", so, src],
                               capture_output=True, text=True)
            assert r.returncode == 0, r.stdout + r.stderr
            lib = ctypes.CDLL(so)
            lib.one_thread_sweep.argtypes = ([ctypes.c_void_p] * 11
                                             + [ctypes.c_int, ctypes.c_int, tsw._J2Params,
                                                ctypes.c_int, ctypes.c_longlong])
            lib.one_thread_sweep.restype = ctypes.c_int
            loaded[(source, key)] = lib
        return loaded[(source, key)]

    return get


def _plastic_share(mat, F, state):
    """The share of points on the plastic branch of a J2-family material's
    plain return map at F."""
    if mat.name() == "J2Linear":
        return float((mat._common_soa(F, state)[3] > 0).float().mean())
    ret = mat._return_map(F, state, 0.05) if mat.name() == "J2" else mat._return_map_soa(
        F, state, 0.05)
    return float(ret[4].float().mean())


SLOT_CASES = [("J2", None, "cauchy"), ("J2", None, "full"), ("J2", "pow", "cauchy"),
              ("J2", "voce", "cauchy"), ("J2Simo", None, "full")]


@pytest.mark.parametrize("name, law, storage", SLOT_CASES,
                         ids=[f"{n}{'_' + law if law else ''}_{s}" for n, law, s in SLOT_CASES])
def test_dense_point_slots_equal_the_one_thread_kernel_on_cpu_tensors(host_sweeps, one_thread,
                                                                     name, law, storage):
    """dense_slot_kernel's residual and assemble at the golden cantilever's
    (2, 16, 25), on 40 elements (a full tile of 32 and a ragged one of 8) of
    a random plastic history: J2 (Johnson-Cook, yield stress 5; PowerLaw;
    Voce) with its Cauchy block and (Johnson-Cook) the full one, J2Simo (the
    press's law) with the full one.  Against the plain versions at the
    smoke's bars, and equal to the bit to the one-thread kernel
    (dense_residual_kernel) on the same material: F, P, each node's sums in
    q order and the planes are formed with the same operations, J2's
    closed-form block stored in the float pass, J2Simo's columns dealt as
    forward-mode passes over the warps.  So J2Simo's outputs are what the
    point slots gave it before J2 joined the template, and J2's what one
    thread per element gave it."""
    if name == "J2Simo":
        mat = _press_law(name, viscosity=-1.0)
    elif law:
        mat = _j2_family(name, law)
    else:
        mat = _material("J2")
        mat.hardening.A = 5.0
    prob = _finite_tile_problem((2, 16, 25), mat)
    f = _plastic_inputs(prob, np.random.default_rng(21), 0.004)
    u_el, a_el, _, _, state = f
    dN, N, wq, E = prob.dense["dN_t"], prob.dense["N_t"], prob.wdet_t, prob.n_el
    assert E == 40
    share = _plastic_share(mat, soa.add_diag(tsw.dense_grad(u_el, dN), 1.0), state)
    assert 0.05 < share, share
    _hold_host_sweeps(host_sweeps, prob, f, False, False, matvec=False, storage=storage)
    rho = float(mat.density)
    args = (u_el, a_el, state, dN, N, wq, mat, 0.05, rho)
    y = host_sweeps._dense_sweep(False, *args)
    y_a, C = host_sweeps._dense_sweep(True, *args, storage=storage)
    _, prm, mat_id, st = tsw._material_args(mat, state, 0.05, rho, 2, 25, E, torch.device("cpu"),
                                            "dense")
    lib = one_thread("sweeps_dense_finite.cu" if name == "J2Simo" else "sweeps_dense_j2.cu")
    y1, y1_a, C1 = torch.empty_like(y), torch.empty_like(y_a), torch.empty_like(C)
    head = (_ptr(u_el), _ptr(a_el), _ptr(dN), _ptr(N), _ptr(wq), *st)
    full = int(storage == "full")
    assert lib.one_thread_sweep(*head, _ptr(y1), _ptr(None), 0, full, prm, mat_id, E) == 0
    assert lib.one_thread_sweep(*head, _ptr(y1_a), _ptr(C1), 1, full, prm, mat_id, E) == 0
    assert torch.equal(y, y1) and torch.equal(y_a, y1_a) and torch.equal(C, C1)


RESIDUAL_TILE_CASES = [(key, name, visc, bf16) for key in ((3, 64, 125), (2, 25, 36))
                       for name, visc, bf16 in (("CompressibleOgdenNeoHookean", False, False),
                                                ("CompressibleOgdenNeoHookean", True, True),
                                                ("J2Linear", False, False),
                                                ("J2Linear", True, False))]


@pytest.mark.parametrize(
    "key, name, visc, bf16", RESIDUAL_TILE_CASES,
    ids=[f"{n}_{'_'.join(map(str, k))}{'_visc' if v else ''}{'_bf16' if b else ''}"
         for k, n, v, b in RESIDUAL_TILE_CASES])
def test_dense_residual_tile_on_cpu_tensors(host_sweeps, key, name, visc, bf16):
    """dense_residual_tile_kernel (owner warps holding their nodes' dN and N
    rows in registers from the gradient's partials to the scatter, a flux
    warp running the material and storing the block) at path I's
    (3, 64, 125) and path L's (2, 25, 36), on 40 elements (a full tile of
    32 and a ragged one of 8): the neo-Hookean's symmetric block at strains
    of a few percent, inviscid with a float32 block and viscous with a
    bfloat16 one, and J2Linear's Cauchy block on a random plastic history
    with a deviatoric back stress, inviscid and viscous, against the plain
    versions (residuals at 1e-5 of scale, float32 planes at 1e-5 of their
    max, bfloat16 ones within 2^-7)."""
    mat = _j2_family(name) if name == "J2Linear" else _hyper(name)
    prob = _finite_tile_problem(key, mat)
    rng = np.random.default_rng(22)
    if mat.has_state:
        f = _plastic_inputs(prob, rng, 0.001 if key[0] == 2 else 0.0005)
        share = _plastic_share(mat, soa.add_diag(tsw.dense_grad(f[0], prob.dense["dN_t"]), 1.0),
                               f[4])
        assert 0.05 < share < 0.95, share
    else:
        f = _hyper_inputs(prob, rng)
    _hold_host_sweeps(host_sweeps, prob, f, visc, bf16, matvec=False)


def test_dense_residual_tile_diagonal_near_identity_on_cpu_tensors(host_sweeps):
    """dense_residual_tile_kernel's neo-Hookean residual at path L's
    (2, 25, 36) on the golden cantilever's mesh at 32^2 (1,024 elements),
    at element displacements of 1e-5 to 1e-2: within 1e-5 of the plain
    version's max.  F = I + grad u, which P = mu (F - F^-T) + ... cancels
    near F = I, is summed in n order without FMA as the plain version sums
    it (every warp sums entries of grad u from the point's dN rows in
    shared memory); summed by owner slot, a last bit of (grad u)_gg moved
    F_gg by an ulp of 1, and the residual by 6.5e-5 of its max at 1e-2."""
    mat = _hyper("CompressibleOgdenNeoHookean")
    prob = mt.build_problem(BALKEN, 3, 5, mat, [(2, 0), (2, 1)], {}, rho_inf=0.5, device="cpu",
                            dtype=torch.float32)
    assert (prob.n_el, *prob.dense["dN_t"].shape[:1], prob.n_q) == (1024, 25, 36)
    rng = np.random.default_rng(5)
    for amplitude in (1e-5, 1e-4, 1e-3, 1e-2):
        u_el, a_el = (torch.tensor(s * rng.standard_normal((2, 25, 1024)), dtype=torch.float32)
                      for s in (amplitude, 1.0))
        args = (u_el, a_el, None, prob.dense["dN_t"], prob.dense["N_t"], prob.wdet_t, mat, 0.05,
                float(mat.density))
        y, y_p = host_sweeps._dense_sweep(False, *args), host_sweeps.residual_dense_plain(*args)
        assert float((y - y_p).abs().max()) <= 1e-5 * float(y_p.abs().max()), amplitude


@pytest.mark.parametrize("dim, deg", DENSE_SHAPES, ids=[f"{d}d_p{p}" for d, p in DENSE_SHAPES])
def test_dense_j2_residual_kernels_at_each_default_shape_on_cpu_tensors(host_sweeps, dim, deg):
    """J2's residual and assemble at each shape of tests/torch_shapes.py
    (dense_slot_kernel in 2D and at (3, 64, 125), the one-thread kernel at
    (3, 27, 64)) launch within the host stub's limits (1024 threads and
    227 KB of shared memory a block, as on the card) on 33 elements (a full
    tile and one element more) of a random plastic history, and agree with
    the plain versions at the smoke's bars."""
    mat = _material("J2")
    mat.hardening.A = 5.0
    key = tsw.dense_key(dim, deg)
    prob = _finite_tile_problem(key, mat, n=33)
    f = _plastic_inputs(prob, np.random.default_rng(23), 0.004 if dim == 2 else 0.002)
    _hold_host_sweeps(host_sweeps, prob, f, False, False, matvec=False)


def _fused_problem(key):
    """The first 40 elements (a full tile of 32 and a ragged one of 8) of
    neo-Hookean dense tables at `key`: _finite_tile_problem's meshes, and
    at (2, 9, 9) the golden cantilever's mesh at p = 2 with 3 Gauss points
    per axis (quadrature order 5) at 8^2."""
    mat = _hyper("CompressibleOgdenNeoHookean", -1.0)
    if key != (2, 9, 9):
        return _finite_tile_problem(key, mat)
    prob = mt.build_problem(BALKEN, 1, 3, mat, [(2, 0), (2, 1)], {}, rho_inf=0.5, device="cpu",
                            dtype=torch.float32, quadrature_order=5)
    assert (prob.dim, prob.dense["dN_t"].shape[0], prob.n_q) == key
    return _first_elements(prob, 40)


@pytest.mark.parametrize("key", FUSED_APPLY_SHAPES, ids=["_".join(map(str, k))
                                                         for k in FUSED_APPLY_SHAPES])
def test_fused_tangent_apply_at_each_shape_on_cpu_tensors(host_sweeps, libs, key):
    """The fused neo-Hookean tangent apply of the host build at each shape
    of FUSED_APPLY_SHAPES (3D: nh_tangent_apply_tile_kernel, owner warps
    holding their nodes' dN rows in registers from grad u's and grad w's
    partial sums to the scatter, a flux warp forming F, dF and dP; 2D: one
    thread per element at (2, 9, 9), dense_tile_kernel's point slots at
    (2, 25, 36)) on 40 elements (a full tile and a ragged one) at strains of
    a few percent: against its plain version and against matvec_dense
    (rho = 0, fac0 = 1) on the planes assembled at the same u at phase 17's
    bar, 1e-4 of scale; grad u summed by owner slot keeps the owners within
    1e-6 of the plain version's max."""
    from mimi_tpu_torch.ops import fused_neohookean as fused

    prob = _fused_problem(key)
    mat, E = prob.material, prob.n_el
    dN, N, wq = prob.dense["dN_t"], prob.dense["N_t"], prob.wdet_t
    u_el, _, _, w_el, _ = _hyper_inputs(prob, np.random.default_rng(31))
    y = torch.empty_like(u_el)
    lib = libs("dense", key)
    assert lib.mimi_neohookean_tangent_apply(
        _ptr(u_el), _ptr(w_el), _ptr(dN), _ptr(wq), _ptr(y), ctypes.c_float(mat.lambda_),
        ctypes.c_float(mat.mu), *map(ctypes.c_int, key), ctypes.c_longlong(E),
        ctypes.c_void_p(None)) == 0
    y_p = fused.neohookean_tangent_apply_plain(u_el, w_el, dN, wq, mat.lambda_, mat.mu)
    _, C = host_sweeps._dense_sweep(True, u_el, torch.zeros_like(u_el), None, dN, N, wq, mat,
                                    0.05, 1.0)
    y_d = host_sweeps._dense_matvec(w_el, dN, N, wq, C, 0.0, 1.0, "sym")
    scale = float(y_p.abs().max())
    assert float((y - y_p).abs().max()) <= 1e-6 * scale
    assert float((y - y_d).abs().max()) <= 1e-4 * scale


J2_UNTILED_CASES = [(key, visc, bf16) for key in J2_UNTILED_3D_SHAPES for visc in (False, True)
                    for bf16 in (False, True)]


@pytest.mark.parametrize(
    "key, visc, bf16", J2_UNTILED_CASES,
    ids=[f"{'_'.join(map(str, k))}{'_visc' if v else ''}{'_bf16' if b else ''}"
         for k, v, b in J2_UNTILED_CASES])
def test_dense_j2_3d_untiled_on_the_ring_on_cpu_tensors(host_sweeps, one_thread, key, visc,
                                                        bf16):
    """3D J2's residual and assemble at the untiled shapes of
    J2_UNTILED_3D_SHAPES, inviscid and viscous, with a float32 or bfloat16
    block, on 40 elements (a full tile of 32 and a ragged one of 8) of a
    random plastic history (Johnson-Cook, yield stress 5): against the plain
    versions at the smoke's bars; inviscid equal to the bit to the
    one-thread kernel (dense_residual_kernel, built beside it), which the
    residual and the float32 assemble left for dense_ring_kernel (one thread
    per element, the point's dN and N rows copied ahead into the thread's
    column of shared memory: the same operations in the same order, the
    rows read from shared memory instead of device memory).  The viscous
    ones and the bfloat16 assemble stay on the one-thread kernel."""
    mat = _material("J2")
    mat.hardening.A = 5.0
    prob = _finite_tile_problem(key, mat)
    f = _plastic_inputs(prob, np.random.default_rng(32), 0.002)
    u_el, a_el, _, _, state = f
    dN, N, wq, E = prob.dense["dN_t"], prob.dense["N_t"], prob.wdet_t, prob.n_el
    share = _plastic_share(mat, soa.add_diag(tsw.dense_grad(u_el, dN), 1.0), state)
    assert 0.05 < share < 0.95, share
    _hold_host_sweeps(host_sweeps, prob, f, visc, bf16, matvec=False)
    if visc:
        return
    args = (u_el, a_el, state, dN, N, wq, mat, 0.05, float(mat.density))
    ct = torch.bfloat16 if bf16 else torch.float32
    y = host_sweeps._dense_sweep(False, *args)
    y_a, C = host_sweeps._dense_sweep(True, *args, c_dtype=ct)
    _, prm, mat_id, st = tsw._material_args(mat, state, 0.05, float(mat.density), 3, key[2], E,
                                            torch.device("cpu"), "dense")
    lib = one_thread("sweeps_dense_j2.cu", key)
    y1, y1_a, C1 = torch.empty_like(y), torch.empty_like(y_a), torch.empty(C.shape)
    head = (_ptr(u_el), _ptr(a_el), _ptr(dN), _ptr(N), _ptr(wq), *st)
    assert lib.one_thread_sweep(*head, _ptr(y1), _ptr(None), 0, 0, prm, mat_id, E) == 0
    assert lib.one_thread_sweep(*head, _ptr(y1_a), _ptr(C1), 1, 0, prm, mat_id, E) == 0
    assert torch.equal(y, y1) and torch.equal(y_a, y1_a) and torch.equal(C, C1.to(ct))
