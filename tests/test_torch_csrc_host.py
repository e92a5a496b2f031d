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
on the card.  Each source must compile; the objects are linked into one
library with the C entry points of ops/build.py, and the dense
finite-strain kernels (sweeps_dense_finite.cu) run on CPU tensors at 4
elements (2D, p = 3), the viscous dense kernels (sym and cauchy, 2D and
3D), the viscous hyperelastic sf kernels with a float32 or bfloat16 block
(sweeps_sf_hyper.cu) and the J2-family sf and dense kernels at a few
elements, the sf residual and assemble of J2 also on a partial tile and on
full tiles with a ragged tail, the sf matvec of every storage, viscous or
not, float32 or bfloat16 block, at p = 2 and p = 3 on a ragged last tile,
J2Simo's and J2Log's viscous and bfloat16
full-storage kernels and the full block of J2, J2Linear and the
hyperelastic materials, sf and dense, against their plain versions (the J2
family's as the kernels' twin, the radial return at 40 trips:
materials.kernel_solver_mode).  Skips where no g++ is found.
"""

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
from mimi_tpu_torch.ops import build as kbuild
from mimi_tpu_torch.ops import sweeps as tsw
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

CSRC = os.path.join(os.path.dirname(kbuild.__file__), "csrc")
STUB = os.path.join(CSRC, "host_stub")
DATA = os.path.join(os.path.dirname(__file__), "data")
BALKEN = os.path.join(DATA, "balken.mesh")
MESH = os.path.join(DATA, "cube-nurbs.mesh")
SOURCES = [os.path.basename(s) for s in kbuild.SOURCES]
CXX = ["-std=c++20", "-O1", "-fPIC", "-pthread", "-ffp-contract=off", "-w"]


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


def host_build(dest):
    """Copy the sources and headers into `dest` with host launches, and
    compile every source with g++ in parallel.  Returns ({source: (return
    code, compiler output)}, [object paths])."""
    for name in os.listdir(CSRC):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name)) as f:
                text = serial_launches(f.read())
            with open(os.path.join(dest, name), "w") as f:
                f.write(text)
    objs = [os.path.join(dest, f"{name}.o") for name in SOURCES]
    procs = [
        subprocess.Popen(
            ["g++", *CXX, "-x", "c++", "-I", STUB, "-I", dest, "-c", "-o", obj,
             os.path.join(dest, name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name, obj in zip(SOURCES, objs)
    ]
    out = {name: (p.wait(timeout=600), p.stdout.read()) for name, p in zip(SOURCES, procs)}
    return out, objs


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host to build the CUDA sources as C++")
    dest = str(tmp_path_factory.mktemp("csrc_host"))
    results, objs = host_build(dest)
    return dest, results, objs


@pytest.fixture(scope="module")
def lib(built):
    dest, results, objs = built
    failed = [name for name, (rc, _) in results.items() if rc]
    assert not failed, f"sources that do not compile: {failed}"
    so = os.path.join(dest, "libmimi_sweeps_host.so")
    r = subprocess.run(["g++", "-shared", "-o", so, *objs], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return kbuild.bind(ctypes.CDLL(so))


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


@pytest.mark.parametrize("source", SOURCES)
def test_source_compiles_as_host_cpp(built, source):
    _, results, _ = built
    rc, log = results[source]
    assert rc == 0, f"g++ could not build {source}:\n{log[-4000:]}"


def test_only_the_dense_finite_source_builds_without_fused_multiply_add():
    """nvcc builds the dense finite-strain kernels with -fmad=false (each
    product and sum rounded on its own, as their plain twin's torch
    operations round them) and every other source with its default."""
    for src in kbuild.SOURCES:
        flags = kbuild.flags_of(src)
        assert flags[: len(kbuild.FLAGS)] == kbuild.FLAGS
        assert ("-fmad=false" in flags) == (os.path.basename(src) == "sweeps_dense_finite.cu")


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
def test_dense_finite_kernels_on_cpu_tensors(lib, name):
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
    shape = (ctypes.c_int(2), ctypes.c_int(3), ctypes.c_longlong(E), ctypes.c_void_p(None))
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
def test_dense_viscous_kernels_on_cpu_tensors(lib, case):
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
    shape = (ctypes.c_int(dim), ctypes.c_int(deg), ctypes.c_longlong(E), ctypes.c_void_p(None))
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
def test_sf_hyper_viscous_kernels_on_cpu_tensors(lib, name, bf16):
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
def host_sweeps(lib, monkeypatch):
    """ops/sweeps.py's kernel wrappers on CPU tensors through the host
    build: the library, no device check, launches on no stream."""
    def launch(fn, name, *args):
        tsw.LAUNCHES[name] += 1
        err = fn(*args, ctypes.c_void_p(None))
        assert err == 0, f"{name} returned {err}"

    monkeypatch.setattr(kbuild, "load", lambda: lib)
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


def _hold_host_sweeps(sw, prob, f, visc, bf16, matvec=True, storage=None):
    """The material's residual, assemble (the block in `storage`, default
    the material's own) and (with `matvec`) matvec kernels of the host
    build through the wrappers' own marshalling against the plain versions
    (the J2 family's return at the kernels' 40 trips): residuals and matvec
    at 1e-5 of scale, float32 planes at 1e-5 of their max, bfloat16 planes
    within one bfloat16 step (2^-7) of the plain float32 planes rounded to
    bfloat16."""
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
    ak = dict(vk, storage=storage, **({"c_dtype": c_dtype} if kind == "sf" else {}))
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
        assert float((C - C_p).abs().max()) <= 1e-5 * scale
    p = prob.sf["pp1"] - 1 if kind == "sf" else round(tables[0].shape[0] ** (1.0 / prob.dim)) - 1
    names = sw.kernel_counters(mat, kind, prob.dim, p, visc, bf16, storage)
    assert sw.LAUNCHES[names[0]] == 1 and sw.LAUNCHES[names[1]] == 1
    if not matvec:
        return C_p
    Cb = C_p.to(c_dtype)
    fm = 50.0 if visc else None
    if kind == "sf":
        mv = mv_kernel(w_el, *tables, wq, Cb, rho, fac0, fm, storage)
    else:
        mv = sw._dense_matvec(w_el, *tables, wq, Cb, rho, fac0, storage, fm)
    mv_p = plain[2](w_el, *tables, wq, Cb, rho, fac0, fm, storage=storage)
    assert float((mv - mv_p).abs().max()) <= 1e-5 * float(mv_p.abs().max())
    assert sw.LAUNCHES[sw.matvec_counter(kind, storage, prob.dim, p, visc, bf16)] == 1
    return C_p


J2LIN_CASES = ([("sf", 3, 2, visc, bf16) for visc in (False, True) for bf16 in (False, True)]
               + [("dense", d, p, visc, False) for d, p in tsw.DENSE_SHAPES
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
                + [("dense", d, p, name, True, False) for d, p in tsw.DENSE_SHAPES
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
                    + [("dense", d, p, name, visc, False) for d, p in tsw.DENSE_SHAPES
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


MATVEC_CASES = [(p, storage, visc, bf16) for p in (2, 3) for storage in ("cauchy", "sym", "full")
                for visc in (False, True) for bf16 in (False, True)]


@pytest.mark.parametrize(
    "p, storage, visc, bf16", MATVEC_CASES,
    ids=[f"p{p}_{s}{'_visc' if v else ''}{'_bf16' if b else ''}"
         for p, s, v, b in MATVEC_CASES])
def test_sf_matvec_tiles_on_cpu_tensors(host_sweeps, p, storage, visc, bf16):
    """The tiled sf matvec of the host build (one thread per element and
    point slot, the points' fluxes reduced by the nodes' owners through
    shared memory) with every storage, inviscid and viscous, a float32 or
    bfloat16 block, against matvec_sf_plain at 1e-5 of scale, on a ragged
    last tile: 125 = 3 x 32 + 29 elements at p = 2, 45 = 32 + 13 at p = 3.
    The block's planes are random (the matvec is linear in them)."""
    mesh, elev, spans, n = (("cube-nurbs.mesh", 1, 5, 125) if p == 2
                            else ("cube-nurbs-3.mesh", 0, 4, 45))
    prob = mt.build_problem(os.path.join(DATA, mesh), elev, 0, _hyper("StVenantKirchhoff"),
                            [(1, 0), (1, 1), (1, 2)], {}, rho_inf=0.5, device="cpu",
                            dtype=torch.float32, refine_spans=spans)
    prob = _first_elements(prob, n)
    assert prob.sf["pp1"] == p + 1 and n % 32 != 0
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
    # the mass, the block's and the viscous terms each move the output by
    # more than 10% of its max at these factors
    for k in range(3 if visc else 2):
        off = tuple(None if i == k == 2 else 0.0 if i == k else a for i, a in enumerate(args))
        mv0 = host_sweeps.matvec_sf_plain(w_el, *tables, Cb, *off, storage=storage)
        assert float((mv_p - mv0).abs().max()) > 0.1 * float(mv_p.abs().max())
    assert host_sweeps.LAUNCHES[host_sweeps.matvec_counter("sf", storage, 3, p, visc, bf16)] == 1
