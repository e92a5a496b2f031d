"""J2Simo's and J2Log's sum-factorized residual and assemble up to p = 3
(sweeps_sf_finite.cu: at p = 2 J2Log's assemble and J2Simo's viscous one
on sf_common.cuh sf_dealt_kernel, their tangent columns dealt over the
warps; the others on sf_tile_kernel) built as host C++, against their
plain versions.

Only sweeps_sf_finite.cu is built, once a module, at (3, 4) and (4, 5)
with the host stand-ins of tests/test_torch_csrc_host.py (g++ without
fused multiply-adds; the launches' blocks run with one host thread per
thread and real barriers).  The kernels run through ops/sweeps.py's own
marshalling on CPU tensors: a ragged last tile (33 elements: one tile of
32 and one of 1), p = 3 (125 points: the last round of four holds one),
batches where only some points yield, a J2Log batch that one point sends
to the deep log series.  Skips where no g++ is found.
"""

import ctypes
import os
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import mimi_tpu_torch as mt
from mimi_tpu_torch.fem import soa
from mimi_tpu_torch.ops import build as kbuild
from mimi_tpu_torch.ops import sweeps as tsw
from test_torch_csrc_host import (CSRC, CXX, DATA, MESH, STUB, _first_elements,
                                  _hold_host_sweeps, _plastic_inputs, _press_law,
                                  _stretch_one_point, serial_launches)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

SOURCE = "sweeps_sf_finite.cu"
SHAPES = ((3, 4), (4, 5))


class _FiniteLib:
    """The library of SOURCE alone, bound as ops/build.py binds the "sf"
    kind: the entry points of the other sf sources are absent, and binding
    them sets nothing that is called."""

    def __init__(self, so):
        self._lib = ctypes.CDLL(so)

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return types.SimpleNamespace()


def _build(dest, shape):
    """SOURCE at `shape` with host launches: the bound library."""
    os.makedirs(dest, exist_ok=True)
    for name in os.listdir(CSRC):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name)) as f:
                text = serial_launches(f.read())
            with open(os.path.join(dest, name), "w") as f:
                f.write(text)
    obj, so = os.path.join(dest, "finite.o"), os.path.join(dest, "libfinite.so")
    r = subprocess.run(["g++", *CXX, *kbuild.defines("sf", shape), "-x", "c++", "-I", STUB,
                        "-I", dest, "-c", "-o", obj, os.path.join(dest, SOURCE)],
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    subprocess.run(["g++", "-shared", "-o", so, obj], check=True)
    return kbuild.bind(_FiniteLib(so), "sf")


@pytest.fixture(scope="module")
def finite_libs(tmp_path_factory):
    """{shape: library}: SOURCE at SHAPES, built in parallel."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host to build the CUDA sources as C++")
    import concurrent.futures

    root = tmp_path_factory.mktemp("sf_finite_host")
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        libs = pool.map(lambda s: _build(str(root / f"{s[0]}_{s[1]}"), s), SHAPES)
        return dict(zip(SHAPES, libs))


@pytest.fixture
def sweeps_of(finite_libs, monkeypatch):
    """sweeps_of(): ops/sweeps.py's wrappers launching the host builds on
    CPU tensors, on no stream, their launches counted."""
    def launch(fn, name, *args):
        tsw.LAUNCHES[name] += 1
        assert fn(*args, ctypes.c_void_p(None)) == 0, name

    def use():
        monkeypatch.setattr(kbuild, "load", lambda kind, shape: finite_libs[tuple(shape)])
        tsw.reset_launches()
        return tsw

    monkeypatch.setattr(tsw, "_check_device", lambda device: None)
    monkeypatch.setattr(tsw, "_launch", launch)
    return use


def _problem(name, p, n, viscosity=100.0):
    """The press law's `name` on n elements of the cube at degree p (2:
    cube-nurbs.mesh elevated by 1 at 4^3; 3: cube-nurbs-3.mesh at 3^3),
    float32."""
    mesh, elevate, spans = (MESH, 1, 4) if p == 2 else (os.path.join(DATA, "cube-nurbs-3.mesh"),
                                                        0, 3)
    prob = mt.build_problem(mesh, elevate, 0, _press_law(name, viscosity), [(1, 0), (1, 1), (1, 2)],
                            {}, rho_inf=0.5, device="cpu", dtype=torch.float32,
                            refine_spans=spans)
    assert (prob.sf["pp1"], prob.sf["n_g"]) == (p + 1, p + 2)
    return _first_elements(prob, n)


def _yielding_share(prob, f):
    F = soa.add_diag(tsw.sf_grad(f[0], prob.sf["tables"], prob.sf["jinv"]), 1.0)
    return float(prob.material._return_map_soa(F, f[4], 0.05)[4].float().mean())


COMBOS = ((False, False), (True, False), (True, True), (False, True))
# the float32 planes' bar, the smoke's (PERF.md section 2): on a batch
# where only some points yield, J2Simo's planes at points near the yield
# surface round 3.4e-5 of the block's max from the plain version's float32
# operations (PR 20's kernels to the bit the same)
PLANE_BAR = 1e-4
RAGGED_CASES = [(name, visc, bf16) for name in tsw.FULL_KERNELS for visc, bf16 in COMBOS]


@pytest.mark.parametrize("name, visc, bf16", RAGGED_CASES,
                         ids=[f"{n}{'_visc' if v else ''}{'_bf16' if b else ''}"
                              for n, v, b in RAGGED_CASES])
def test_sf_finite_kernels_on_a_ragged_tile(sweeps_of, name, visc, bf16):
    """The residual, the full assemble (float32 or bfloat16 block) and the
    matvec on it, inviscid or viscous, on 33 elements at p = 2 (a full tile
    and a tile of one) where about half the points yield, against the
    plain versions: residuals at 1e-5 of scale, float32 planes at
    PLANE_BAR of their max, the bfloat16 block the float32 one rounded to
    nearest even."""
    prob = _problem(name, 2, 33)
    f = _plastic_inputs(prob, np.random.default_rng(21), 0.0001)
    share = _yielding_share(prob, f)
    assert 0.1 < share < 0.9, share
    _hold_host_sweeps(sweeps_of(), prob, f, visc, bf16, plane_bar=PLANE_BAR)


P3_CASES = [("J2Simo", False, False), ("J2Log", True, True)]


@pytest.mark.parametrize("name, visc, bf16", P3_CASES,
                         ids=[f"{n}{'_visc' if v else ''}{'_bf16' if b else ''}"
                              for n, v, b in P3_CASES])
def test_sf_finite_kernels_at_p3(sweeps_of, name, visc, bf16):
    """p = 3 (4 nodes, 5 Gauss points per axis: 125 points, so the last
    round of four points holds one) on 27 elements (one ragged tile) where some points yield, against the
    plain versions; the counters carry the shape."""
    prob = _problem(name, 3, 27)
    f = _plastic_inputs(prob, np.random.default_rng(22), 0.0002)
    share = _yielding_share(prob, f)
    assert 0.1 < share < 0.9, share
    sw = sweeps_of()
    _hold_host_sweeps(sw, prob, f, visc, bf16, matvec=False, plane_bar=PLANE_BAR)
    assert sw.kernel_counters(prob.material, "sf", 3, 3, visc, bf16)[1].endswith("@3d_p3")


def _deep_count(lib):
    fn = lib.mimi_logm_deep_sf_finite
    fn.argtypes = [ctypes.c_void_p]
    n = ctypes.c_longlong(0)
    assert fn(ctypes.byref(n)) == 0
    return n.value


def test_j2log_deep_series_on_point_slots(sweeps_of, finite_libs):
    """J2Log's viscous residual and bfloat16 assemble on 33 elements with
    one point of the batch past the fast log series' range: the sweep's
    deep launch runs (the device counter counts both sweeps) and takes
    every point in the deep series, as the plain version does for the
    batch, within 1e-5 of its scale (the planes within one bfloat16 step)."""
    prob = _problem("J2Log", 2, 33)
    u_el, a_el, v_el, w_el, state = _plastic_inputs(prob, np.random.default_rng(23), 0.0001)
    f = (u_el, a_el, v_el, w_el, _stretch_one_point(state, e=32, q=5))
    lib = finite_libs[(3, 4)]
    n0 = _deep_count(lib)
    C_p = _hold_host_sweeps(sweeps_of(), prob, f, True, True, matvec=False)
    assert _deep_count(lib) == n0 + 3  # residual, assemble and its float32 twin
    assert bool(torch.isfinite(C_p).all())
