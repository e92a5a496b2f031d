"""The fixed-order scatter of mimi_tpu_torch (fem/scatter.py) against
`index_add_`, which it replaced: the connectivity scatter of a multi-patch
problem (parallel/sharding.py `_gather_scatter`), and a contact block's
scatters onto its mortar dofs and onto the global dofs
(contact/mortar.py `contact_scatter_tables`, sharding `_scatter_conn`), in
float64 at 1e-12 of the scale.  Two runs of `index_add_` on a CUDA tensor
add in another order each; these sums have one order on every device.
"""

import os

import numpy as np
import pytest
import torch

import mimi_tpu_torch as mt
from mimi_tpu_torch import splines as tspl
from mimi_tpu_torch.fem.scatter import gather_sum, inverse_map
from mimi_tpu_torch.parallel import sharding as tsh
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one thread)

DATA = os.path.join(os.path.dirname(__file__), "data")
TOL = 1e-12


def _rel(y, y_ref):
    assert y.shape == y_ref.shape, (y.shape, y_ref.shape)
    return float((y - y_ref).abs().max() / y_ref.abs().max())


@pytest.mark.parametrize("n_out, size", [(7, 40), (50, 30), (1000, 20000)])
def test_gather_sum_matches_index_add(n_out, size):
    """Random indices, some outputs hit many times and some never (their
    row is all padding and sums to 0)."""
    rng = np.random.default_rng(n_out)
    idx = rng.integers(0, n_out, size)
    inv = inverse_map(idx, n_out)
    assert inv.shape == (n_out, np.bincount(idx, minlength=n_out).max())
    vals = torch.tensor(rng.standard_normal((3, size)))
    ref = torch.zeros(3, n_out, dtype=torch.float64).index_add_(1, torch.tensor(idx), vals)
    out = gather_sum(vals, torch.tensor(inv))
    assert _rel(out, ref) <= TOL
    untouched = np.setdiff1d(np.arange(n_out), idx)
    assert torch.equal(out[:, untouched], torch.zeros(3, len(untouched), dtype=torch.float64))


def _neo_hookean():
    mat = mt.CompressibleOgdenNeoHookean()
    mat.density, mat.viscosity = 1e3, 100.0
    mat.set_young_poisson(1e6, 0.3)
    return mat


def _press(dim):
    """The two-patch press of tests/test_torch_dense_contact.py: the 2D
    two-patch square under a flat tool, or the two-patch cube (p = 2) under
    a bilinear one."""
    sc = mt.NearestDistanceToSplines()
    if dim == 2:
        sc.add_spline(tspl.Bezier([1], [[-0.5, 1.0], [2.5, 1.0]]))
        mesh, elev, subd, bid = "two-patch-square.mesh", 1, 2, 3
        clamp = [(2, 0), (2, 1)]
    else:
        sc.add_spline(tspl.Bezier([1, 1], [[-0.5, -0.5, 1.0], [-0.5, 1.5, 1.0],
                                           [1.5, -0.5, 1.0], [1.5, 1.5, 1.0]]))
        mesh, elev, subd, bid = "two-patch-cube.mesh", 1, 1, 1
        clamp = [(0, 0), (0, 1), (0, 2)]
    sc.plant_kd_tree(16, 1)
    sc.coefficient = 5e7
    return mt.build_problem(os.path.join(DATA, mesh), elev, subd, _neo_hookean(), clamp, {},
                            rho_inf=0.5, device="cpu", dtype=torch.float64,
                            contact=[(bid, sc)])


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def press(request):
    prob = _press(request.param)
    assert prob.grid is None and prob.dense is not None and prob.conn_inv is not None
    return prob


def test_conn_scatter_matches_index_add(press):
    """The multi-patch problem's element-to-dof scatter: every dof's
    element values summed in a fixed order, against index_add_ on the
    transposed (dim, n_dof) accumulator."""
    prob = press
    nd = prob.connT.shape[0]
    r = torch.tensor(np.random.default_rng(1).standard_normal((prob.dim, nd, prob.n_el)))
    _, scatter_el = tsh._gather_scatter(prob)
    ref = torch.zeros(prob.dim, prob.n_dof, dtype=torch.float64).index_add_(
        1, prob.connT.reshape(-1), r.reshape(prob.dim, -1)).T
    assert _rel(scatter_el(r), ref) <= TOL
    # a dof of the patches' interface gathers from both patches' elements
    assert prob.conn_inv.shape[1] == int(np.bincount(prob.conn.ravel()).max())


def test_contact_scatters_match_index_add(press):
    """A contact block's scatter of its element values onto its mortar
    dofs (the pressure pass's nodal gap and area) and onto the global dofs
    (the traction residual), against index_add_ through ldof and conn."""
    prob = press
    cd = prob.contact[0]
    assert torch.equal(cd["gdof"][cd["ldof"]], cd["conn"])
    n_mb, nd = cd["conn"].shape
    n_local = prob.contact_static[0]["n_local"]
    rng = np.random.default_rng(2)
    vals = torch.tensor(rng.standard_normal((n_mb, nd)))
    ref = torch.zeros(n_local, dtype=torch.float64).index_add_(0, cd["ldof"].reshape(-1),
                                                               vals.reshape(-1))
    assert _rel(gather_sum(vals.reshape(-1), cd["inv"]), ref) <= TOL
    res_el = torch.tensor(rng.standard_normal((n_mb, nd, prob.dim)))
    ref = torch.zeros(prob.n_dof, prob.dim, dtype=torch.float64).index_add_(
        0, cd["conn"].reshape(-1), res_el.reshape(-1, prob.dim))
    assert _rel(tsh._scatter_conn(res_el, cd, prob.n_dof), ref) <= TOL
