"""Tensor-product fast-diagonalization (FDM) preconditioner.

Counterpart of mimi_tpu/solvers/fdm.py.  On one patch the Newton tangent
J = M + fac1 S + fac0 K is preconditioned by the exact inverse of its
separable surrogate per displacement component c,

    J_c_hat = rho M1 (x) M2 (x) M3 + sum_d coef_cd ... K_d (x) M ...,

with 1D B-spline mass/stiffness matrices per parametric axis and
coef_cd = fac0 alpha_cd + fac1 mu_v (alpha_cd = lambda + 2 mu on the
diagonal, mu off it).  The generalized eigenbases K_d V_d = M_d V_d L_d
(built once on the host with scipy) diagonalize it, so the inverse applies
as two or three small dense 1D transforms per side, one per parametric
axis of the 2D or 3D patch (torch einsums on the device).
Face Dirichlet sets restrict the 1D matrices; the eigenbasis is embedded
with zero rows at constrained indices.  Penalty contact on a face folds
into the face-normal component's 1D stiffness as a boundary spring.

A multi-patch space gets the patch-wise additive Schwarz sum of these
inverses, P^-1 = sum_p R_p^T J_hat_p^-1 R_p over the patch dof sets
(interface dofs belong to every adjacent patch, so their corrections
add): `build_fdm_data` and `make_fdm_apply` dispatch to it.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch


def _assemble_1d(kv, p, n_gauss, length):
    """1D B-spline mass/stiffness on knot vector kv with physical-length
    scaling: x = a + (L/U) u, so M_phys = (L/U) M_par, K_phys =
    (U/L) K_par."""
    from ..fem.space import _dim_tables
    from ..nurbs import knots as kn

    starts, uq, wq, B, D = _dim_tables(kv, p, n_gauss)
    n = kn.n_ctrl(kv, p)
    M = np.zeros((n, n))
    K = np.zeros((n, n))
    for s in range(len(starts)):
        idx = starts[s] + np.arange(p + 1)
        ix = np.ix_(idx, idx)
        for g in range(uq.shape[1]):
            M[ix] += wq[s, g] * np.outer(B[s, g], B[s, g])
            K[ix] += wq[s, g] * np.outer(D[s, g], D[s, g])
    U = float(kv[-1] - kv[0])
    scale = length / U if U > 0 else 1.0
    return M * scale, K / scale


def _embedded_eigenbases(mats, nc, dim, constrained, springs):
    """Per (component, axis): the generalized eigenbasis of the 1D
    stiffness/mass pair restricted to the free indices, embedded with zero
    rows at the constrained ones (V^T M V = I), and its eigenvalues."""
    d = len(nc)
    Ve = [[None] * d for _ in range(dim)]
    lam = [[None] * d for _ in range(dim)]
    for c in range(dim):
        for ax in range(d):
            M, K = mats[ax]
            if (c, ax) in springs:
                K = K.copy()
                for idx, k_oa in springs[(c, ax)]:
                    K[idx, idx] += k_oa
            free = np.array([i for i in range(nc[ax]) if i not in constrained[(c, ax)]])
            w, V = scipy.linalg.eigh(K[np.ix_(free, free)], M[np.ix_(free, free)])
            emb = np.zeros((nc[ax], len(free)))
            emb[free, :] = V
            Ve[c][ax] = emb
            lam[c][ax] = w
    return Ve, lam


def _alpha(material, dim, d):
    """alpha[c, axis]: lambda + 2 mu on the diagonal, mu off it."""
    mu_e = float(material.mu)
    alpha = np.full((dim, d), mu_e)
    for c in range(min(dim, d)):
        alpha[c, c] = float(material.lambda_) + 2.0 * mu_e
    return alpha


def build_fdm_data(fes, dir_pairs, material, contact_springs=None):
    """Per-(component, axis) embedded eigenbases.

    dir_pairs: [(bid, component), ...] face Dirichlet sets.  Returns a
    numpy dict, or None when the decomposition does not apply (no elastic
    constants, or a Dirichlet set or contact face that is not a patch
    face).

    contact_springs: [(bid, penalty), ...] -- penalty contact on face `bid`
    adds kappa (M (x) M (x) e_N e_N^T) to the tangent, which is
    Kronecker-separable: kappa / alpha joins the face-normal component's
    1D stiffness at the face's end index (clamped B-spline bases are
    interpolatory at the ends, so the end function is the e_N unit).

    A multi-patch space (no `patch` attribute) gets the additive-Schwarz
    data of build_fdm_data_multipatch."""
    if not hasattr(fes, "patch"):
        return build_fdm_data_multipatch(fes, dir_pairs, material, contact_springs)
    lam_e = float(material.lambda_)
    mu_e = float(material.mu)
    if lam_e <= 0 and mu_e <= 0:
        return None
    patch = fes.patch
    d = fes.para_dim
    nc = list(fes.n_ctrl)
    # physical length per axis from the control-point bounding box
    ext = fes.x_ref.max(axis=0) - fes.x_ref.min(axis=0)
    side_of_bid = {attr - 1: (axis, end) for attr, axis, end, _ in fes.sides}
    constrained = {(c, ax): set() for c in range(fes.dim) for ax in range(d)}
    for bid, comp in dir_pairs:
        if bid not in side_of_bid:
            return None
        axis, end = side_of_bid[bid]
        constrained[(comp, axis)].add(0 if end == 0 else nc[axis] - 1)

    mats = [
        _assemble_1d(
            patch.knot_vectors[ax], patch.degrees[ax],
            patch.degrees[ax] + 2, float(ext[ax]),
        )
        for ax in range(d)
    ]
    alpha = _alpha(material, fes.dim, d)
    springs = {}  # (comp, axis) -> [(end_index, kappa / alpha)]
    for bid, penalty in contact_springs or []:
        if bid not in side_of_bid:
            return None
        axis, end = side_of_bid[bid]
        springs.setdefault((axis, axis), []).append(
            (0 if end == 0 else nc[axis] - 1, float(penalty) / alpha[axis, axis])
        )

    Ve, lam = _embedded_eigenbases(mats, nc, fes.dim, constrained, springs)
    return {
        "Ve": Ve,
        "lam": lam,
        "alpha": alpha,
        "nc": nc,
        "dim": fes.dim,
        "rho": float(material.density),
        "mu_v": max(float(material.viscosity), 0.0),
    }


def build_fdm_data_multipatch(fes, dir_pairs, material, contact_springs=None):
    """Patch-wise additive-Schwarz data for a MultiPatchFESpace: per patch
    the single-patch eigenbases (Dirichlet faces constrain only the patches
    that own them; interfaces stay natural, the rho-weighted mass keeps
    every local solve SPD; contact springs fold into the owning patch's
    face-normal 1D stiffness), and the patch's global dofs."""
    if float(material.lambda_) <= 0 and float(material.mu) <= 0:
        return None
    dim, d = fes.dim, fes.para_dim
    alpha = _alpha(material, dim, d)
    spring_of_bid = {bid: float(k) for bid, k in contact_springs or []}
    dir_set = set(dir_pairs)
    patches, gdofs = [], []
    for p, patch in enumerate(fes.patches):
        nc = list(patch.n_ctrl())
        xs = np.asarray(patch.control_points)
        ext = xs.max(axis=0) - xs.min(axis=0)
        constrained = {(c, ax): set() for c in range(dim) for ax in range(d)}
        springs = {}
        for attr, pp, axis, end, _sign in fes._bsides:
            if pp != p:
                continue
            bid = attr - 1
            idx = 0 if end == 0 else nc[axis] - 1
            for c in range(dim):
                if (bid, c) in dir_set:
                    constrained[(c, axis)].add(idx)
            if bid in spring_of_bid:
                springs.setdefault((axis, axis), []).append(
                    (idx, spring_of_bid[bid] / alpha[axis, axis])
                )
        mats = [
            _assemble_1d(
                patch.knot_vectors[ax], patch.degrees[ax],
                patch.degrees[ax] + 2, float(ext[ax]),
            )
            for ax in range(d)
        ]
        Ve, lam = _embedded_eigenbases(mats, nc, dim, constrained, springs)
        patches.append({
            "Ve": Ve, "lam": lam, "alpha": alpha, "nc": nc, "dim": dim,
            "rho": float(material.density),
            "mu_v": max(float(material.viscosity), 0.0),
        })
        gdofs.append(fes._gflat(p).astype(np.int32))
    return {"mp": patches, "gdofs": gdofs, "n_dof": int(fes.n_dof), "dim": dim}


def make_fdm_apply(fdm, fac0, fac1, dtype, device):
    """v_flat -> J_hat^{-1} v_flat (2D or 3D patches), tables on `device`;
    the additive-Schwarz sum over patches for multi-patch data."""
    if "mp" in fdm:
        return _make_fdm_apply_multipatch(fdm, fac0, fac1, dtype, device)
    dim = fdm["dim"]
    nc = fdm["nc"]
    d = len(nc)
    rho = fdm["rho"]
    mu_v = fdm["mu_v"]

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    Ve = [[dev(fdm["Ve"][c][ax]) for ax in range(d)] for c in range(dim)]
    D = []
    for c in range(dim):
        coef = [
            fac0 * float(fdm["alpha"][c, ax]) + fac1 * mu_v for ax in range(d)
        ]
        lam = [np.asarray(fdm["lam"][c][ax]) for ax in range(d)]
        if d == 3:
            Dc = (
                rho
                + coef[0] * lam[0][None, None, :]
                + coef[1] * lam[1][None, :, None]
                + coef[2] * lam[2][:, None, None]
            )
        else:
            Dc = rho + coef[0] * lam[0][None, :] + coef[1] * lam[1][:, None]
        D.append(dev(1.0 / Dc))
    n_dof = int(np.prod(nc))

    def apply3(g, V, Dc):
        t = torch.einsum("abi,ik->abk", g, V[0])
        t = torch.einsum("aji,jk->aki", t, V[1])
        t = torch.einsum("jbi,jk->kbi", t, V[2])
        t = t * Dc
        t = torch.einsum("kbi,jk->jbi", t, V[2])
        t = torch.einsum("aki,jk->aji", t, V[1])
        return torch.einsum("abk,ik->abi", t, V[0])

    def apply2(g, V, Dc):
        t = torch.einsum("ai,ik->ak", g, V[0])
        t = torch.einsum("ji,jk->ki", t, V[1])
        t = t * Dc
        t = torch.einsum("ki,jk->ji", t, V[1])
        return torch.einsum("ak,ik->ai", t, V[0])

    one = apply3 if d == 3 else apply2

    def apply(v_flat):
        v = v_flat.reshape(n_dof, dim)
        outs = [
            one(v[:, c].reshape(*nc[::-1]), Ve[c], D[c]).reshape(-1) for c in range(dim)
        ]
        return torch.stack(outs, -1).reshape(-1)

    return apply


def _make_fdm_apply_multipatch(fdm, fac0, fac1, dtype, device):
    """v -> sum_p R_p^T J_hat_p^{-1} R_p v over the per-patch inverses."""
    n_dof, dim = fdm["n_dof"], fdm["dim"]
    applies = [make_fdm_apply(fp, fac0, fac1, dtype, device) for fp in fdm["mp"]]
    gdofs = [
        torch.as_tensor(np.asarray(g), dtype=torch.int64, device=device)
        for g in fdm["gdofs"]
    ]

    def apply(v_flat):
        v = v_flat.reshape(n_dof, dim)
        out = torch.zeros_like(v)
        for ap, g in zip(applies, gdofs):
            out.index_add_(0, g, ap(v[g].reshape(-1)).reshape(-1, dim))
        return out.reshape(-1)

    return apply
