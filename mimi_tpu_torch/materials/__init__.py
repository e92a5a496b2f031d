"""Material models as torch functions of the deformation gradient plus
per-quadrature-point state.

Counterpart of mimi_tpu/materials/__init__.py for the structure-of-arrays
(SoA) hot path: F arrives as (dim, dim, *batch), state leaves as
(dim, dim, *batch) or (*batch) tensors (fem/soa.py).  Each model exposes
`cauchy_soa`, `pk1_soa` (stress, no state change) and `accumulate_soa`
(the converged-step state update).  Tangents are forward-mode derivatives
(torch.func.jvp) of these functions; the radial-return scalar solve runs
on detached tensors and re-injects its exact sensitivity through one
implicit-function-theorem correction.

Every model works on 2 x 2 (2D) and 3 x 3 (3D) tensors, as the reference's
do (a true 2 x 2 tensor in 2D, the deviator over trace / 2).  Ported:
`J2` (small-strain J2 with nonlinear isotropic hardening, any of the
reference's five laws) and `J2Linear` (small-strain J2 with linear
isotropic and kinematic hardening, a closed-form return), both with the
Cauchy-decomposition tangent storage (37 planes in 3D and 14 in 2D), the finite-strain plasticity models
`J2Simo` and `J2Log` (the 81-plane `full` storage, whose planes the CUDA
assemble kernels form by forward-mode dual numbers), and the hyperelastic
`CompressibleOgdenNeoHookean` and `StVenantKirchhoff` (each with its
closed-form dP/dF as `tangent_soa`, the 45-plane `sym` storage).
"""

from __future__ import annotations

import contextlib
import math

import torch

from .hardening import Hardening
from .logm import expm_sym_soa, logm_sym_soa
from .scalar_solve import make_scalar_solver
from ..config import default_dtype, resolve_device
from ..fem import soa

_K_TOL = 1.0e-10
# trips of the radial return's scalar solve inside the reference's Pallas
# kernels (its fixed-trip `_solver_fori`, materials/__init__.py of the JAX
# package): the CUDA kernels run the same cap (ops/sweeps.py _j2_params),
# the "torch" engine and the state update the solver's 100
KERNEL_SOLVE_TRIPS = 40

_KERNEL_SOLVE = {"on": False, "trips": None}


@contextlib.contextmanager
def kernel_solver_mode():
    """Inside: the radial return's scalar solve stops at KERNEL_SOLVE_TRIPS
    trips, as inside the reference's kernels (its `kernel_solver_mode`) and
    the port's CUDA kernels: the plain twin that a kernel is held against."""
    old = _KERNEL_SOLVE["on"]
    _KERNEL_SOLVE["on"] = True
    try:
        yield
    finally:
        _KERNEL_SOLVE["on"] = old


@contextlib.contextmanager
def record_trips():
    """Inside: every radial-return solve appends to the yielded list the
    trips each lane ran (0 on an elastic lane; the cap on a lane that never
    converged)."""
    old = _KERNEL_SOLVE["trips"]
    log = _KERNEL_SOLVE["trips"] = []
    try:
        yield log
    finally:
        _KERNEL_SOLVE["trips"] = old


class Material:
    """Base: parameter store + elastic-constant conversions."""

    # sigma symmetric and a function of F only through sym(F): the step
    # may then store the 37-plane Cauchy-decomposition tangent
    # (ops/sweeps.py cauchy_plane_layout)
    tangent_cauchy_decomp = False
    # dP/dF has major symmetry (a hyperelastic energy Hessian): the step
    # may then store the 45-plane symmetric tangent (sweeps.py
    # tri_index_map(9))
    tangent_major_symmetric = False
    has_state = False

    def __init__(self):
        self.density = -1.0
        self.viscosity = -1.0
        self.lambda_ = -1.0
        self.mu = -1.0
        self.young = -1.0
        self.poisson = -1.0
        self.K = -1.0
        self.G = -1.0

    def name(self):
        return type(self).__name__

    def set_young_poisson(self, young, poisson):
        self.young = young
        self.poisson = poisson
        self.lambda_ = young * poisson / ((1 + poisson) * (1 - 2 * poisson))
        self.mu = young / (2.0 * (1.0 + poisson))
        self.G = self.mu
        self.K = young / (3.0 * (1.0 - 2.0 * poisson))

    def set_lame(self, lam, mu):
        self.young = mu * (3 * lam + 2 * mu) / (lam + mu)
        self.poisson = lam / (2 * (lam + mu))
        self.lambda_ = lam
        self.mu = mu
        self.G = mu
        self.K = lam + 2 * mu / 3

    def setup(self, dim):
        self.dim = dim

    def init_state(self, shape_prefix, dtype=None, device="cuda"):
        """Initial state over a `shape_prefix` batch on `device` (the card
        unless "cpu" is passed), or None for a stateless material."""
        return None

    def pk1_soa(self, F, state, dt):
        raise NotImplementedError(f"{self.name()} has no SoA fast path")

    def accumulate_soa(self, F, state, dt):
        return state


def _pk1_from_cauchy_soa(sigma, F):
    """P = det(F) sigma F^{-T}."""
    return soa.det(F) * soa.matmul_nt(sigma, soa.inv(F))


class StVenantKirchhoff(Material):
    """E = (F^T F - I) / 2, S = lambda tr(E) I + 2 mu E, P = F S."""

    tangent_major_symmetric = True  # P = F S(E): d2W/dF2 Hessian

    def _second_pk(self, F):
        E = 0.5 * soa.add_diag(soa.matmul_tn(F, F), -1.0)
        return soa.add_diag(2.0 * self.mu * E, self.lambda_ * soa.trace(E))

    def pk1_soa(self, F, state, dt):
        # the CUDA kernels repeat these operations in this order
        return soa.matmul(F, self._second_pk(F))

    def tangent_soa(self, F):
        """Closed-form dP/dF as C[c, d, g, f] = dP_cd / dF_gf over the
        batch of F: with dS = lambda tr(F^T dF) I + mu (dF^T F + F^T dF),
          dP = dF S + F dS,
        so C_cdgf = d_cg S_fd + lambda F_cd F_gf
                    + mu (F_cf F_gd + B_cg d_df), B = F F^T."""
        S = self._second_pk(F)
        B = soa.matmul_nt(F, F)
        n = F.shape[0]
        rows = []
        for c in range(n):
            for d in range(n):
                for g in range(n):
                    for f in range(n):
                        x = self.lambda_ * F[c, d] * F[g, f] + self.mu * F[c, f] * F[g, d]
                        if c == g:
                            x = x + S[f, d]
                        if d == f:
                            x = x + self.mu * B[c, g]
                        rows.append(x)
        return torch.stack(rows, 0).reshape(n, n, n, n, *F.shape[2:])


def neohookean_pk1_soa(F, lam, mu):
    """P = J sigma F^-T with sigma = mu/J (B - I) + lambda (J - 1) I: sigma
    first, then J sigma F^-T, as the reference package writes it (the CUDA
    kernels repeat these operations in this order)."""
    J = soa.det(F)
    B = soa.matmul_nt(F, F)
    mu_over_J = mu / J
    sigma = soa.add_diag(mu_over_J * B, -mu_over_J + lam * (J - 1.0))
    return _pk1_from_cauchy_soa(sigma, F)


class CompressibleOgdenNeoHookean(Material):
    """sigma = mu/J (B - I) + lambda (J - 1) I (the reference's
    materials.hpp), P = J sigma F^{-T}."""

    tangent_major_symmetric = True  # hyperelastic energy Hessian

    def pk1_soa(self, F, state, dt):
        return neohookean_pk1_soa(F, self.lambda_, self.mu)

    def tangent_soa(self, F):
        """Closed-form dP/dF as C[c, d, g, f] = dP_cd / dF_gf over the
        batch of F: with P = mu F + (lambda J (J - 1) - mu) F^-T,
          dP = mu dF + lambda (2J - 1) J tr(F^-1 dF) F^-T
               - (lambda J (J - 1) - mu) F^-T dF^T F^-T,
        so C_cdgf = mu d_cg d_df + k1 G_cd G_gf - k2 G_cf G_gd with
        G = F^-T, k1 = lambda (2J - 1) J, k2 = lambda J (J - 1) - mu."""
        J = soa.det(F)
        fi = soa.inv(F)
        k1 = self.lambda_ * (2.0 * J - 1.0) * J
        k2 = self.lambda_ * J * (J - 1.0) - self.mu
        n = F.shape[0]
        rows = []
        for c in range(n):
            for d in range(n):
                for g in range(n):
                    for f in range(n):
                        x = k1 * fi[d, c] * fi[f, g] - k2 * fi[f, c] * fi[d, g]
                        if c == g and d == f:
                            x = x + self.mu
                        rows.append(x)
        return torch.stack(rows, 0).reshape(n, n, n, n, *F.shape[2:])


class J2Linear(Material):
    """Small-strain J2 with linear isotropic and kinematic hardening and a
    closed-form return (the reference's materials.hpp J2Linear, "Computational
    Methods for Plasticity" box 7.5).  State: plastic_strain, beta (the
    back stress), eqps."""

    has_state = True
    tangent_cauchy_decomp = True  # sigma = sigma(sym F), symmetric

    def __init__(self):
        super().__init__()
        self.isotropic_hardening = 0.0
        self.kinematic_hardening = 0.0
        self.sigma_y = 0.0

    def init_state(self, shape_prefix, dtype=None, device="cuda"):
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        d = self.dim
        return {
            "plastic_strain": torch.zeros((*shape_prefix, d, d), dtype=dtype, device=device),
            "beta": torch.zeros((*shape_prefix, d, d), dtype=dtype, device=device),
            "eqps": torch.zeros(shape_prefix, dtype=dtype, device=device),
        }

    def _common_soa(self, F, state):
        # the CUDA kernels (csrc/j2.cuh j2_linear_cauchy) repeat these
        # operations in this order up to the yield decision phi > 0
        G = self.G
        eps = soa.add_diag(soa.sym(F) - state["plastic_strain"], -1.0)
        p = self.K * soa.trace(eps)
        s = soa.dev(eps, 2.0 * G)
        eta = s - state["beta"]
        eta_norm = soa.fro_norm(eta)
        q = math.sqrt(1.5) * eta_norm
        phi = q - (self.sigma_y + self.isotropic_hardening * state["eqps"])
        denom = 3.0 * G + self.kinematic_hardening + self.isotropic_hardening
        dps = torch.where(phi > 0.0, phi / denom, 0.0)
        eta_hat = eta / torch.where(eta_norm > 0.0, eta_norm, 1.0)
        return p, s, eta_hat, dps

    def cauchy_soa(self, F, state, dt):
        p, s, eta_hat, dps = self._common_soa(F, state)
        s = s - math.sqrt(6.0) * self.G * dps * eta_hat
        return soa.add_diag(s, p)

    def pk1_soa(self, F, state, dt):
        return _pk1_from_cauchy_soa(self.cauchy_soa(F, state, dt), F)

    def accumulate_soa(self, F, state, dt):
        _, _, eta_hat, dps = self._common_soa(F, state)
        return {
            "plastic_strain": state["plastic_strain"] + math.sqrt(1.5) * dps * eta_hat,
            "beta": state["beta"]
            + math.sqrt(2.0 / 3.0) * self.kinematic_hardening * dps * eta_hat,
            "eqps": state["eqps"] + dps,
        }


class _J2ThermoBase(Material):
    """Shared parameters and radial-return machinery of the J2 family."""

    has_state = True

    def __init__(self):
        super().__init__()
        self.hardening: Hardening | None = None
        self.heat_fraction = 0.9
        self.specific_heat = -1.0
        self.initial_temperature = 20.0
        self.melting_temperature = -1.0

    def setup(self, dim):
        super().setup(dim)
        if self.hardening is None:
            raise RuntimeError(f"hardening missing for {self.name()}")
        self.hardening.initialize_temperature(
            self.initial_temperature, self.melting_temperature
        )
        self.hardening.validate()
        self._tolerance = self.hardening.sigma_y_value() * _K_TOL
        hard = self.hardening

        # residual(delta_eqps; q, eqps_old, thermo, dt, slope), slope = 3G
        # (J2, J2Log) or G tr(be) (J2Simo), and its derivative in delta
        def residual_grad(delta, q, eqps_old, thermo, dt, slope):
            rate = delta / dt
            flow = hard.evaluate(eqps_old + delta)
            rc = hard.rate_contribution(rate)
            d_flow = hard.evaluate_grad(eqps_old + delta)
            d_rc = hard.rate_contribution_grad(rate)
            r = q - slope * delta - flow * (rc * thermo)
            return r, -slope - (d_flow * (rc * thermo) + flow * ((d_rc / dt) * thermo))

        self._residual_grad = residual_grad
        self._solver = make_scalar_solver(residual_grad, _K_TOL, 100)
        self._solver_fori = make_scalar_solver(residual_grad, _K_TOL, KERNEL_SOLVE_TRIPS)

    def _solve_delta_eqps(self, q, eqps_old, thermo, dt, slope):
        """Masked radial-return solve: active where residual(0) > tol.

        The scalar solve takes KERNEL_SOLVE_TRIPS trips inside
        kernel_solver_mode(), 100 outside.  The bracketed Newton-bisection runs on detached inputs; the exact
        sensitivity comes back through one implicit-function-theorem
        correction delta = d* - r(d*, theta)/r'(d*), whose value equals d*
        (r ~ 0 there) and whose forward derivative is the IFT derivative.
        """
        hard = self.hardening
        thermo = torch.as_tensor(thermo, dtype=q.dtype, device=q.device)
        r0, _ = self._residual_grad(
            torch.zeros_like(q), q, eqps_old, thermo, dt, slope
        )
        active = r0 > self._tolerance
        eval0 = hard.evaluate(eqps_old)
        ub_raw = (q - eval0 * thermo) / slope
        # benign substitute problem on elastic lanes (result discarded):
        # residual(0) == 0 there, so they converge on the first check
        q_safe = torch.where(active, q, eval0 * thermo)
        ub = torch.where(active, ub_raw, 1.0)
        # slope: 3G, or a tensor with tangents (J2Simo's G tr(be))
        slope_ng = slope.detach() if torch.is_tensor(slope) else slope
        theta_ng = (
            q_safe.detach(), eqps_old.detach(), thermo.detach(), dt, slope_ng
        )
        solver = self._solver_fori if _KERNEL_SOLVE["on"] else self._solver
        log = _KERNEL_SOLVE["trips"]
        d_star = solver(0.0, 0.0, ub.detach(), self._tolerance, theta_ng,
                        return_trips=log is not None)
        if log is not None:
            d_star, trips = d_star
            log.append(torch.where(active, trips, 0))
        # differentiable re-injection (theta with its tangents)
        fval, _ = self._residual_grad(d_star, q_safe, eqps_old, thermo, dt, slope)
        _, fprime = self._residual_grad(d_star, *theta_ng)
        delta = d_star - fval / fprime
        return torch.where(active, delta, 0.0), active


class J2(_J2ThermoBase):
    """Small-strain J2, nonlinear isotropic hardening (the reference's
    materials.hpp J2)."""

    tangent_cauchy_decomp = True  # sigma = sigma(sym F), symmetric

    def init_state(self, shape_prefix, dtype=None, device="cuda"):
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        d = self.dim
        return {
            "plastic_strain": torch.zeros(
                (*shape_prefix, d, d), dtype=dtype, device=device
            ),
            "eqps": torch.zeros(shape_prefix, dtype=dtype, device=device),
            "temperature": torch.full(
                shape_prefix, float(self.initial_temperature),
                dtype=dtype, device=device,
            ),
        }

    def _trial_soa(self, F, state):
        eps = soa.add_diag(soa.sym(F) - state["plastic_strain"], -1.0)
        p = self.K * soa.trace(eps)
        s = soa.dev(eps, 2.0 * self.G)
        q = math.sqrt(1.5) * soa.fro_norm(s)
        return p, s, q

    def _return_map(self, F, state, dt):
        p, s, q = self._trial_soa(F, state)
        thermo = self.hardening.thermo_contribution(state["temperature"])
        delta, active = self._solve_delta_eqps(
            q, state["eqps"], thermo, dt, 3.0 * self.G
        )
        N_p = (1.5 / torch.where(q > 0.0, q, 1.0)) * s
        return p, s, q, delta, active, N_p

    def cauchy_soa(self, F, state, dt):
        p, s, q, delta, active, N_p = self._return_map(F, state, dt)
        return soa.add_diag(_plastic_correction(self, s, delta, active, N_p), p)

    def pk1_soa(self, F, state, dt):
        return _pk1_from_cauchy_soa(self.cauchy_soa(F, state, dt), F)

    def accumulate_soa(self, F, state, dt):
        p, s, q, delta, active, N_p = self._return_map(F, state, dt)
        new = dict(state)
        new["eqps"] = state["eqps"] + delta
        new["plastic_strain"] = state["plastic_strain"] + delta * N_p
        if self.hardening.is_temperature_dependent():
            new["temperature"] = _heat(self, state, q, delta, active)
        return new


def _plastic_correction(mat, s, delta, active, N_p):
    """s - 2 G delta N_p where the point yields, s where it is elastic.
    There delta is 0, and the term is left out rather than formed: where
    q^2 is subnormal in float32 the flow direction's derivative 1.5 q' / q^2
    overflows, and 0 x inf would make the tangent NaN (the reference's XLA
    flushes subnormals to zero, so its q is 0 there and its tangent finite)."""
    return torch.where(active, s - 2.0 * mat.G * delta * N_p, s)


def _eye_state(shape_prefix, d, dtype, device):
    """Identity tensors over a batch, (*shape_prefix, d, d), contiguous."""
    return torch.eye(d, dtype=dtype, device=device).expand(*shape_prefix, d, d).clone()


def _heat(mat, state, q, delta, active):
    """The temperature after the increment: adiabatic heating of the
    plastic work where the point yielded."""
    return state["temperature"] + torch.where(
        active,
        mat.heat_fraction * q * delta / (mat.density * mat.specific_heat),
        0.0,
    )


class J2Simo(_J2ThermoBase):
    """Finite-strain J2 (Simo): multiplicative split with the elastic left
    Cauchy-Green trial push-forward (the reference's materials.hpp
    J2Simo).  State: be_old, F_old (3 x 3), eqps, temperature."""

    def init_state(self, shape_prefix, dtype=None, device="cuda"):
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        d = self.dim
        return {
            "be_old": _eye_state(shape_prefix, d, dtype, device),
            "F_old": _eye_state(shape_prefix, d, dtype, device),
            "eqps": torch.zeros(shape_prefix, dtype=dtype, device=device),
            "temperature": torch.full(
                shape_prefix, float(self.initial_temperature), dtype=dtype, device=device
            ),
        }

    def _trial_soa(self, F, state):
        # f_inv = F_old F^-1, f_bar = inv(f_inv) cbrt(det), as the reference
        # computes it (an inverse of an inverse, then the cube root)
        d = F.shape[0]
        f_inv = soa.matmul(state["F_old"], soa.inv(F))
        f_bar = soa.inv(f_inv)
        f_bar = f_bar * soa.cbrt(soa.det(f_bar))
        be = soa.matmul_nt(soa.matmul(f_bar, state["be_old"]), f_bar)
        s = soa.dev(be, self.G)
        s_norm = soa.fro_norm(s)
        near_zero = s_norm < torch.finfo(s.dtype).eps
        s_hat = math.sqrt(1.5) / torch.where(near_zero, 1.0, s_norm) * s
        N_p = soa.stack2(
            [
                [
                    torch.where(
                        near_zero,
                        math.sqrt(0.5) if i == j else s_hat[i, j] * 0.0,
                        s_hat[i, j],
                    )
                    for j in range(d)
                ]
                for i in range(d)
            ]
        )
        q = soa.ddot(N_p, s)  # s_effective
        return be, s, N_p, q

    def _return_map_soa(self, F, state, dt):
        be, s, N_p, q = self._trial_soa(F, state)
        thermo = self.hardening.thermo_contribution(state["temperature"])
        be_trace = soa.trace(be)
        delta, active = self._solve_delta_eqps(
            q, state["eqps"], thermo, dt, self.G * be_trace
        )
        be = be - (2.0 / 3.0) * delta * be_trace * N_p
        s = soa.dev(be, self.G)
        return be, s, q, delta, active

    def pk1_soa(self, F, state, dt):
        be, s, q, delta, active = self._return_map_soa(F, state, dt)
        J = soa.det(F)
        tau = soa.add_diag(s, self.K * (J * J - 1.0) * 0.5)
        return soa.matmul_nt(tau, soa.inv(F))

    def accumulate_soa(self, F, state, dt):
        be, s, q, delta, active = self._return_map_soa(F, state, dt)
        new = dict(state)
        new["F_old"] = F
        new["be_old"] = be
        new["eqps"] = state["eqps"] + delta
        if self.hardening.is_temperature_dependent():
            new["temperature"] = _heat(self, state, q, delta, active)
        return new


class J2Log(_J2ThermoBase):
    """Finite-strain J2 in the logarithmic (Hencky) strain with the
    exponential-map update of Fp^-1 (the reference's materials.hpp J2Log).
    The first Piola stress is P = (det(F) s + p I) F^-T, as the reference's
    call chain forms it.  State: Fp_inv (3 x 3), eqps, temperature."""

    def init_state(self, shape_prefix, dtype=None, device="cuda"):
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        return {
            "Fp_inv": _eye_state(shape_prefix, self.dim, dtype, device),
            "eqps": torch.zeros(shape_prefix, dtype=dtype, device=device),
            "temperature": torch.full(
                shape_prefix, float(self.initial_temperature), dtype=dtype, device=device
            ),
        }

    def _return_map_soa(self, F, state, dt):
        F_e = soa.matmul(F, state["Fp_inv"])
        C_e = soa.matmul_tn(F_e, F_e)
        E_e = 0.5 * logm_sym_soa(C_e)
        p = self.K * soa.trace(E_e)
        s = soa.dev(E_e, 2.0 * self.G)
        q = math.sqrt(1.5) * soa.fro_norm(s)
        thermo = self.hardening.thermo_contribution(state["temperature"])
        delta, active = self._solve_delta_eqps(
            q, state["eqps"], thermo, dt, 3.0 * self.G
        )
        N_p = (1.5 / torch.where(q > 0.0, q, 1.0)) * s
        s = _plastic_correction(self, s, delta, active, N_p)
        return p, s, q, delta, active, N_p

    def pk1_soa(self, F, state, dt):
        p, s, q, delta, active, N_p = self._return_map_soa(F, state, dt)
        J = soa.det(F)
        M = soa.add_diag(s, p / J)
        return J * soa.matmul_nt(M, soa.inv(F))

    def accumulate_soa(self, F, state, dt):
        p, s, q, delta, active, N_p = self._return_map_soa(F, state, dt)
        # delta == 0 on elastic points, where expm(0) == I exactly
        exp_inc = expm_sym_soa(-delta * N_p)
        new = dict(state)
        new["Fp_inv"] = soa.matmul(state["Fp_inv"], exp_inc)
        new["eqps"] = state["eqps"] + delta
        if self.hardening.is_temperature_dependent():
            new["temperature"] = _heat(self, state, q, delta, active)
        return new
