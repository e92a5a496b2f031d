"""B-spline knot-vector utilities (numpy, setup-time only).

Implements Cox-de Boor basis evaluation, derivatives, knot insertion and
degree elevation as *linear operators on control points*, applied axis-wise
to tensor-product patches.  These run once at problem setup; the hot path
(per-quadrature basis tables) is precomputed into dense arrays consumed by
the assembly kernels (see fem/space.py and ops/sweeps.py).

Semantics match the reference solver's discretization layer
(`ElevateDegrees`/`Subdivide` in the reference's py_solid.cpp,
which delegate to MFEM NURBS refinement).  Degree elevation and knot
insertion of B-splines are mathematically unique operations, so any exact
algorithm reproduces the reference control nets; we use the classical
Piegl & Tiller formulations (The NURBS Book, A5.1/A5.9).
"""

from __future__ import annotations

import numpy as np


def find_span(knots: np.ndarray, degree: int, u: float) -> int:
    """Index i such that knots[i] <= u < knots[i+1], clamped to valid spans."""
    n = len(knots) - degree - 1  # number of basis functions
    if u >= knots[n]:
        return n - 1
    if u <= knots[degree]:
        return degree
    lo, hi = degree, n
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if u < knots[mid]:
            hi = mid
        else:
            lo = mid
    return lo


def basis_funs(knots: np.ndarray, degree: int, span: int, u: float) -> np.ndarray:
    """Nonzero basis functions N_{span-degree..span} at u (Cox-de Boor)."""
    N = np.zeros(degree + 1)
    left = np.zeros(degree + 1)
    right = np.zeros(degree + 1)
    N[0] = 1.0
    for j in range(1, degree + 1):
        left[j] = u - knots[span + 1 - j]
        right[j] = knots[span + j] - u
        saved = 0.0
        for r in range(j):
            temp = N[r] / (right[r + 1] + left[j - r])
            N[r] = saved + right[r + 1] * temp
            saved = left[j - r] * temp
        N[j] = saved
    return N


def ders_basis_funs(
    knots: np.ndarray, degree: int, span: int, u: float, n_ders: int
) -> np.ndarray:
    """Basis functions and derivatives, shape (n_ders+1, degree+1).

    Row 0 holds values, row k the k-th derivative (Piegl & Tiller A2.3).
    """
    p = degree
    ndu = np.zeros((p + 1, p + 1))
    left = np.zeros(p + 1)
    right = np.zeros(p + 1)
    ndu[0, 0] = 1.0
    for j in range(1, p + 1):
        left[j] = u - knots[span + 1 - j]
        right[j] = knots[span + j] - u
        saved = 0.0
        for r in range(j):
            ndu[j, r] = right[r + 1] + left[j - r]
            temp = ndu[r, j - 1] / ndu[j, r]
            ndu[r, j] = saved + right[r + 1] * temp
            saved = left[j - r] * temp
        ndu[j, j] = saved

    ders = np.zeros((n_ders + 1, p + 1))
    ders[0, :] = ndu[:, p]
    a = np.zeros((2, p + 1))
    for r in range(p + 1):
        s1, s2 = 0, 1
        a[0, 0] = 1.0
        for k in range(1, n_ders + 1):
            d = 0.0
            rk = r - k
            pk = p - k
            if r >= k:
                a[s2, 0] = a[s1, 0] / ndu[pk + 1, rk]
                d = a[s2, 0] * ndu[rk, pk]
            j1 = 1 if rk >= -1 else -rk
            j2 = k - 1 if (r - 1) <= pk else p - r
            for j in range(j1, j2 + 1):
                a[s2, j] = (a[s1, j] - a[s1, j - 1]) / ndu[pk + 1, rk + j]
                d += a[s2, j] * ndu[rk + j, pk]
            if r <= pk:
                a[s2, k] = -a[s1, k - 1] / ndu[pk + 1, r]
                d += a[s2, k] * ndu[r, pk]
            ders[k, r] = d
            s1, s2 = s2, s1
    r_fac = float(p)
    for k in range(1, n_ders + 1):
        ders[k, :] *= r_fac
        r_fac *= p - k
    return ders


def unique_spans(knots: np.ndarray, degree: int) -> np.ndarray:
    """Breakpoints of nonempty spans: unique knots within the active range."""
    active = knots[degree : len(knots) - degree]
    return np.unique(active)


def n_spans(knots: np.ndarray, degree: int) -> int:
    return len(unique_spans(knots, degree)) - 1


def n_ctrl(knots: np.ndarray, degree: int) -> int:
    return len(knots) - degree - 1


def insertion_operator(
    knots: np.ndarray, degree: int, new_knots: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Knot-insertion as a matrix: P_new = T @ P_old.

    Inserts each value of `new_knots` (sorted, possibly repeated) via Boehm's
    algorithm applied to an identity payload.  Returns (T, refined_knots).
    """
    kv = np.asarray(knots, dtype=float).copy()
    p = degree
    n = n_ctrl(kv, p)
    T = np.eye(n)
    for u in np.sort(np.asarray(new_knots, dtype=float)):
        n_cur = T.shape[0]
        span = find_span(kv, p, u)
        # Boehm single insertion: one new row; rows span-p+1..span are blends.
        Tn = np.zeros((n_cur + 1, T.shape[1]))
        Tn[: span - p + 1] = T[: span - p + 1]
        for i in range(span - p + 1, span + 1):
            denom = kv[i + p] - kv[i]
            alpha = (u - kv[i]) / denom if denom > 0 else 0.0
            Tn[i] = alpha * T[i] + (1.0 - alpha) * T[i - 1]
        Tn[span + 1 :] = T[span:]
        T = Tn
        kv = np.insert(kv, span + 1, u)
    return T, kv


def uniform_refine_knots(knots: np.ndarray, degree: int) -> np.ndarray:
    """Midpoints of every nonempty span (MFEM UniformRefinement semantics)."""
    bps = unique_spans(knots, degree)
    return 0.5 * (bps[:-1] + bps[1:])


def elevation_operator(
    knots: np.ndarray, degree: int, t: int
) -> tuple[np.ndarray, np.ndarray]:
    """Degree elevation by t as a matrix: P_new = T @ P_old.

    Strategy: decompose into Bezier segments (insert knots up to multiplicity
    p), elevate each Bezier segment (binomial formula), then remove the extra
    knots exactly.  All three steps are linear; we compose their operators.
    Degree elevation is unique, so this matches MFEM's result exactly.
    """
    kv = np.asarray(knots, dtype=float)
    p = degree
    # 1. insert knots so every interior breakpoint has multiplicity p
    bps = unique_spans(kv, p)
    to_insert = []
    for b in bps[1:-1]:
        mult = int(np.sum(kv == b))
        to_insert.extend([b] * (p - mult))
    T_ins, kv_bez = insertion_operator(kv, p, np.array(to_insert))

    # 2. elevate each Bezier segment of degree p to p+t
    n_seg = len(bps) - 1
    q = p + t
    # Bezier elevation matrix E (q+1, p+1): B^q_i = sum_j E[i,j] B^p_j
    from math import comb

    E = np.zeros((q + 1, p + 1))
    for i in range(q + 1):
        for j in range(max(0, i - t), min(p, i) + 1):
            E[i, j] = comb(p, j) * comb(t, i - j) / comb(q, i)

    n_bez = T_ins.shape[0]
    # segment s occupies rows s*p .. s*p+p (shared endpoints)
    n_new = n_seg * q + 1
    T_elev = np.zeros((n_new, n_bez))
    for s in range(n_seg):
        rows = slice(s * q, s * q + q + 1)
        cols = slice(s * p, s * p + p + 1)
        # shared endpoint rows are written consistently by both segments
        T_elev[rows, cols] = E
    # elevated knot vector: every breakpoint with multiplicity += t
    kv_new = []
    for b in bps:
        mult = int(np.sum(kv == b)) + t
        kv_new.extend([b] * mult)
    kv_elev_bez = []
    for b in bps:
        if b == bps[0] or b == bps[-1]:
            kv_elev_bez.extend([b] * (q + 1))
        else:
            kv_elev_bez.extend([b] * q)
    kv_elev_bez = np.array(kv_elev_bez, dtype=float)

    # 3. remove interior knots back to original multiplicity + t
    T_rem, kv_final = removal_operator_exact(kv_elev_bez, q, kv, p, t)
    T = T_rem @ T_elev @ T_ins
    return T, kv_final


def removal_operator_exact(
    kv_bez: np.ndarray,
    q: int,
    kv_orig: np.ndarray,
    p: int,
    t: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact-knot-removal operator from Bezier-form degree-q spline back to
    the minimal degree-q knot vector (original multiplicities + t).

    Because the underlying curve is exactly representable in the target
    space, we solve the (overdetermined, consistent) interpolation problem
    via least squares on a collocation matrix at Greville-type parameters.
    """
    # target knot vector
    bps = unique_spans(kv_orig, p)
    kv_t = []
    kv_t.extend([bps[0]] * (q + 1))
    for b in bps[1:-1]:
        mult = int(np.sum(kv_orig == b)) + t
        kv_t.extend([b] * mult)
    kv_t.extend([bps[-1]] * (q + 1))
    kv_t = np.array(kv_t, dtype=float)

    n_t = n_ctrl(kv_t, q)
    n_b = n_ctrl(kv_bez, q)

    # collocation at a dense set of parameters (Chebyshev-like per span)
    pts = []
    for a, b in zip(bps[:-1], bps[1:]):
        pts.extend(np.linspace(a, b, q + 3)[:-1])
    pts.append(bps[-1])
    pts = np.array(pts)

    def colloc(kv, deg):
        A = np.zeros((len(pts), n_ctrl(kv, deg)))
        for r, u in enumerate(pts):
            s = find_span(kv, deg, u)
            A[r, s - deg : s + 1] = basis_funs(kv, deg, s, u)
        return A

    A_t = colloc(kv_t, q)
    A_b = colloc(kv_bez, q)
    # Solve A_t @ T = A_b  (consistent):  T = pinv via lstsq
    T, *_ = np.linalg.lstsq(A_t, A_b, rcond=None)
    # clean numerical noise
    T[np.abs(T) < 1e-12] = 0.0
    return T, kv_t


def greville(knots: np.ndarray, degree: int) -> np.ndarray:
    n = n_ctrl(knots, degree)
    return np.array(
        [np.mean(knots[i + 1 : i + degree + 1]) for i in range(n)]
    )
