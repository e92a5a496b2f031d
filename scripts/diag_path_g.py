#!/usr/bin/env python3
"""Drive path G of chip_smoke.py (the 2D two-patch press with J2Simo,
dense (2, 2), 2 x 512^2; 1 warm + PRESS_F_TIMED steps) up to --attempts
times on one CUDA GPU and, at each path state, hold the viscous dense
residual kernel against its plain twin; at the first state where they
differ by more than 1e-3 of the scale, print the worst element's points:
F, det F, the state, P from the kernel (recovered point by point from
one-hot quadrature weights), from the plain twin in float32 and from
float64, the trial state and the return map.  Each attempt prints the
state it ends at: det F min, the points with det F <= 0 and a SHA-256 of
the carry (u, v, a and the material state, in that order); the drive's
scatters add in a fixed order (fem/scatter.py), so every attempt, and
every run of the script, should end at the same state.  The drives run
under torch.use_deterministic_algorithms(True, warn_only=True), and the
operations that torch knows to be nondeterministic on the card are
printed.  A failed check of the drive is printed, not raised.

    python3 scripts/diag_path_g.py [--attempts 5]
"""

import argparse
import hashlib
import os
import subprocess
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def worst_point(torch, mt, sweeps, soa, prob, f, e, dt, mu_v):
    """Print element e's points: P from the kernel, the plain twin in
    float32 and float64, the trial state and the return map at the point
    where the kernel is farthest from float64."""
    from mimi_tpu_torch.materials import kernel_solver_mode, record_trips

    mat = prob.material
    sl = slice(e, e + 1)
    el = lambda t: t[..., sl].contiguous()  # noqa: E731
    ue, dNe, Ne, wqe = el(f["u_el"]), el(prob.dense["dN_t"]), el(prob.dense["N_t"]), el(prob.wdet_t)
    ste = {k: el(v) for k, v in f["state"].items()}
    ste64 = {k: v.double() for k, v in ste.items()}
    Fe = soa.add_diag(sweeps.dense_grad(ue, dNe), 1.0)
    with kernel_solver_mode(), record_trips() as trips:
        P32 = mat.pk1_soa(Fe, ste, dt)
    with kernel_solver_mode():
        P64 = mat.pk1_soa(Fe.double(), ste64, dt)
    zero = torch.zeros_like(ue)
    Pk = torch.empty_like(P32)
    for q in range(wqe.shape[0]):  # y[c, n] = sum_d dN[n, d](q) X[c, d] with a = v = 0
        w1 = torch.zeros_like(wqe)
        w1[q] = 1.0
        yq = sweeps.residual_dense(ue, zero, ste, dNe, Ne, w1, mat, dt, 1.0, v_el=zero, mu_v=mu_v)
        X = torch.linalg.lstsq(dNe[:, :, q, 0].double(), yq[:, :, 0].double().T).solution.T
        Pk[:, :, q, 0] = X.float()
    dk = (Pk.double() - P64).abs().amax(dim=(0, 1))[:, 0]
    dp = (P32.double() - P64).abs().amax(dim=(0, 1))[:, 0]
    qw = int(dk.argmax())
    print(f"per point |P_kernel - P64| {dk.tolist()}\n|P_plain - P64| {dp.tolist()}")
    print(f"trips of the twin {[t.reshape(-1).tolist() for t in trips]}")
    print(f"worst point {qw}: F {Fe[:, :, qw, 0].tolist()}, det F {float(soa.det(Fe)[qw, 0])}")
    for k, v in ste.items():
        print(f"  {k} {(v[..., qw, 0] if v.dim() == 4 else v[qw, 0]).tolist()}")
    print(f"  P kernel {Pk[:, :, qw, 0].tolist()}\n  P plain {P32[:, :, qw, 0].tolist()}\n"
          f"  P float64 {P64[:, :, qw, 0].tolist()}")
    with kernel_solver_mode():
        for name, r in (("float32", mat._return_map_soa(Fe, ste, dt)),
                        ("float64", mat._return_map_soa(Fe.double(), ste64, dt))):
            print(f"  return map {name}: " + "; ".join(
                str(x[..., qw, 0].tolist() if torch.is_tensor(x) and x.dim() >= 2 else x)
                for x in r))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--attempts", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA GPU")
    import chip_smoke as cs
    import mimi_tpu_torch as mt
    from mimi_tpu_torch.fem import soa
    from mimi_tpu_torch.materials import kernel_solver_mode
    from mimi_tpu_torch.ops import build as kbuild
    from mimi_tpu_torch.ops import sweeps
    from mimi_tpu_torch.parallel import sharding as sh

    cs.fail = lambda msg: print(f"FAIL (printed, not raised): {msg}", flush=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    warnings.simplefilter("always")
    warnings.showwarning = lambda msg, *_: print(f"torch warns: {msg}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    kbuild.load()
    device = torch.device("cuda")
    step_kw = dict(cs.PRESS_STEP_KW)
    dt = step_kw["dt"]
    base = cs.press_build(mt, 2, cs.PRESS_2D_SUBDIVIDE, device, None,
                          cs.press_finite_material(mt, "J2Simo"))
    for attempt in range(args.attempts):
        prob = cs.with_material(soa, base, cs.press_finite_material(mt, "J2Simo"))
        carry = cs.drive_press(torch, mt, sweeps, prob, f"attempt {attempt}", step_kw,
                               cs.PRESS_F_TIMED)[0]
        g, _ = sh._gather_scatter(prob)
        fc = prob.facs
        xa = carry["u"] + (carry["v"] + fc["fac0"] * dt * carry["a"]) * fc["fac1"] * dt
        va = carry["v"] + fc["fac2"] * dt * carry["a"]
        f = {"u_el": g(xa), "a_el": g(carry["a"]), "v_el": g(va), "state": carry["state"]}
        mat, mu_v = prob.material, float(prob.material.viscosity)
        dN, N, wq = prob.dense["dN_t"], prob.dense["N_t"], prob.wdet_t
        a = (f["u_el"], f["a_el"], f["state"], dN, N, wq, mat, dt, float(mat.density))
        y_k = sweeps.residual_dense(*a, v_el=f["v_el"], mu_v=mu_v)
        with kernel_solver_mode():
            y_p = sweeps.residual_dense_plain(*a, v_el=f["v_el"], mu_v=mu_v)
        d = (y_k - y_p).abs()
        err, scale = float(d.max()), float(y_p.abs().max())
        J = soa.det(soa.add_diag(sweeps.dense_grad(f["u_el"], dN), 1.0))
        digest = hashlib.sha256()
        for t in (carry["u"], carry["v"], carry["a"],
                  *(carry["state"][k] for k in sorted(carry["state"]))):
            digest.update(t.detach().cpu().contiguous().numpy().tobytes())
        print(f"attempt {attempt}: residual kernel vs plain {err:.4e} of {scale:.4e} "
              f"({err / scale:.3e}); det F min {float(J.min())!r}, points with det F <= 0 "
              f"{int((J <= 0).sum())}, carry sha256 {digest.hexdigest()}", flush=True)
        if err > 1e-3 * scale:
            worst_point(torch, mt, sweeps, soa, prob, f, int(d.amax(dim=(0, 1)).argmax()), dt,
                        mu_v)
            break
        del carry, f, a, y_k, y_p, d, J, prob
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
