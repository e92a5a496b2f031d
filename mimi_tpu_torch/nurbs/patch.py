"""Tensor-product NURBS patch with refinement operations.

Control points are stored in lexicographic order: a grid of shape
(n_0, n_1[, n_2], dim) where axis 0 (the first parametric direction) varies
*fastest* when flattened with ``reshape(order="F")`` convention — i.e. the
flat index of grid point (i, j, k) is ``i + n0*(j + n1*k)``.

Refinement (degree elevation / knot insertion) operates on homogeneous
coordinates (w*x, w) and is applied axis-by-axis via the linear operators in
nurbs/knots.py.  Mirrors the behavior of the reference's
`ElevateDegrees`/`Subdivide` (the reference's py_solid.cpp).
"""

from __future__ import annotations

import numpy as np

from . import knots as kn


class NurbsPatch:
    def __init__(
        self,
        degrees: list[int],
        knot_vectors: list[np.ndarray],
        control_points: np.ndarray,  # (n_cp_total, dim), lexicographic
        weights: np.ndarray,  # (n_cp_total,)
    ):
        self.degrees = [int(d) for d in degrees]
        self.knot_vectors = [np.asarray(k, dtype=float) for k in knot_vectors]
        self.para_dim = len(self.degrees)
        cps = np.asarray(control_points, dtype=float)
        self.dim = cps.shape[1]
        self.control_points = cps
        self.weights = np.asarray(weights, dtype=float).ravel()
        assert self.control_points.shape[0] == self.n_ctrl_total()

    # ---------------- basic queries ----------------
    def n_ctrl(self) -> list[int]:
        return [
            kn.n_ctrl(k, p) for k, p in zip(self.knot_vectors, self.degrees)
        ]

    def n_ctrl_total(self) -> int:
        return int(np.prod(self.n_ctrl()))

    def n_spans(self) -> list[int]:
        return [
            kn.n_spans(k, p) for k, p in zip(self.knot_vectors, self.degrees)
        ]

    def span_breakpoints(self) -> list[np.ndarray]:
        return [
            kn.unique_spans(k, p)
            for k, p in zip(self.knot_vectors, self.degrees)
        ]

    # ---------------- homogeneous grid helpers ----------------
    def _hom_grid(self) -> np.ndarray:
        """(n0, n1[, n2], dim+1) homogeneous control grid (w*x, w)."""
        nc = self.n_ctrl()
        hom = np.concatenate(
            [
                self.control_points * self.weights[:, None],
                self.weights[:, None],
            ],
            axis=1,
        )
        # flat index i + n0*j + n0*n1*k -> grid (i, j, k)
        return hom.reshape(*nc[::-1], self.dim + 1).transpose(
            *range(self.para_dim - 1, -1, -1), self.para_dim
        )

    def _set_from_hom_grid(self, grid: np.ndarray) -> None:
        pd = self.para_dim
        flat = grid.transpose(*range(pd - 1, -1, -1), pd).reshape(
            -1, self.dim + 1
        )
        w = flat[:, -1]
        self.weights = w
        self.control_points = flat[:, :-1] / w[:, None]

    def _apply_axis_operator(
        self,
        axis: int,
        T: np.ndarray,
        new_kv: np.ndarray,
        new_degree: int | None = None,
    ):
        # grab the grid BEFORE mutating kv/degree (n_ctrl depends on both)
        grid = self._hom_grid()
        grid = np.moveaxis(grid, axis, 0)
        shp = grid.shape
        flat = grid.reshape(shp[0], -1)
        out = T @ flat
        grid = out.reshape(T.shape[0], *shp[1:])
        grid = np.moveaxis(grid, 0, axis)
        self.knot_vectors[axis] = new_kv
        if new_degree is not None:
            self.degrees[axis] = new_degree
        self._set_from_hom_grid(grid)

    # ---------------- refinement ----------------
    def elevate_degrees(self, t: int, max_degree: int = 50) -> None:
        for axis in range(self.para_dim):
            if self.degrees[axis] + t > max_degree:
                continue
            self.elevate_axis(axis, t)

    def elevate_axis(self, axis: int, t: int) -> None:
        """Elevate the degree of one parametric axis by t (degrees that
        differ per axis)."""
        T, new_kv = kn.elevation_operator(
            self.knot_vectors[axis], self.degrees[axis], t
        )
        self._apply_axis_operator(
            axis, T, new_kv, new_degree=self.degrees[axis] + t
        )

    def uniform_refine(self) -> None:
        for axis in range(self.para_dim):
            new = kn.uniform_refine_knots(
                self.knot_vectors[axis], self.degrees[axis]
            )
            T, new_kv = kn.insertion_operator(
                self.knot_vectors[axis], self.degrees[axis], new
            )
            self._apply_axis_operator(axis, T, new_kv)

    def refine_to(self, n_spans: int | list[int]) -> None:
        """Insert uniformly spaced knots until each axis has `n_spans`
        nonempty spans (per-axis list or one count for all axes).

        Additive over the reference's power-of-two `Subdivide`
        (py_solid.cpp:168-183): arbitrary span counts let benchmark
        meshes hit exact element budgets (e.g. 48^3 ~ 1.1e5 elements)."""
        targets = (
            list(n_spans)
            if isinstance(n_spans, (list, tuple))
            else [int(n_spans)] * self.para_dim
        )
        for axis in range(self.para_dim):
            t = targets[axis]
            kv = self.knot_vectors[axis]
            lo, hi = kv[0], kv[-1]
            want = lo + (hi - lo) * np.arange(1, t) / t
            have = kn.unique_spans(kv, self.degrees[axis])
            new = np.array(
                [u for u in want if not np.isclose(have, u).any()]
            )
            if new.size == 0:
                continue
            T, new_kv = kn.insertion_operator(
                kv, self.degrees[axis], new
            )
            self._apply_axis_operator(axis, T, new_kv)

    # ---------------- evaluation (setup-time, numpy) ----------------
    def evaluate(self, params: np.ndarray) -> np.ndarray:
        """Evaluate patch at (n_pts, para_dim) parameters (numpy, slow path)."""
        params = np.atleast_2d(params)
        nc = self.n_ctrl()
        hom = np.concatenate(
            [
                self.control_points * self.weights[:, None],
                self.weights[:, None],
            ],
            axis=1,
        )
        out = np.zeros((len(params), self.dim))
        for r, u in enumerate(params):
            idx_1d, bas_1d = [], []
            for d in range(self.para_dim):
                s = kn.find_span(self.knot_vectors[d], self.degrees[d], u[d])
                idx_1d.append(np.arange(s - self.degrees[d], s + 1))
                bas_1d.append(
                    kn.basis_funs(
                        self.knot_vectors[d], self.degrees[d], s, u[d]
                    )
                )
            acc = np.zeros(self.dim + 1)
            if self.para_dim == 1:
                for a, Na in zip(idx_1d[0], bas_1d[0]):
                    acc += Na * hom[a]
            elif self.para_dim == 2:
                for b, Nb in zip(idx_1d[1], bas_1d[1]):
                    for a, Na in zip(idx_1d[0], bas_1d[0]):
                        acc += Na * Nb * hom[a + nc[0] * b]
            else:
                for c, Nc in zip(idx_1d[2], bas_1d[2]):
                    for b, Nb in zip(idx_1d[1], bas_1d[1]):
                        for a, Na in zip(idx_1d[0], bas_1d[0]):
                            acc += (
                                Na * Nb * Nc * hom[a + nc[0] * (b + nc[1] * c)]
                            )
            out[r] = acc[:-1] / acc[-1]
        return out
