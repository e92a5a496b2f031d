"""Reader/writer for the "MFEM NURBS mesh v1.0" text format.

Format (observed in tests/data/*.mesh; parity with the reference which loads
these via mfem::Mesh in its py_solid.cpp):

    MFEM NURBS mesh v1.0
    dimension
    <d>
    elements
    <n>
    <attr> <geom> <v0> <v1> ...      # geom: 1=segment, 3=square, 5=cube
    boundary
    <n>
    <attr> <geom> <v0> ...
    edges
    <n>
    <kv_index> <v0> <v1>
    vertices
    <n>
    knotvectors
    <n>
    <degree> <n_ctrl> <knot0> <knot1> ...
    weights
    <w0> ...
    FiniteElementSpace
    FiniteElementCollection: NURBS<p>
    VDim: <d>
    Ordering: 1
    <cp rows in MFEM NURBS dof order>
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MfemNurbsMesh:
    dimension: int
    elements: list  # (attr, geom, [vertex ids])
    boundary: list  # (attr, geom, [vertex ids])
    edges: list  # (kv_index, v0, v1)
    n_vertices: int
    knot_degrees: list  # per knot vector
    knot_vectors: list = field(default_factory=list)  # np arrays
    weights: np.ndarray = None  # in MFEM dof order
    control_points: np.ndarray = None  # (n, dim) in MFEM dof order


def read_mfem_nurbs_mesh(fname: str) -> MfemNurbsMesh:
    with open(fname) as f:
        raw = f.read()
    lines = [
        ln.strip()
        for ln in raw.split("\n")
        if ln.strip() and not ln.strip().startswith("#")
    ]
    if "NURBS mesh v1.0" not in lines[0]:
        raise ValueError(f"{fname} does not contain NURBS mesh.")

    pos = 1

    def expect(tag):
        nonlocal pos
        if lines[pos] != tag:
            raise ValueError(f"expected '{tag}' got '{lines[pos]}' in {fname}")
        pos += 1

    expect("dimension")
    dim = int(lines[pos]); pos += 1

    expect("elements")
    n_el = int(lines[pos]); pos += 1
    elements = []
    for _ in range(n_el):
        vals = [int(x) for x in lines[pos].split()]; pos += 1
        elements.append((vals[0], vals[1], vals[2:]))

    expect("boundary")
    n_b = int(lines[pos]); pos += 1
    boundary = []
    for _ in range(n_b):
        vals = [int(x) for x in lines[pos].split()]; pos += 1
        boundary.append((vals[0], vals[1], vals[2:]))

    expect("edges")
    n_e = int(lines[pos]); pos += 1
    edges = []
    for _ in range(n_e):
        vals = [int(x) for x in lines[pos].split()]; pos += 1
        edges.append(tuple(vals))

    expect("vertices")
    n_v = int(lines[pos]); pos += 1

    expect("knotvectors")
    n_kv = int(lines[pos]); pos += 1
    degrees, kvs = [], []
    for _ in range(n_kv):
        vals = lines[pos].split(); pos += 1
        p = int(vals[0])
        nc = int(vals[1])
        knots = np.array([float(x) for x in vals[2:]])
        assert len(knots) == nc + p + 1, "knot vector length mismatch"
        degrees.append(p)
        kvs.append(knots)

    expect("weights")
    weights = []
    while pos < len(lines) and lines[pos] != "FiniteElementSpace":
        weights.extend(float(x) for x in lines[pos].split())
        pos += 1
    weights = np.array(weights)

    expect("FiniteElementSpace")
    # FiniteElementCollection / VDim / Ordering lines
    while not lines[pos].startswith("Ordering"):
        pos += 1
    pos += 1
    cps = []
    while pos < len(lines):
        cps.append([float(x) for x in lines[pos].split()])
        pos += 1
    cps = np.array(cps)

    return MfemNurbsMesh(
        dimension=dim,
        elements=elements,
        boundary=boundary,
        edges=edges,
        n_vertices=n_v,
        knot_degrees=degrees,
        knot_vectors=kvs,
        weights=weights,
        control_points=cps,
    )


def write_mfem_nurbs_mesh_multipatch(
    fname: str, mesh, knotvectors, x, w, vdim
) -> None:
    """Writes a (possibly refined) multi-patch NURBS mesh (save_mesh
    parity: the reference's PySolid::SaveMesh, py_solid.cpp:97-107, uses
    mfem's generic printer which handles any NURBSExtension).

    `mesh`: the coarse MfemNurbsMesh (elements/boundary/edges/vertices
    topology is refinement-invariant), `knotvectors`: per kv-index list
    of (degree, knots) AFTER refinement, `x`/`w`: global control points
    and weights in MFEM NURBS dof order.
    """
    degrees = sorted({p for p, _ in knotvectors})
    fec = (
        "NURBS%d" % degrees[0]
        if len(degrees) == 1
        else "NURBS"  # mfem writes the variable-order collection name
    )
    with open(fname, "w") as f:
        f.write("MFEM NURBS mesh v1.0\n\n")
        f.write("dimension\n%d\n\n" % mesh.dimension)
        f.write("elements\n%d\n" % len(mesh.elements))
        for attr, geom, vs in mesh.elements:
            f.write(" ".join(str(x_) for x_ in [attr, geom, *vs]) + "\n")
        f.write("\nboundary\n%d\n" % len(mesh.boundary))
        for attr, geom, vs in mesh.boundary:
            f.write(" ".join(str(x_) for x_ in [attr, geom, *vs]) + "\n")
        f.write("\nedges\n%d\n" % len(mesh.edges))
        for e in mesh.edges:
            f.write(" ".join(str(x_) for x_ in e) + "\n")
        f.write("\nvertices\n%d\n\n" % mesh.n_vertices)
        f.write("knotvectors\n%d\n" % len(knotvectors))
        for p, kv in knotvectors:
            nc = len(kv) - p - 1
            f.write(
                "%d %d " % (p, nc)
                + " ".join(repr(float(k)) for k in kv)
                + "\n"
            )
        f.write("\nweights\n")
        for wi in w:
            f.write(repr(float(wi)) + "\n")
        f.write("\nFiniteElementSpace\n")
        f.write("FiniteElementCollection: %s\n" % fec)
        f.write("VDim: %d\n" % vdim)
        f.write("Ordering: 1\n\n")
        for row in x:
            f.write(" ".join(repr(float(c)) for c in row) + "\n")


def write_mfem_nurbs_mesh(fname: str, mesh, dof_perm, patch) -> None:
    """Writes the current (possibly refined) mesh back out (save_mesh parity).

    `mesh`: MfemNurbsMesh topology, `dof_perm`: lex->mfem permutation,
    `patch`: current NurbsPatch.
    """
    d = mesh.dimension
    with open(fname, "w") as f:
        f.write("MFEM NURBS mesh v1.0\n\n")
        f.write("dimension\n%d\n\n" % d)
        f.write("elements\n%d\n" % len(mesh.elements))
        for attr, geom, vs in mesh.elements:
            f.write(" ".join(str(x) for x in [attr, geom, *vs]) + "\n")
        f.write("\nboundary\n%d\n" % len(mesh.boundary))
        for attr, geom, vs in mesh.boundary:
            f.write(" ".join(str(x) for x in [attr, geom, *vs]) + "\n")
        f.write("\nedges\n%d\n" % len(mesh.edges))
        for e in mesh.edges:
            f.write(" ".join(str(x) for x in e) + "\n")
        f.write("\nvertices\n%d\n\n" % mesh.n_vertices)
        f.write("knotvectors\n%d\n" % patch.para_dim)
        for p, kv in zip(patch.degrees, patch.knot_vectors):
            nc = len(kv) - p - 1
            f.write(
                "%d %d " % (p, nc)
                + " ".join(repr(float(x)) for x in kv)
                + "\n"
            )
        n = patch.n_ctrl_total()
        inv = np.empty(n, dtype=int)
        inv[dof_perm] = np.arange(n)  # mfem -> lex
        f.write("\nweights\n")
        for i in range(n):
            f.write(repr(float(patch.weights[inv[i]])) + "\n")
        f.write("\nFiniteElementSpace\n")
        f.write("FiniteElementCollection: NURBS%d\n" % patch.degrees[0])
        f.write("VDim: %d\n" % patch.dim)
        f.write("Ordering: 1\n\n")
        for i in range(n):
            f.write(
                " ".join(repr(float(x)) for x in patch.control_points[inv[i]])
                + "\n"
            )


def single_patch_mesh(template, degrees, knot_vectors, control_points, weights):
    """A one-patch mesh with the topology (elements, boundary, edges,
    vertices) of the one-patch `template` and the patch given by `degrees`,
    `knot_vectors`, `control_points` (n, dim) and `weights` (n,) in
    lexicographic order (axis 0 fastest), put into MFEM dof order: a
    patch of degrees that differ per axis, or a rational patch, built in
    code."""
    import dataclasses

    from .topology import PatchTopology

    kvs = [np.asarray(kv, dtype=np.float64) for kv in knot_vectors]
    nc = [len(kv) - p - 1 for kv, p in zip(kvs, degrees)]
    perm = PatchTopology(template).lex_to_mfem(nc)  # perm[lex] = mfem
    cps = np.empty((len(perm), np.asarray(control_points).shape[1]))
    w = np.empty(len(perm))
    cps[perm] = np.asarray(control_points, dtype=np.float64)
    w[perm] = np.asarray(weights, dtype=np.float64)
    return dataclasses.replace(template, knot_degrees=list(degrees), knot_vectors=kvs,
                               weights=w, control_points=cps)
