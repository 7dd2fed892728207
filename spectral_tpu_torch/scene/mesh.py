"""Mesh construction helpers: Wavefront OBJ import and primitive
generators.

Beyond-reference capability (the reference's geometry catalog is boxes
and spheres only, ``UIObjectType`` src/main.rs:2070-2076): builds
``schema.Mesh`` objects that flatten into first-class triangle rows and
trace through the same kernels as every other primitive.
"""

from __future__ import annotations

import math
from pathlib import Path

from spectral_tpu_torch.scene.schema import Mesh

__all__ = [
    "load_obj",
    "icosahedron",
    "icosphere",
    "smooth_normals",
]


def smooth_normals(mesh: Mesh) -> Mesh:
    """A copy of ``mesh`` with area-weighted per-vertex normals (smooth
    Phong shading). The unnormalized face-normal sum is the standard
    area weighting — the cross product's magnitude is twice the face
    area, so large faces dominate their vertices' normals."""
    import numpy as np

    v = np.asarray(mesh.vertices, np.float64)
    acc = np.zeros_like(v)
    for (i, j, k) in mesh.faces:
        n = np.cross(v[j] - v[i], v[k] - v[i])
        acc[i] += n
        acc[j] += n
        acc[k] += n
    ln = np.linalg.norm(acc, axis=1, keepdims=True)
    ln[ln == 0.0] = 1.0  # isolated vertices: keep a zero normal
    acc = acc / ln
    return Mesh(
        vertices=mesh.vertices,
        faces=mesh.faces,
        normals=tuple(tuple(float(c) for c in n) for n in acc),
    )


def load_obj(path, scale: float = 1.0, smooth: bool = False) -> Mesh:
    """Parse a Wavefront ``.obj`` file into a :class:`Mesh`.

    Supports the geometry subset: ``v`` lines (positions; w ignored) and
    ``f`` lines (``i``, ``i/t``, ``i/t/n``, ``i//n`` forms; negative
    indices count from the end, per the OBJ spec). Polygons are
    fan-triangulated, preserving winding. File normals/texcoords/
    materials are ignored — the material comes from the owning
    ``SceneObject`` — but ``smooth=True`` derives area-weighted vertex
    normals for Phong-interpolated smooth shading (the common intent of
    OBJ ``vn`` data, without its separate index topology); the default
    keeps flat winding normals.
    """
    vertices: list[tuple] = []
    faces: list[tuple] = []
    with open(path) as fh:
        for lineno, raw in enumerate(fh, start=1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if parts[0] == "v":
                if len(parts) < 4:
                    raise ValueError(
                        f"{path}:{lineno}: vertex needs 3 coordinates"
                    )
                vertices.append(
                    (
                        float(parts[1]) * scale,
                        float(parts[2]) * scale,
                        float(parts[3]) * scale,
                    )
                )
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    if i < 0:
                        i = len(vertices) + i
                    else:
                        i = i - 1
                    if not 0 <= i < len(vertices):
                        raise ValueError(
                            f"{path}:{lineno}: face index {tok} out of range"
                        )
                    idx.append(i)
                if len(idx) < 3:
                    raise ValueError(
                        f"{path}:{lineno}: face needs >= 3 vertices"
                    )
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    if not faces:
        raise ValueError(f"{Path(path).name}: no faces found")
    out = Mesh(vertices=tuple(vertices), faces=tuple(faces))
    return smooth_normals(out) if smooth else out


def icosahedron(radius: float = 1.0) -> Mesh:
    """The regular icosahedron (20 triangles), CCW-outward winding."""
    phi = (1.0 + math.sqrt(5.0)) / 2.0
    s = radius / math.sqrt(1.0 + phi * phi)
    a, b = s, s * phi
    verts = [
        (-a, b, 0), (a, b, 0), (-a, -b, 0), (a, -b, 0),
        (0, -a, b), (0, a, b), (0, -a, -b), (0, a, -b),
        (b, 0, -a), (b, 0, a), (-b, 0, -a), (-b, 0, a),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    return Mesh(vertices=tuple(verts), faces=tuple(faces))


def icosphere(
    radius: float = 1.0, subdivisions: int = 1, smooth: bool = False
) -> Mesh:
    """Icosahedron subdivided ``subdivisions`` times with vertices
    projected to the sphere (20 * 4^n triangles). ``smooth=True``
    attaches the exact sphere normals (the unit vertex directions), so
    the mesh shades like an analytic sphere."""
    if subdivisions < 0:
        raise ValueError("subdivisions must be >= 0")
    base = icosahedron(1.0)
    verts = [tuple(v) for v in base.vertices]
    faces = list(base.faces)
    for _ in range(subdivisions):
        cache: dict = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key in cache:
                return cache[key]
            vi, vj = verts[i], verts[j]
            m = tuple((vi[k] + vj[k]) / 2.0 for k in range(3))
            ln = math.sqrt(sum(c * c for c in m))
            verts.append(tuple(c / ln for c in m))
            cache[key] = len(verts) - 1
            return cache[key]

        nxt = []
        for (i, j, k) in faces:
            ij, jk, ki = midpoint(i, j), midpoint(j, k), midpoint(k, i)
            nxt += [(i, ij, ki), (j, jk, ij), (k, ki, jk), (ij, jk, ki)]
        faces = nxt
    scaled = tuple(
        (v[0] * radius, v[1] * radius, v[2] * radius) for v in verts
    )
    normals = tuple(tuple(v) for v in verts) if smooth else ()
    return Mesh(vertices=scaled, faces=tuple(faces), normals=normals)
