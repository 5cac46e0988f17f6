"""Convex-hull collision assets: host-side construction + mass properties.

Copy of ``maniskill_tpu/physics/hulls.py`` (numpy and scipy only; the port
keeps its own copy rather than importing the JAX package). A convex shape
is a PADDED vertex set + face-plane set with static sizes:

  * ``verts`` (HULL_V, 3)  — hull vertices in body frame, padded by
    repeating the first vertex.
  * ``faces`` (HULL_F, 4)  — outward face planes ``[n, d]`` with
    ``n·p <= d`` inside, padded with planes at distance ``_FAR`` so the
    max-plane SDF ignores them.
  * ``cpts`` (HULL_P, 3)   — the contact cloud (vertices, face centroids,
    edge midpoints; padded with the CoM), what ``SimState.hull_verts``
    holds.

Static sizes let every env of a batch carry a different hull: the tables
are per-env simulation state next to ``geom_size``. The CUDA mega-kernel
reads ``HULL_P`` and ``HULL_F`` as compile-time sizes
(``csrc/megakernel.cu``); ``megakernel.supports`` checks that they agree.
Mass properties are the exact polyhedron integrals (divergence theorem
over the triangulated boundary).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

HULL_V = 24  # padded vertex count
HULL_F = 32  # padded face-plane count
HULL_P = 40  # padded CONTACT-POINT cloud: vertices + face centroids.
# Vertex-only tests miss cross-shaped overlaps (neither hull's vertices
# inside the other, e.g. a thin domino standing on a wide box); face
# centroids catch face-interior penetrations. Edge-edge crossings remain
# approximate — the same approximation class as the engine's 8-corner
# box-box test (shapes.box_box).
_FAR = 1.0e6


class HullAsset:
    """One convex collision asset (host-side, numpy)."""

    def __init__(self, name: str, verts: np.ndarray, faces: np.ndarray,
                 volume: float, com: np.ndarray, inertia_com: np.ndarray,
                 aabb_half: np.ndarray, cpts: np.ndarray):
        self.name = name
        self.verts = verts.astype(np.float32)          # (HULL_V, 3)
        self.faces = faces.astype(np.float32)          # (HULL_F, 4)
        self.cpts = cpts.astype(np.float32)            # (HULL_P, 3)
        self.volume = float(volume)
        self.com = com.astype(np.float32)              # (3,)
        self.inertia_com = inertia_com.astype(np.float32)  # (3,3) unit dens.
        self.aabb_half = aabb_half.astype(np.float32)  # (3,)

    def mass(self, density: float) -> float:
        return self.volume * density

    def inertia(self, density: float) -> np.ndarray:
        return self.inertia_com * density


def _polyhedron_mass_properties(verts: np.ndarray, simplices: np.ndarray,
                                outward: np.ndarray = None):
    """Volume, CoM, inertia about CoM (unit density) of a closed triangulated
    surface via the signed-tetrahedron decomposition (each face triangle +
    origin). ``outward`` (nf, 3): per-simplex outward normals used to fix
    Qhull's arbitrary triangle winding."""
    if outward is not None:
        a = verts[simplices[:, 0]]
        b = verts[simplices[:, 1]]
        c = verts[simplices[:, 2]]
        flip = np.einsum("ij,ij->i", np.cross(b - a, c - a), outward) < 0
        simplices = simplices.copy()
        simplices[flip] = simplices[flip][:, [0, 2, 1]]
    v0 = verts[simplices[:, 0]]
    v1 = verts[simplices[:, 1]]
    v2 = verts[simplices[:, 2]]
    det = np.einsum("ij,ij->i", v0, np.cross(v1, v2))  # 6 * signed volume
    vol = det.sum() / 6.0
    com = (det[:, None] * (v0 + v1 + v2)).sum(axis=0) / (24.0 * vol)

    # covariance C_jk = ∫ x_j x_k dV summed over signed tets
    C = np.zeros((3, 3))
    for t in range(len(simplices)):
        V = np.stack([v0[t], v1[t], v2[t]])  # (3,3) rows = verts
        # ∫_tet x_j x_k dV = det/120 * (Σ_i Σ_l V_ij V_lk + Σ_i V_ij V_ik)
        S = V.sum(axis=0)
        C += det[t] / 120.0 * (np.outer(S, S) + V.T @ V)
    # shift to CoM: C_com = C - vol * com comᵀ
    C = C - vol * np.outer(com, com)
    inertia = np.trace(C) * np.eye(3) - C
    return vol, com, inertia


def make_hull(name: str, points: np.ndarray,
              max_verts: int = HULL_V, max_faces: int = HULL_F) -> HullAsset:
    """Build a padded HullAsset from a point cloud (body frame).

    Vertices are decimated to ``max_verts`` (greedy farthest-point) and the
    hull re-taken, so the contact budget stays static. The stored frame is
    recentered so the CoM is the body origin (matching how free bodies
    integrate about their CoM in the engine).
    """
    from scipy.spatial import ConvexHull

    pts = np.asarray(points, np.float64)
    hull = ConvexHull(pts)
    v = pts[hull.vertices]
    if len(v) > max_verts:
        # greedy farthest-point decimation keeps the extremal shape
        keep = [int(np.argmax(np.linalg.norm(v - v.mean(0), axis=1)))]
        for _ in range(max_verts - 1):
            d = np.min(
                np.linalg.norm(v[:, None] - v[keep][None], axis=-1), axis=1
            )
            keep.append(int(np.argmax(d)))
        v = v[sorted(set(keep))]
        v = v[ConvexHull(v).vertices]

    hull = ConvexHull(v)  # simplices index into v
    vol, com, inertia = _polyhedron_mass_properties(
        v, hull.simplices, outward=hull.equations[:, :3]
    )
    assert vol > 0, f"hull {name}: degenerate volume {vol}"
    v = v - com  # recenter: body origin = CoM

    # face planes from the recentered hull (merge coplanar duplicates)
    hull2 = ConvexHull(v)
    eqs = hull2.equations  # (nf, 4): n·p + off <= 0 inside
    planes = []
    for n_, off in zip(eqs[:, :3], eqs[:, 3]):
        d = -off
        dup = any(
            np.dot(n_, p[:3]) > 1.0 - 1e-6 and abs(d - p[3]) < 1e-6
            for p in planes
        )
        if not dup:
            planes.append(np.array([n_[0], n_[1], n_[2], d]))
    if len(planes) > max_faces:
        # keep the faces supporting the largest area (approx: by triangle
        # count is unavailable after merge — keep nearest-to-origin first,
        # which drops slivers whose planes sit far out)
        planes.sort(key=lambda p: p[3])
        planes = planes[:max_faces]
    faces = np.stack(planes)
    faces = np.concatenate(
        [faces,
         np.tile(np.array([[0.0, 0.0, 1.0, _FAR]]),
                 (max_faces - len(faces), 1))],
        axis=0,
    )
    verts = np.concatenate(
        [v, np.tile(v[:1], (max_verts - len(v), 1))], axis=0
    )
    aabb_half = np.abs(v).max(axis=0)

    # contact cloud: vertices + face centroids + edge midpoints (priority
    # order; truncated at HULL_P). Midpoints give flat faces an interior
    # support polygon even when the counterpart is smaller than the face —
    # without them a box resting on a narrower hull balances on 1-2 points
    # and rocks itself over.
    cloud = [v]
    for pl in planes:
        on = v[np.abs(v @ pl[:3] - pl[3]) < 1e-6]
        if len(on) >= 3:
            cloud.append(on.mean(axis=0, keepdims=True))
    edges = set()
    for tri in hull2.simplices:
        for a_, b_ in ((0, 1), (1, 2), (0, 2)):
            edges.add((min(tri[a_], tri[b_]), max(tri[a_], tri[b_])))
    if edges:
        e = np.array(sorted(edges))
        cloud.append(0.5 * (v[e[:, 0]] + v[e[:, 1]]))
    cloud = np.concatenate(cloud)
    if len(cloud) > HULL_P:
        cloud = cloud[:HULL_P]
    # pad with the CoM (strictly interior): padded entries only activate
    # under total overlap, so they add no duplicate boundary stiffness
    cpts = np.concatenate(
        [cloud, np.zeros((HULL_P - len(cloud), 3))], axis=0
    )
    return HullAsset(name, verts, faces, vol, com.astype(np.float32) * 0.0,
                     inertia, aabb_half, cpts)


# ---------------------------------------------------------------------------
# procedural object library (YCB-class silhouettes without mesh downloads)
# ---------------------------------------------------------------------------


def _cylinder_pts(r, h, n=12):
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([r * np.cos(a), r * np.sin(a)], axis=1)
    top = np.concatenate([ring, np.full((n, 1), h)], axis=1)
    bot = np.concatenate([ring, np.full((n, 1), -h)], axis=1)
    return np.concatenate([top, bot])


def _frustum_pts(r0, r1, h, n=10):
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    c, s = np.cos(a), np.sin(a)
    top = np.stack([r1 * c, r1 * s, np.full(n, h)], axis=1)
    bot = np.stack([r0 * c, r0 * s, np.full(n, -h)], axis=1)
    return np.concatenate([top, bot])


def _box_pts(hx, hy, hz):
    return np.array(
        [[sx * hx, sy * hy, sz * hz]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    )


def standard_object_library() -> List[HullAsset]:
    """Procedural stand-ins for the YCB grasping set: one hull per everyday
    object class (can, mug body, banana-ish wedge, block, bowl frustum, …).
    Reference analogue: the model-id list sampled per sub-scene in
    ``pick_single_ycb.py:81-124``."""
    lib = []
    lib.append(make_hull("can", _cylinder_pts(0.026, 0.045)))
    lib.append(make_hull("small_box", _box_pts(0.025, 0.018, 0.035)))
    lib.append(make_hull("wedge", np.array(
        [[-0.04, -0.02, -0.015], [0.04, -0.02, -0.015],
         [-0.04, 0.02, -0.015], [0.04, 0.02, -0.015],
         [-0.04, -0.012, 0.02], [-0.005, -0.012, 0.028],
         [-0.04, 0.012, 0.02], [-0.005, 0.012, 0.028]])))
    lib.append(make_hull("frustum_cup", _frustum_pts(0.02, 0.032, 0.045)))
    lib.append(make_hull("octa", 0.042 * np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
         [0, 0, 0.8], [0, 0, -0.8]])))
    lib.append(make_hull("lemon", np.concatenate([
        _frustum_pts(0.024, 0.015, 0.026, 8),
        _frustum_pts(0.015, 0.024, 0.026, 8) * np.array([1, 1, -1]),
    ])))
    lib.append(make_hull("domino", _box_pts(0.01, 0.024, 0.047)))
    lib.append(make_hull("prism6", _cylinder_pts(0.03, 0.02, 6)))
    return lib


def pad_library(lib: List[HullAsset]) -> Tuple[np.ndarray, ...]:
    """Stack a library into index-selectable tables:
    (cpts (M,HULL_P,3), faces (M,F,4), volume (M,), inertia (M,3,3),
    aabb_half (M,3)). The first table is the CONTACT cloud — what
    SimState.hull_verts holds."""
    return (
        np.stack([a.cpts for a in lib]),
        np.stack([a.faces for a in lib]),
        np.array([a.volume for a in lib], np.float32),
        np.stack([a.inertia_com for a in lib]),
        np.stack([a.aabb_half for a in lib]),
    )
