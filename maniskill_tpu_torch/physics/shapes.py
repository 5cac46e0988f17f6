"""Collision primitives and pairwise contact-point generation, batched.

Port of ``maniskill_tpu/physics/shapes.py``: ``geom_local_half_extents``
(``:52``); the sphere and capsule functions ``plane_sphere``,
``plane_capsule``, ``sphere_sphere``, ``sphere_box``, ``box_sphere``
(``:100-186``), ``sphere_capsule``, ``capsule_box`` and ``capsule_capsule``
(``:229-279``); ``plane_box`` (``:110``), the symmetric 28-point ``box_box``
(``:198``) with ``_FACE_DIRS`` and ``_box_face_centers`` (``:188-195``),
``box_box_corners`` (``:281``), ``box_box_onesided`` (``:301``) and their
helpers ``_box_corners`` and ``_point_box_sdf``; the convex-hull face-plane
SDF ``_hull_sdf`` (``:325``), ``plane_hull`` (``:341``), ``sphere_hull``
(``:350``), ``box_hull`` (``:361``), ``capsule_hull`` (``:378``) and
``hull_hull`` (``:392``) with their ``hull_args`` tags; and ``contact_fn``.

Every pair function emits a fixed number of candidate points; inputs are
poses ``p (..., 3)``, ``q (..., 4)`` and half sizes ``s (..., 3)``, outputs
carry a trailing point axis. The normal points from B toward A; ``depth > 0``
means penetration.
"""
from __future__ import annotations

from enum import IntEnum
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .._consts import const
from ..math import clamps
from ..math.rotations import quat_apply, quat_conjugate
from .hulls import HULL_P


class GeomType(IntEnum):
    PLANE = 0  # half-space z<=0 in geom frame, normal +z
    SPHERE = 1  # size[0] = radius
    BOX = 2  # size = half extents
    CAPSULE = 3  # size[0] = radius, size[1] = half length (axis +z)
    CYLINDER = 4
    HULL = 5  # padded contact-cloud + face-plane tables (physics/hulls.py);
    #           size = AABB half extents


class ContactPoints(NamedTuple):
    pos: torch.Tensor  # (..., n, 3)
    normal: torch.Tensor  # (..., n, 3) unit normal, B -> A
    depth: torch.Tensor  # (..., n)


_BOX_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    dtype=np.float32,
)


_FACE_DIRS = np.array(
    [[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [0, -1.0, 0], [0, 0, 1.0], [0, 0, -1.0]],
    dtype=np.float32,
)


_CONSTS = SimpleNamespace()  # holds this module's device copies (_consts.const)


def geom_local_half_extents(gtype: int, size) -> np.ndarray:
    """Local AABB half extents of a geom (host side, numpy): exact for a box
    and a sphere, conservative for a capsule or cylinder (radius r, half
    length hl along z -> (r, r, hl + r)); a hull stores its own in ``size``."""
    size = np.asarray(size, np.float64)
    t = int(gtype)
    if t == GeomType.SPHERE:
        return np.full(3, float(size[0]))
    if t in (GeomType.CAPSULE, GeomType.CYLINDER):
        r, hl = float(size[0]), float(size[1])
        return np.array([r, r, hl + r])
    return size  # BOX and HULL


def _box_corners(pos, quat, half):
    corners = const(_CONSTS, "corners", _BOX_CORNERS, pos.device) * half[..., None, :]
    return pos[..., None, :] + quat_apply(quat[..., None, :], corners)


def _box_face_centers(pos, quat, half):
    centers = const(_CONSTS, "face_dirs", _FACE_DIRS, pos.device) * half[..., None, :]
    return pos[..., None, :] + quat_apply(quat[..., None, :], centers)


def _unit_z(like: torch.Tensor) -> torch.Tensor:
    ez = torch.zeros_like(like)
    ez[..., 2] = 1.0
    return ez


def _point_box_sdf(p_local: torch.Tensor, half: torch.Tensor):
    """Signed distance + outward normal (local frame) of points vs a box."""
    q = clamps.abs(p_local) - half
    outside = clamps.maximum(q, 0.0)
    d_out = torch.sqrt(torch.sum(outside * outside, dim=-1) + 1e-18)
    d_in = clamps.minimum(torch.amax(q, dim=-1), 0.0)
    sdf = d_out + d_in
    sgn = torch.sign(p_local)
    n_out = outside * sgn
    n_out = n_out / torch.sqrt(torch.sum(n_out * n_out, dim=-1, keepdim=True) + 1e-18)
    # interior normal: axis of least penetration as an arithmetic one-hot;
    # ties split across axes and are re-normalized
    qmax = torch.amax(q, dim=-1, keepdim=True)
    onehot = (q >= qmax).to(p_local.dtype)
    onehot = onehot / torch.sum(onehot, dim=-1, keepdim=True)
    n_in = onehot * sgn
    n_in = n_in / torch.sqrt(torch.sum(n_in * n_in, dim=-1, keepdim=True) + 1e-18)
    # 1 µm branch threshold: a point exactly on a face has d_out = 1e-9, and
    # the outside branch's normal would then be a zero vector
    n = torch.where((d_out > 1e-6)[..., None], n_out, n_in)
    return sdf, n


def _points_in_box(ca, pb, qb, sb):
    """Points ``ca (..., n, 3)`` against box B: positions, B->A normals,
    depths."""
    ca_local = quat_apply(quat_conjugate(qb)[..., None, :], ca - pb[..., None, :])
    sdf, n_local = _point_box_sdf(ca_local, sb[..., None, :])
    n = quat_apply(qb[..., None, :], n_local)
    return ca, n, -sdf


def _corners_in_box(pa, qa, sa, pb, qb, sb):
    """Corners of box A against box B: positions, B->A normals, depths."""
    return _points_in_box(_box_corners(pa, qa, sa), pb, qb, sb)


def plane_box(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    """A = plane, B = box: all 8 corners against the half-space."""
    n = quat_apply(qa, _unit_z(pa))
    corners = _box_corners(pb, qb, sb)  # (..., 8, 3)
    dist = torch.sum((corners - pa[..., None, :]) * n[..., None, :], dim=-1)
    return ContactPoints(corners, (-n)[..., None, :].expand_as(corners), -dist)


def box_box(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    """Symmetric vertex-SDF box-box (28 points) for free-free pairs: A's 8
    corners and 6 face centers against B, then B's against A with the
    normal negated (B->A). The face centers carry two flush, stacked boxes:
    their corners all sit on the other box's side planes, where the SDF
    reads zero depth."""
    pts_a = torch.cat([_box_corners(pa, qa, sa), _box_face_centers(pa, qa, sa)], dim=-2)
    pts_b = torch.cat([_box_corners(pb, qb, sb), _box_face_centers(pb, qb, sb)], dim=-2)
    pos_a, n_a, d_a = _points_in_box(pts_a, pb, qb, sb)
    pos_b, n_b, d_b = _points_in_box(pts_b, pa, qa, sa)
    return ContactPoints(
        torch.cat([pos_a, pos_b], dim=-2),
        torch.cat([n_a, -n_b], dim=-2),
        torch.cat([d_a, d_b], dim=-1),
    )


def box_box_corners(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    """Symmetric corners-only box-box (16 points): A's corners in B, then
    B's corners in A. Used for robot-involved box pairs."""
    pos_a, n_a, d_a = _corners_in_box(pa, qa, sa, pb, qb, sb)
    pos_b, n_b, d_b = _corners_in_box(pb, qb, sb, pa, qa, sa)
    return ContactPoints(
        torch.cat([pos_a, pos_b], dim=-2),
        torch.cat([n_a, -n_b], dim=-2),
        torch.cat([d_a, d_b], dim=-1),
    )


def box_box_onesided(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    """Corners of box A against box B only (8 points); B is static."""
    return ContactPoints(*_corners_in_box(pa, qa, sa, pb, qb, sb))


# ---------------------------------------------------------------------------
# spheres and capsules (one point per pair, except plane_capsule: the two
# ends at -hl, +hl; capsule_box: three sample spheres at -hl, 0, +hl)
# ---------------------------------------------------------------------------


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def plane_sphere(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    """A = plane, B = sphere."""
    n = quat_apply(qa, _unit_z(pa))
    r = sb[..., 0]
    dist = _dot(pb - pa, n) - r
    pos = pb - n * (r + 0.5 * dist)[..., None]
    return ContactPoints(pos[..., None, :], (-n)[..., None, :], (-dist)[..., None])


def plane_capsule(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    """A = plane, B = capsule: both ends of the segment against the
    half-space, each a sphere of the capsule's radius."""
    n = quat_apply(qa, _unit_z(pa))
    axis = quat_apply(qb, _unit_z(pb))
    r, hl = sb[..., 0, None], sb[..., 1, None]
    sign = const(_CONSTS, "ends", np.array([-1.0, 1.0], np.float32), pb.device)
    ends = pb[..., None, :] + axis[..., None, :] * (hl * sign)[..., None]  # (..., 2, 3)
    dist = _dot(ends - pa[..., None, :], n[..., None, :]) - r
    pos = ends - n[..., None, :] * (r + 0.5 * dist)[..., None]
    return ContactPoints(pos, (-n)[..., None, :].expand_as(pos), -dist)


def sphere_sphere(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    d = pa - pb
    dist = torch.sqrt(_dot(d, d) + 1e-18)
    n = d / dist[..., None]
    depth = sa[..., 0] + sb[..., 0] - dist
    pos = pb + n * (sb[..., 0] - 0.5 * depth)[..., None]
    return ContactPoints(pos[..., None, :], n[..., None, :], depth[..., None])


def sphere_box(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    """A = sphere, B = box: the centre against the box SDF."""
    r = sa[..., 0]
    p_local = quat_apply(quat_conjugate(qb), pa - pb)
    sdf, n_local = _point_box_sdf(p_local, sb)
    n = quat_apply(qb, n_local)  # outward from the box: B -> A
    depth = r - sdf
    pos = pa - n * (r - 0.5 * depth)[..., None]
    return ContactPoints(pos[..., None, :], n[..., None, :], depth[..., None])


def box_sphere(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    """A = box, B = sphere: ``sphere_box`` with the sides swapped."""
    c = sphere_box(pb, qb, sb, pa, qa, sa)
    return ContactPoints(c.pos, -c.normal, c.depth)


def sphere_capsule(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    """A = sphere, B = capsule: the centre against the closest point of
    the capsule's segment."""
    axis = quat_apply(qb, _unit_z(pb))
    t = clamps.clip(_dot(pa - pb, axis), -sb[..., 1], sb[..., 1])
    closest = pb + axis * t[..., None]
    d = pa - closest
    dist = torch.sqrt(_dot(d, d) + 1e-18)
    n = d / dist[..., None]
    depth = sa[..., 0] + sb[..., 0] - dist
    pos = closest + n * (sb[..., 0] - 0.5 * depth)[..., None]
    return ContactPoints(pos[..., None, :], n[..., None, :], depth[..., None])


def capsule_box(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    """A = capsule, B = box: three spheres along the capsule's axis, at -hl,
    0 and +hl, against the box SDF."""
    axis = quat_apply(qa, _unit_z(pa))
    r, hl = sa[..., 0, None], sa[..., 1, None]
    sign = const(_CONSTS, "samples", np.array([-1.0, 0.0, 1.0], np.float32), pa.device)
    centers = pa[..., None, :] + axis[..., None, :] * (hl * sign)[..., None]  # (..., 3, 3)
    p_local = quat_apply(quat_conjugate(qb)[..., None, :], centers - pb[..., None, :])
    sdf, n_local = _point_box_sdf(p_local, sb[..., None, :])
    n = quat_apply(qb[..., None, :], n_local)
    depth = r - sdf
    pos = centers - n * (r - 0.5 * depth)[..., None]
    return ContactPoints(pos, n, depth)


def capsule_capsule(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    """Closest points of the two capsule segments (clamped, one pass of
    alternation as in the JAX function), then sphere against sphere."""
    ua = quat_apply(qa, _unit_z(pa))
    ub = quat_apply(qb, _unit_z(pb))
    ha, hb = sa[..., 1], sb[..., 1]
    d0 = pa - pb
    b = _dot(ua, ub)
    c = _dot(ua, d0)
    f = _dot(ub, d0)
    denom = clamps.maximum(1.0 - b * b, 1e-9)  # |ua| = |ub| = 1
    s = clamps.clip((b * f - c) / denom, -ha, ha)
    t = clamps.clip(b * s + f, -hb, hb)
    s = clamps.clip(b * t - c, -ha, ha)
    ca = pa + ua * s[..., None]
    cb = pb + ub * t[..., None]
    d = ca - cb
    dist = torch.sqrt(_dot(d, d) + 1e-18)
    n = d / dist[..., None]
    depth = sa[..., 0] + sb[..., 0] - dist
    pos = cb + n * (sb[..., 0] - 0.5 * depth)[..., None]
    return ContactPoints(pos[..., None, :], n[..., None, :], depth[..., None])


# ---------------------------------------------------------------------------
# convex hulls (padded contact-cloud + face-plane tables, physics/hulls.py)
# ---------------------------------------------------------------------------


def _hull_sdf(p_local: torch.Tensor, faces: torch.Tensor):
    """Signed distance + outward normal of points vs a face-plane hull.

    ``p_local (..., n, 3)`` in the hull frame, ``faces (..., Hf, 4)``
    outward planes ``[n, d]`` with ``n·p <= d`` inside (padding planes sit
    at d = 1e6). The SDF is the largest face distance; the normal averages
    the normals of every face that attains it (a point on an edge gets the
    mean of the two faces' normals), then is normalised. Each distance is
    ``x nx + y ny + z nz - d`` in that order, as the CUDA kernel computes it
    (the JAX function uses a matmul), so both break ties alike."""
    f = faces[..., None, :, :]  # (..., 1, Hf, 4)
    x, y, z = (p_local[..., i, None] for i in range(3))  # (..., n, 1)
    d = x * f[..., 0] + y * f[..., 1] + z * f[..., 2] - f[..., 3]  # (..., n, Hf)
    sdf = torch.amax(d, dim=-1)
    m = (d >= sdf[..., None]).to(p_local.dtype)
    acc = torch.sum(m[..., None] * f[..., :3], dim=-2)  # (..., n, 3)
    n = acc * (1.0 / torch.sum(m, dim=-1))[..., None]
    nn = clamps.maximum(torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)), 1e-9)
    return sdf, n * (1.0 / nn)


def plane_hull(pa, qa, sa, pb, qb, sb, vb, fb) -> ContactPoints:
    """A = plane, B = hull: every contact-cloud point against the half-space."""
    n = quat_apply(qa, _unit_z(pa))
    w = pb[..., None, :] + quat_apply(qb[..., None, :], vb)  # (..., V, 3)
    dist = torch.sum((w - pa[..., None, :]) * n[..., None, :], dim=-1)
    return ContactPoints(w, (-n)[..., None, :].expand_as(w), -dist)


def sphere_hull(pa, qa, sa, pb, qb, sb, vb, fb) -> ContactPoints:
    """A = sphere, B = hull: the centre against the hull SDF."""
    r = sa[..., 0]
    loc = quat_apply(quat_conjugate(qb), pa - pb)
    sdf, nl = _hull_sdf(loc[..., None, :], fb)
    n = quat_apply(qb, nl[..., 0, :])  # B -> A
    depth = r - sdf[..., 0]
    pos = pa - n * (r - 0.5 * depth)[..., None]
    return ContactPoints(pos[..., None, :], n[..., None, :], depth[..., None])


def box_hull(pa, qa, sa, pb, qb, sb, vb, fb) -> ContactPoints:
    """A = box, B = hull: A's 8 corners against the hull SDF, then B's
    contact-cloud points against the box SDF with the normal negated (B->A)."""
    ca = _box_corners(pa, qa, sa)  # (..., 8, 3)
    loc = quat_apply(quat_conjugate(qb)[..., None, :], ca - pb[..., None, :])
    sdf_a, nl_a = _hull_sdf(loc, fb)
    n_a = quat_apply(qb[..., None, :], nl_a)
    w = pb[..., None, :] + quat_apply(qb[..., None, :], vb)  # (..., V, 3)
    pos_b, n_b, d_b = _points_in_box(w, pa, qa, sa)
    return ContactPoints(
        torch.cat([ca, pos_b], dim=-2),
        torch.cat([n_a, -n_b], dim=-2),
        torch.cat([-sdf_a, d_b], dim=-1),
    )


def capsule_hull(pa, qa, sa, pb, qb, sb, vb, fb) -> ContactPoints:
    """A = capsule, B = hull: three spheres along the capsule's axis, at -hl,
    0 and +hl, against the hull SDF."""
    axis = quat_apply(qa, _unit_z(pa))
    r, hl = sa[..., 0, None], sa[..., 1, None]
    sign = const(_CONSTS, "samples", np.array([-1.0, 0.0, 1.0], np.float32), pa.device)
    centers = pa[..., None, :] + axis[..., None, :] * (hl * sign)[..., None]  # (..., 3, 3)
    loc = quat_apply(quat_conjugate(qb)[..., None, :], centers - pb[..., None, :])
    sdf, nl = _hull_sdf(loc, fb)
    n = quat_apply(qb[..., None, :], nl)
    depth = r - sdf
    pos = centers - n * (r - 0.5 * depth)[..., None]
    return ContactPoints(pos, n, depth)


def hull_hull(pa, qa, sa, pb, qb, sb, va, fa, vb, fb) -> ContactPoints:
    """Both hulls: A's contact cloud against B's SDF, then B's cloud against
    A's SDF with the normal negated (B->A)."""
    wa = pa[..., None, :] + quat_apply(qa[..., None, :], va)  # (..., V, 3)
    loc_a = quat_apply(quat_conjugate(qb)[..., None, :], wa - pb[..., None, :])
    sdf_a, nl_a = _hull_sdf(loc_a, fb)
    n_a = quat_apply(qb[..., None, :], nl_a)
    wb = pb[..., None, :] + quat_apply(qb[..., None, :], vb)
    loc_b = quat_apply(quat_conjugate(qa)[..., None, :], wb - pa[..., None, :])
    sdf_b, nl_b = _hull_sdf(loc_b, fa)
    n_b = quat_apply(qa[..., None, :], nl_b)
    return ContactPoints(
        torch.cat([wa, wb], dim=-2),
        torch.cat([n_a, -n_b], dim=-2),
        torch.cat([-sdf_a, -sdf_b], dim=-1),
    )


# which sides of each hull pair function consume (verts, faces) tables; a
# pair with "ab" takes A's tables before B's
plane_hull.hull_args = "b"
sphere_hull.hull_args = "b"
box_hull.hull_args = "b"
capsule_hull.hull_args = "b"
hull_hull.hull_args = "ab"


# (type_a, type_b) -> (fn, n_points). The builder lists a pair's geom of the
# lower type first (model.py), as the JAX builder does, and replaces box_box
# by the one-sided or corners-only test where one side is fixed or a robot
# link. So no task's table holds box_sphere: it serves a pair listed box
# first (the JAX kernel implements it too; its PAIR_FUNCS resolves such a
# pair to sphere_box with the sides swapped).
PAIR_FUNCS = {
    (GeomType.PLANE, GeomType.SPHERE): (plane_sphere, 1),
    (GeomType.PLANE, GeomType.BOX): (plane_box, 8),
    (GeomType.PLANE, GeomType.CAPSULE): (plane_capsule, 2),
    (GeomType.SPHERE, GeomType.SPHERE): (sphere_sphere, 1),
    (GeomType.SPHERE, GeomType.BOX): (sphere_box, 1),
    (GeomType.BOX, GeomType.SPHERE): (box_sphere, 1),
    (GeomType.BOX, GeomType.BOX): (box_box, 28),
    (GeomType.SPHERE, GeomType.CAPSULE): (sphere_capsule, 1),
    (GeomType.CAPSULE, GeomType.BOX): (capsule_box, 3),
    (GeomType.CAPSULE, GeomType.CAPSULE): (capsule_capsule, 1),
    (GeomType.PLANE, GeomType.HULL): (plane_hull, HULL_P),
    (GeomType.SPHERE, GeomType.HULL): (sphere_hull, 1),
    (GeomType.BOX, GeomType.HULL): (box_hull, 8 + HULL_P),
    (GeomType.CAPSULE, GeomType.HULL): (capsule_hull, 3),
    (GeomType.HULL, GeomType.HULL): (hull_hull, 2 * HULL_P),
}


def contact_fn(type_a: int, type_b: int):
    """Return (fn, n_points, swapped) for a geom type pair."""
    key = (GeomType(type_a), GeomType(type_b))
    if key in PAIR_FUNCS:
        fn, k = PAIR_FUNCS[key]
        return fn, k, False
    rkey = (key[1], key[0])
    if rkey in PAIR_FUNCS:
        fn, k = PAIR_FUNCS[rkey]
        return fn, k, True
    raise NotImplementedError(f"no contact function ported for {key}")
