"""Collision primitives and pairwise contact-point generation, batched.

Port of the box and plane parts of ``maniskill_tpu/physics/shapes.py``:
``plane_box`` (``:110``), the symmetric 28-point ``box_box`` (``:198``)
with ``_FACE_DIRS`` and ``_box_face_centers`` (``:188-195``),
``box_box_corners`` (``:281``), ``box_box_onesided`` (``:301``) and their
helpers ``_box_corners`` and ``_point_box_sdf``; the convex-hull face-plane
SDF ``_hull_sdf`` (``:325``), ``plane_hull`` (``:341``) and ``box_hull``
(``:361``) with their ``hull_args`` tags; and ``contact_fn``. The sphere
and capsule functions and ``sphere_hull``, ``capsule_hull`` and
``hull_hull`` are not ported yet.

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
    SPHERE = 1
    BOX = 2  # size = half extents
    CAPSULE = 3
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


# which sides of each hull pair function consume (verts, faces) tables
plane_hull.hull_args = "b"
box_hull.hull_args = "b"


# (type_a, type_b) -> (fn, n_points). The model builder replaces box_box by
# the one-sided or corners-only test where one side is fixed or a robot
# link (model.py).
PAIR_FUNCS = {
    (GeomType.PLANE, GeomType.BOX): (plane_box, 8),
    (GeomType.BOX, GeomType.BOX): (box_box, 28),
    (GeomType.PLANE, GeomType.HULL): (plane_hull, HULL_P),
    (GeomType.BOX, GeomType.HULL): (box_hull, 8 + HULL_P),
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
