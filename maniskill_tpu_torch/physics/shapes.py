"""Collision primitives and pairwise contact-point generation, batched.

Port of the box and plane parts of ``maniskill_tpu/physics/shapes.py``:
``plane_box`` (``:110``), ``box_box_corners`` (``:281``),
``box_box_onesided`` (``:301``) and their helpers ``_box_corners`` and
``_point_box_sdf``, plus ``contact_fn``. The sphere, capsule, full 28-point
``box_box`` and convex-hull functions are not ported yet.

Every pair function emits a fixed number of candidate points; inputs are
poses ``p (..., 3)``, ``q (..., 4)`` and half sizes ``s (..., 3)``, outputs
carry a trailing point axis. The normal points from B toward A; ``depth > 0``
means penetration.
"""
from __future__ import annotations

import functools
from enum import IntEnum
from typing import NamedTuple

import numpy as np
import torch

from ..math.rotations import quat_apply, quat_conjugate


class GeomType(IntEnum):
    PLANE = 0  # half-space z<=0 in geom frame, normal +z
    SPHERE = 1
    BOX = 2  # size = half extents
    CAPSULE = 3
    CYLINDER = 4
    HULL = 5


class ContactPoints(NamedTuple):
    pos: torch.Tensor  # (..., n, 3)
    normal: torch.Tensor  # (..., n, 3) unit normal, B -> A
    depth: torch.Tensor  # (..., n)


_BOX_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    dtype=np.float32,
)


@functools.lru_cache(maxsize=8)
def _corner_signs(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_BOX_CORNERS, device=device)


def _box_corners(pos, quat, half):
    corners = _corner_signs(pos.device) * half[..., None, :]
    return pos[..., None, :] + quat_apply(quat[..., None, :], corners)


def _unit_z(like: torch.Tensor) -> torch.Tensor:
    ez = torch.zeros_like(like)
    ez[..., 2] = 1.0
    return ez


def _point_box_sdf(p_local: torch.Tensor, half: torch.Tensor):
    """Signed distance + outward normal (local frame) of points vs a box."""
    q = torch.abs(p_local) - half
    outside = torch.clamp_min(q, 0.0)
    d_out = torch.sqrt(torch.sum(outside * outside, dim=-1) + 1e-18)
    d_in = torch.clamp_max(torch.amax(q, dim=-1), 0.0)
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


def _corners_in_box(pa, qa, sa, pb, qb, sb):
    """Corners of box A against box B: positions, B->A normals, depths."""
    ca = _box_corners(pa, qa, sa)  # (..., 8, 3)
    ca_local = quat_apply(quat_conjugate(qb)[..., None, :], ca - pb[..., None, :])
    sdf, n_local = _point_box_sdf(ca_local, sb[..., None, :])
    n = quat_apply(qb[..., None, :], n_local)
    return ca, n, -sdf


def plane_box(pa, qa, sa, pb, qb, sb) -> ContactPoints:
    """A = plane, B = box: all 8 corners against the half-space."""
    n = quat_apply(qa, _unit_z(pa))
    corners = _box_corners(pb, qb, sb)  # (..., 8, 3)
    dist = torch.sum((corners - pa[..., None, :]) * n[..., None, :], dim=-1)
    return ContactPoints(corners, (-n)[..., None, :].expand_as(corners), -dist)


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


# (type_a, type_b) -> (fn, n_points). Box-box pairs are resolved by the model
# builder to the one-sided or corners-only test (model.py).
PAIR_FUNCS = {
    (GeomType.PLANE, GeomType.BOX): (plane_box, 8),
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
