"""Quaternion and rotation math on batched torch tensors.

Port of ``maniskill_tpu/math/rotations.py`` (the functions the ported tasks
need). Quaternions are ``(..., 4)`` tensors in ``(w, x, y, z)`` order; every
function broadcasts over leading batch dims.
"""
from __future__ import annotations

import math

import torch

from . import clamps


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / clamps.maximum(torch.linalg.norm(q, dim=-1, keepdim=True), eps)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, wxyz order."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q:
    v' = v + 2 w (u x v) + 2 u x (u x v), u = q.xyz."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    m = torch.stack(
        [
            1.0 - (tyy + tzz), txy - twz, txz + twy,
            txy + twz, 1.0 - (txx + tzz), tyz - twx,
            txz - twy, tyz + twx, 1.0 - (txx + tyy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3) + angle (...,) -> quaternion."""
    half = 0.5 * angle
    xyz = axis * torch.sin(half)[..., None]
    return torch.cat([torch.cos(half)[..., None], xyz], dim=-1)


def quat_from_euler(rpy: torch.Tensor) -> torch.Tensor:
    """(roll, pitch, yaw) Euler angles (..., 3) -> quaternion, the URDF
    ``<origin rpy>`` convention: R = Rz(yaw) Ry(pitch) Rx(roll)."""
    r, p, y = rpy.unbind(-1)
    cr, sr = torch.cos(r * 0.5), torch.sin(r * 0.5)
    cp, sp = torch.cos(p * 0.5), torch.sin(p * 0.5)
    cy, sy = torch.cos(y * 0.5), torch.sin(y * 0.5)
    return torch.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        dim=-1,
    )


def quat_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) -> quaternion; the 1e-18 keeps it finite at 0."""
    sq = torch.sum(w * w, dim=-1, keepdim=True)
    angle = torch.sqrt(sq + 1e-18)
    half = 0.5 * angle
    k = torch.sin(half) / angle
    return torch.cat([torch.cos(half), w * k], dim=-1)


def random_quaternion(gen: torch.Generator, shape=(), lock_x: bool = False,
                      lock_y: bool = False, lock_z: bool = False,
                      device="cpu") -> torch.Tensor:
    """Random unit quaternions of ``shape`` drawn with ``gen``: yaw only
    (a uniform angle about +z) under ``lock_x and lock_y``, the identity
    under all three locks, else Shoemake's uniform quaternion (the other
    lock combinations restrict nothing, as in the JAX package)."""
    shape = tuple(shape)
    if lock_x and lock_y and not lock_z:
        ang = -math.pi + 2 * math.pi * torch.rand(shape, generator=gen, device=device)
        axis = torch.tensor([0.0, 0.0, 1.0], device=device).expand(shape + (3,))
        return quat_from_axis_angle(axis, ang)
    if lock_x and lock_y and lock_z:
        return torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).expand(shape + (4,)).clone()
    u1, u2, u3 = torch.rand(shape + (3,), generator=gen, device=device).unbind(-1)
    a, b = torch.sqrt(1.0 - u1), torch.sqrt(u1)
    return torch.stack([a * torch.sin(2 * math.pi * u2), a * torch.cos(2 * math.pi * u2),
                        b * torch.sin(2 * math.pi * u3), b * torch.cos(2 * math.pi * u3)], -1)


def angle_between(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Angle (radians) between batched vectors."""
    na = a / torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True) + eps * eps)
    nb = b / torch.sqrt(torch.sum(b * b, dim=-1, keepdim=True) + eps * eps)
    return torch.arccos(
        torch.clamp(torch.sum(na * nb, dim=-1), -1.0 + 1e-7, 1.0 - 1e-7))
