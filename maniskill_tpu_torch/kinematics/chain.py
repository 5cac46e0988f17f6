"""Kinematic chain operations on batched torch tensors: FK, frame poses,
point Jacobians, the damped-least-squares IK step.

Port of ``maniskill_tpu/kinematics/chain.py`` (``fk``, ``_fk_unrolled``,
``frame_pose``, ``point_jacobian``, ``dls_ik_delta``). The JAX package has
two lowerings of FK (an unrolled one for the TPU and a ``lax.scan`` one for
its CPU tests); the port keeps only the unrolled form, which is also what
the CUDA kernel runs. The IK step's SPD solve goes through the batched
solve kernel (``physics/solve_kernel.py``) on CUDA tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .._consts import const
from ..math.rotations import quat_apply, quat_mul
from ..physics import solve_kernel
from .urdf import JOINT_REVOLUTE, RobotSpec, _quat_mul


def fk_tables(spec: RobotSpec):
    """Per-body pre-composed joint quaternions ``(Aq, Bq)`` (nb, 4):
    ``jq ∘ aa(axis, q) = cos(q/2)·Aq + sin(q/2)·Bq`` with ``Aq = jq`` and
    ``Bq = jq ∘ [0, axis]``. Cached on the spec."""
    cache = getattr(spec, "_fk_quat_cache", None)
    if cache is None:
        A = [spec.joint_quat[i] for i in range(spec.nb)]
        B = [_quat_mul(spec.joint_quat[i], np.concatenate([[0.0], spec.axis[i]]))
             for i in range(spec.nb)]
        cache = (np.stack(A).astype(np.float32), np.stack(B).astype(np.float32))
        spec._fk_quat_cache = cache
    return cache


def fk(spec: RobotSpec, base_pose: torch.Tensor, qpos: torch.Tensor):
    """Forward kinematics of a batch ``qpos (..., nb)``.

    Returns ``(body_pos (..., nb, 3), body_quat (..., nb, 4),
    axis_w (..., nb, 3))``."""
    return _fk_unrolled(spec, base_pose, qpos)


def _fk_unrolled(spec: RobotSpec, base_pose: torch.Tensor, qpos: torch.Tensor):
    dev = qpos.device
    A_np, B_np = fk_tables(spec)
    Aq = const(spec, "fk_Aq", A_np, dev)
    Bq = const(spec, "fk_Bq", B_np, dev)
    jpos = const(spec, "joint_pos", spec.joint_pos, dev)
    jaxis = const(spec, "axis", spec.axis, dev)
    batch = qpos.shape[:-1]
    base_p = base_pose[..., :3].expand(batch + (3,))
    base_q = base_pose[..., 3:7].expand(batch + (4,))
    pos_list, quat_list, axis_list = [], [], []
    for i in range(spec.nb):
        par = int(spec.parent[i])
        pp = base_p if par < 0 else pos_list[par]
        pq = base_q if par < 0 else quat_list[par]
        fp = pp + quat_apply(pq, jpos[i])  # joint frame origin in world
        if int(spec.joint_type[i]) == JOINT_REVOLUTE:
            half = 0.5 * qpos[..., i:i + 1]
            m = torch.cos(half) * Aq[i] + torch.sin(half) * Bq[i]
            bq = quat_mul(pq, m)
            bp = fp
            axis_list.append(quat_apply(bq, jaxis[i]))
        else:  # prismatic
            bq = quat_mul(pq, Aq[i].expand_as(pq))
            aw = quat_apply(bq, jaxis[i])
            bp = fp + aw * qpos[..., i:i + 1]
            axis_list.append(aw)
        pos_list.append(bp)
        quat_list.append(bq)
    return (
        torch.stack(pos_list, dim=-2),
        torch.stack(quat_list, dim=-2),
        torch.stack(axis_list, dim=-2),
    )


def frame_pose(spec: RobotSpec, base_pose: torch.Tensor, body_pos, body_quat,
               frame_name: str):
    """World pose (p, q) of a named movable link or fused fixed frame."""
    idx, off_p, off_q = spec.frame_of(frame_name)
    dev = body_pos.device
    off_p = const(spec, f"frame_p:{frame_name}", off_p, dev)
    off_q = const(spec, f"frame_q:{frame_name}", off_q, dev)
    if idx < 0:
        bp = base_pose[..., :3].expand(body_pos.shape[:-2] + (3,))
        bq = base_pose[..., 3:7].expand(body_pos.shape[:-2] + (4,))
    else:
        bp, bq = body_pos[..., idx, :], body_quat[..., idx, :]
    return bp + quat_apply(bq, off_p), quat_mul(bq, off_q.expand_as(bq))


def point_jacobian(spec: RobotSpec, body_pos, axis_w, point_w, body_idx: int,
                   joint_indices: np.ndarray, ancestor_mask: np.ndarray):
    """(..., 6, k) Jacobian ([ang; lin] rows) of a world point fixed to
    ``body_idx`` w.r.t. the selected dofs. The static tables are device
    tensors cached on the spec (no host copy a call)."""
    dev = body_pos.device
    is_rev = const(spec, "is_rev", (spec.joint_type == JOINT_REVOLUTE)[:, None], dev)
    row = np.asarray(ancestor_mask[body_idx], np.float32)
    mask = const(spec, f"ancestors:{body_idx}:{row.tobytes().hex()}", row[:, None], dev)
    cols = np.asarray(joint_indices, np.int64)
    idx = const(spec, f"columns:{cols.tobytes().hex()}", cols, dev, dtype=torch.long)
    ang = is_rev * axis_w
    arm = point_w[..., None, :] - body_pos
    lin = is_rev * torch.linalg.cross(axis_w, arm, dim=-1) + (1.0 - is_rev) * axis_w
    J = torch.cat([ang * mask, lin * mask], dim=-1).transpose(-1, -2)
    return J[..., idx]


def dls_ik_delta(J: torch.Tensor, dx: torch.Tensor, damping: float = 0.05) -> torch.Tensor:
    """One damped-least-squares IK step for a batch: Δq = Jᵀ (J Jᵀ + λ²I)⁻¹ Δx
    with J (K, m, nj) and Δx (K, m); returns Δq (K, nj).

    The JAX package solves the system with LU (``jnp.linalg.solve``); it is
    SPD with every pivot at least λ², so the batched Cholesky solve
    (``solve_kernel.solve_psd``: the kernel on CUDA tensors, its plain
    version on CPU ones) computes the same function, with no host sync."""
    A = J @ J.transpose(-1, -2)
    A.diagonal(dim1=-2, dim2=-1).add_(damping ** 2)
    y = solve_kernel.solve_psd(A, dx)
    return (J.transpose(-1, -2) @ y[..., None])[..., 0]
