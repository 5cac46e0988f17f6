"""Task-space (end-effector) delta controllers through damped-least-squares
IK, on batched tensors.

Port of ``maniskill_tpu/agents/controllers/ee.py``: ``pd_ee_delta_pos`` and
``pd_ee_delta_pose``, one delta-IK step ``Δq = DLS(J) Δx`` a control step,
in the ``root_translation`` / ``root_aligned_body_rotation`` frames. The
Jacobian comes from the env's own FK of the pre-step state (``aux``), sliced
to the robot's own bodies; the IK step's SPD solve is the batched solve
kernel on CUDA tensors (``kinematics.chain.dls_ik_delta``).
"""
from __future__ import annotations

import numpy as np
import torch

from ...kinematics import chain
from ...math import clamps
from ...math.rotations import quat_apply
from .base import (ControllerState, PDEEPosControllerConfig, PDEEPoseControllerConfig,
                   clip_and_scale_action)


class EEController:
    """pd_ee_delta_pos / pd_ee_delta_pose controller of the robot ``spec``."""

    def __init__(self, config: PDEEPosControllerConfig, spec, device):
        self.config = config
        self.spec = spec
        idx = np.asarray(config.joint_indices, dtype=np.int64)
        self.joint_indices = idx
        self.nj = len(idx)
        self._idx = torch.as_tensor(idx, device=device)
        self.with_rot = isinstance(config, PDEEPoseControllerConfig)
        self.action_dim = 6 if self.with_rot else 3
        self.normalize_action = config.normalize_action
        lo = np.full(3, config.pos_lower, np.float32)
        hi = np.full(3, config.pos_upper, np.float32)
        if self.with_rot:
            lo = np.concatenate([lo, np.full(3, config.rot_lower, np.float32)])
            hi = np.concatenate([hi, np.full(3, config.rot_upper, np.float32)])
        self.raw_low, self.raw_high = lo, hi
        self.ee_body, self.ee_off_p, _ = spec.frame_of(config.ee_link)
        # ancestor mask over the robot's bodies (the point Jacobian's)
        anc = np.zeros((spec.nb, spec.nb), np.float32)
        for b in range(spec.nb):
            j = b
            while j >= 0:
                anc[b, j] = 1.0
                j = int(spec.parent[j])
        self.ancestor_mask = anc
        self.qlim = spec.qlim[idx].astype(np.float32)
        self.kp = np.broadcast_to(np.asarray(config.stiffness, np.float32), (self.nj,)).copy()
        self.kd = np.broadcast_to(np.asarray(config.damping, np.float32), (self.nj,)).copy()
        self.force_limit = np.broadcast_to(
            np.asarray(config.force_limit, np.float32), (self.nj,)).copy()
        self._low = torch.as_tensor(lo, device=device)
        self._high = torch.as_tensor(hi, device=device)
        self._qlo = torch.as_tensor(self.qlim[:, 0], device=device)
        self._qhi = torch.as_tensor(self.qlim[:, 1], device=device)
        self._off_p = torch.as_tensor(np.asarray(self.ee_off_p, np.float32), device=device)

    def set_action(self, cstate: ControllerState, qpos: torch.Tensor, action: torch.Tensor,
                   aux=None) -> ControllerState:
        """New arm targets from a (K, 3) or (K, 6) action. ``aux`` is
        ``(base_pose (7,), body_pos (K, nb', 3), body_quat (K, nb', 4),
        axis_w (K, nb', 3))``, the env's FK of ``qpos``; a scene with
        articulated objects has more bodies than the robot (its trees follow
        the robot's), so the FK is sliced to the robot's ``nb``."""
        if aux is None:
            raise ValueError("the EE controller needs the FK of the pre-step state (aux)")
        base_pose, body_pos, body_quat, axis_w = aux
        nb = self.spec.nb
        body_pos, body_quat, axis_w = body_pos[:, :nb], body_quat[:, :nb], axis_w[:, :nb]
        a = (clip_and_scale_action(action, self._low, self._high)
             if self.normalize_action else action)
        base_q = base_pose[3:7].expand(a.shape[:-1] + (4,))
        dx_pos = quat_apply(base_q, a[..., :3])  # root_translation frame
        if self.ee_body >= 0:
            ee_p = body_pos[:, self.ee_body] + quat_apply(body_quat[:, self.ee_body],
                                                          self._off_p)
        else:
            ee_p = base_pose[:3].expand_as(dx_pos)
        J = chain.point_jacobian(self.spec, body_pos, axis_w, ee_p, self.ee_body,
                                 self.joint_indices, self.ancestor_mask)  # (K, 6, nj)
        if self.with_rot:
            dx_rot = quat_apply(base_q, a[..., 3:6])  # root-aligned rotation delta
            dq = chain.dls_ik_delta(J, torch.cat([dx_rot, dx_pos], dim=-1),
                                    self.config.ik_damping)
        else:
            dq = chain.dls_ik_delta(J[:, 3:], dx_pos, self.config.ik_damping)
        tgt = clamps.clip(qpos[..., self._idx] + dq, self._qlo, self._qhi)
        return ControllerState(target_qpos=tgt, target_qvel=torch.zeros_like(tgt))

