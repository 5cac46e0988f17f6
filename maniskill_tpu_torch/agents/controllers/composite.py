"""Composite controller: arm + gripper in one flat action space.

Port of ``maniskill_tpu/agents/controllers/composite.py`` on batched
tensors: sub-controllers are concatenated in insertion order, the action is
split by ``action_dim`` and each sub-controller writes drive targets for its
joints into the full (K, nq) target arrays. A torque sub-controller also
writes its joints' generalized forces: when the composite has one, ``qf``
is rebuilt each step, zero on every other dof (``:90-108``); otherwise the
command's ``qf`` is kept.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...physics.model import DriveCmd
from .base import ControllerState, JointController


class CompositeController:
    def __init__(self, controllers: Dict[str, JointController], nq: int, device):
        self.controllers = controllers
        self.nq = nq
        self.device = device
        self.action_dim = sum(c.action_dim for c in controllers.values())
        # action bounds: [-1, 1] for a normalized controller, else its raw range
        lows, highs = [], []
        for c in controllers.values():
            n = c.action_dim
            lows.append(c.raw_low[:n] if not c.normalize_action else -np.ones(n, np.float32))
            highs.append(c.raw_high[:n] if not c.normalize_action else np.ones(n, np.float32))
        self.action_low = np.concatenate(lows).astype(np.float32)
        self.action_high = np.concatenate(highs).astype(np.float32)
        # full-dof drive gains for the scene model
        self.kp = np.zeros(nq, dtype=np.float32)
        self.kd = np.zeros(nq, dtype=np.float32)
        self.force_limit = np.full(nq, 1e10, dtype=np.float32)
        for c in controllers.values():
            self.kp[c.joint_indices] = c.kp
            self.kd[c.joint_indices] = c.kd
            self.force_limit[c.joint_indices] = c.force_limit
        self._gains = [torch.as_tensor(g, device=device)
                       for g in (self.kp, self.kd, self.force_limit)]

    def reset(self, qpos: torch.Tensor) -> DriveCmd:
        """Drive command holding the current (K, nq) qpos, with the
        controller-config gains materialized per env. A scene's qpos may
        extend past the robot's dofs (articulated objects follow the robot
        in the forest): those dofs are undriven (kp = kd = 0)."""
        extra = qpos.shape[-1] - self.nq
        pads = (0.0, 0.0, 1e10)
        kp, kd, fl = (torch.cat([g, g.new_full((extra,), v)]).expand_as(qpos).clone()
                      for g, v in zip(self._gains, pads))
        return DriveCmd(target_qpos=qpos.clone(), target_qvel=torch.zeros_like(qpos),
                        qf=torch.zeros_like(qpos), kp=kp, kd=kd, force_limit=fl)

    def set_action(self, cmd: DriveCmd, qpos: torch.Tensor,
                   action: torch.Tensor) -> DriveCmd:
        """Split the flat (K, A) action and compute new full-dof targets."""
        tq = cmd.target_qpos.clone()
        tv = torch.zeros_like(tq)
        qf = None
        off = 0
        for c in self.controllers.values():
            a = action[..., off:off + c.action_dim]
            off += c.action_dim
            sub = ControllerState(target_qpos=cmd.target_qpos[..., c._idx],
                                  target_qvel=cmd.target_qvel[..., c._idx])
            new_sub = c.set_action(sub, qpos, a)
            tq[..., c._idx] = new_sub.target_qpos
            tv[..., c._idx] = new_sub.target_qvel
            if hasattr(c, "compute_qf"):
                if qf is None:
                    qf = torch.zeros_like(tq)
                qf[..., c._idx] = c.compute_qf(a)
        if qf is None:
            return cmd.replace(target_qpos=tq, target_qvel=tv)
        return cmd.replace(target_qpos=tq, target_qvel=tv, qf=qf)
