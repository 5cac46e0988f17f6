"""Joint-space controllers on batched tensors.

Port of ``maniskill_tpu/agents/controllers/base.py``:
``PDJointPosControllerConfig`` and ``JointController`` in position mode,
with delta or absolute targets, the delta added to the last target
(``use_target``: ``pd_joint_target_delta_pos``) or to qpos, raw
(``normalize_action=False``) or scaled actions, and the mimic (one action,
all joints) gripper; ``PDJointVelControllerConfig`` (the ``vel`` mode:
velocity targets, kp 0) and ``PDJointPosVelControllerConfig`` (the
``pos_vel`` mode: position targets as the position mode's, then velocity
targets, ``:251-265``); the task-space configs ``PDEEPosControllerConfig``
and ``PDEEPoseControllerConfig`` (``:128-145``; their controller is
``ee.EEController``);
``PDBaseForwardVelControllerConfig`` (the ``base_vel`` mode,
``:160-175``, ``:268``: two actions, forward and turning velocity, onto the
root x, y and yaw joints through damping-only velocity drives);
``PassiveControllerConfig`` (``:93``, the ``passive`` mode ``:178``,
``:266``: no action, no stiffness, optional damping; its targets are left
as they were); ``TorqueControllerConfig`` and ``TorqueController``
(``:115``, ``:304-330``: the MJCF ``<motor>`` actuators, ``qf = gear *
clip(a, ctrlrange)`` with kp = kd = 0).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ...math import clamps


def clip_and_scale_action(action, low, high):
    """[-1, 1] -> [low, high]."""
    action = clamps.clip(action, -1.0, 1.0)
    return 0.5 * (high + low) + 0.5 * (high - low) * action


@dataclass
class ControllerState:
    """Drive targets of the controlled joints, (K, nj) each."""

    target_qpos: torch.Tensor
    target_qvel: torch.Tensor


@dataclass
class ControllerConfig:
    joint_names: Sequence[str] = ()
    joint_indices: np.ndarray = None  # resolved by the agent layer


@dataclass
class PDJointPosControllerConfig(ControllerConfig):
    lower: Union[None, float, Sequence[float]] = None
    upper: Union[None, float, Sequence[float]] = None
    stiffness: Union[float, Sequence[float]] = 100.0
    damping: Union[float, Sequence[float]] = 10.0
    force_limit: Union[float, Sequence[float]] = 1e10
    use_delta: bool = False  # targets are qpos + action
    use_target: bool = False  # with use_delta: the last target + action
    mimic: bool = False  # one action drives all joints
    normalize_action: bool = True  # action in [-1, 1] scaled to [lower, upper]


@dataclass
class PDJointPosVelControllerConfig(PDJointPosControllerConfig):
    """Action [position targets (nj), velocity targets (nj)]: the position
    half as ``PDJointPosControllerConfig``'s, the velocity half scaled to
    [vel_lower, vel_upper]."""

    vel_lower: Union[float, Sequence[float]] = -1.0
    vel_upper: Union[float, Sequence[float]] = 1.0


@dataclass
class PDJointVelControllerConfig(ControllerConfig):
    """Joint velocity targets in [lower, upper] through damping-only drives."""

    lower: Union[None, float, Sequence[float]] = -1.0
    upper: Union[None, float, Sequence[float]] = 1.0
    damping: Union[float, Sequence[float]] = 10.0
    force_limit: Union[float, Sequence[float]] = 1e10
    normalize_action: bool = True


@dataclass
class PDEEPosControllerConfig(ControllerConfig):
    """Task-space delta-position control through one damped-least-squares IK
    step a control step, in the ``root_translation`` frame (the only frame
    the JAX controller takes)."""

    pos_lower: Union[None, float] = -0.1
    pos_upper: Union[None, float] = 0.1
    stiffness: Union[float, Sequence[float]] = 100.0
    damping: Union[float, Sequence[float]] = 10.0
    force_limit: Union[float, Sequence[float]] = 1e10
    ee_link: str = ""
    normalize_action: bool = True
    ik_damping: float = 0.05


@dataclass
class PDEEPoseControllerConfig(PDEEPosControllerConfig):
    """``PDEEPosControllerConfig`` plus a rotation delta (axis-angle, in
    the ``root_aligned_body_rotation`` frame) in [rot_lower, rot_upper]."""

    rot_lower: float = -0.1
    rot_upper: float = 0.1


@dataclass
class PDBaseForwardVelControllerConfig(ControllerConfig):
    """Ego-centric mobile-base velocity control: 2 actions (forward and
    turning velocity) onto the root x, y and yaw joints, in that order."""

    lower: float = -0.5
    upper: float = 0.5
    damping: Union[float, Sequence[float]] = 1e3
    force_limit: Union[float, Sequence[float]] = 1e10
    normalize_action: bool = True


@dataclass
class PassiveControllerConfig(ControllerConfig):
    """Joints that take no action and no drive; optional damping."""

    damping: Union[float, Sequence[float]] = 0.0
    friction: Union[float, Sequence[float]] = 0.0


@dataclass
class TorqueControllerConfig(ControllerConfig):
    """Direct joint torque (dm_control-style MJCF ``<motor>`` actuators):
    qf = gear * a, with a clipped to ``ctrlrange``."""

    gear: Union[float, Sequence[float]] = 1.0
    ctrlrange: Tuple[float, float] = (-1.0, 1.0)


def make_controller(config: ControllerConfig, agent, device):
    """The controller of a resolved config (``joint_indices`` set) of
    ``agent``'s robot."""
    if isinstance(config, PDEEPosControllerConfig):
        from .ee import EEController

        return EEController(config, agent.robot_spec, device)
    if isinstance(config, TorqueControllerConfig):
        return TorqueController(config, device)
    return JointController(config, agent.robot_spec.qlim, device)


class JointController:
    """Per-joint PD controller with device-resident constants: position
    targets (``PDJointPosControllerConfig``), position and velocity targets
    (``PDJointPosVelControllerConfig``), velocity targets
    (``PDJointVelControllerConfig``), the mobile base's velocity targets
    (``PDBaseForwardVelControllerConfig``) or passive joints
    (``PassiveControllerConfig``)."""

    def __init__(self, config: ControllerConfig, qlim: np.ndarray, device):
        idx = np.asarray(config.joint_indices, dtype=np.int64)
        self.config = config
        self.joint_indices = idx
        self.nj = len(idx)
        self._idx = torch.as_tensor(idx, device=device)
        self.qlim = qlim[idx].astype(np.float32)
        self.use_delta = self.use_target = self.mimic = False
        if isinstance(config, PDBaseForwardVelControllerConfig):
            if self.nj != 3:
                raise ValueError("the base controller drives (root x, root y, root yaw)")
            self._mode = "base_vel"
            self.action_dim = 2
            self.raw_low = np.full(2, config.lower, np.float32)
            self.raw_high = np.full(2, config.upper, np.float32)
            self.normalize_action = config.normalize_action
            self.kp = np.zeros(self.nj, np.float32)
            self.kd = np.broadcast_to(np.asarray(config.damping, np.float32), (self.nj,)).copy()
            self.force_limit = np.broadcast_to(
                np.asarray(config.force_limit, np.float32), (self.nj,)).copy()
            self._low = torch.as_tensor(self.raw_low, device=device)
            self._high = torch.as_tensor(self.raw_high, device=device)
            return
        if isinstance(config, PassiveControllerConfig):
            self._mode = "passive"
            self.action_dim = 0
            self.raw_low = self.raw_high = np.zeros(0, np.float32)
            self.normalize_action = False
            self.kp = np.zeros(self.nj, np.float32)
            self.kd = np.broadcast_to(np.asarray(config.damping, np.float32), (self.nj,)).copy()
            self.force_limit = np.full(self.nj, 1e10, np.float32)
            return
        if isinstance(config, PDJointVelControllerConfig):
            self._mode = "vel"
            lo = np.broadcast_to(np.asarray(config.lower, np.float32), (self.nj,)).copy()
            hi = np.broadcast_to(np.asarray(config.upper, np.float32), (self.nj,)).copy()
        elif isinstance(config, PDJointPosControllerConfig):
            self._mode = "pos"
            lo = qlim[idx, 0].copy()
            hi = qlim[idx, 1].copy()
            if config.lower is not None:
                lo[:] = config.lower
            if config.upper is not None:
                hi[:] = config.upper
            self.use_delta = config.use_delta
            self.use_target = config.use_target
            self.mimic = config.mimic
            if isinstance(config, PDJointPosVelControllerConfig):
                if self.mimic:
                    raise ValueError("a pos_vel controller takes no mimic joints")
                self._mode = "pos_vel"
                lo = np.concatenate([lo, np.broadcast_to(
                    np.asarray(config.vel_lower, np.float32), (self.nj,))])
                hi = np.concatenate([hi, np.broadcast_to(
                    np.asarray(config.vel_upper, np.float32), (self.nj,))])
        else:
            raise NotImplementedError(f"controller {type(config).__name__}")
        self.normalize_action = config.normalize_action
        if self.mimic:
            if not (np.allclose(lo, lo[0]) and np.allclose(hi, hi[0])):
                raise ValueError("mimic joints need one shared action range")
            self.action_dim = 1
        else:
            self.action_dim = len(lo)
        self.raw_low = lo.astype(np.float32)
        self.raw_high = hi.astype(np.float32)
        # the velocity mode has no stiffness: its drives are damping only
        self.kp = np.broadcast_to(np.asarray(getattr(config, "stiffness", 0.0), np.float32),
                                  (self.nj,)).copy()
        self.kd = np.broadcast_to(np.asarray(config.damping, np.float32), (self.nj,)).copy()
        self.force_limit = np.broadcast_to(
            np.asarray(config.force_limit, np.float32), (self.nj,)).copy()
        n = self.action_dim
        self._low = torch.as_tensor(self.raw_low[:n], device=device)
        self._high = torch.as_tensor(self.raw_high[:n], device=device)
        self._qlo = torch.as_tensor(self.qlim[:, 0], device=device)
        self._qhi = torch.as_tensor(self.qlim[:, 1], device=device)

    def set_action(self, cstate: ControllerState, qpos: torch.Tensor,
                   action: torch.Tensor) -> ControllerState:
        """New drive targets from a (K, action_dim) action in [-1, 1]."""
        if self._mode == "passive":
            return cstate
        a = (clip_and_scale_action(action, self._low, self._high)
             if self.normalize_action else action)
        if self._mode == "base_vel":
            # ego-centric (forward, turn) -> world (vx, vy, yaw rate); the
            # position targets hold the current pose (kp is 0)
            ori = qpos[..., self._idx[2]]
            tv = torch.stack([a[..., 0] * torch.cos(ori), a[..., 0] * torch.sin(ori),
                              a[..., 1]], dim=-1)
            return ControllerState(target_qpos=qpos[..., self._idx], target_qvel=tv)
        if self.mimic:
            a = a.expand(a.shape[:-1] + (self.nj,))
        q = qpos[..., self._idx]
        if self._mode == "vel":
            return ControllerState(target_qpos=q, target_qvel=a)
        tv = None
        if self._mode == "pos_vel":
            a, tv = a[..., :self.nj], a[..., self.nj:]
        if self.use_delta:
            tgt = (cstate.target_qpos if self.use_target else q) + a
        else:
            tgt = a.expand(q.shape)
        # clamp targets to joint limits like PhysX drive targets do
        tgt = clamps.clip(tgt, self._qlo, self._qhi)
        return ControllerState(target_qpos=tgt,
                               target_qvel=torch.zeros_like(tgt) if tv is None else tv)


class TorqueController:
    """Writes ``DriveCmd.qf`` directly (zero PD gains): qf = gear * a, a
    clipped to ``ctrlrange``, which is also the raw action space."""

    def __init__(self, config: TorqueControllerConfig, device):
        idx = np.asarray(config.joint_indices, dtype=np.int64)
        self.config = config
        self.joint_indices = idx
        self.nj = nj = len(idx)
        self._idx = torch.as_tensor(idx, device=device)
        self.action_dim = nj
        self.mimic = False
        self.normalize_action = False
        self.gear = np.broadcast_to(np.asarray(config.gear, np.float32), (nj,)).copy()
        self.raw_low = np.full(nj, config.ctrlrange[0], np.float32)
        self.raw_high = np.full(nj, config.ctrlrange[1], np.float32)
        self.kp = np.zeros(nj, np.float32)
        self.kd = np.zeros(nj, np.float32)
        self.force_limit = np.full(nj, 1e10, np.float32)
        self._gear = torch.as_tensor(self.gear, device=device)
        self._low = torch.as_tensor(self.raw_low, device=device)
        self._high = torch.as_tensor(self.raw_high, device=device)

    def set_action(self, cstate: ControllerState, qpos: torch.Tensor,
                   action: torch.Tensor) -> ControllerState:
        """The targets hold the current qpos (kp and kd are 0)."""
        q = qpos[..., self._idx]
        return ControllerState(target_qpos=q, target_qvel=torch.zeros_like(q))

    def compute_qf(self, action: torch.Tensor) -> torch.Tensor:
        """The (K, nj) generalized forces of a (K, nj) action."""
        return self._gear * clamps.clip(action, self._low, self._high)
