"""WidowX-250 6DOF agent (the BridgeData v2 robot).

Port of ``maniskill_tpu/agents/robots/widowx.py``: ``WidowX250S`` with the
real2sim arm gains (``:45-57``), the ``rest`` keyframe, the four control
modes in the JAX package's order (``:71-116``; the first,
``pd_joint_delta_pos``, is the default): ``pd_joint_delta_pos``,
``pd_joint_pos``, ``pd_ee_delta_pos`` and ``pd_ee_delta_pose`` (the EE
modes through ``controllers/ee.py``, whose IK solve is the batched solve
kernel on a card), the gripper on the mimic ``pd_joint_pos`` over
[0.014, 0.038]; ``build_grasp_checker`` (``:118-155``: the contact force
of each finger against its own opening direction, +y for the left finger
and -y for the right) and ``is_static``. ``WidowX250SBridge``
(``widowx250s_bridgedataset_flat_table``, ``:158-183``) is the same body
and controllers; the pose of its third-view camera is kept as data, and
the camera waits for the sensors. The URDF is read as a data file from the
JAX package's asset tree.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ...math.rotations import angle_between, quat_to_matrix
from ..base_agent import BaseAgent, Keyframe, register_agent
from ..controllers.base import (PDEEPosControllerConfig, PDEEPoseControllerConfig,
                                PDJointPosControllerConfig)

WX250S_URDF = str(Path(__file__).resolve().parents[3]
                  / "maniskill_tpu" / "assets" / "robots" / "widowx" / "wx250s.urdf")

ARM_JOINTS = ["waist", "shoulder", "elbow", "forearm_roll", "wrist_angle", "wrist_rotate"]
GRIPPER_JOINTS = ["left_finger", "right_finger"]


@register_agent
class WidowX250S(BaseAgent):
    uid = "widowx250s"
    urdf_path = WX250S_URDF
    ee_link_name = "ee_gripper_link"

    arm_stiffness = np.array([1169.79, 730.0, 808.46, 1229.13, 1272.28, 1056.33], np.float32)
    arm_damping = np.array([330.0, 180.0, 152.12, 309.62, 201.05, 269.51], np.float32)
    arm_force_limit = np.array([200, 200, 100, 100, 100, 100], np.float32)
    gripper_stiffness = 1000.0
    gripper_damping = 200.0
    gripper_force_limit = 60.0

    link_friction = {"left_finger_link": 2.0, "right_finger_link": 2.0}

    # the bridge rig's flat-table rest pose, gripper open
    keyframes = dict(rest=Keyframe(qpos=np.array(
        [-0.0184, 0.0399, 0.2224, -0.0046, 1.3652, 0.0015, 0.037, 0.037], np.float32)))

    def _controller_configs(self):
        arm = dict(joint_names=ARM_JOINTS, stiffness=self.arm_stiffness,
                   damping=self.arm_damping, force_limit=self.arm_force_limit)
        ee = dict(pos_lower=-0.1, pos_upper=0.1, ee_link=self.ee_link_name, **arm)
        gripper = PDJointPosControllerConfig(
            joint_names=GRIPPER_JOINTS,
            lower=0.015 - 0.001,  # the bridge rig's range with 1 mm clearance
            upper=0.037 + 0.001,
            stiffness=self.gripper_stiffness, damping=self.gripper_damping,
            force_limit=self.gripper_force_limit, mimic=True)
        arms = dict(
            pd_joint_delta_pos=PDJointPosControllerConfig(
                lower=-0.1, upper=0.1, use_delta=True, **arm),
            pd_joint_pos=PDJointPosControllerConfig(
                lower=None, upper=None, normalize_action=False, **arm),
            pd_ee_delta_pos=PDEEPosControllerConfig(**ee),
            pd_ee_delta_pose=PDEEPoseControllerConfig(
                rot_lower=-np.pi / 2, rot_upper=np.pi / 2, **ee),
        )
        return {mode: dict(arm=cfg, gripper=gripper) for mode, cfg in arms.items()}

    def build_grasp_checker(self, model, obj_name: str, device,
                            min_force: float = 0.5, max_angle: float = 85.0):
        """``is_grasping(body_quat (K,nb,4), f_pt (K,P,3)) -> (K,) bool``:
        both fingers feel at least ``min_force`` from the object, each
        within ``max_angle`` of its finger's opening direction (+y of the
        left finger, -y of the right)."""
        from ...physics.engine import pair_force_signs
        from ...physics.model import BodyKind

        obj_idx = model.free_index[obj_name]
        lf = self.robot_spec.link_index["left_finger_link"]
        rf = self.robot_spec.link_index["right_finger_link"]
        sl = torch.as_tensor(pair_force_signs(
            model, (BodyKind.ROBOT_LINK, lf), (BodyKind.FREE, obj_idx)), device=device)
        sr = torch.as_tensor(pair_force_signs(
            model, (BodyKind.ROBOT_LINK, rf), (BodyKind.FREE, obj_idx)), device=device)
        max_rad = float(np.deg2rad(max_angle))

        def is_grasping(body_quat, f_pt):
            lforce_vec = torch.einsum("p,Kpc->Kc", sl.to(f_pt.dtype), f_pt)
            rforce_vec = torch.einsum("p,Kpc->Kc", sr.to(f_pt.dtype), f_pt)
            lforce = torch.linalg.norm(lforce_vec, dim=-1)
            rforce = torch.linalg.norm(rforce_vec, dim=-1)
            ldir = quat_to_matrix(body_quat[:, lf])[..., :, 1]
            rdir = -quat_to_matrix(body_quat[:, rf])[..., :, 1]
            lflag = (lforce >= min_force) & (angle_between(ldir, lforce_vec) <= max_rad)
            rflag = (rforce >= min_force) & (angle_between(rdir, rforce_vec) <= max_rad)
            return lflag & rflag

        return is_grasping

    def is_static(self, qvel: torch.Tensor, threshold: float = 0.2):
        """Arm joints only (grippers excluded)."""
        return torch.amax(torch.abs(qvel[..., :6]), dim=-1) <= threshold


@register_agent
class WidowX250SBridge(WidowX250S):
    """The bridge-dataset eval variant: the WidowX's body and controllers.
    The JAX agent adds the rig's third-view camera (a Logitech C920 at the
    measured pose relative to ``base_link``); the port's sensors are not
    written yet (ROADMAP Queue A item 8), so the pose is kept here as data
    and no sensor is built."""

    uid = "widowx250s_bridgedataset_flat_table"
    # (uid, pose relative to the mount link, width, height, vertical fov, mount)
    third_view_camera = ("3rd_view_camera",
                         np.array([0.00, -0.16, 0.36, 0.8992917, -0.09263245, 0.35892478,
                                   0.23209205], np.float32),
                         128, 128, 0.85, "base_link")
