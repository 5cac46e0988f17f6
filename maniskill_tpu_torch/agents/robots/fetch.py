"""Fetch mobile manipulator.

Port of ``maniskill_tpu/agents/robots/fetch.py``: the 15-dof URDF with its
explicit planar root joints (x and y prismatic, yaw revolute), a 7-dof arm,
head pan and tilt, torso lift and a two-finger gripper; primitive collision
boxes for the base, the torso and the fingers (the URDF's collisions are
meshes), gripper friction 2.0, the rest keyframe (remapped by joint name)
and the control modes ``pd_joint_delta_pos`` (13 actions: arm 7, gripper 1,
body 3, base 2) and ``pd_joint_pos``. The URDF is read as a data file from
the JAX package's asset tree.
"""
from __future__ import annotations

import numpy as np
import torch

from ...physics.shapes import GeomType
from ...utils.building import ASSET_DIR
from ..base_agent import BaseAgent, Keyframe, register_agent
from ..controllers.base import PDBaseForwardVelControllerConfig, PDJointPosControllerConfig

FETCH_URDF = str(ASSET_DIR / "robots" / "fetch" / "fetch.urdf")

ARM_JOINTS = ["shoulder_pan_joint", "shoulder_lift_joint", "upperarm_roll_joint",
              "elbow_flex_joint", "forearm_roll_joint", "wrist_flex_joint", "wrist_roll_joint"]
BODY_JOINTS = ["head_pan_joint", "head_tilt_joint", "torso_lift_joint"]
BASE_JOINTS = ["root_x_axis_joint", "root_y_axis_joint", "root_z_rotation_joint"]
GRIPPER_JOINTS = ["l_gripper_finger_joint", "r_gripper_finger_joint"]


@register_agent
class Fetch(BaseAgent):
    uid = "fetch"
    urdf_path = FETCH_URDF
    ee_link_name = "gripper_link"

    link_friction = {"l_gripper_finger_link": 2.0, "r_gripper_finger_link": 2.0}

    extra_collisions = [
        dict(link="base_link", type=GeomType.BOX, size=np.array([0.28, 0.28, 0.18], np.float32),
             offset_p=np.array([0, 0, 0.18], np.float32)),
        dict(link="torso_lift_link", type=GeomType.BOX,
             size=np.array([0.12, 0.18, 0.30], np.float32),
             offset_p=np.array([-0.08, 0, 0.25], np.float32)),
        dict(link="l_gripper_finger_link", type=GeomType.BOX,
             size=np.array([0.018, 0.007, 0.014], np.float32),
             offset_p=np.array([0, -0.009, 0], np.float32)),
        dict(link="r_gripper_finger_link", type=GeomType.BOX,
             size=np.array([0.018, 0.007, 0.014], np.float32),
             offset_p=np.array([0, 0.009, 0], np.float32)),
    ]

    REST_QPOS_BY_NAME = {
        "root_x_axis_joint": 0.0, "root_y_axis_joint": 0.0, "root_z_rotation_joint": 0.0,
        "torso_lift_joint": 0.386, "head_pan_joint": 0.0, "head_tilt_joint": -0.370,
        "shoulder_pan_joint": 0.562, "shoulder_lift_joint": -1.032,
        "upperarm_roll_joint": 0.695, "elbow_flex_joint": 0.955, "forearm_roll_joint": -0.1,
        "wrist_flex_joint": 2.077, "wrist_roll_joint": 0.0,
        "l_gripper_finger_joint": 0.015, "r_gripper_finger_joint": 0.015,
    }

    def __init__(self, device="cpu", control_mode=None):
        super().__init__(device=device, control_mode=control_mode)
        qpos = np.array([self.REST_QPOS_BY_NAME[n] for n in self.robot_spec.joint_names],
                        np.float32)
        self.keyframes = dict(rest=Keyframe(qpos=qpos))

    def _controller_configs(self):
        arm = dict(joint_names=ARM_JOINTS, stiffness=1e3, damping=1e2, force_limit=100)
        body = PDJointPosControllerConfig(
            joint_names=BODY_JOINTS, lower=-0.1, upper=0.1, use_delta=True, stiffness=1e3,
            damping=1e2, force_limit=100)
        base = PDBaseForwardVelControllerConfig(
            joint_names=BASE_JOINTS, lower=-0.5, upper=0.5, damping=1e3, force_limit=500)
        gripper = PDJointPosControllerConfig(
            joint_names=GRIPPER_JOINTS, lower=0.0, upper=0.05, stiffness=1e3, damping=1e2,
            force_limit=100, mimic=True)
        return dict(
            pd_joint_delta_pos=dict(
                arm=PDJointPosControllerConfig(lower=-0.1, upper=0.1, use_delta=True, **arm),
                gripper=gripper, body=body, base=base),
            pd_joint_pos=dict(
                arm=PDJointPosControllerConfig(lower=None, upper=None, normalize_action=False,
                                               **arm),
                gripper=gripper, body=body, base=base),
        )

    def is_static(self, qvel: torch.Tensor, threshold: float = 0.2):
        """Arm joints only."""
        idx = [self.robot_spec.joint_names.index(n) for n in ARM_JOINTS]
        return torch.amax(torch.abs(qvel[..., idx]), dim=-1) <= threshold
