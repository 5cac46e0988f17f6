"""Panda (Franka Emika) agent.

Port of ``maniskill_tpu/agents/robots/panda.py``: the URDF, gains, rest
keyframe, collision pruning, the eight control modes in the JAX package's
order (``:78-140``; the first, ``pd_joint_delta_pos``, is the default):
``pd_joint_delta_pos``, ``pd_joint_pos``, ``pd_ee_delta_pos``,
``pd_ee_delta_pose``, ``pd_joint_target_delta_pos``, ``pd_joint_vel``,
``pd_joint_pos_vel`` and ``pd_joint_delta_pos_vel``, the gripper on the
mimic ``pd_joint_pos`` in each; ``build_grasp_checker`` (``:147``) and
``is_static`` (``:187``). ``PandaWristCam`` (``panda_wristcam``, ``:193``)
is the same body and controllers; its hand camera waits for the sensors.
The URDF is read as a data file from the JAX package's asset tree.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ...math.rotations import angle_between, quat_to_matrix
from ...physics.shapes import GeomType
from ..base_agent import BaseAgent, Keyframe, register_agent
from ..controllers.base import (PDEEPosControllerConfig, PDEEPoseControllerConfig,
                                PDJointPosControllerConfig, PDJointPosVelControllerConfig,
                                PDJointVelControllerConfig)

PANDA_URDF = str(Path(__file__).resolve().parents[3]
                 / "maniskill_tpu" / "assets" / "robots" / "panda" / "panda_v2.urdf")

ARM_JOINTS = [f"panda_joint{i}" for i in range(1, 8)]
GRIPPER_JOINTS = ["panda_finger_joint1", "panda_finger_joint2"]


@register_agent
class Panda(BaseAgent):
    uid = "panda"
    urdf_path = PANDA_URDF
    ee_link_name = "panda_hand_tcp"

    arm_stiffness = 1e3
    arm_damping = 1e2
    arm_force_limit = 100
    gripper_stiffness = 1e3
    gripper_damping = 1e2
    gripper_force_limit = 100

    link_friction = {"panda_leftfinger": 2.0, "panda_rightfinger": 2.0}

    keyframes = dict(rest=Keyframe(qpos=np.array(
        [0.0, np.pi / 8, 0, -np.pi * 5 / 8, 0, np.pi * 3 / 4, -np.pi / 4,
         0.04, 0.04])))

    # keep only the "diagonal finger" + "rubber tip" boxes per finger
    urdf_collision_filter = {"panda_leftfinger": (2, 3),
                             "panda_rightfinger": (2, 3)}

    # hand palm (the URDF uses a mesh): primitive approximation
    extra_collisions = [dict(
        link="panda_hand", type=GeomType.BOX,
        size=np.array([0.031, 0.1, 0.05], np.float32),
        offset_p=np.array([0, 0, 0.033], np.float32),
    )]

    def _controller_configs(self):
        arm = dict(joint_names=ARM_JOINTS, stiffness=self.arm_stiffness,
                   damping=self.arm_damping, force_limit=self.arm_force_limit)
        ee = dict(pos_lower=-0.1, pos_upper=0.1, ee_link=self.ee_link_name, **arm)
        gripper = PDJointPosControllerConfig(
            joint_names=GRIPPER_JOINTS,
            lower=-0.01,  # closing force on thin objects
            upper=0.04,
            stiffness=self.gripper_stiffness, damping=self.gripper_damping,
            force_limit=self.gripper_force_limit, mimic=True)
        arms = dict(
            pd_joint_delta_pos=PDJointPosControllerConfig(
                lower=-0.1, upper=0.1, use_delta=True, **arm),
            pd_joint_pos=PDJointPosControllerConfig(
                lower=None, upper=None, normalize_action=False, **arm),
            pd_ee_delta_pos=PDEEPosControllerConfig(**ee),
            pd_ee_delta_pose=PDEEPoseControllerConfig(rot_lower=-0.1, rot_upper=0.1, **ee),
            pd_joint_target_delta_pos=PDJointPosControllerConfig(
                lower=-0.1, upper=0.1, use_delta=True, use_target=True, **arm),
            pd_joint_vel=PDJointVelControllerConfig(
                joint_names=ARM_JOINTS, lower=-1.0, upper=1.0, damping=self.arm_damping,
                force_limit=self.arm_force_limit),
            pd_joint_pos_vel=PDJointPosVelControllerConfig(
                lower=None, upper=None, normalize_action=False, **arm),
            pd_joint_delta_pos_vel=PDJointPosVelControllerConfig(
                lower=-0.1, upper=0.1, use_delta=True, **arm),
        )
        return {mode: dict(arm=cfg, gripper=gripper) for mode, cfg in arms.items()}

    def build_grasp_checker(self, model, obj_name: str, device,
                            min_force: float = 0.5, max_angle: float = 85.0):
        """``is_grasping(body_quat (K,nb,4), f_pt (K,P,3)) -> (K,) bool``:
        both fingers feel at least ``min_force`` from the object, within
        ``max_angle`` of each finger's opening direction."""
        from ...physics.engine import pair_force_signs
        from ...physics.model import BodyKind

        obj_idx = model.free_index[obj_name]
        lf = self.robot_spec.link_index["panda_leftfinger"]
        rf = self.robot_spec.link_index["panda_rightfinger"]
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
            ldir = quat_to_matrix(body_quat[:, lf])[..., :, 1]  # local +y
            rdir = -quat_to_matrix(body_quat[:, rf])[..., :, 1]
            lflag = (lforce >= min_force) & (angle_between(ldir, lforce_vec) <= max_rad)
            rflag = (rforce >= min_force) & (angle_between(rdir, rforce_vec) <= max_rad)
            return lflag & rflag

        return is_grasping

    def is_static(self, qvel: torch.Tensor, threshold: float = 0.2):
        """Arm joints only (grippers excluded)."""
        return torch.amax(torch.abs(qvel[..., :7]), dim=-1) <= threshold


@register_agent
class PandaWristCam(Panda):
    """``panda_wristcam`` (JAX ``agents/robots/panda.py:193-215``): the
    Panda's body, collisions and controllers. The JAX agent adds a depth
    camera on the ``panda_hand`` frame; the port's sensors are not written
    yet (ROADMAP Queue A item 8), so this agent has none."""

    uid = "panda_wristcam"
