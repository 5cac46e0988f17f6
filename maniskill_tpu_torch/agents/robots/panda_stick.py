"""PandaStick: the Panda arm with a stick in place of the gripper.

Port of ``maniskill_tpu/agents/robots/panda_stick.py``: 7 dofs, the arm's
gains, the ``rest`` keyframe and four control modes (``pd_joint_delta_pos``,
the default, ``pd_joint_pos``, ``pd_ee_delta_pos``, ``pd_ee_delta_pose``:
no gripper, so 7, 7, 3 and 6 actions). The URDF's stick cylinder
(``panda_stick.urdf:226``, r = 0.008) is read as a capsule of that radius
(``kinematics/urdf.py``). The URDF is read as a data file from the JAX
package's asset tree. Used by PushT-v1 and the drawing tasks.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..base_agent import BaseAgent, Keyframe, register_agent
from ..controllers.base import (PDEEPosControllerConfig, PDEEPoseControllerConfig,
                                PDJointPosControllerConfig)
from .panda import ARM_JOINTS

PANDA_STICK_URDF = str(Path(__file__).resolve().parents[3]
                       / "maniskill_tpu" / "assets" / "robots" / "panda" / "panda_stick.urdf")


@register_agent
class PandaStick(BaseAgent):
    uid = "panda_stick"
    urdf_path = PANDA_STICK_URDF
    ee_link_name = "panda_hand_tcp"

    keyframes = dict(rest=Keyframe(qpos=np.array(
        [0.0, np.pi / 8, 0, -np.pi * 5 / 8, 0, np.pi * 3 / 4, -np.pi / 4], np.float32)))

    def _controller_configs(self):
        arm = dict(joint_names=ARM_JOINTS, stiffness=1e3, damping=1e2, force_limit=100)
        ee = dict(pos_lower=-0.1, pos_upper=0.1, ee_link=self.ee_link_name, **arm)
        arms = dict(
            pd_joint_delta_pos=PDJointPosControllerConfig(
                lower=-0.1, upper=0.1, use_delta=True, **arm),
            pd_joint_pos=PDJointPosControllerConfig(
                lower=None, upper=None, normalize_action=False, **arm),
            pd_ee_delta_pos=PDEEPosControllerConfig(**ee),
            pd_ee_delta_pose=PDEEPoseControllerConfig(rot_lower=-0.1, rot_upper=0.1, **ee),
        )
        return {mode: dict(arm=cfg) for mode, cfg in arms.items()}
