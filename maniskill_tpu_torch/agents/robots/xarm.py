"""The Allegro right hand and the ROBEL D'Claw.

Port of ``AllegroHandRight`` and ``DClaw`` in
``maniskill_tpu/agents/robots/xarm.py`` (``:86-165``), both with a fixed
base, auto-generated capsule collisions and the ``pd_joint_delta_pos`` and
``pd_joint_pos`` control modes; neither has a mimic gripper: every joint
takes its own action.

- ``AllegroHandRight``: 16 dofs, four fingers, its cradle rest keyframe
  (fingers slightly curled, so an upturned palm holds an object), capsules
  of radius 0.014 (leaf tips 0.035, friction 1.0); kp 4e2, kd 10, force
  limit 10.
- ``DClaw``: 9 dofs, three fingers, the zero rest keyframe, capsules of
  radius 0.018 (leaf tips 0.04, friction 1.0); kp 1e2, kd 5, force limit
  20. Used by RotateValveDClaw-v1 and RotateValveLevel0-4-v1.

XArm7 and XArm7Ability, which share the JAX module, are not ported yet.
The URDFs are read as data files from the JAX package's asset tree.
"""
from __future__ import annotations

import numpy as np

from ...utils.building import ASSET_DIR
from ..base_agent import BaseAgent, Keyframe, auto_capsule_collisions, register_agent
from ..controllers.base import PDJointPosControllerConfig

ALLEGRO_URDF = str(ASSET_DIR / "robots" / "allegro" / "allegro_hand_right.urdf")
DCLAW_URDF = str(ASSET_DIR / "robots" / "dclaw" / "dclaw_gripper_glb.urdf")


def _joint_modes(agent, group):
    """The two joint control modes over every joint of ``agent``."""
    common = dict(joint_names=list(agent.robot_spec.joint_names), stiffness=agent.stiffness,
                  damping=agent.damping, force_limit=agent.force_limit)
    return dict(
        pd_joint_delta_pos={group: PDJointPosControllerConfig(
            lower=-0.1, upper=0.1, use_delta=True, **common)},
        pd_joint_pos={group: PDJointPosControllerConfig(
            lower=None, upper=None, normalize_action=False, **common)},
    )


@register_agent
class AllegroHandRight(BaseAgent):
    uid = "allegro_hand_right"
    urdf_path = ALLEGRO_URDF
    ee_link_name = None

    stiffness = 4e2
    damping = 10.0
    force_limit = 10.0

    def _make_robot_spec(self):
        spec = super()._make_robot_spec()
        # cradle rest pose: fingers slightly curled so a palm-facing-up hand
        # forms a lip that keeps a resting object from rolling off
        q = np.zeros(spec.nb, np.float32)
        for f in range(3):
            q[4 * f + 1:4 * f + 4] = [0.45, 0.45, 0.3]
        q[12:16] = [1.1, 0.35, 0.35, 0.3]
        self.keyframes = dict(rest=Keyframe(qpos=q))
        return spec

    def collision_geoms(self):
        return auto_capsule_collisions(self.robot_spec, default_radius=0.014,
                                       tip_length=0.035, friction=1.0)

    def _controller_configs(self):
        return _joint_modes(self, "hand")


@register_agent
class DClaw(BaseAgent):
    uid = "dclaw"
    urdf_path = DCLAW_URDF
    ee_link_name = None

    stiffness = 1e2
    damping = 5.0
    force_limit = 20.0

    def _make_robot_spec(self):
        spec = super()._make_robot_spec()
        self.keyframes = dict(rest=Keyframe(qpos=np.zeros(spec.nb, np.float32)))
        return spec

    def collision_geoms(self):
        return auto_capsule_collisions(self.robot_spec, default_radius=0.018,
                                       tip_length=0.04, friction=1.0)

    def _controller_configs(self):
        return _joint_modes(self, "claw")
