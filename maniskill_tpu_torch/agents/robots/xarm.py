"""Allegro right hand.

Port of ``AllegroHandRight`` in ``maniskill_tpu/agents/robots/xarm.py``
(``:86-128``): the 16-dof, four-finger hand with a fixed base, its cradle
rest keyframe (fingers slightly curled, so an upturned palm holds an
object), auto-generated capsule collisions (radius 0.014, leaf tips 0.035,
friction 1.0) and the ``pd_joint_delta_pos`` and ``pd_joint_pos`` control
modes. It has no mimic gripper: every joint takes its own action. XArm7
and DClaw, which share the JAX module, are not ported yet. The URDF is
read as a data file from the JAX package's asset tree.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..base_agent import BaseAgent, Keyframe, auto_capsule_collisions, register_agent
from ..controllers.base import PDJointPosControllerConfig

ALLEGRO_URDF = str(Path(__file__).resolve().parents[3] / "maniskill_tpu" / "assets"
                   / "robots" / "allegro" / "allegro_hand_right.urdf")


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
        common = dict(joint_names=list(self.robot_spec.joint_names),
                      stiffness=self.stiffness, damping=self.damping,
                      force_limit=self.force_limit)
        return dict(
            pd_joint_delta_pos=dict(hand=PDJointPosControllerConfig(
                lower=-0.1, upper=0.1, use_delta=True, **common)),
            pd_joint_pos=dict(hand=PDJointPosControllerConfig(
                lower=None, upper=None, normalize_action=False, **common)),
        )
