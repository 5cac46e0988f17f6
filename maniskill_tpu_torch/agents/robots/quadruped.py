"""Legged robots from primitive MJCFs: ANYmal C, Unitree Go2 and Unitree H1.

Port of ``maniskill_tpu/agents/robots/quadruped.py`` (``:21-144``). Each robot
is read from its capsule MJCF (``assets/control/anymal_c.xml``, ``go2.xml``,
``h1.xml``) by ``kinematics/mjcf.py``: the ``<freejoint>`` root becomes a
chain of slides x, y, z and hinges z, y, x, then the leg (or body) joints.
The robot's links fall under gravity (``balance_passive_force = False``).
Keyframes ``standing`` and ``rest`` (the same pose: the legs' standing
angles, the root's z slide at ``standing_root_z``); the
``pd_joint_delta_pos`` (+-``delta_action`` rad) and ``pd_joint_pos``
control modes over the leg joints, the root's six dofs undriven.

- ``AnymalC`` (18 dofs): kp 80, kd 2, force limit 100, delta 0.225.
- ``UnitreeGo2`` (18 dofs): kp 60, kd 3, force limit 45, delta 0.25; the
  root 2 cm lower than the MJCF's (0.29 m standing).
- ``UnitreeH1`` (25 dofs: 19 body joints): kp 200, kd 8, force limit 200,
  delta 0.2.

``base_link`` and ``shank_links`` name the links whose floor contacts
the quadruped tasks read (a fall, an undesired shank contact). The XMLs
are read as data files from the JAX package's asset tree.
"""
from __future__ import annotations

import numpy as np

from ...kinematics.mjcf import load_mjcf
from ...utils.building import ASSET_DIR
from ..base_agent import BaseAgent, Keyframe, register_agent
from ..controllers.base import PDJointPosControllerConfig


class _QuadrupedAgent(BaseAgent):
    mjcf_path: str = ""
    balance_passive_force = False  # gravity acts on the whole robot
    ee_link_name = None
    leg_joint_names: list = []
    standing_qpos: dict = {}
    standing_root_z: float = 0.0  # the root's z slide at the keyframe
    stiffness = 80.0
    damping = 2.0
    force_limit = 100.0
    delta_action = 0.225
    base_link = "base"
    shank_links: list = []

    def _make_robot_spec(self):
        self._mjcf = load_mjcf(str(self.mjcf_path))
        spec = self._mjcf.spec
        names = list(spec.joint_names)
        q = np.zeros(spec.nb, np.float32)
        q[names.index("root_slide_2")] = self.standing_root_z
        for name, v in self.standing_qpos.items():
            q[names.index(name)] = v
        self.keyframes = dict(standing=Keyframe(qpos=q), rest=Keyframe(qpos=q))
        return spec

    def collision_geoms(self):
        return [dict(g) for g in self._mjcf.collision_geoms]

    def _controller_configs(self):
        common = dict(joint_names=self.leg_joint_names, stiffness=self.stiffness,
                      damping=self.damping, force_limit=self.force_limit)
        return dict(
            pd_joint_delta_pos=dict(body=PDJointPosControllerConfig(
                lower=-self.delta_action, upper=self.delta_action, use_delta=True, **common)),
            pd_joint_pos=dict(body=PDJointPosControllerConfig(
                lower=None, upper=None, normalize_action=False, **common)),
        )


@register_agent
class AnymalC(_QuadrupedAgent):
    uid = "anymal_c"
    mjcf_path = ASSET_DIR / "control" / "anymal_c.xml"
    leg_joint_names = [f"{leg}_{j}" for leg in ("LF", "RF", "LH", "RH")
                       for j in ("HAA", "HFE", "KFE")]
    standing_qpos = {
        "LF_HAA": 0.03, "RF_HAA": -0.03, "LH_HAA": 0.03, "RH_HAA": -0.03,
        "LF_HFE": 0.4, "RF_HFE": 0.4, "LH_HFE": -0.4, "RH_HFE": -0.4,
        "LF_KFE": -0.8, "RF_KFE": -0.8, "LH_KFE": 0.8, "RH_KFE": 0.8,
    }
    standing_root_z = 0.0  # the base stands at the MJCF's 0.60 m
    shank_links = ["LF_SHANK", "RF_SHANK", "LH_SHANK", "RH_SHANK"]


@register_agent
class UnitreeGo2(_QuadrupedAgent):
    uid = "unitree_go2"
    mjcf_path = ASSET_DIR / "control" / "go2.xml"
    leg_joint_names = [f"{leg}_{j}" for leg in ("FL", "FR", "RL", "RR")
                       for j in ("hip", "thigh", "calf")]
    standing_qpos = {f"{leg}_{j}": v for leg in ("FL", "FR", "RL", "RR")
                     for j, v in (("hip", 0.0), ("thigh", 0.9), ("calf", -1.8))}
    standing_root_z = -0.02  # 0.31 m in the MJCF, 0.29 m standing
    stiffness = 60.0
    damping = 3.0
    force_limit = 45.0
    delta_action = 0.25
    shank_links = ["FL_thigh_b", "FR_thigh_b", "RL_thigh_b", "RR_thigh_b"]


@register_agent
class UnitreeH1(_QuadrupedAgent):
    uid = "unitree_h1"
    mjcf_path = ASSET_DIR / "control" / "h1.xml"
    leg_joint_names = [
        "left_hip_yaw_joint", "right_hip_yaw_joint", "torso_joint",
        "left_hip_roll_joint", "right_hip_roll_joint",
        "left_shoulder_pitch_joint", "right_shoulder_pitch_joint",
        "left_hip_pitch_joint", "right_hip_pitch_joint",
        "left_shoulder_roll_joint", "right_shoulder_roll_joint",
        "left_knee_joint", "right_knee_joint",
        "left_shoulder_yaw_joint", "right_shoulder_yaw_joint",
        "left_ankle_joint", "right_ankle_joint",
        "left_elbow_joint", "right_elbow_joint",
    ]
    standing_qpos = {
        "left_hip_pitch_joint": -0.4, "right_hip_pitch_joint": -0.4,
        "left_knee_joint": 0.8, "right_knee_joint": 0.8,
        "left_ankle_joint": -0.4, "right_ankle_joint": -0.4,
    }
    standing_root_z = 0.0  # the pelvis stands at the MJCF's 0.975 m
    stiffness = 200.0
    damping = 8.0
    force_limit = 200.0
    delta_action = 0.2
    base_link = "pelvis"
    shank_links = ["left_knee_link", "right_knee_link"]
