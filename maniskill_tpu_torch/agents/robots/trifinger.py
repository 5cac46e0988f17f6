"""TriFingerPro: the 9-dof three-finger manipulation platform.

Port of ``maniskill_tpu/agents/robots/trifinger.py``: three fingers of
three joints each (0, 120 and 240 degrees round the platform), a sphere of
radius 0.0155 (friction 1.0) on each fused fingertip link, the ``rest``
keyframe (0, 0.9, -1.7 a finger) and the ``pd_joint_delta_pos`` and
``pd_joint_pos`` control modes (kp 1e2, kd 1e1, force limit 20). The URDF
is read as a data file from the JAX package's asset tree. Used by
RotateCube-v1 and TriFingerRotateCubeLevel0-4-v1.
"""
from __future__ import annotations

import numpy as np

from ...physics.shapes import GeomType
from ...utils.building import ASSET_DIR
from ..base_agent import BaseAgent, Keyframe, register_agent
from ..controllers.base import PDJointPosControllerConfig

TRIFINGER_URDF = str(ASSET_DIR / "robots" / "trifinger" / "trifingerpro.urdf")

JOINTS = [f"finger_{part}_joint_{ang}" for ang in (0, 120, 240)
          for part in ("base_to_upper", "upper_to_middle", "middle_to_lower")]
TIPS = [f"finger_tip_link_{ang}" for ang in (0, 120, 240)]


@register_agent
class TriFingerPro(BaseAgent):
    uid = "trifingerpro"
    urdf_path = TRIFINGER_URDF
    ee_link_name = "finger_tip_link_0"

    link_friction = {name: 1.0 for name in TIPS}
    extra_collisions = [dict(link=name, type=GeomType.SPHERE,
                             size=np.array([0.0155, 0, 0], np.float32), friction=1.0)
                        for name in TIPS]
    keyframes = dict(rest=Keyframe(qpos=np.tile(np.array([0.0, 0.9, -1.7], np.float32), 3)))
    tip_link_names = TIPS

    def _controller_configs(self):
        common = dict(joint_names=JOINTS, stiffness=1e2, damping=1e1, force_limit=2e1)
        return dict(
            pd_joint_delta_pos=dict(joints=PDJointPosControllerConfig(
                lower=-0.1, upper=0.1, use_delta=True, **common)),
            pd_joint_pos=dict(joints=PDJointPosControllerConfig(
                lower=None, upper=None, normalize_action=False, **common)),
        )
