"""CartPole robot (dm_control cart-pole).

Port of ``CartPoleRobot`` of ``maniskill_tpu/agents/robots/cartpole.py``
(``:62-90``; the spec of ``_cartpole_spec``, ``:26-59``): a 2-dof
articulation built in code, with no collision geoms (contact is disabled
in the MJCF), under gravity (``balance_passive_force = False``), and one
control mode, ``pd_joint_delta_pos``: a PD slider and a passive hinge.
  cart: slide joint along x at height 1 m, box (0.2, 0.15, 0.1), mass 1
  pole: hinge about y, capsule r=0.045 l=1 upward, mass 0.1
"""
from __future__ import annotations

import numpy as np

from ...kinematics.urdf import JOINT_PRISMATIC, JOINT_REVOLUTE, RobotSpec
from ..base_agent import BaseAgent, Keyframe, register_agent
from ..controllers.base import PassiveControllerConfig, PDJointPosControllerConfig


def _cartpole_spec() -> RobotSpec:
    # cart box inertia (half extents 0.2, 0.15, 0.1, mass 1)
    hx, hy, hz = 0.2, 0.15, 0.1
    m_cart = 1.0
    I_cart = m_cart / 3.0 * np.diag([hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy])
    # pole: capsule r=0.045 from z=0 to z=1, mass .1; about its lower end:
    # slender rod about its end plus a radial term
    m_pole = 0.1
    L, r = 1.0, 0.045
    Ixx = m_pole * (L * L / 3.0 + r * r / 4.0)
    I_pole = np.diag([Ixx, Ixx, m_pole * r * r / 2.0])
    return RobotSpec(
        name="cart_pole",
        nb=2,
        parent=np.array([-1, 0], dtype=np.int32),
        joint_type=np.array([JOINT_PRISMATIC, JOINT_REVOLUTE], dtype=np.int32),
        joint_pos=np.array([[0, 0, 1.0], [0, 0, 0]], dtype=np.float64),
        joint_quat=np.array([[1, 0, 0, 0], [1, 0, 0, 0]], dtype=np.float64),
        axis=np.array([[1, 0, 0], [0, 1, 0]], dtype=np.float64),
        mass=np.array([m_cart, m_pole]),
        com=np.array([[0, 0, 0], [0, 0, 0.5]]),
        inertia=np.stack([I_cart, I_pole]),
        qlim=np.array([[-1.8, 1.8], [-300.0, 300.0]]),
        effort=np.array([100.0, 100.0]),
        vel_limit=np.array([np.inf, np.inf]),
        joint_damping=np.array([5e-4, 2e-6]),  # cartpole.xml
        joint_friction=np.zeros(2),
        frames={},
        link_index={"cart": 0, "pole_1": 1},
        joint_names=["slider", "hinge_1"],
        link_names=["cart", "pole_1"],
        base_link="world",
    )


@register_agent
class CartPoleRobot(BaseAgent):
    uid = "cart_pole"
    balance_passive_force = False  # gravity acts on the pole
    keyframes = dict(rest=Keyframe(qpos=np.zeros(2)))

    def _make_robot_spec(self):
        return _cartpole_spec()

    def collision_geoms(self):
        return []  # contact is disabled in the MJCF (flag contact="disable")

    def _controller_configs(self):
        slider = PDJointPosControllerConfig(
            joint_names=["slider"], lower=-1.0, upper=1.0,
            stiffness=2000.0, damping=200.0, use_delta=True)
        rest = PassiveControllerConfig(joint_names=["hinge_1"], damping=0.0, friction=0.0)
        return dict(pd_joint_delta_pos=dict(slider=slider, rest=rest))
