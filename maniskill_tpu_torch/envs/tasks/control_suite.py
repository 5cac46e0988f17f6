"""Control-suite locomotion tasks: MS-HopperStand/Hop-v1, MS-AntWalk/Run-v1
and MS-HumanoidStand/Walk/Run-v1.

Port of ``maniskill_tpu/envs/tasks/control_suite.py``: dm_control reward
structures over MJCF robots loaded by ``kinematics/mjcf.py`` (the hopper's
planar root is a slide-slide-hinge chain straight from the XML; the ant's
and the humanoid's ``<freejoint>`` expand to a 6-dof chain of 3 slides
and 3 hinges). Torque actuation through ``TorqueController`` (the MJCF
``<motor>`` gears); the robot's links fall under gravity
(``balance_passive_force = False``); the floor is the MJCF world's plane;
the whole robot's COM velocity comes from every body's ``J q̇``
(``engine.body_velocities``, the JAX ``_link_velocities``).
Each control step is 4 sim steps of 2 substeps (100 Hz sim, 25 Hz
control, h = 5 ms).

The XMLs are read as data files from the JAX package's asset tree.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..._consts import const
from ...agents.base_agent import BaseAgent, Keyframe, register_agent
from ...agents.controllers.base import TorqueControllerConfig
from ...kinematics.mjcf import load_mjcf
from ...math.rotations import _cross, quat_apply
from ...kinematics.urdf import JOINT_PRISMATIC, JOINT_REVOLUTE
from ...physics.engine import body_velocities, compute_contacts, make_step_fn, robot_fk
from ...physics.model import SceneSpecBuilder, SimParams, plane_geom
from ...utils.building import ASSET_DIR
from .. import rewards
from ..base_env import BaseEnv, EnvState
from ..registration import register_env

_STAND_HEIGHT_HOPPER = 0.6
_HOP_SPEED = 2.0
_STAND_HEIGHT_ANT = 0.35
_WALK_SPEED = 0.5
_RUN_SPEED = 4.0
_STAND_HEIGHT_HUM = 1.4
_WALK_SPEED_HUM = 1.0
_RUN_SPEED_HUM = 10.0


class _MJCFAgent(BaseAgent):
    mjcf_path: str = ""
    balance_passive_force = False  # locomotion: gravity acts on the robot

    def _make_robot_spec(self):
        self._mjcf = load_mjcf(str(self.mjcf_path))
        return self._mjcf.spec

    def collision_geoms(self):
        return [dict(g) for g in self._mjcf.collision_geoms]

    def _controller_configs(self):
        acts = self._mjcf.actuators
        return {"torque": {"body": TorqueControllerConfig(
            joint_names=[a["joint"] for a in acts],
            gear=np.array([a["gear"] for a in acts], np.float32),
            ctrlrange=acts[0]["ctrlrange"])}}


@register_agent
class HopperRobot(_MJCFAgent):
    uid = "hopper"
    mjcf_path = ASSET_DIR / "control" / "hopper.xml"
    keyframes = {"rest": Keyframe(qpos=np.zeros(7, np.float32))}


@register_agent
class AntRobot(_MJCFAgent):
    uid = "ant"
    mjcf_path = ASSET_DIR / "control" / "ant.xml"
    keyframes = {"rest": Keyframe(qpos=np.zeros(14, np.float32))}


@register_agent
class HumanoidRobot(_MJCFAgent):
    uid = "humanoid"
    mjcf_path = ASSET_DIR / "robots" / "humanoid" / "humanoid.xml"
    keyframes = {"rest": Keyframe(qpos=np.zeros(27, np.float32))}


class FloorRobotEnv(BaseEnv):
    """A robot on a floor plane, its root a chain of slides x, y, z and
    hinges z, y, x (the MJCF ``<freejoint>`` expansion): random commands
    and states on the floor for checks of the physics step (the control
    suite here; the legged robots of ``quadruped.py`` and
    ``humanoid_stand.py``)."""

    # the pair functions whose points carry force in ``contact_state``'s
    # standing envs and upside-down envs: the humanoid's capsule feet and
    # sphere head
    FLOOR_CONTACT = ("plane_capsule", "plane_sphere")

    def random_command(self, state: EnvState, gen: torch.Generator,
                       sigma: float = 0.6) -> EnvState:
        """``state`` with the command of a random action: normal(0,
        ``sigma``) clipped to [-1, 1] (0.6: MPPI's draw at the bench
        sigma)."""
        a = torch.randn((state.sim.qpos.shape[0], self.action_dim), generator=gen,
                        device=self.device)
        cmd = self.agent.controller.set_action(state.cmd, state.sim.qpos,
                                               torch.clamp(sigma * a, -1.0, 1.0))
        return state.replace(cmd=cmd)

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved onto the floor: the robot as posed (even envs),
        turned about its root's last hinge (the humanoid's and the ant's x
        hinge; a quarter turn of their middle, y hinge would align the
        chain's outer two, where the mass matrix is singular) a quarter
        where the env index is 1 modulo 4 (lying on its side) or a half
        where it is 3 (upside down: the humanoid on its head), lowered along the root's z slide until its
        lowest collision point is 0-1 mm inside the floor, with random
        joint velocities (0.1); one control step of the plain physics step
        under the command that holds the pose (zero torque, or PD targets
        at the posed joints) then loads the warm-start impulses, and the
        command holds a small random action (``random_command`` at sigma
        0.1: the bench sigma's 0.6 throws most robots off the floor within
        a step).
        Points on the floor carry force, with friction, from such states
        (the humanoid: its feet's capsules standing, its limbs' capsules on
        its side, its head's sphere upside down), so checks of the physics
        step start from them."""
        dev = self.device
        spec = self.model.robot
        K = state.sim.qpos.shape[0]
        z_dof = next(i for i in range(spec.nb) if spec.joint_type[i] == JOINT_PRISMATIC
                     and spec.axis[i][2] == 1.0)
        roll = max(i for i, n in enumerate(spec.joint_names)
                   if n.startswith("root") and spec.joint_type[i] == JOINT_REVOLUTE)
        qpos = state.sim.qpos.clone()
        qpos[1::4, roll] -= math.pi / 2
        qpos[3::4, roll] += math.pi
        sim = state.sim.replace(qpos=qpos)
        depth = compute_contacts(self.model, sim, *robot_fk(self.model, qpos)[:2])[2]
        qpos[:, z_dof] += depth.max(1).values - 1e-3 * torch.rand(K, generator=gen, device=dev)
        qvel = 0.1 * torch.randn(qpos.shape, generator=gen, device=dev)
        cmd = self.agent.controller.reset(qpos)
        sim = make_step_fn(self.model)(sim.replace(qpos=qpos, qvel=qvel), cmd,
                                       self.sim_steps_per_control)
        return self.random_command(state.replace(sim=sim, cmd=cmd), gen, sigma=0.1)


class _ControlEnv(FloorRobotEnv):
    """Shared locomotion scaffolding: the floor from the MJCF world, the
    whole robot's COM velocity, link heights."""

    CONTROL_FREQ = 25

    def __init__(self, control_mode=None, **kwargs):
        super().__init__(control_mode=control_mode or "torque", **kwargs)

    def _sim_params(self) -> SimParams:
        # stiff gym-style gears (ant: 150) on light links need h = 5 ms
        return SimParams(dt=1.0 / self.SIM_FREQ, substeps=2)

    def _load_scene(self, builder: SceneSpecBuilder):
        floor_fric = 1.0
        for g in self.agent._mjcf.world_geoms:
            if g["type"] == "plane":
                floor_fric = float(g["friction"])
        builder.add_static_body("floor", np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                                [plane_geom(friction=floor_fric)])

    def _com_vel(self, state, ctx):
        """Mass-weighted COM linear velocity of the whole robot (K, 3)
        (dm_control's ``subtreelinvel``; link-origin velocities stand in for
        per-link COM velocities)."""
        model = self.model
        dev = state.sim.qvel.device
        vb = body_velocities(model, ctx.body_pos, ctx.axis_w, state.sim.qvel)
        ref = const(model, "robot_base_pose", model.robot_base_pose, dev)[:3]
        v_lin = vb[..., 3:] + _cross(vb[..., :3], ctx.body_pos - ref)
        m = const(model, "robot_mass", model.robot.mass, dev)
        return (m[:, None] * v_lin).sum(1) / m.sum()

    @staticmethod
    def _small_control(action):
        return (4 + rewards.tolerance(action, margin=1, value_at_margin=0,
                                      sigmoid="quadratic").mean(-1)) / 5


class _HopperEnv(_ControlEnv):
    DEFAULT_ROBOT = "hopper"

    def _initialize_episode(self, state, gen):
        """dm_control-style: leg joints uniform within their limits, the
        rotation joint in (-pi/6, pi/6), the root slides at 0."""
        K, nq = state.sim.qpos.shape
        qlim = const(self.model, "robot_qlim", self.model.robot_qlim, self.device)
        u = self._uniform(gen, (K, nq), 0.0, 1.0)
        q = qlim[:, 0] + u * (qlim[:, 1] - qlim[:, 0])
        q[:, 0] = 0.0
        q[:, 1] = 0.0
        q[:, 2] = self._uniform(gen, (K,), -math.pi / 6, math.pi / 6)
        return state.replace(sim=state.sim.replace(qpos=q, qvel=torch.zeros_like(q)))

    def _height(self, ctx):
        li = self.model.robot.link_index
        return ctx.body_pos[:, li["torso"], 2] - ctx.body_pos[:, li["foot_heel"], 2]


@register_env("MS-HopperStand-v1", max_episode_steps=600)
class HopperStandEnv(_HopperEnv):
    """Stand upright."""

    def compute_dense_reward(self, state, action, info, ctx):
        return rewards.tolerance(self._height(ctx), lower=_STAND_HEIGHT_HOPPER, upper=2.0)


@register_env("MS-HopperHop-v1", max_episode_steps=600)
class HopperHopEnv(_HopperEnv):
    """Hop in +x."""

    def compute_dense_reward(self, state, action, info, ctx):
        standing = rewards.tolerance(self._height(ctx), lower=_STAND_HEIGHT_HOPPER, upper=2.0)
        hopping = rewards.tolerance(
            self._com_vel(state, ctx)[:, 0], lower=_HOP_SPEED, upper=math.inf,
            margin=_HOP_SPEED / 2, value_at_margin=0.5, sigmoid="linear")
        return standing * hopping


def _near_zero_pose(env, state, gen, inset, root_z):
    """Joints at 0 clipped ``inset`` inside their limits, plus U(-1e-2,
    1e-2) in qpos and qvel, the root's z slide at ``root_z``."""
    K, nq = state.sim.qpos.shape
    dq = env._uniform(gen, (K, nq), -1e-2, 1e-2)
    dv = env._uniform(gen, (K, nq), -1e-2, 1e-2)
    qlim = const(env.model, "robot_qlim", env.model.robot_qlim, env.device)
    q = torch.clamp(torch.zeros(nq, device=env.device), qlim[:, 0] + inset,
                    qlim[:, 1] - inset) + dq
    q[:, 2] = root_z
    return state.replace(sim=state.sim.replace(qpos=q, qvel=dv))


class _AntEnv(_ControlEnv):
    DEFAULT_ROBOT = "ant"
    move_speed = _WALK_SPEED

    def _initialize_episode(self, state, gen):
        # legs inside their limits (ankles ~1 rad into their range, hips 0),
        # root z -0.175 so that the feet touch the floor
        return _near_zero_pose(self, state, gen, 0.3, -0.175)

    def compute_dense_reward(self, state, action, info, ctx):
        height = ctx.body_pos[:, self.model.robot.link_index["torso"], 2]
        standing = rewards.tolerance(height, lower=_STAND_HEIGHT_ANT, upper=math.inf,
                                     margin=_STAND_HEIGHT_ANT / 4)
        move = rewards.tolerance(
            self._com_vel(state, ctx)[:, 0], lower=self.move_speed, upper=math.inf,
            margin=self.move_speed, value_at_margin=0.0, sigmoid="linear")
        return self._small_control(action) * move * standing


@register_env("MS-AntWalk-v1", max_episode_steps=1000)
class AntWalkEnv(_AntEnv):
    """Walk at 0.5 m/s."""

    move_speed = _WALK_SPEED


@register_env("MS-AntRun-v1", max_episode_steps=1000)
class AntRunEnv(_AntEnv):
    """Run at 4 m/s."""

    move_speed = _RUN_SPEED


class _HumanoidEnv(_ControlEnv):
    """dm_control humanoid locomotion."""

    DEFAULT_ROBOT = "humanoid"
    move_speed = 0.0

    def _initialize_episode(self, state, gen):
        # the torso at the XML origin; the feet reach z = -0.98: lift the root
        return _near_zero_pose(self, state, gen, 0.1, 1.23)

    def _head_height(self, ctx):
        b, off, _ = self.model.robot.frame_of("head")
        off = const(self.model, "head_offset", off, ctx.body_pos.device)
        return (ctx.body_pos[:, b] + quat_apply(ctx.body_quat[:, b], off))[:, 2]

    def _torso_upright(self, ctx):
        """World z-component of the torso's z axis (R[2, 2])."""
        q = ctx.body_quat[:, self.model.robot.link_index["torso"]]
        return 1.0 - 2.0 * (q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2])

    def compute_dense_reward(self, state, action, info, ctx):
        standing = rewards.tolerance(self._head_height(ctx), lower=_STAND_HEIGHT_HUM,
                                     upper=math.inf, margin=_STAND_HEIGHT_HUM / 4)
        upright = rewards.tolerance(self._torso_upright(ctx), lower=0.9, upper=math.inf,
                                    sigmoid="linear", margin=1.9, value_at_margin=0)
        stand_reward = standing * upright
        com_xy = self._com_vel(state, ctx)[:, :2]
        if self.move_speed == 0.0:
            dont_move = rewards.tolerance(com_xy, margin=2.0).mean(-1)
            return self._small_control(action) * stand_reward * dont_move
        move = rewards.tolerance(
            torch.linalg.norm(com_xy, dim=-1), lower=self.move_speed, upper=math.inf,
            margin=self.move_speed, value_at_margin=0, sigmoid="linear")
        return self._small_control(action) * stand_reward * move


@register_env("MS-HumanoidStand-v1", max_episode_steps=1000)
class HumanoidStandEnv(_HumanoidEnv):
    """Stand upright without moving."""

    move_speed = 0.0


@register_env("MS-HumanoidWalk-v1", max_episode_steps=1000)
class HumanoidWalkEnv(_HumanoidEnv):
    """Walk at 1 m/s."""

    move_speed = _WALK_SPEED_HUM


@register_env("MS-HumanoidRun-v1", max_episode_steps=1000)
class HumanoidRunEnv(_HumanoidEnv):
    """Run at 10 m/s."""

    move_speed = _RUN_SPEED_HUM
