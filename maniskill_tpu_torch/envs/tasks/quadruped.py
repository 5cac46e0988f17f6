"""Quadruped locomotion: AnymalC-Reach-v1, AnymalC-Spin-v1 and
UnitreeGo2-Reach-v1.

Port of ``maniskill_tpu/envs/tasks/quadruped.py``. A quadruped (ANYmal C or
Go2, ``agents/robots/quadruped.py``) stands on a floor plane (friction 1.0)
at its standing keyframe; 100 Hz sim of 2 substeps, 50 Hz control (2 sim
steps a control step), ``pd_joint_delta_pos`` by default.

- Reach (``:134-194``): walk to a goal (the ``goal`` kinematic body)
  2.5 +- 0.5 m ahead and within 1 m to the side; success within 0.35 m of
  it (the base's xy) and not fallen; the dense reward 1 + 2 (1 - tanh d)
  plus the penalties, 0 once fallen.
- Spin (``:197-214``): turn about +z; the dense reward 2 x the yaw rate
  plus the penalties, -100 once fallen.

Fallen: a contact force above 1 N on the base (``TaskContext.contact_forces``
under the static (P,) mask of the points touching the base,
``engine.body_contact_mask``). The penalties: the base's vertical speed,
its roll and pitch rates, an undesired shank contact (above 1 N) and the
legs' distance from the standing pose. The root's rates come from the synthetic
chain's qvel (slides x, y, z; hinges z, y, x: the angular rates reversed).
"""
from __future__ import annotations

import numpy as np
import torch

from ..._consts import const
from ...physics.engine import body_contact_mask
from ...physics.model import SceneSpecBuilder, SimParams, plane_geom
from ..base_env import EnvState, TaskContext
from ..registration import register_env
from .control_suite import FloorRobotEnv


class LeggedEnv(FloorRobotEnv):
    """A legged robot on a floor plane: 2 sim steps of 2 substeps a control
    step, PD joint control, the standing keyframe."""

    SIM_FREQ = 100
    CONTROL_FREQ = 50

    def __init__(self, *args, control_mode=None, **kwargs):
        super().__init__(*args, control_mode=control_mode or "pd_joint_delta_pos", **kwargs)

    def _sim_params(self) -> SimParams:
        return SimParams(dt=1.0 / self.SIM_FREQ, substeps=2)

    def _load_scene(self, builder: SceneSpecBuilder):
        builder.add_static_body("floor", np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                                [plane_geom(friction=1.0)])

    def _post_build(self):
        self._default_qpos = self.agent.keyframes["standing"].qpos


class _QuadrupedEnv(LeggedEnv):
    DEFAULT_ROBOT = "anymal_c"
    FLOOR_CONTACT = ("plane_sphere", "plane_box")  # sphere feet; the base box

    def _load_scene(self, builder: SceneSpecBuilder):
        super()._load_scene(builder)
        self.goal_site = builder.add_kinematic_body("goal")

    def _post_build(self):
        super()._post_build()
        self._base_mask = body_contact_mask(self.model, [self.agent.base_link])
        self._shank_mask = body_contact_mask(self.model, self.agent.shank_links)
        names = list(self.model.robot.joint_names)
        self._leg_idx = np.array([names.index(n) for n in self.agent.leg_joint_names])
        self._base_idx = self.model.robot.link_index[self.agent.base_link]

    def _root_vel(self, state: EnvState):
        """(linear xyz, angular xyz) of the root from the chain's qvel."""
        qv = state.sim.qvel
        return qv[:, 0:3], torch.stack([qv[:, 5], qv[:, 4], qv[:, 3]], -1)

    def _root_xy(self, ctx: TaskContext) -> torch.Tensor:
        return ctx.body_pos[:, self._base_idx, :2]

    def _contact_force_mag(self, ctx: TaskContext, name: str) -> torch.Tensor:
        mask = const(self, name, getattr(self, name), ctx.body_pos.device)
        return torch.amax(mask * torch.linalg.norm(ctx.contact_forces(), dim=-1), -1)

    def _is_fallen(self, ctx: TaskContext) -> torch.Tensor:
        return self._contact_force_mag(ctx, "_base_mask") > 1.0

    def _penalties(self, state: EnvState, ctx: TaskContext) -> torch.Tensor:
        lin, ang = self._root_vel(state)
        undesired = (self._contact_force_mag(ctx, "_shank_mask") > 1.0).to(lin.dtype)
        dq = const(self, "_default_qpos", self._default_qpos, lin.device)
        leg = const(self, "_leg_idx", self._leg_idx, lin.device, torch.long)
        posture = torch.linalg.norm(state.sim.qpos[:, leg] - dq[leg], dim=-1)
        return (-2.0 * lin[:, 2] ** 2 - 0.05 * (ang[:, 0] ** 2 + ang[:, 1] ** 2)
                - 1.0 * undesired - 0.05 * posture)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        qpos = torch.as_tensor(self._default_qpos, device=self.device).expand(K, -1).clone()
        return state.replace(sim=state.sim.replace(qpos=qpos,
                                                   qvel=torch.zeros_like(state.sim.qvel)))

    def _get_obs_extra(self, state, ctx, info):
        lin, ang = self._root_vel(state)
        return dict(root_linear_velocity=lin, root_angular_velocity=ang)


class QuadrupedReachEnv(_QuadrupedEnv):
    goal_radius = 0.35

    def _draw(self, gen: torch.Generator, K: int) -> dict:
        """The goal's x (2.5 +- 0.5 m) and y (+-1 m), (K,) each."""
        return dict(gx=2.5 + self._uniform(gen, (K,), -0.5, 0.5),
                    gy=self._uniform(gen, (K,), -1.0, 1.0))

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        state = super()._initialize_episode(state, gen)
        K = state.sim.qpos.shape[0]
        d = self._draw(gen, K)
        rest = torch.tensor([0.2, 1.0, 0, 0, 0], device=self.device).expand(K, 5)
        kin_pose = state.sim.kin_pose.clone()
        kin_pose[:, self.goal_site] = torch.cat([d["gx"][:, None], d["gy"][:, None], rest], -1)
        return state.replace(sim=state.sim.replace(kin_pose=kin_pose))

    def evaluate(self, state, ctx: TaskContext):
        is_fallen = self._is_fallen(ctx)
        dist = torch.linalg.norm(ctx.actor_pose("goal").p[:, :2] - self._root_xy(ctx), dim=-1)
        reached = dist < self.goal_radius
        return dict(success=reached & ~is_fallen, fail=is_fallen, robot_to_goal_dist=dist,
                    reached_goal=reached, is_fallen=is_fallen)

    def _get_obs_extra(self, state, ctx, info):
        obs = super()._get_obs_extra(state, ctx, info)
        obs["reached_goal"] = info["success"]
        if "state" in self.obs_mode:
            goal_xy = ctx.actor_pose("goal").p[:, :2]
            obs["goal_pos"] = goal_xy
            obs["robot_to_goal"] = goal_xy - self._root_xy(ctx)
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        reaching = 1.0 - torch.tanh(info["robot_to_goal_dist"])
        reward = 1.0 + 2.0 * reaching + self._penalties(state, ctx)
        return torch.where(info["fail"], torch.zeros_like(reward), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 3.0


class QuadrupedSpinEnv(_QuadrupedEnv):
    def evaluate(self, state, ctx: TaskContext):
        is_fallen = self._is_fallen(ctx)
        return dict(success=torch.zeros_like(is_fallen), fail=is_fallen, is_fallen=is_fallen)

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        _, ang = self._root_vel(state)
        reward = 2.0 * ang[:, 2] + self._penalties(state, ctx)
        return torch.where(info["fail"], torch.full_like(reward, -100.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 2.0


@register_env("AnymalC-Reach-v1", max_episode_steps=200)
class AnymalCReachEnv(QuadrupedReachEnv):
    DEFAULT_ROBOT = "anymal_c"


@register_env("AnymalC-Spin-v1", max_episode_steps=200)
class AnymalCSpinEnv(QuadrupedSpinEnv):
    DEFAULT_ROBOT = "anymal_c"


@register_env("UnitreeGo2-Reach-v1", max_episode_steps=200)
class UnitreeGo2ReachEnv(QuadrupedReachEnv):
    DEFAULT_ROBOT = "unitree_go2"
