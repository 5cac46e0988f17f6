"""PushCube-v1 and PushCubeKitchen-v1.

Port of ``maniskill_tpu/envs/tasks/push_cube.py``: the same randomization
(cube xy ~ U[-0.1, 0.1]², the goal region 0.1 + ``goal_radius`` in front of
it in x), success (the cube's xy within ``goal_radius`` of the goal's, the
cube on the table), staged dense reward (reach the push point behind the
cube, then push; 3 on success) and obs extras. The default robot is
``panda_wristcam``; its camera waits for the sensors, so the state obs
modes only. PushCubeKitchen-v1 is the same task on the kitchen counter of
the scene-builder registry. ``MPPI_CONFIG`` is the JAX package's planner
config (``tools/solve_tasks.py:34-35``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..._consts import const
from ...physics.model import SceneSpecBuilder, box_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from ..scene_builders import REGISTERED_SCENE_BUILDERS
from .pick_cube import PickCubeEnv


@register_env("PushCube-v1", max_episode_steps=50)
class PushCubeEnv(BaseEnv):
    DEFAULT_ROBOT = "panda_wristcam"
    SCENE_BUILDER = "table"
    MPPI_CONFIG = dict(horizon=20, num_samples=2048, sigma=0.6, temperature=0.3)

    goal_radius = 0.1
    cube_half_size = 0.02

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = REGISTERED_SCENE_BUILDERS[self.SCENE_BUILDER](self)
        pose, qpos = self.table_scene.robot_pose_and_qpos(self.robot_uids)
        self.agent.install(builder, pose, init_qpos=qpos)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        half = self.cube_half_size
        m = 1000.0 * (2 * half) ** 3  # density 1000
        inertia = (2.0 / 3.0) * m * half * half * np.eye(3)
        self.cube = builder.add_free_body("cube", m, inertia, [box_geom([half] * 3)])
        # the goal region: a kinematic marker without geoms
        self.goal_region = builder.add_kinematic_body("goal_region")

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        half = self.cube_half_size
        xy = self._uniform(gen, (K, 2), -0.1, 0.1)
        ident = torch.zeros(K, 4, device=dev)
        ident[:, 0] = 1.0
        cube = torch.cat([xy, torch.full((K, 1), half, device=dev), ident], dim=-1)
        # the goal in front of the cube, flat on the table
        goal_xy = xy + const(self, "goal_off", [0.1 + self.goal_radius, 0.0], dev)
        goal = torch.cat([goal_xy, torch.full((K, 1), 1e-3, device=dev), ident], dim=-1)
        free_pose = state.sim.free_pose.clone()
        free_vel = state.sim.free_vel.clone()
        kin_pose = state.sim.kin_pose.clone()
        free_pose[:, self.cube] = cube
        free_vel[:, self.cube] = 0.0
        kin_pose[:, self.goal_region] = goal
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=free_vel, kin_pose=kin_pose))

    # the cube held between the fingers (every fourth env: on the floor), as
    # PickCube's: the same 2 cm cube, and the same pair functions load
    contact_state = PickCubeEnv.contact_state

    def evaluate(self, state: EnvState, ctx: TaskContext):
        obj_p = ctx.actor_pose("cube").p
        goal_p = ctx.actor_pose("goal_region").p
        placed = ((torch.linalg.norm(obj_p[..., :2] - goal_p[..., :2], dim=-1) < self.goal_radius)
                  & (obj_p[..., 2] < self.cube_half_size + 5e-3))
        return dict(success=placed)

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if self.obs_mode in ("state", "state_dict"):
            obs.update(goal_pos=ctx.actor_pose("goal_region").p,
                       obj_pose=ctx.actor_pose("cube").raw)
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        obj_p = ctx.actor_pose("cube").p
        goal_p = ctx.actor_pose("goal_region").p
        # reach the push point behind the cube
        push_off = const(self, "push_off", [-self.cube_half_size - 0.005, 0.0, 0.0], obj_p.device)
        tcp_to_push = torch.linalg.norm(obj_p + push_off - ctx.tcp_pose.p, dim=-1)
        reward = 1.0 - torch.tanh(5.0 * tcp_to_push)
        reached = (tcp_to_push < 0.01).to(reward.dtype)
        obj_to_goal = torch.linalg.norm(obj_p[..., :2] - goal_p[..., :2], dim=-1)
        reward = reward + (1.0 - torch.tanh(5.0 * obj_to_goal)) * reached
        return torch.where(info["success"], torch.full_like(reward, 3.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 3.0


@register_env("PushCubeKitchen-v1", max_episode_steps=50)
class PushCubeKitchenEnv(PushCubeEnv):
    """PushCube on the procedural kitchen counter (``kitchen_counter`` in
    the scene-builder registry)."""

    SCENE_BUILDER = "kitchen_counter"
