"""Task-authoring template, registered as CustomEnv-v1.

Port of ``maniskill_tpu/envs/template.py``: copy this file, rename the
class, fill in the hooks and register an env id. A task is a
specialization of ``BaseEnv``:

- **Build time** (once, numpy on the host): ``_load_agent`` and
  ``_load_scene`` declare the static scene (bodies, geoms, articulations)
  through a ``SceneSpecBuilder``; the result is one ``SceneModel`` shared
  by every env of the batch. Per-env variation (sizes, masses, hull
  models) lives in ``SimState`` and is set per episode.
- **Episode time** (batched PyTorch, K envs leading):
  ``_initialize_episode`` places objects and goals with draws from the
  reset's ``torch.Generator``; ``evaluate`` computes success (and
  ``fail``); ``compute_dense_reward`` shapes the learning signal. These
  run on the env's device inside planners' rollouts: use tensor ops and
  ``torch.where``, and no host reads of tensor values.

The JAX template's camera config (``:64-69``) waits for the port's
sensors: this env builds no camera.
"""
from __future__ import annotations

import numpy as np
import torch

from .._consts import const
from ..physics.model import SceneSpecBuilder, box_geom
from .base_env import BaseEnv, EnvState, TaskContext
from .registration import register_env
from .scene_builders import TableSceneBuilder


@register_env("CustomEnv-v1", max_episode_steps=200)
class MyTaskEnv(BaseEnv):
    """Push a cube to a goal in the air above the table.

    **Randomizations:** the cube's xy in U[-0.1, 0.1]², the goal's xy in
    U[-0.1, 0.1]² and its height in U[0.1, 0.3].

    **Success:** the cube within ``goal_thresh`` of the goal and the robot
    (every joint) nearly at rest.
    """

    DEFAULT_ROBOT = "panda_wristcam"

    cube_half_size = 0.02
    goal_thresh = 0.025

    # build time: the robot, mounted by a scene builder at its rest qpos
    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, qpos = self.table_scene.robot_pose_and_qpos(self.robot_uids)
        self.agent.install(builder, pose, init_qpos=qpos)

    # build time: everything else; free bodies need mass and inertia,
    # kinematic bodies are pose-driven markers (goal sites, targets)
    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        half = self.cube_half_size
        m = 1000.0 * (2 * half) ** 3
        inertia = (2.0 / 3.0) * m * half * half * np.eye(3)
        self.obj = builder.add_free_body("cube", m, inertia, [box_geom([half] * 3)])
        self.goal_site = builder.add_kinematic_body("goal_site")

    # episode time: write new tensors (clone, then index) and return a new
    # state; partial resets are the runtime's, this only sees "reset these"
    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        xy = self._uniform(gen, (K, 2), -0.1, 0.1)
        rest = const(self, "obj_rest", [self.cube_half_size, 1.0, 0.0, 0.0, 0.0], dev)
        goal_xy = self._uniform(gen, (K, 2), -0.1, 0.1)
        goal_z = self._uniform(gen, (K, 1), 0.1, 0.3)
        ident = const(self, "ident", [1.0, 0.0, 0.0, 0.0], dev)
        free_pose, free_vel = state.sim.free_pose.clone(), state.sim.free_vel.clone()
        kin_pose = state.sim.kin_pose.clone()
        free_pose[:, self.obj] = torch.cat([xy, rest.expand(K, 5)], -1)
        free_vel[:, self.obj] = 0.0
        kin_pose[:, self.goal_site] = torch.cat([goal_xy, goal_z, ident.expand(K, 4)], -1)
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=free_vel, kin_pose=kin_pose))

    # episode time: a dict with at least "success" (add "fail" for an early
    # failure); the sparse reward is success minus fail
    def evaluate(self, state: EnvState, ctx: TaskContext):
        obj_p = ctx.actor_pose("cube").p
        goal_p = ctx.actor_pose("goal_site").p
        is_placed = torch.linalg.norm(obj_p - goal_p, dim=-1) < self.goal_thresh
        is_static = torch.linalg.norm(state.sim.qvel, dim=-1) < 0.2
        return dict(success=is_placed & is_static)

    # extra observations; ground truth only in the state obs modes
    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if self.obs_mode in ("state", "state_dict"):
            obs.update(goal_pos=ctx.actor_pose("goal_site").p,
                       obj_pose=ctx.actor_pose("cube").raw)
        return obs

    # the shaped reward: staged tanh terms, success at the maximum
    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        obj_p = ctx.actor_pose("cube").p
        goal_p = ctx.actor_pose("goal_site").p
        reaching = 1.0 - torch.tanh(5.0 * torch.linalg.norm(obj_p - ctx.tcp_pose.p, dim=-1))
        placing = 1.0 - torch.tanh(5.0 * torch.linalg.norm(obj_p - goal_p, dim=-1))
        reward = reaching + placing
        return torch.where(info["success"], torch.full_like(reward, 5.0), reward)

    # dense over its maximum, in [0, 1]
    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 5.0
