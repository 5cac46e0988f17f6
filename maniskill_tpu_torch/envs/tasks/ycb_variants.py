"""PickSingleYCB-v1 and FMBAssembly1Easy-v1.

Port of ``maniskill_tpu/envs/tasks/ycb_variants.py``:

- ``PickSingleYCB-v1`` (``:51-66``, with ``_set_hull_library_on``,
  ``:40-48``): PickSingleHull over the YCB hull library. Each model row is
  the convex hull of a YCB mesh where the mesh pack is on disk
  (``utils/building.py`` ``YCB_DIR``), else the procedural stand-in of the
  same position, so the env runs without the pack.
- ``FMBAssembly1Easy-v1`` (``:398-477``): place a beam across the two
  raised pads of a static board, within 1 cm of the goal pose.

The module's other tasks (PickCubeYCB, the two-robot tasks, the G1's) are
not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..._consts import const
from ...physics.model import SceneSpecBuilder, box_geom
from ...utils.building import ycb_or_procedural_library
from ..base_env import EnvState, TaskContext
from ..registration import register_env
from .pick_cube import PickCubeEnv
from .pick_single_hull import PickSingleHullEnv, set_hull_library


@register_env("PickSingleYCB-v1", max_episode_steps=50)
class PickSingleYCBEnv(PickSingleHullEnv):
    """The scene is built with the procedural library's first object, as in
    the JAX package; the library tables are then swapped (same padded
    sizes) and each env draws its object from them at reset."""

    def __init__(self, *args, model_ids=None, **kwargs):
        super().__init__(*args, **kwargs)
        set_hull_library(self, ycb_or_procedural_library(model_ids))


@register_env("FMBAssembly1Easy-v1", max_episode_steps=500)
class FMBAssembly1EasyEnv(PickCubeEnv):
    """The bridge beam and the board are boxes: a slab with two raised
    pads that the beam spans at the goal."""

    beam_half = np.array([0.06, 0.015, 0.015], np.float32)
    goal_thresh = 0.01
    held_body = "bridge"  # contact_state: the fingers close on its 3 cm width

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        bh = self.beam_half
        m = 800.0 * 8 * float(np.prod(bh))
        inertia = m / 3.0 * np.diag([bh[1] ** 2 + bh[2] ** 2, bh[0] ** 2 + bh[2] ** 2,
                                     bh[0] ** 2 + bh[1] ** 2])
        self.beam = builder.add_free_body("bridge", m, inertia, [box_geom(bh, friction=0.8)])
        builder.add_static_body(
            "board", np.array([0.1, 0.1, 0.005, 1, 0, 0, 0], np.float32),
            [box_geom([0.11, 0.11, 0.005], friction=0.8),
             box_geom([0.02, 0.03, 0.015], offset_p=[-0.05, 0.0, 0.02], friction=0.8),
             box_geom([0.02, 0.03, 0.015], offset_p=[0.05, 0.0, 0.02], friction=0.8)])
        self.goal_site = builder.add_kinematic_body("goal_site")

    def _post_build(self):
        self._is_grasping = self.agent.build_grasp_checker(self.model, "bridge", self.device)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        xy = self._uniform(gen, (K, 2), [-0.15, -0.25], [0.0, -0.1])
        rest = const(self, "beam_rest", [self.beam_half[2], 1.0, 0.0, 0.0, 0.0], dev)
        # the goal spans the pads (tops at z = 0.005 + 0.02 + 0.015)
        goal = const(self, "goal", [0.1, 0.1, 0.04 + self.beam_half[2], 1.0, 0.0, 0.0, 0.0], dev)
        free_pose, kin_pose = state.sim.free_pose.clone(), state.sim.kin_pose.clone()
        free_pose[:, self.beam] = torch.cat([xy, rest.expand(K, 5)], -1)
        kin_pose[:, self.goal_site] = goal
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=torch.zeros_like(state.sim.free_vel),
            kin_pose=kin_pose))

    def evaluate(self, state: EnvState, ctx: TaskContext):
        beam = ctx.actor_pose("bridge").p
        goal = ctx.actor_pose("goal_site").p
        return dict(success=torch.linalg.norm(beam - goal, dim=-1) < self.goal_thresh)

    def _get_obs_extra(self, state, ctx, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if "state" in self.obs_mode:
            obs.update(bridge_pose=ctx.actor_pose("bridge").raw,
                       goal_pos=ctx.actor_pose("goal_site").p)
        return obs

    def compute_dense_reward(self, state, action, info, ctx):
        beam = ctx.actor_pose("bridge").p
        goal = ctx.actor_pose("goal_site").p
        reach = 1.0 - torch.tanh(5.0 * torch.linalg.norm(beam - ctx.tcp_pose.p, dim=-1))
        place = 1.0 - torch.tanh(5.0 * torch.linalg.norm(beam - goal, dim=-1))
        reward = reach + 2.0 * place
        return torch.where(info["success"], torch.full_like(reward, 5.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 5.0
