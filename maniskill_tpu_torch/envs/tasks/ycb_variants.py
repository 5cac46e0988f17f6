"""PickSingleYCB-v1, FMBAssembly1Easy-v1, PickCubeYCB-v1 and the two-robot
clutter and fold tasks.

Port of ``maniskill_tpu/envs/tasks/ycb_variants.py``:

- ``PickSingleYCB-v1`` (``:51-66``, with ``_set_hull_library_on``,
  ``:40-48``): PickSingleHull over the YCB hull library. Each model row is
  the convex hull of a YCB mesh where the mesh pack is on disk
  (``utils/building.py`` ``YCB_DIR``), else the procedural stand-in of the
  same position, so the env runs without the pack.
- ``FMBAssembly1Easy-v1`` (``:398-477``): place a beam across the two
  raised pads of a static board, within 1 cm of the goal pose.

- ``PickCubeYCB-v1`` (``:243-253``): PickCube with two clutter hulls of
  the procedural YCB library on the table (``_add_distractors``: its
  objects 1 and 3), dropped from 5 and 8 cm at reset
  (``_scatter_distractors``, ``:67-93``; JAX draws each one's xy from
  ``fold_in(key, 100 + i)``, the port from the env's generator after the
  cube and the goal).
- ``TwoRobotPickCubeYCB-v1`` (``:256-266``): the two-robot handover with
  the same clutter: n_all 36 exceeds the mega-kernel's ``NALL_MAX`` of 32,
  so it declares that refusal (``PLAIN_STEP_REFUSAL``) and runs on the
  plain step, as the JAX package runs it on its XLA engine.
- ``TwoRobotFold-v1`` (``:269-304``): FoldSuitcase worked by two Pandas;
  the same success, the lid's close fraction as its dense reward.

The G1's task of the module waits for its robot (ROADMAP Queue A item 7).
"""
from __future__ import annotations

import numpy as np
import torch

from ..._consts import const
from ...physics.hulls import standard_object_library
from ...physics.model import SceneSpecBuilder, box_geom
from ...utils.building import ycb_or_procedural_library
from ..base_env import EnvState, TaskContext
from ..registration import register_env
from .fold_suitcase import FoldSuitcaseEnv
from .pick_cube import PickCubeEnv
from .pick_single_hull import PickSingleHullEnv, set_hull_library
from .two_robot import TwoRobotPickCubeEnv, install_two_pandas


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


def _add_distractors(builder: SceneSpecBuilder, n: int = 2):
    """Clutter hulls of the procedural YCB library (objects 1, 3, ...), not
    part of the task. Returns their free-body indices."""
    lib = standard_object_library()
    return [builder.add_free_hull(f"distractor{i}", lib[(2 * i + 1) % len(lib)], density=600,
                                  friction=0.5) for i in range(n)]


def _scatter_distractors(env, state: EnvState, gen: torch.Generator, z: float = 0.05):
    """Each distractor at a random xy on the table, upright, at rest, the
    i-th dropped from ``z + 0.03 i``."""
    K, dev = state.sim.qpos.shape[0], env.device
    free_pose, free_vel = state.sim.free_pose.clone(), state.sim.free_vel.clone()
    for i, idx in enumerate(env.distractors):
        xy = env._uniform(gen, (K, 2), [-0.12, -0.25], [0.12, 0.25])
        rest = torch.tensor([z + 0.03 * i, 1.0, 0, 0, 0], device=dev).expand(K, 5)
        free_pose[:, idx] = torch.cat([xy, rest], -1)
        free_vel[:, idx] = 0.0
    return state.replace(sim=state.sim.replace(free_pose=free_pose, free_vel=free_vel))


def _stack_distractors(env, sim, gen: torch.Generator):
    """Distractor 1 set upright on distractor 0 (at its reset xy, on the
    table), 0-1 mm into its top: a hull on a hull (``hull_hull``)."""
    K = sim.qpos.shape[0]
    d0, d1 = env.distractors[:2]
    h0, h1 = (sim.geom_size[:, env.model.geom_indices(f"distractor{i}")[0], 2] for i in (0, 1))
    free_pose = sim.free_pose.clone()
    free_pose[:, d0, 2] = h0
    free_pose[:, d0, 3:] = free_pose.new_tensor([1.0, 0, 0, 0])
    free_pose[:, d1] = free_pose[:, d0]
    free_pose[:, d1, 2] = 2 * h0 + h1 - env._uniform(gen, (K,), 0.0, 1e-3)
    return sim.replace(free_pose=free_pose)


@register_env("PickCubeYCB-v1", max_episode_steps=50)
class PickCubeYCBEnv(PickCubeEnv):
    """PickCube amid clutter."""

    def _load_scene(self, builder: SceneSpecBuilder):
        super()._load_scene(builder)
        self.distractors = _add_distractors(builder, n=2)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        return _scatter_distractors(self, super()._initialize_episode(state, gen), gen)

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """PickCube's contact states (the cube held) with distractor 1 first
        set on distractor 0 (``_stack_distractors``)."""
        return super().contact_state(
            state.replace(sim=_stack_distractors(self, state.sim, gen)), gen)


@register_env("TwoRobotPickCubeYCB-v1", max_episode_steps=100)
class TwoRobotPickCubeYCBEnv(TwoRobotPickCubeEnv):
    """The two-robot handover amid clutter."""

    PLAIN_STEP_REFUSAL = "n_all 36 > NALL_MAX 32"

    def _load_scene(self, builder: SceneSpecBuilder):
        super()._load_scene(builder)
        self.distractors = _add_distractors(builder, n=2)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        return _scatter_distractors(self, super()._initialize_episode(state, gen), gen)


@register_env("TwoRobotFold-v1", max_episode_steps=50)
class TwoRobotFoldEnv(FoldSuitcaseEnv):
    """The suitcase worked by two arms from the table's two sides (the same
    fold success)."""

    DEFAULT_ROBOT = ("panda", "panda")

    def _load_agent(self, builder: SceneSpecBuilder):
        install_two_pandas(self, builder)

    def _pressing_arm(self):
        """The left arm (agent 0) presses the lid in the contact states."""
        ma = self.agent
        return (ma.agent_prefix(0) + ma.sub_agents[0].ee_link_name, range(7), slice(7, 9),
                ("robot:" + ma.agent_prefix(0) + "panda_leftfinger",
                 "robot:" + ma.agent_prefix(0) + "panda_rightfinger"))

    def _get_obs_extra(self, state, ctx, info):
        obs = dict(left_arm_tcp=self.agent.tcp_pose_of(0, ctx).raw,
                   right_arm_tcp=self.agent.tcp_pose_of(1, ctx).raw)
        if "state" in self.obs_mode:
            obs["lid_qpos"] = state.sim.qpos[:, -1:]
        return obs

    def compute_dense_reward(self, state, action, info, ctx):
        close = 1.0 - torch.clamp(state.sim.qpos[:, -1] / self.lid_qmax, 0.0, 1.0)
        reward = 3.0 * close
        return torch.where(info["success"], torch.full_like(reward, 5.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 5.0
