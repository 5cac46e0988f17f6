"""PullCube-v1, PokeCube-v1 and LiftPegUpright-v1.

Port of ``maniskill_tpu/envs/tasks/tabletop_simple.py``: the same
randomizations, success conditions, staged dense rewards and obs extras,
on a batch (the JAX package writes these for one env and vmaps them: its
``obj_p[:2]`` and ``qvel[:-2]`` are ``[..., :2]`` and ``qvel[..., :-2]``
here). PokeCube's peg-cube alignment is ``|atan2 - atan2|`` without a wrap,
as in the JAX package. ``MPPI_CONFIG``: the JAX package's planner configs
for PullCube and PokeCube (``tools/solve_tasks.py:41-44``), the bench shape
for LiftPegUpright. Each task has a ``contact_state`` for checks of the
physics step: PullCube's cube held as PickCube's; the peg held between the
fingers (PokeCube: with the cube pressed against its head).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..._consts import const
from ...math.pose import Pose
from ...math.rotations import quat_apply, quat_from_euler
from ...physics.engine import make_step_fn
from ...physics.model import SceneSpecBuilder, box_geom
from ..base_env import BaseEnv, EnvState
from ..registration import register_env
from ..scene_builders import TableSceneBuilder
from .pick_cube import PickCubeEnv, _closing_half, grasp_qpos


class _TabletopBase(BaseEnv):
    DEFAULT_ROBOT = "panda"

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, qpos = self.table_scene.robot_pose_and_qpos(self.robot_uids)
        self.agent.install(builder, pose, init_qpos=qpos)

    def _ident(self, K):
        q = torch.zeros(K, 4, device=self.device)
        q[:, 0] = 1.0
        return q

    def _peg_body(self, builder, density):
        L, w = self.peg_half_length, self.peg_half_width
        m = density * (2 * L) * (2 * w) * (2 * w)
        inertia = m / 3.0 * np.diag([2 * w * w, L * L + w * w, L * L + w * w])
        return builder.add_free_body("peg", m, inertia, [box_geom([L, w, w])])

    def _hold_peg(self, state: EnvState, gen: torch.Generator):
        """``state``'s peg held between the fingers, as
        ``PickCubeEnv.contact_state`` holds its cube: the TCP on the peg's
        centre (2-12 mm below it, pointing down), the fingers closed 0-1 mm
        into its sides, small random joint and peg velocities (0.02 rad/s,
        0.01 m/s and rad/s: the grasp's contacts hold through a control
        step); returns the sim
        state and the command (the arm holds, the gripper shuts)."""
        dev, sim = self.device, state.sim
        K = sim.qpos.shape[0]
        half = sim.geom_size[:, self.model.geom_indices("peg")[0]]
        pose = sim.free_pose[:, self.peg]
        qpos = grasp_qpos(self, sim.qpos, pose, gen)
        width = _closing_half(pose, half)
        qpos[:, 7:9] = self._uniform(gen, (K, 1), width - 0.001, width)
        qvel = 0.02 * torch.randn(qpos.shape, generator=gen, device=dev)
        free_vel = sim.free_vel.clone()
        free_vel[:, self.peg] = 0.01 * torch.randn((K, 6), generator=gen, device=dev)
        target = qpos.clone()
        target[:, 7:9] = 0.0
        cmd = self.agent.controller.reset(qpos).replace(target_qpos=target)
        return sim.replace(qpos=qpos, qvel=qvel, free_vel=free_vel), cmd


@register_env("PullCube-v1", max_episode_steps=50)
class PullCubeEnv(_TabletopBase):
    """Pull the cube backward into the goal region."""

    MPPI_CONFIG = dict(horizon=20, num_samples=2048, sigma=0.6, temperature=0.3)
    goal_radius = 0.1
    cube_half_size = 0.02

    def _load_scene(self, builder):
        self.table_scene.build(builder)
        half = self.cube_half_size
        m = 1000.0 * (2 * half) ** 3
        self.cube = builder.add_free_body(
            "cube", m, (2 / 3) * m * half * half * np.eye(3), [box_geom([half] * 3)])
        self.goal_region = builder.add_kinematic_body("goal_region")

    def _initialize_episode(self, state, gen):
        K = state.sim.qpos.shape[0]
        dev = self.device
        xy = self._uniform(gen, (K, 2), -0.1, 0.1)
        ident = self._ident(K)
        cube = torch.cat([xy, torch.full((K, 1), self.cube_half_size, device=dev), ident], -1)
        goal_xy = xy - const(self, "goal_off", [0.1 + self.goal_radius, 0.0], dev)
        goal = torch.cat([goal_xy, torch.full((K, 1), 1e-3, device=dev), ident], -1)
        free_pose = state.sim.free_pose.clone()
        free_vel = state.sim.free_vel.clone()
        kin_pose = state.sim.kin_pose.clone()
        free_pose[:, self.cube] = cube
        free_vel[:, self.cube] = 0.0
        kin_pose[:, self.goal_region] = goal
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=free_vel, kin_pose=kin_pose))

    contact_state = PickCubeEnv.contact_state

    def evaluate(self, state, ctx):
        obj_p = ctx.actor_pose("cube").p
        goal_p = ctx.actor_pose("goal_region").p
        return dict(success=torch.linalg.norm(obj_p[..., :2] - goal_p[..., :2], dim=-1)
                    < self.goal_radius)

    def _get_obs_extra(self, state, ctx, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw, goal_pos=ctx.actor_pose("goal_region").p)
        if "state" in self.obs_mode:
            obs.update(obj_pose=ctx.actor_pose("cube").raw)
        return obs

    def compute_dense_reward(self, state, action, info, ctx):
        obj_p = ctx.actor_pose("cube").p
        goal_p = ctx.actor_pose("goal_region").p
        # pull from the cube's far side
        pull_off = const(self, "pull_off", [self.cube_half_size + 2 * 0.005, 0.0, 0.0],
                         obj_p.device)
        d = torch.linalg.norm(obj_p + pull_off - ctx.tcp_pose.p, dim=-1)
        reward = 1.0 - torch.tanh(5.0 * d)
        reached = (d < 0.01).to(reward.dtype)
        place = 1.0 - torch.tanh(5.0 * torch.linalg.norm(obj_p[..., :2] - goal_p[..., :2],
                                                         dim=-1))
        reward = reward + place * reached
        return torch.where(info["success"], torch.full_like(reward, 3.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 3.0


@register_env("PokeCube-v1", max_episode_steps=50)
class PokeCubeEnv(_TabletopBase):
    """Poke a cube with a grasped peg into the goal region."""

    MPPI_CONFIG = dict(horizon=25, num_samples=2048, sigma=0.6, temperature=0.3)
    cube_half_size = 0.02
    peg_half_width = 0.025
    peg_half_length = 0.12
    goal_radius = 0.05

    def _load_scene(self, builder):
        self.table_scene.build(builder)
        half = self.cube_half_size
        m_c = 1000.0 * (2 * half) ** 3
        self.cube = builder.add_free_body(
            "cube", m_c, (2 / 3) * m_c * half * half * np.eye(3), [box_geom([half] * 3)])
        self.peg = self._peg_body(builder, 400.0)
        self.goal_region = builder.add_kinematic_body("goal_region")

    def _post_build(self):
        self._is_grasping_peg = self.agent.build_grasp_checker(self.model, "peg", self.device)

    def _initialize_episode(self, state, gen):
        K = state.sim.qpos.shape[0]
        dev = self.device
        ident = self._ident(K)
        # the peg on the table; the cube 0.1 in front of its head, y drawn
        peg_xy = self._uniform(gen, (K, 2), -0.1, 0.1)
        peg = torch.cat([peg_xy, torch.full((K, 1), self.peg_half_width, device=dev), ident], -1)
        cube_y = self._uniform(gen, (K, 1), -0.1, 0.1)
        cube_x = peg_xy[:, :1] + self.peg_half_length + 0.1
        cube = torch.cat([cube_x, cube_y, torch.full((K, 1), self.cube_half_size, device=dev),
                          ident], -1)
        goal = torch.cat([cube_x + 0.05 + self.goal_radius, cube_y,
                          torch.full((K, 1), 1e-3, device=dev), ident], -1)
        free_pose = state.sim.free_pose.clone()
        kin_pose = state.sim.kin_pose.clone()
        free_pose[:, self.cube] = cube
        free_pose[:, self.peg] = peg
        kin_pose[:, self.goal_region] = goal
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=torch.zeros_like(state.sim.free_vel),
            kin_pose=kin_pose))

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact, for checks of the physics step: the
        peg held between the fingers (``_hold_peg``) and the cube pressed
        1 mm into the peg's head, moving into it at 10 cm/s, so that the peg-cube box_box
        points load beside the finger-peg and the table's; one control step
        of the plain physics step loads the warm-start impulses."""
        sim, cmd = self._hold_peg(state, gen)
        peg = sim.free_pose[:, self.peg]
        free_pose = sim.free_pose.clone()
        free_pose[:, self.cube, 0] = (peg[:, 0] + self.peg_half_length + self.cube_half_size
                                      - 0.001)
        free_pose[:, self.cube, 1] = peg[:, 1]
        free_vel = sim.free_vel.clone()
        free_vel[:, self.cube] = 0.0
        free_vel[:, self.cube, 0] = -0.1  # into the peg, so the contact holds
        sim = sim.replace(free_pose=free_pose, free_vel=free_vel)
        sim = make_step_fn(self.model)(sim, cmd, self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)

    def _peg_head_pos(self, ctx):
        peg = ctx.actor_pose("peg")
        head = const(self, "head", [self.peg_half_length, 0.0, 0.0], peg.p.device)
        return (peg * Pose.translation(head.expand_as(peg.p))).p

    def evaluate(self, state, ctx):
        cube = ctx.actor_pose("cube")
        goal_p = ctx.actor_pose("goal_region").p
        is_cube_placed = torch.linalg.norm(cube.p[..., :2] - goal_p[..., :2], dim=-1) \
            < self.goal_radius
        # yaw alignment of peg and cube, without a wrap as in the JAX package
        ex = const(self, "ex", [1.0, 0.0, 0.0], cube.p.device)
        peg_dir = quat_apply(ctx.actor_pose("peg").q, ex)
        cube_dir = quat_apply(cube.q, ex)
        angle_diff = torch.abs(torch.atan2(peg_dir[..., 1], peg_dir[..., 0])
                               - torch.atan2(cube_dir[..., 1], cube_dir[..., 0]))
        is_aligned = angle_diff < 0.05
        head_to_cube = torch.linalg.norm(self._peg_head_pos(ctx)[..., :2] - cube.p[..., :2],
                                         dim=-1)
        is_close = head_to_cube <= self.cube_half_size + 0.005
        is_grasped = self._is_grasping_peg(ctx.body_quat, ctx.contact_forces())
        is_static = self.agent.is_static(state.sim.qvel, 0.2)
        return dict(success=is_cube_placed & is_static, is_cube_placed=is_cube_placed,
                    is_peg_cube_fit=is_aligned & is_close, is_peg_grasped=is_grasped,
                    angle_diff=angle_diff, head_to_cube_dist=head_to_cube)

    def _get_obs_extra(self, state, ctx, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw, goal_pos=ctx.actor_pose("goal_region").p)
        if "state" in self.obs_mode:
            obs.update(cube_pose=ctx.actor_pose("cube").raw, peg_pose=ctx.actor_pose("peg").raw)
        return obs

    def compute_dense_reward(self, state, action, info, ctx):
        peg_p = ctx.actor_pose("peg").p
        d = torch.linalg.norm(ctx.tcp_pose.p - peg_p, dim=-1)
        reached = d < 0.01
        reward = 2.0 * (1.0 - torch.tanh(5.0 * d))
        align = 1.0 - torch.tanh(5.0 * info["angle_diff"])
        close_r = 1.0 - torch.tanh(5.0 * info["head_to_cube_dist"])
        grasped = info["is_peg_grasped"] & reached
        reward = torch.where(grasped, 4.0 + close_r + align, reward)
        cube_to_goal = torch.linalg.norm(ctx.actor_pose("goal_region").p
                                         - ctx.actor_pose("cube").p, dim=-1)
        place = 1.0 - torch.tanh(5.0 * cube_to_goal)
        reward = torch.where(info["is_peg_cube_fit"] & grasped, 7.0 + place, reward)
        static_r = 1.0 - torch.tanh(5.0 * torch.linalg.norm(state.sim.qvel[..., :-2], dim=-1))
        reward = reward + static_r * info["is_cube_placed"].to(reward.dtype)
        return torch.where(info["success"], torch.full_like(reward, 10.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 10.0


@register_env("LiftPegUpright-v1", max_episode_steps=50)
class LiftPegUprightEnv(_TabletopBase):
    """Stand a lying peg upright."""

    peg_half_width = 0.025
    peg_half_length = 0.12

    def _load_scene(self, builder):
        self.table_scene.build(builder)
        self.peg = self._peg_body(builder, 400.0)

    def _post_build(self):
        self._is_grasping_peg = self.agent.build_grasp_checker(self.model, "peg", self.device)

    def _initialize_episode(self, state, gen):
        K = state.sim.qpos.shape[0]
        dev = self.device
        xy = self._uniform(gen, (K, 2), -0.1, 0.1)
        q = quat_from_euler(const(self, "lying", [math.pi / 2, 0.0, 0.0], dev)).expand(K, 4)
        pose = torch.cat([xy, torch.full((K, 1), self.peg_half_width, device=dev), q], -1)
        free_pose = state.sim.free_pose.clone()
        free_pose[:, self.peg] = pose
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=torch.zeros_like(state.sim.free_vel)))

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact: the lying peg held between the
        fingers (``_hold_peg``), on the table; one control step of the
        plain physics step loads the warm-start impulses."""
        sim, cmd = self._hold_peg(state, gen)
        sim = make_step_fn(self.model)(sim, cmd, self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)

    def _long_axis_z(self, peg: Pose):
        return quat_apply(peg.q, const(self, "ex", [1.0, 0.0, 0.0], peg.p.device))[..., 2]

    def evaluate(self, state, ctx):
        peg = ctx.actor_pose("peg")
        # the long axis (x) vertical within 0.08 rad
        tilt = torch.arccos(torch.clamp(torch.abs(self._long_axis_z(peg)), 0.0, 1.0))
        close = torch.abs(peg.p[..., 2] - self.peg_half_length) < 0.005
        return dict(success=(tilt < 0.08) & close)

    def _get_obs_extra(self, state, ctx, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if "state" in self.obs_mode:
            obs.update(obj_pose=ctx.actor_pose("peg").raw)
        return obs

    def compute_dense_reward(self, state, action, info, ctx):
        peg = ctx.actor_pose("peg")
        reward = torch.abs(self._long_axis_z(peg))
        z_dist = torch.abs(peg.p[..., 2] - self.peg_half_length)
        reward = reward + 1.0 - torch.tanh(5.0 * z_dist)
        to_grip = torch.linalg.norm(peg.p - ctx.tcp_pose.p, dim=-1)
        grasped = self._is_grasping_peg(ctx.body_quat, ctx.contact_forces())
        reaching = torch.where(grasped, torch.ones_like(to_grip), 1.0 - torch.tanh(5.0 * to_grip))
        reward = reward + reaching / 5.0
        return torch.where(info["success"], torch.full_like(reward, 3.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 3.0
