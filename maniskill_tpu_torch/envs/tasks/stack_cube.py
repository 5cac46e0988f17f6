"""StackCube-v1.

Port of ``maniskill_tpu/envs/tasks/stack_cube.py``: two 2 cm cubes of
density 1000 (``_load_scene``), the min-separation placement
(``_initialize_episode``, ``:56-84``), success = cubeA on cubeB, static and
not grasped (``evaluate``, ``:86-107``), the obs extras (``:109-121``) and
the staged dense reward (reach ×2 → grasp + place → ungrasp + static → 8
on success) with its normalized form (``:123-147``). ``is_cubeA_grasped``
is the Panda's contact-force angle test on cubeA.

The scene is the first with two free bodies in contact with each other:
the cubeA-cubeB pair takes the symmetric 28-point ``box_box`` test.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...math.rotations import quat_from_axis_angle
from ...physics.engine import make_step_fn
from ...physics.model import SceneSpecBuilder, box_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from ..scene_builders import TABLE_HEIGHT, TableSceneBuilder
from .pick_cube import grasp_qpos


@register_env("StackCube-v1", max_episode_steps=50)
class StackCubeEnv(BaseEnv):
    DEFAULT_ROBOT = "panda"

    cube_half_size = 0.02

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, qpos = self.table_scene.robot_pose_and_qpos(self.robot_uids)
        self.agent.install(builder, pose, init_qpos=qpos)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        half = self.cube_half_size
        m = 1000.0 * (2 * half) ** 3
        inertia = (2.0 / 3.0) * m * half * half * np.eye(3)
        self.cubeA = builder.add_free_body("cubeA", m, inertia, [box_geom([half] * 3)])
        self.cubeB = builder.add_free_body("cubeB", m, inertia, [box_geom([half] * 3)])

    def _post_build(self):
        self._is_grasping_A = self.agent.build_grasp_checker(self.model, "cubeA", self.device)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        half = self.cube_half_size
        xy = self._uniform(gen, (K, 2), -0.1, 0.1)
        # B at a random direction, at least the radius sqrt(2) half + 1 mm
        # away from A (the reference's UniformPlacementSampler)
        radius = float(np.sqrt(2) * half) + 0.001
        a_off = self._uniform(gen, (K, 2), -0.1, 0.1)
        ang = self._uniform(gen, (K,), -math.pi, math.pi)
        dist = self._uniform(gen, (K,), radius, 0.10)
        b_off = a_off + dist[:, None] * torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
        b_off = torch.clamp(b_off, -0.1, 0.2)
        yaw_a = self._uniform(gen, (K,), -math.pi, math.pi)
        yaw_b = self._uniform(gen, (K,), -math.pi, math.pi)
        up = torch.zeros(K, 3, device=dev)
        up[:, 2] = 1.0
        z = torch.full((K, 1), half, device=dev)
        pose_a = torch.cat([xy + a_off, z, quat_from_axis_angle(up, yaw_a)], dim=-1)
        pose_b = torch.cat([xy + b_off, z, quat_from_axis_angle(up, yaw_b)], dim=-1)
        free_pose = state.sim.free_pose.clone()
        free_pose[:, self.cubeA] = pose_a
        free_pose[:, self.cubeB] = pose_b
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=torch.zeros_like(state.sim.free_vel)))

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact, for checks of the physics step.

        Even envs stack cubeA on cubeB: cubeA's centre within 4 mm of the
        axis of cubeB (which stays where it was), 0-1 mm into it, aligned
        with cubeB in every fourth env and at a random yaw in the others.
        Odd envs grasp cubeA as ``PickCubeEnv.contact_state`` does (IK puts
        the TCP on the cube, the fingertips within the contact margin of
        the table, the fingers 0-1 mm into the cube), and every other one
        of them drops cubeB on the floor beyond the table's far edge.
        Joint and cube velocities are random; the arm holds its pose, the
        gripper shuts in the grasp envs and holds in the stacked ones. One
        control step of the plain physics step then loads the warm-start
        impulses. The cubeA-cubeB points (``box_box``, both sides free),
        finger-cube, cube-table and cube-floor points, and friction, carry
        force from such states."""
        dev = self.device
        half = self.cube_half_size
        sim = state.sim
        K = sim.qpos.shape[0]
        idx = torch.arange(K, device=dev)
        stacked = idx % 2 == 0
        free_pose = sim.free_pose.clone()
        pose_b = free_pose[:, self.cubeB]
        yaw_b = 2.0 * torch.atan2(pose_b[:, 6], pose_b[:, 3])
        off = self._uniform(gen, (K, 2), -0.004, 0.004)
        sink = self._uniform(gen, (K, 1), 0.0, 0.001)
        yaw = torch.where(idx % 4 == 0, yaw_b, self._uniform(gen, (K,), -math.pi, math.pi))
        up = torch.zeros(K, 3, device=dev)
        up[:, 2] = 1.0
        on_b = torch.cat([pose_b[:, :2] + off, pose_b[:, 2:3] + 2 * half - sink,
                          quat_from_axis_angle(up, yaw)], dim=-1)
        free_pose[:, self.cubeA] = torch.where(stacked[:, None], on_b, free_pose[:, self.cubeA])
        qpos = grasp_qpos(self, sim.qpos, free_pose[:, self.cubeA], gen)
        fingers = self._uniform(gen, (K, 1), half - 0.001, half)
        qpos[:, 7:9] = fingers
        qpos = torch.where(stacked[:, None], sim.qpos, qpos)
        floor = idx % 4 == 3
        table = TableSceneBuilder
        free_pose[floor, self.cubeB, 0] = float(table.TABLE_CENTER[0] + table.TABLE_HALF[0]) + 0.1
        free_pose[floor, self.cubeB, 2] = half - TABLE_HEIGHT
        qvel = 0.1 * torch.randn(qpos.shape, generator=gen, device=dev)
        free_vel = 0.05 * torch.randn(sim.free_vel.shape, generator=gen, device=dev)
        free_vel[:, :, 2] *= torch.where(stacked, 0.0, 1.0)[:, None]
        sim = sim.replace(qpos=qpos, qvel=qvel, free_pose=free_pose, free_vel=free_vel)
        target = qpos.clone()
        target[:, 7:9] = torch.where(stacked[:, None], qpos[:, 7:9], torch.zeros_like(fingers))
        cmd = self.agent.controller.reset(qpos).replace(target_qpos=target)
        sim = make_step_fn(self.model)(sim, cmd, self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)

    def evaluate(self, state: EnvState, ctx: TaskContext):
        half = self.cube_half_size
        offset = ctx.actor_pose("cubeA").p - ctx.actor_pose("cubeB").p
        xy_flag = (torch.linalg.norm(offset[..., :2], dim=-1)
                   <= float(np.linalg.norm([half, half])) + 0.005)
        z_flag = torch.abs(offset[..., 2] - 2 * half) <= 0.005
        is_on = xy_flag & z_flag
        vel_a = ctx.actor_vel("cubeA")
        is_static = ((torch.linalg.norm(vel_a[..., :3], dim=-1) <= 1e-2)
                     & (torch.linalg.norm(vel_a[..., 3:], dim=-1) <= 0.5))
        is_grasped = self._is_grasping_A(ctx.body_quat, ctx.contact_forces())
        return dict(is_cubeA_grasped=is_grasped, is_cubeA_on_cubeB=is_on,
                    is_cubeA_static=is_static, success=is_on & is_static & ~is_grasped)

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if "state" in self.obs_mode:
            a, b = ctx.actor_pose("cubeA"), ctx.actor_pose("cubeB")
            obs.update(cubeA_pose=a.raw, cubeB_pose=b.raw,
                       tcp_to_cubeA_pos=a.p - ctx.tcp_pose.p,
                       tcp_to_cubeB_pos=b.p - ctx.tcp_pose.p,
                       cubeA_to_cubeB_pos=b.p - a.p)
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        half = self.cube_half_size
        pos_a = ctx.actor_pose("cubeA").p
        pos_b = ctx.actor_pose("cubeB").p
        tcp = ctx.tcp_pose.p
        reach = 2.0 * (1.0 - torch.tanh(5.0 * torch.linalg.norm(tcp - pos_a, dim=-1)))
        goal = torch.cat([pos_b[..., :2], pos_b[..., 2:3] + 2 * half], dim=-1)
        place = 1.0 - torch.tanh(5.0 * torch.linalg.norm(goal - pos_a, dim=-1))
        grasped = info["is_cubeA_grasped"]
        reward = torch.where(grasped, 4.0 + place, reach)
        gripper_width = 2 * 0.04  # the Panda's finger limit
        ungrasp = torch.sum(state.sim.qpos[..., -2:], dim=-1) / gripper_width
        ungrasp = torch.where(grasped, ungrasp, torch.ones_like(ungrasp))
        vel_a = ctx.actor_vel("cubeA")
        static_r = 1.0 - torch.tanh(10.0 * torch.linalg.norm(vel_a[..., :3], dim=-1)
                                    + torch.linalg.norm(vel_a[..., 3:], dim=-1))
        reward = torch.where(info["is_cubeA_on_cubeB"], 6.0 + (ungrasp + static_r) / 2.0,
                             reward)
        return torch.where(info["success"], torch.full_like(reward, 8.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 8.0
