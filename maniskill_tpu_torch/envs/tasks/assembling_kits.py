"""AssemblingKits-v1: insert a square piece through a slot in a board.

Port of ``maniskill_tpu/envs/tasks/assembling_kits.py``: the board is four
static boxes around a 6 cm square opening, the piece a box whose half
width (U[0.018, 0.024], per env through ``geom_size``, mass and inertia
with it) always leaves clearance. Success as in the JAX task: the piece's
xy within 2 cm of the slot, its yaw within 4 degrees modulo a quarter
turn, dropped below the board top and released.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..._consts import const
from ...math import clamps
from ...math.rotations import quat_from_axis_angle
from ...physics.model import SceneSpecBuilder, box_geom
from ..base_env import EnvState, TaskContext
from ..registration import register_env
from .pick_cube import PickCubeEnv


@register_env("AssemblingKits-v1", max_episode_steps=100)
class AssemblingKitsEnv(PickCubeEnv):
    slot_half = 0.030  # half width of the square opening
    board_half = 0.12
    board_thick = 0.004  # half thickness
    board_z = 0.008
    piece_lo = 0.018
    piece_hi = 0.024
    pos_eps = 2e-2
    rot_eps = float(np.deg2rad(4))
    board_center = np.array([0.1, 0.0], np.float32)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        s, b, t, z = self.slot_half, self.board_half, self.board_thick, self.board_z
        cx, cy = self.board_center
        w = (b - s) / 2
        for name, (ox, oy, hx, hy) in dict(
                north=(0.0, s + w, b, w), south=(0.0, -(s + w), b, w),
                east=(s + w, 0.0, w, s), west=(-(s + w), 0.0, w, s)).items():
            builder.add_static_body(
                f"board_{name}", np.array([cx + ox, cy + oy, z, 1, 0, 0, 0], np.float32),
                [box_geom([hx, hy, t], friction=0.4)])
        half = 0.021
        m = 1000.0 * (2 * half) ** 3
        inertia = (2.0 / 3.0) * m * half * half * np.eye(3)
        self.cube = builder.add_free_body("cube", m, inertia,
                                          [box_geom([half] * 3, friction=0.6)])
        self.goal_site = builder.add_kinematic_body("goal_site")

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        half_xy = self._uniform(gen, (K,), self.piece_lo, self.piece_hi)
        half = torch.stack([half_xy, half_xy, torch.full_like(half_xy, 0.02)], -1)
        # spawn area left of the board
        xy = self._uniform(gen, (K, 2), -0.08, -0.02) + const(self, "spawn", [-0.1, 0.15], dev)
        yaw = self._uniform(gen, (K,), -math.pi, math.pi)
        ez = torch.zeros(K, 3, device=dev)
        ez[:, 2] = 1.0
        pose = torch.cat([xy, half[:, 2:], quat_from_axis_angle(ez, yaw)], -1)
        goal = const(self, "goal", [*self.board_center, 0.02, 1.0, 0.0, 0.0, 0.0], dev)
        m = 1000.0 * 8.0 * half[:, 0] * half[:, 1] * half[:, 2]
        h2 = half * half
        inertia = (m / 3.0)[:, None, None] * torch.diag_embed(
            torch.stack([h2[:, 1] + h2[:, 2], h2[:, 0] + h2[:, 2], h2[:, 0] + h2[:, 1]], -1))
        sim = state.sim
        free_pose, free_vel, kin_pose = sim.free_pose.clone(), sim.free_vel.clone(), sim.kin_pose.clone()
        geom_size, free_mass = sim.geom_size.clone(), sim.free_mass.clone()
        free_inertia = sim.free_inertia.clone()
        free_pose[:, self.cube] = pose
        free_vel[:, self.cube] = 0.0
        kin_pose[:, self.goal_site] = goal
        geom_size[:, self.model.geom_indices("cube")[0]] = half
        free_mass[:, self.cube] = m
        free_inertia[:, self.cube] = inertia
        return state.replace(sim=sim.replace(
            free_pose=free_pose, free_vel=free_vel, kin_pose=kin_pose, geom_size=geom_size,
            free_mass=free_mass, free_inertia=free_inertia))

    def evaluate(self, state: EnvState, ctx: TaskContext):
        p = ctx.actor_pose("cube")
        center = const(self, "board_center", self.board_center, self.device)
        pos_diff = torch.linalg.norm(p.p[:, :2] - center, dim=-1)
        pos_correct = pos_diff < self.pos_eps
        # yaw modulo a quarter turn (the square piece's symmetry)
        q = p.q
        yaw = torch.atan2(2.0 * (q[:, 0] * q[:, 3] + q[:, 1] * q[:, 2]),
                          1.0 - 2.0 * (q[:, 2] ** 2 + q[:, 3] ** 2))
        rot_diff = torch.abs(torch.remainder(yaw + math.pi / 4, math.pi / 2) - math.pi / 4)
        rot_correct = rot_diff < self.rot_eps
        in_slot = p.p[:, 2] < 2 * self.board_thick + 0.021  # dropped through the opening
        is_grasped = self._is_grasping(ctx.body_quat, ctx.contact_forces())
        return dict(success=pos_correct & rot_correct & in_slot & ~is_grasped,
                    pos_diff_norm=pos_diff, rot_diff=rot_diff, pos_correct=pos_correct,
                    rot_correct=rot_correct, in_slot=in_slot, is_grasped=is_grasped,
                    is_obj_placed=pos_correct & in_slot,
                    is_robot_static=self.agent.is_static(state.sim.qvel, 0.2))

    def _get_obs_extra(self, state, ctx, info):
        obs = dict(is_grasped=info["is_grasped"], tcp_pose=ctx.tcp_pose.raw,
                   goal_pos=ctx.actor_pose("goal_site").p)
        if "state" in self.obs_mode:
            cube = ctx.actor_pose("cube")
            obs.update(obj_pose=cube.raw, tcp_to_obj_pos=cube.p - ctx.tcp_pose.p,
                       obj_to_goal_pos=ctx.actor_pose("goal_site").p - cube.p,
                       obj_half=state.sim.geom_size[:, self.model.geom_indices("cube")[0]])
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        cube_p = ctx.actor_pose("cube").p
        goal_p = ctx.actor_pose("goal_site").p
        reach = 1.0 - torch.tanh(5.0 * torch.linalg.norm(cube_p - ctx.tcp_pose.p, dim=-1))
        grasped = info["is_grasped"].to(torch.float32)
        carry = 1.0 - torch.tanh(5.0 * torch.linalg.norm(goal_p - cube_p, dim=-1))
        align = 1.0 - torch.tanh(10.0 * info["rot_diff"])
        insert = 1.0 - torch.tanh(20.0 * clamps.maximum(cube_p[:, 2] - 0.02, 0.0))
        reward = (reach + grasped + grasped * carry
                  + info["pos_correct"].to(torch.float32) * (align + insert))
        return torch.where(info["success"], torch.full_like(reward, 6.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 6.0
