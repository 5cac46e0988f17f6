"""PegInsertionSide-v1.

Port of ``maniskill_tpu/envs/tasks/peg_insertion_side.py``: grasp a peg
lying on the table and insert it sideways into a box with a hole. The same
pose randomizations, success (the peg's head inside the hole, past
-0.015 m along its axis), 4-stage dense reward (reach and grasp, align,
insert; 10 on success) and state obs.

Each env draws its own peg: half-length in [0.085, 0.125] and radius in
[0.015, 0.025] go into ``SimState.geom_size`` and the ``peg_half_size``
extra (``_default_extras``); the peg's mass and inertia stay the nominal
ones, as in the JAX package. The hole is four walls of a kinematic box
built at the largest radius plus 3 mm, so the clearance is 3-13 mm per
env. The head pose uses the env's own half-length, the goal the nominal
0.105, as in the JAX package. ``MPPI_CONFIG`` is BASELINE config #4 as the
JAX package runs it (``tools/solve_tasks.py:87-90``): H=80, K=16384, sigma
0.4 for each arm joint and 0.1 for the gripper, temperature 0.1.
``contact_state`` puts the grasped peg's head in the hole, resting on the
bottom wall and pressed against a side wall.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..._consts import const
from ...math.pose import Pose
from ...math.rotations import quat_apply, quat_from_axis_angle, quat_mul
from ...physics.engine import make_step_fn
from ...physics.model import SceneSpecBuilder, box_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from ..scene_builders import TableSceneBuilder
from .pick_cube import pose_ik


@register_env("PegInsertionSide-v1", max_episode_steps=100)
class PegInsertionSideEnv(BaseEnv):
    DEFAULT_ROBOT = "panda_wristcam"
    MPPI_CONFIG = dict(horizon=80, num_samples=16384, sigma=[0.4] * 7 + [0.1],
                       temperature=0.1)

    peg_len_range = (0.085, 0.125)
    peg_radius_range = (0.015, 0.025)
    peg_half_length = 0.105  # nominal: the hole's depth and the goal
    peg_radius = 0.025  # the largest radius sizes the hole
    _clearance = 0.003

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, qpos = self.table_scene.robot_pose_and_qpos("panda_wristcam")
        self.agent.install(builder, pose, init_qpos=qpos)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        L, r = self.peg_half_length, self.peg_radius
        m = 1000.0 * (2 * L) * (2 * r) * (2 * r)
        inertia = m / 3.0 * np.diag([2 * r * r, L * L + r * r, L * L + r * r])
        self.peg = builder.add_free_body("peg", m, inertia, [box_geom([L, r, r])])
        # the box with a hole: 4 walls around the x axis (the hole's
        # direction), kinematic
        inner = r + self._clearance
        outer = depth = L
        thickness = (outer - inner) * 0.5
        offset = thickness + inner
        walls = [
            box_geom([depth, thickness, outer], offset_p=[0, offset, 0]),
            box_geom([depth, thickness, outer], offset_p=[0, -offset, 0]),
            box_geom([depth, outer, thickness], offset_p=[0, 0, offset]),
            box_geom([depth, outer, thickness], offset_p=[0, 0, -offset]),
        ]
        self.box = builder.add_kinematic_body("box_with_hole", walls)
        self.box_hole_radius = inner

    def _post_build(self):
        self._is_grasping_peg = self.agent.build_grasp_checker(
            self.model, "peg", self.device, max_angle=20)

    def _default_extras(self, batch: int):
        return dict(peg_half_size=torch.zeros(batch, 3, device=self.device))

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        L = self._uniform(gen, (K, 1), *self.peg_len_range)
        r = self._uniform(gen, (K, 1), *self.peg_radius_range)
        peg_size = torch.cat([L, r, r], -1)
        ez = torch.zeros(K, 3, device=dev)
        ez[:, 2] = 1.0
        # the peg flat on the table, yaw in pi/2 +- pi/3
        peg_xy = self._uniform(gen, (K, 2), [-0.1, -0.3], [0.1, 0.0])
        peg_yaw = math.pi / 2 + self._uniform(gen, (K,), -math.pi / 3, math.pi / 3)
        peg_pose = torch.cat([peg_xy, r, quat_from_axis_angle(ez, peg_yaw)], -1)
        # the box on the far side, yaw in pi/2 +- pi/8
        box_xy = self._uniform(gen, (K, 2), [-0.05, 0.2], [0.05, 0.4])
        box_yaw = math.pi / 2 + self._uniform(gen, (K,), -math.pi / 8, math.pi / 8)
        box_pose = torch.cat([box_xy, torch.full((K, 1), self.peg_half_length, device=dev),
                              quat_from_axis_angle(ez, box_yaw)], -1)
        sim = state.sim
        free_pose, kin_pose, geom_size = (sim.free_pose.clone(), sim.kin_pose.clone(),
                                          sim.geom_size.clone())
        free_pose[:, self.peg] = peg_pose
        kin_pose[:, self.box] = box_pose
        geom_size[:, self.model.geom_indices("peg")[0]] = peg_size
        sim = sim.replace(free_pose=free_pose, free_vel=torch.zeros_like(sim.free_vel),
                          kin_pose=kin_pose, geom_size=geom_size)
        return state.replace(sim=sim, extras=dict(state.extras, peg_half_size=peg_size))

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact, for checks of the physics step: the
        peg's head 2-5 cm into the hole, its side 0.5 mm into the bottom
        wall and, in odd envs, also 0.5 mm into the side wall at +y (the
        hole's frame), and the peg held between the fingers 4 cm from its
        tail (damped least-squares IK: the TCP pointing down, the fingers
        closing across the peg, 0-1 mm into its sides). Joint velocities
        are random (0.02 rad/s), the peg moves into its walls at 5 cm/s, the
        arm holds its pose and the gripper shuts; one control step of the
        plain physics step then loads the warm-start impulses: the peg-wall
        box_box_onesided points carry force."""
        dev, sim = self.device, state.sim
        K = sim.qpos.shape[0]
        size = state.extras["peg_half_size"]
        L, r = size[:, 0], size[:, 1]
        inner = self.box_hole_radius
        box = Pose.from_raw(sim.kin_pose[:, self.box])
        depth = self._uniform(gen, (K,), 0.02, 0.05)
        head_x = -self.peg_half_length + depth
        side = (torch.arange(K, device=dev) % 2 == 1).to(r.dtype)
        p_hole = torch.stack([head_x - L, side * (inner - r + 5e-4),
                              -(inner - r + 5e-4)], -1)
        peg = Pose(box.p + quat_apply(box.q, p_hole), box.q)
        # the grasp: 4 cm from the tail (1 mm beyond its axis towards the
        # side wall, so that the grip presses it there), the TCP pointing
        # down, the fingers across the peg: the hand's yaw is the box's,
        # turned by half a turn into (-pi, 0]
        grip = peg.p + quat_apply(box.q, torch.stack([0.04 - L, side * 0.001, 0 * L], -1))
        yaw = 2.0 * torch.atan2(box.q[:, 3], box.q[:, 0])
        yaw = torch.where(yaw > 0, yaw - math.pi, yaw)
        ez = torch.zeros(K, 3, device=dev)
        ez[:, 2] = 1.0
        down = const(self, "tool_down", [0.0, 1.0, 0.0, 0.0], dev).expand(K, 4)
        q_goal = quat_mul(quat_from_axis_angle(ez, yaw), down)
        dz = self._uniform(gen, (K, 1), -0.012, -0.002)
        qpos = pose_ik(self, sim.qpos, grip + torch.cat([0 * dz, 0 * dz, dz], -1), q_goal)
        qpos[:, 7:9] = r[:, None] - self._uniform(gen, (K, 1), 0.0, 0.001)
        qvel = 0.02 * torch.randn(qpos.shape, generator=gen, device=dev)
        free_pose = sim.free_pose.clone()
        free_pose[:, self.peg] = torch.cat([peg.p, peg.q], -1)
        # the peg moving into its walls at 5 cm/s, so that the contacts hold
        # through the step
        free_vel = sim.free_vel.clone()
        free_vel[:, self.peg, :3] = quat_apply(box.q, torch.stack([0 * r, side, -1 + 0 * r], -1)
                                               * 0.05)
        free_vel[:, self.peg, 3:] = 0.0
        sim = sim.replace(qpos=qpos, qvel=qvel, free_pose=free_pose, free_vel=free_vel)
        target = qpos.clone()
        target[:, 7:9] = 0.0
        cmd = self.agent.controller.reset(qpos).replace(target_qpos=target)
        sim = make_step_fn(self.model)(sim, cmd, self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)

    # -- the geometry ------------------------------------------------------
    def _peg_head_pose(self, ctx) -> Pose:
        L = ctx.state.extras["peg_half_size"][..., :1]
        return ctx.actor_pose("peg") * Pose.translation(torch.cat([L, 0 * L, 0 * L], -1))

    def _box_hole_pose(self, ctx) -> Pose:
        return ctx.actor_pose("box_with_hole")  # the hole is centred

    def _goal_pose(self, ctx) -> Pose:
        hole = self._box_hole_pose(ctx)
        off = const(self, "goal_off", [-self.peg_half_length, 0.0, 0.0], hole.p.device)
        return hole * Pose.translation(off.expand_as(hole.p))

    def evaluate(self, state: EnvState, ctx: TaskContext):
        head_at_hole = (self._box_hole_pose(ctx).inv() * self._peg_head_pose(ctx)).p
        r = self.box_hole_radius
        success = ((head_at_hole[..., 0] >= -0.015) & (torch.abs(head_at_hole[..., 1]) <= r)
                   & (torch.abs(head_at_hole[..., 2]) <= r))
        return dict(success=success, peg_head_pos_at_hole=head_at_hole)

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if "state" in self.obs_mode:
            K = state.sim.qpos.shape[0]
            radius = const(self, "hole_radius", [self.box_hole_radius], state.sim.qpos.device)
            obs.update(peg_pose=ctx.actor_pose("peg").raw,
                       peg_half_size=state.extras["peg_half_size"],
                       box_hole_pose=self._box_hole_pose(ctx).raw,
                       box_hole_radius=radius.expand(K, 1))
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        peg = ctx.actor_pose("peg")
        # reach and grasp
        tgt_off = const(self, "grip_off", [-0.06, 0.0, 0.0], peg.p.device).expand_as(peg.p)
        tgt = peg * Pose.translation(tgt_off)
        reach = 1.0 - torch.tanh(4.0 * torch.linalg.norm(ctx.tcp_pose.p - tgt.p, dim=-1))
        is_grasped = self._is_grasping_peg(ctx.body_quat, ctx.contact_forces())
        grasped = is_grasped.to(reach.dtype)
        reward = reach + grasped
        # align the peg with the hole's axis
        goal_inv = self._goal_pose(ctx).inv()
        head = self._peg_head_pose(ctx)
        d_head = torch.linalg.norm((goal_inv * head).p[..., 1:], dim=-1)
        d_peg = torch.linalg.norm((goal_inv * peg).p[..., 1:], dim=-1)
        pre_insertion = 3.0 * (1.0 - torch.tanh(0.5 * (d_head + d_peg)
                                                + 4.5 * torch.maximum(d_head, d_peg)))
        reward = reward + pre_insertion * grasped
        pre_inserted = (d_head < 0.01) & (d_peg < 0.01)
        # insert
        head_in_hole = (self._box_hole_pose(ctx).inv() * head).p
        insertion = 5.0 * (1.0 - torch.tanh(5.0 * torch.linalg.norm(head_in_hole, dim=-1)))
        reward = reward + insertion * (is_grasped & pre_inserted).to(reward.dtype)
        return torch.where(info["success"], torch.full_like(reward, 10.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 10.0
