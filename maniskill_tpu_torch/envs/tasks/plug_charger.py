"""PlugCharger-v1.

Port of ``maniskill_tpu/envs/tasks/plug_charger.py``: a charger (a base box
and two capsule prongs along its +x axis, one free body of three offset
geoms, density-1000 mass over the whole charger's box) is plugged into a
receptacle of five static wall boxes around two slots. Same scene
(``_load_scene``: prong radius 2.5 mm, length 16 mm, 0.5 mm clearance, wall
at x = 0.13, z = 0.12; the receptacle excluded against the table and the
ground), 2.5 ms substeps (``SimParams(substeps=4)``), the reset draw (xy in
[-0.12, -0.03] x [-0.2, 0.2], yaw in [-pi/6, pi/6]), success (within 5 mm
and 0.2 rad of the inserted pose), state obs and the dense reward (reach,
grasp, align; 6 on success) with its normalized form. The robot is
``panda_wristcam``.

As in the JAX scene, the charger's two prongs form a ``capsule_capsule``
pair of one body with itself: 14 mm apart at 2.5 mm radius, never loaded,
and its Jacobian columns cancel (ROADMAP Queue C).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...math import clamps
from ...math.rotations import quat_conjugate, quat_from_axis_angle, quat_mul
from ...physics.engine import make_step_fn
from ...physics.model import SceneSpecBuilder, SimParams, box_geom, capsule_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from ..scene_builders import TABLE_HEIGHT, TableSceneBuilder
from .pick_cube import grasp_qpos


@register_env("PlugCharger-v1", max_episode_steps=100)
class PlugChargerEnv(BaseEnv):
    DEFAULT_ROBOT = "panda_wristcam"

    _base_size = (2e-2, 1.5e-2, 1.2e-2)
    _peg_radius = 2.5e-3
    _peg_len = 1.6e-2  # full prong length, tip to tip
    _peg_gap = 7e-3  # half distance between the prongs
    _clearance = 5e-4  # slot half height minus prong radius
    _receptacle_size = (1e-2, 5e-2, 5e-2)

    def _sim_params(self) -> SimParams:
        # millimetre clearances: 2.5 ms substeps (JAX __init__)
        return SimParams(dt=1.0 / self.SIM_FREQ, substeps=4)

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, qpos = self.table_scene.robot_pose_and_qpos(self.robot_uids)
        self.agent.install(builder, pose, init_qpos=qpos)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        bs = self._base_size
        r, plen = self._peg_radius, self._peg_len
        # density-1000 mass properties over the charger's bounding box
        hx = bs[0] + plen / 2
        m = 1000.0 * 8 * hx * bs[1] * bs[2]
        inertia = (m / 3.0) * np.diag([bs[1] ** 2 + bs[2] ** 2, hx ** 2 + bs[2] ** 2,
                                       hx ** 2 + bs[1] ** 2])
        # prongs along +x: the capsule's +z axis turned 90 deg about y
        xq = (np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0)
        hl = plen / 2 - r  # segment half length (tip to tip = plen)
        px = bs[0] + plen / 2  # prong centre, from the base centre
        self.charger = builder.add_free_body("charger", m, inertia, [
            box_geom(bs, friction=0.8),
            capsule_geom(r, hl, offset_p=(px, self._peg_gap, 0.0), offset_q=xq, friction=0.5),
            capsule_geom(r, hl, offset_p=(px, -self._peg_gap, 0.0), offset_q=xq, friction=0.5),
        ])
        # receptacle: a wall plate facing -x with two slots (prong + clearance),
        # five static boxes: above, below, left, middle, right
        rs = self._receptacle_size
        sy = sz = r + self._clearance
        cy = self._peg_gap
        wall_x, wall_z = 0.13, 0.12
        self._recep_pose = np.array([wall_x, 0.0, wall_z, 1, 0, 0, 0], np.float32)
        y_top = rs[1]
        walls = [
            ((0.0, 0.0, (sz + rs[2]) / 2 + 0.0), (rs[0], rs[1], (rs[2] - sz) / 2)),
            ((0.0, 0.0, -(sz + rs[2]) / 2), (rs[0], rs[1], (rs[2] - sz) / 2)),
            ((0.0, (cy + sy + y_top) / 2, 0.0), (rs[0], (y_top - cy - sy) / 2, sz)),
            ((0.0, 0.0, 0.0), (rs[0], cy - sy, sz)),
            ((0.0, -(cy + sy + y_top) / 2, 0.0), (rs[0], (y_top - cy - sy) / 2, sz)),
        ]
        builder.add_static_body("receptacle", self._recep_pose,
                                [box_geom(half, offset_p=off, friction=0.4)
                                 for (off, half) in walls])
        builder.exclude_groups(["receptacle"], ["table-workspace", "ground"])

    def _post_build(self):
        self._is_grasping = self.agent.build_grasp_checker(self.model, "charger", self.device)
        # goal: the prongs fully inserted, the base flush with the wall's -x face
        gx = self._recep_pose[0] - self._receptacle_size[0] - self._base_size[0]
        self._goal_pose = np.array([gx, 0.0, self._recep_pose[2], 1, 0, 0, 0], np.float32)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        lo = torch.tensor([-0.12, -0.2], device=dev)
        hi = torch.tensor([-0.03, 0.2], device=dev)
        xy = lo + (hi - lo) * torch.rand((K, 2), generator=gen, device=dev)
        yaw = self._uniform(gen, (K,), -math.pi / 6, math.pi / 6)
        up = torch.zeros(K, 3, device=dev)
        up[:, 2] = 1.0
        pose = torch.cat([xy, torch.full((K, 1), self._base_size[2], device=dev),
                          quat_from_axis_angle(up, yaw)], dim=-1)
        free_pose = state.sim.free_pose.clone()
        free_pose[:, self.charger] = pose
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=torch.zeros_like(state.sim.free_vel)))

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact, for checks of the physics step; by
        env index modulo 4:

        0. the charger held across its base (``box_box_corners``) at the
           inserted pose, 0.3-1 mm back and 0.5-1.5 mm lower, so that both
           prongs press their slot's floor (``capsule_box`` against a
           receptacle wall);
        1. the charger on the table turned a quarter turn and held
           lengthwise: one finger on the base's back face
           (``box_box_corners``), the other on both prong tips
           (``capsule_box`` against a finger);
        2. the charger on the table held across its base, as
           ``PickCubeEnv.contact_state`` grasps a cube;
        3. the charger on the floor beyond the table's far edge: standing
           nose down on its prong tips, at rest and balanced
           (``plane_capsule``), where the index modulo 8 is 3; lying flat
           (``plane_box``) where it is 7.

        The grasps put the TCP on the middle of the held span, pointing
        down, within 1.5 mm of the charger's centre height (the finger pads
        then lie within the base's height, and on the table the fingertips
        1-4 mm above it, within the contact margin) and close the fingers
        0-1 mm into the charger. Joint and charger velocities are random
        (but for the balanced charger); the arm holds its pose (over the
        slots its target is 2 mm lower) and the gripper shuts. One control
        step of the plain physics step then loads the warm-start impulses."""
        dev = self.device
        sim = state.sim
        K = sim.qpos.shape[0]
        idx = torch.arange(K, device=dev)
        group = idx % 4
        bs, r, plen = self._base_size, self._peg_radius, self._peg_len
        up = torch.zeros(K, 3, device=dev)
        up[:, 2] = 1.0
        ey = torch.zeros(K, 3, device=dev)
        ey[:, 1] = 1.0
        pose = sim.free_pose[:, self.charger].clone()
        yaw = 2.0 * torch.atan2(pose[:, 6], pose[:, 3])
        # 0: in the slots, resting on their floors
        slot = torch.as_tensor(self._goal_pose, device=dev).expand(K, 7).clone()
        slot[:, 0] -= self._uniform(gen, (K,), 3e-4, 1e-3)
        slot[:, 2] -= self._clearance + self._uniform(gen, (K,), 0.0, 1e-3)
        # 1: a quarter turn, so that the fingers close along the charger's x
        turned = pose.clone()
        turned[:, 3:7] = quat_from_axis_angle(up, yaw + math.pi / 2)
        # 3: on the floor; nose down (the prongs' far spheres lowest, their
        # centres bs0 + plen - r ahead of the body's centre) or flat
        table = TableSceneBuilder
        nose = idx % 8 == 3
        floor = pose.clone()
        floor[:, 0] = float(table.TABLE_CENTER[0] + table.TABLE_HALF[0]) + 0.1
        floor[:, 2] = torch.where(nose, bs[0] + plen, bs[2]) - TABLE_HEIGHT
        down = quat_mul(quat_from_axis_angle(up, yaw),
                        quat_from_axis_angle(ey, torch.full((K,), math.pi / 2, device=dev)))
        floor[:, 3:7] = torch.where(nose[:, None], down, pose[:, 3:7])
        new_pose = torch.where((group == 0)[:, None], slot, pose)
        new_pose = torch.where((group == 1)[:, None], turned, new_pose)
        new_pose = torch.where((group == 3)[:, None], floor, new_pose)
        # the grasps; group 1 holds the span from the base's back face to
        # the prong tips (-bs0 to bs0 + plen along the charger's x), centred
        # plen / 2 ahead of the body's centre
        along = torch.where(group == 1, plen / 2, 0.0)
        target = new_pose.clone()
        target[:, 0] += along * torch.cos(yaw + math.pi / 2)
        target[:, 1] += along * torch.sin(yaw + math.pi / 2)
        half_span = torch.where(group == 1, bs[0] + plen / 2, bs[1])[:, None]
        # the pads (18.4 mm tall, centred 0.2 mm below the TCP) within the
        # base's 24 mm height: the TCP within 1.5 mm of the charger's centre
        dz = self._uniform(gen, (K,), -1.5e-3, 1.5e-3)
        qpos = grasp_qpos(self, sim.qpos, target, gen, dz=dz)
        qpos[:, 7:9] = half_span - self._uniform(gen, (K, 1), 0.0, 0.001)
        grasp = group != 3
        qpos = torch.where(grasp[:, None], qpos, sim.qpos)
        qvel = 0.1 * torch.randn(qpos.shape, generator=gen, device=dev)
        free_vel = 0.05 * torch.randn(sim.free_vel.shape, generator=gen, device=dev)
        free_vel[:, self.charger] *= (~nose).to(free_vel.dtype)[:, None]  # balanced at rest
        free_pose = sim.free_pose.clone()
        free_pose[:, self.charger] = new_pose
        sim = sim.replace(qpos=qpos, qvel=qvel, free_pose=free_pose, free_vel=free_vel)
        # the arm holds its pose, but over the slots its target is 2 mm
        # lower, so that the prongs stay pressed on the slots' floors
        lower = grasp_qpos(self, qpos, target, gen, dz=dz - 0.002)
        target_q = torch.where((group == 0)[:, None], lower, qpos)
        target_q[:, 7:9] = torch.where(grasp[:, None], torch.zeros_like(qpos[:, 7:9]),
                                       qpos[:, 7:9])
        cmd = self.agent.controller.reset(qpos).replace(target_qpos=target_q)
        sim = make_step_fn(self.model)(sim, cmd, self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)

    def _pose_err(self, state: EnvState):
        p = state.sim.free_pose[:, self.charger]
        goal = torch.as_tensor(self._goal_pose, device=p.device, dtype=p.dtype)
        dist = torch.linalg.norm(p[:, :3] - goal[:3], dim=-1)
        dq = quat_mul(quat_conjugate(goal[3:7]).expand_as(p[:, 3:7]), p[:, 3:7])
        angle = 2.0 * torch.arccos(clamps.clip(clamps.abs(dq[:, 0]), 0.0, 1.0))
        return dist, angle

    def evaluate(self, state: EnvState, ctx: TaskContext):
        dist, angle = self._pose_err(state)
        return dict(success=(dist <= 5e-3) & (angle <= 0.2),
                    obj_to_goal_dist=dist, obj_to_goal_angle=angle,
                    is_grasped=self._is_grasping(ctx.body_quat, ctx.contact_forces()))

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        K = state.sim.qpos.shape[0]
        goal = torch.as_tensor(self._goal_pose, device=state.sim.qpos.device)
        obs = dict(tcp_pose=ctx.tcp_pose.raw, goal_pose=goal.expand(K, 7))
        if "state" in self.obs_mode:
            obs.update(charger_pose=ctx.actor_pose("charger").raw)
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        charger = ctx.actor_pose("charger").p
        reach = 1.0 - torch.tanh(5.0 * torch.linalg.norm(ctx.tcp_pose.p - charger, dim=-1))
        grasped = info["is_grasped"].to(charger.dtype)
        dist, angle = self._pose_err(state)
        align = 1.0 - torch.tanh(5.0 * dist + angle)
        reward = reach + grasped + 2.0 * grasped * align
        return torch.where(info["success"], torch.full_like(reward, 6.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 6.0
