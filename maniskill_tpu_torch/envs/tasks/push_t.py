"""PushT-v1: push a T-shaped block into a goal T with the Panda's stick.

Port of ``maniskill_tpu/envs/tasks/push_t.py``: the T is two boxes (a bar
and a stem) on one free body with its centre of mass at the origin, the
goal T a kinematic body at (-0.156, -0.1) with yaw 5π/3; the T spawns in a
box around the goal with a random yaw. Success: the share of the T's area
over the goal T of at least 0.9, measured on a static grid of 512 points
covering the T in its own frame (``_t_sample_points``), carried into the
goal's frame and tested against its two boxes (``_points_in_t``). The
dense reward is the JAX task's pose-based one (yaw, xy distance, the
stick's reach).

The bar and the stem pair with each other (one free body's two geoms, as
PlugCharger's charger: mirrored from the JAX model builder); their
Jacobian columns cancel, so the pair moves nothing.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..._consts import const
from ...math.rotations import quat_apply, quat_conjugate, quat_from_axis_angle
from ...physics.engine import make_step_fn
from ...physics.model import SceneSpecBuilder, box_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from ..scene_builders import TableSceneBuilder
from .pick_cube import pose_ik

# the T: a horizontal bar and a stem hanging flush below it, both shifted
# so that the centre of mass is at the origin
_BAR_HALF = np.array([0.1, 0.025])
_STEM_HALF = np.array([0.025, 0.075])
_A1 = 4 * _BAR_HALF[0] * _BAR_HALF[1]
_A2 = 4 * _STEM_HALF[0] * _STEM_HALF[1]
_STEM_CY = -_BAR_HALF[1] - _STEM_HALF[1]
_COM_Y = (_A2 * _STEM_CY) / (_A1 + _A2)
_BAR_OFF = np.array([0.0, -_COM_Y])
_STEM_OFF = np.array([0.0, _STEM_CY - _COM_Y])
_HALF_T = 0.02  # half thickness


def _t_sample_points(n_per_box: int = 16) -> np.ndarray:
    """(2 n², 2) points covering the T in its local frame: the centres of
    an n x n grid of cells over each box (strictly inside, so the T at the
    goal pose scores 1.0)."""
    pts = []
    for half, off in ((_BAR_HALF, _BAR_OFF), (_STEM_HALF, _STEM_OFF)):
        xs = ((np.arange(n_per_box) + 0.5) / n_per_box) * 2 * half[0] - half[0]
        ys = ((np.arange(n_per_box) + 0.5) / n_per_box) * 2 * half[1] - half[1]
        pts.append(np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2) + off)
    return np.concatenate(pts).astype(np.float32)


def _points_in_t(pts: torch.Tensor) -> torch.Tensor:
    """(..., N) bool: which local-frame points ``pts`` (..., N, 2) lie in
    the T (its boundary widened by 1e-5)."""
    def in_box(half, off):
        d = torch.abs(pts - torch.as_tensor(off, dtype=pts.dtype, device=pts.device))
        return (d[..., 0] <= half[0] + 1e-5) & (d[..., 1] <= half[1] + 1e-5)

    return in_box(_BAR_HALF, _BAR_OFF) | in_box(_STEM_HALF, _STEM_OFF)


@register_env("PushT-v1", max_episode_steps=100)
class PushTEnv(BaseEnv):
    DEFAULT_ROBOT = "panda_stick"

    goal_offset = np.array([-0.156, -0.1])
    goal_z_rot = (5 / 3) * np.pi
    intersection_thresh = 0.90

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, _ = self.table_scene.robot_pose_and_qpos("panda")
        self.agent.install(builder, pose)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        m = 1000.0 * (_A1 + _A2) * 2 * _HALF_T
        # the bounding box's inertia about the centre of mass
        hx, hy, hz = 0.1, 0.1, _HALF_T
        inertia = m / 3.0 * np.diag([hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy])
        self.tee = builder.add_free_body("tee", m, inertia, [
            box_geom([_BAR_HALF[0], _BAR_HALF[1], _HALF_T], offset_p=[_BAR_OFF[0], _BAR_OFF[1], 0]),
            box_geom([_STEM_HALF[0], _STEM_HALF[1], _HALF_T],
                     offset_p=[_STEM_OFF[0], _STEM_OFF[1], 0])])
        self.goal_tee = builder.add_kinematic_body("goal_tee")
        self._t_pts = _t_sample_points()

    def _ez(self, K):
        ez = torch.zeros(K, 3, device=self.device)
        ez[:, 2] = 1.0
        return ez

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        ez = self._ez(K)
        goal = torch.cat([const(self, "goal_p", [*self.goal_offset, 1e-3], dev).expand(K, 3),
                          quat_from_axis_angle(ez, torch.full((K,), self.goal_z_rot, device=dev))],
                         -1)
        # the T's spawn box around the goal
        x = self.goal_offset[0] + self._uniform(gen, (K,), -0.1, 0.1)
        y = self.goal_offset[1] + self._uniform(gen, (K,), -0.1, 0.2)
        yaw = self._uniform(gen, (K,), 0.0, 2 * math.pi)
        tee = torch.cat([torch.stack([x, y, torch.full_like(x, _HALF_T + 1e-3)], -1),
                         quat_from_axis_angle(ez, yaw)], -1)
        free_pose, kin_pose = state.sim.free_pose.clone(), state.sim.kin_pose.clone()
        free_pose[:, self.tee] = tee
        kin_pose[:, self.goal_tee] = goal
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=torch.zeros_like(state.sim.free_vel),
            kin_pose=kin_pose))

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact, for checks of the physics step: the
        T rests 0-0.5 mm into the table, and the stick, pointing down (IK),
        presses 0.5-1.5 mm into a side of the T's bar (even envs: its far
        long side, 2-10 mm above its bottom) or 1-2 mm into the tabletop
        beside the T (odd envs); small random joint and T velocities, the
        arm holding its pose; one control step of the plain physics step
        then loads the warm-start impulses."""
        dev, sim = self.device, state.sim
        K = sim.qpos.shape[0]
        tee = sim.free_pose[:, self.tee].clone()
        tee[:, 2] = _HALF_T - self._uniform(gen, (K,), 0.0, 5e-4)
        r = 0.008 - self._uniform(gen, (K,), 5e-4, 1.5e-3)  # stick axis to the face
        along = self._uniform(gen, (K,), -0.08, 0.08)
        local = torch.stack([along, torch.full_like(along, _BAR_OFF[1] + _BAR_HALF[1]) + r,
                             torch.zeros_like(along)], -1)
        side = tee[:, :3] + quat_apply(tee[:, 3:], local)
        side[:, 2] = self._uniform(gen, (K,), 0.002, 0.01)
        table = tee[:, :3] + quat_apply(tee[:, 3:], local + torch.tensor([0.0, 0.06, 0.0],
                                                                         device=dev))
        table[:, 2] = -self._uniform(gen, (K,), 1e-3, 2e-3)
        odd = (torch.arange(K, device=dev) % 2 == 1)[:, None]
        p_goal = torch.where(odd, table, side)
        down = torch.tensor([0.0, 1.0, 0.0, 0.0], device=dev).expand(K, 4)
        qpos = pose_ik(self, sim.qpos, p_goal, down)
        qvel = 0.02 * torch.randn(qpos.shape, generator=gen, device=dev)
        free_pose = sim.free_pose.clone()
        free_pose[:, self.tee] = tee
        free_vel = 0.01 * torch.randn(sim.free_vel.shape, generator=gen, device=dev)
        cmd = self.agent.controller.reset(qpos)
        sim = sim.replace(qpos=qpos, qvel=qvel, free_pose=free_pose, free_vel=free_vel)
        sim = make_step_fn(self.model)(sim, cmd, self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)

    def _intersection(self, ctx: TaskContext) -> torch.Tensor:
        """(K,) share of the T's sample points over the goal T."""
        tee, goal = ctx.actor_pose("tee"), ctx.actor_pose("goal_tee")
        pts = const(self, "t_pts", np.concatenate(
            [self._t_pts, np.zeros((len(self._t_pts), 1), np.float32)], -1), self.device)
        K, N = tee.p.shape[0], pts.shape[0]
        world = tee.p[:, None] + quat_apply(tee.q[:, None].expand(K, N, 4), pts.expand(K, N, 3))
        local = quat_apply(quat_conjugate(goal.q)[:, None].expand(K, N, 4),
                           world - goal.p[:, None])
        return _points_in_t(local[..., :2]).to(torch.float32).mean(-1)

    def _z_euler(self, q):
        x_axis = const(self, "ex", [1.0, 0.0, 0.0], q.device).expand(q.shape[0], 3)
        v = quat_apply(q, x_axis)
        return torch.atan2(v[:, 1], v[:, 0])

    def evaluate(self, state: EnvState, ctx: TaskContext):
        inter = self._intersection(ctx)
        return dict(success=inter >= self.intersection_thresh, intersection=inter)

    def _get_obs_extra(self, state, ctx, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if "state" in self.obs_mode:
            obs.update(goal_pos=ctx.actor_pose("goal_tee").p, obj_pose=ctx.actor_pose("tee").raw)
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        tee = ctx.actor_pose("tee")
        rot = torch.cos(self._z_euler(tee.q) - self.goal_z_rot)
        reward = (((rot + 1.0) / 2.0) ** 2) / 2.0
        d = torch.linalg.norm(tee.p[:, :2] - ctx.actor_pose("goal_tee").p[:, :2], dim=-1)
        reward = reward + ((1.0 - torch.tanh(5.0 * d)) ** 2) / 2.0
        tcp_d = torch.linalg.norm(tee.p - ctx.tcp_pose.p, dim=-1)
        reward = reward + torch.sqrt(1.0 - torch.tanh(5.0 * tcp_d) + 1e-12) / 20.0
        return torch.where(info["success"], torch.full_like(reward, 3.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 3.0
