"""PickCube-v1.

Port of ``maniskill_tpu/envs/tasks/pick_cube.py``: same randomization
(cube xy ~ U[-0.1, 0.1]² with random yaw; goal xy ~ U[-0.1, 0.1]², z ~ cube
z + U[0, 0.3]), success (placed within ``goal_thresh`` and the robot
static), staged dense reward (reach → grasp → place → static, max 5) and
obs extras. ``is_grasped`` is the contact-force angle test.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..._consts import const
from ...kinematics import chain
from ...math.rotations import quat_apply, quat_conjugate, quat_from_axis_angle, quat_mul
from ...physics.engine import all_geom_poses, make_step_fn, robot_fk
from ...physics.model import SceneSpecBuilder, box_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from ..scene_builders import TABLE_HEIGHT, TableSceneBuilder


def grasp_qpos(env, qpos: torch.Tensor, cube: torch.Tensor,
               gen: torch.Generator, dz=None, tool=(0.0, 1.0, 0.0, 0.0), **ik) -> torch.Tensor:
    """``qpos`` with the arm moved so the TCP grasps the object at pose
    ``cube`` (K, 7) from above: damped least-squares IK puts the TCP on the
    object's vertical axis, pointing down, 2-12 mm below its centre (drawn
    from ``gen``; or ``dz`` (K,) metres above it, where given), with the
    fingers closing along the object's y axis, or its x axis where the yaw
    is folded by an odd number of quarter turns (``_closing_half``).
    ``tool``: the TCP's orientation before the yaw (default: its +z turned
    to world -z, pointing down). The gripper joints are left as they are;
    ``ik``: ``pose_ik``'s ``joints`` and ``ee_link`` (one arm of several)."""
    dev = env.device
    K = qpos.shape[0]
    # the object's yaw (reset objects are yaw-only) folded into
    # [-pi/4, pi/4]: a quarter turn keeps the wrist in range
    yaw, turns = _yaw_fold(cube)
    yaw = yaw - (math.pi / 2) * turns
    ez = torch.zeros(K, 3, device=dev)
    ez[:, 2] = 1.0
    q_goal = quat_mul(quat_from_axis_angle(ez, yaw), torch.tensor(tool, device=dev).expand(K, 4))
    if dz is None:
        dz = -0.012 + 0.01 * torch.rand((K,), generator=gen, device=dev)
    p_goal = cube[:, :3] + torch.stack(
        [torch.zeros(K, device=dev), torch.zeros(K, device=dev), dz], dim=-1)
    return pose_ik(env, qpos, p_goal, q_goal, **ik)


def pose_ik(env, qpos: torch.Tensor, p_goal: torch.Tensor, q_goal: torch.Tensor,
            joints=range(7), iters: int = 30, ee_link=None) -> torch.Tensor:
    """``qpos`` with the ``joints`` moved (damped least squares, steps of
    at most 0.2 rad, within the joint limits) so that the TCP (the frame
    ``ee_link``, by default the agent's) reaches the world pose
    ``(p_goal (K, 3), q_goal (K, 4))``; 30 steps bring a reachable goal
    within ~1e-6 m."""
    model, spec, dev = env.model, env.model.robot, env.device
    base = const(model, "robot_base_pose", model.robot_base_pose, dev)
    ee_link = env.agent.ee_link_name if ee_link is None else ee_link
    tcp = spec.frame_of(ee_link)[0]
    arm = np.asarray(joints)
    idx = torch.as_tensor(arm, device=dev)
    qlim = torch.as_tensor(model.robot_qlim, device=dev)
    qpos = qpos.clone()
    for _ in range(iters):
        body_pos, body_quat, axis_w = chain.fk(spec, base, qpos)
        p, q = chain.frame_pose(spec, base, body_pos, body_quat, ee_link)
        q_err = quat_mul(q_goal, quat_conjugate(q))
        w_err = 2.0 * torch.sign(q_err[:, :1]) * q_err[:, 1:]
        err = torch.cat([w_err, p_goal - p], dim=-1)
        J = chain.point_jacobian(spec, body_pos, axis_w, p, tcp, arm,
                                 model.ancestor_mask)  # (K, 6, n)
        dq = chain.dls_ik_delta(J, err, damping=0.01)
        qpos[:, idx] = torch.clamp(qpos[:, idx] + dq.clamp(-0.2, 0.2),
                                   qlim[idx, 0], qlim[idx, 1])
    return qpos


def box_corners(model, qpos: torch.Tensor, geoms) -> torch.Tensor:
    """(K, 8 len(geoms), 3) world corners of the box geoms ``geoms`` (robot
    links, at their model sizes and offsets) at ``qpos``."""
    sim = model.initial_state(qpos.shape[0], qpos.device).replace(qpos=qpos)
    body_pos, body_quat, _ = robot_fk(model, qpos)
    gp, gq = all_geom_poses(model, sim, body_pos, body_quat)
    signs = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                         dtype=qpos.dtype, device=qpos.device)
    return torch.cat([gp[:, g, None] + quat_apply(gq[:, g, None].expand(-1, 8, 4),
                                                  signs * sim.geom_size[:, g, None])
                      for g in geoms], dim=1)


def _yaw_fold(pose: torch.Tensor):
    """Yaw of yaw-only poses (K, 7) and its nearest number of quarter turns."""
    yaw = 2.0 * torch.atan2(pose[:, 6], pose[:, 3])
    return yaw, torch.round(yaw / (math.pi / 2))


def _closing_half(pose: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """(K, 1) half extent of an object with AABB half extents ``half``
    (K, 3) along the fingers' closing direction of ``grasp_qpos``: its y
    axis, or its x axis after an odd number of quarter turns."""
    odd = torch.remainder(_yaw_fold(pose)[1], 2) != 0
    return torch.where(odd, half[:, 0], half[:, 1])[:, None]


@register_env("PickCube-v1", max_episode_steps=50)
class PickCubeEnv(BaseEnv):
    DEFAULT_ROBOT = "panda"

    cube_half_size = 0.02
    goal_thresh = 0.025

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, qpos = self.table_scene.robot_pose_and_qpos(self.robot_uids)
        self.agent.install(builder, pose, init_qpos=qpos)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        half = self.cube_half_size
        m = 1000.0 * (2 * half) ** 3
        inertia = (2.0 / 3.0) * m * half * half * np.eye(3)
        self.cube = builder.add_free_body("cube", m, inertia, [box_geom([half] * 3)])
        self.goal_site = builder.add_kinematic_body("goal_site")

    def _post_build(self):
        self._is_grasping = self.agent.build_grasp_checker(self.model, "cube", self.device)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        half = self.cube_half_size

        xy = self._uniform(gen, (K, 2), -0.1, 0.1)
        yaw = self._uniform(gen, (K,), -math.pi, math.pi)
        ez = torch.zeros(K, 3, device=dev)
        ez[:, 2] = 1.0
        q = quat_from_axis_angle(ez, yaw)
        cube_pose = torch.cat([xy, torch.full((K, 1), half, device=dev), q], dim=-1)
        goal_xy = self._uniform(gen, (K, 2), -0.1, 0.1)
        goal_z = self._uniform(gen, (K, 1), 0.0, 0.3) + half
        goal_q = torch.zeros(K, 4, device=dev)
        goal_q[:, 0] = 1.0
        goal_pose = torch.cat([goal_xy, goal_z, goal_q], dim=-1)
        free_pose = state.sim.free_pose.clone()
        free_vel = state.sim.free_vel.clone()
        kin_pose = state.sim.kin_pose.clone()
        free_pose[:, self.cube] = cube_pose
        free_vel[:, self.cube] = 0.0
        kin_pose[:, self.goal_site] = goal_pose
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=free_vel, kin_pose=kin_pose))

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact: the cube held between the fingers.

        Damped least-squares IK puts the TCP on the cube (pointing down, 2-12
        mm below its centre, so the fingertips reach within the contact
        margin of the table, fingers across two faces) and the fingers close
        0-1 mm into it, sized by each env's own object (``geom_size``: its
        AABB half extents). Every fourth env instead drops its cube on the
        floor beyond the table's far edge. Joint and cube velocities are
        random, the arm holds its pose and the gripper shuts; one control
        step of the plain physics step then loads the warm-start impulses.
        Points of all three pair functions (finger-cube, finger-table,
        cube-table, cube-floor) carry force, with friction, from such
        states, so checks of the physics step start from them."""
        dev = self.device
        sim = state.sim
        K = sim.qpos.shape[0]

        held = getattr(self, "held_body", "cube")  # the free body grasped
        body = self.model.free_index[held]
        half = sim.geom_size[:, self.model.geom_indices(held)[0]]  # (K, 3)
        pose = sim.free_pose[:, body]
        qpos = grasp_qpos(self, sim.qpos, pose, gen)
        width = _closing_half(pose, half)
        qpos[:, 7:9] = self._uniform(gen, (K, 1), width - 0.001, width)
        qvel = 0.1 * torch.randn(qpos.shape, generator=gen, device=dev)
        free_vel = sim.free_vel.clone()
        free_vel[:, body] = 0.05 * torch.randn(
            (K, 6), generator=gen, device=dev)
        free_pose = sim.free_pose.clone()
        floor = torch.arange(K, device=dev) % 4 == 3
        table = TableSceneBuilder
        free_pose[floor, body, 0] = float(table.TABLE_CENTER[0] + table.TABLE_HALF[0]) + 0.1
        free_pose[floor, body, 2] = half[floor, 2] - TABLE_HEIGHT
        sim = sim.replace(qpos=qpos, qvel=qvel, free_pose=free_pose, free_vel=free_vel)
        target = qpos.clone()
        target[:, 7:9] = 0.0  # the arm holds its pose, the gripper shuts
        cmd = self.agent.controller.reset(qpos).replace(target_qpos=target)
        sim = make_step_fn(self.model)(sim, cmd, self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)

    def evaluate(self, state: EnvState, ctx: TaskContext):
        cube_p = ctx.actor_pose("cube").p
        goal_p = ctx.actor_pose("goal_site").p
        is_obj_placed = torch.linalg.norm(goal_p - cube_p, dim=-1) <= self.goal_thresh
        is_grasped = self._is_grasping(ctx.body_quat, ctx.contact_forces())
        is_robot_static = self.agent.is_static(state.sim.qvel, 0.2)
        return dict(success=is_obj_placed & is_robot_static,
                    is_obj_placed=is_obj_placed,
                    is_robot_static=is_robot_static,
                    is_grasped=is_grasped)

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = dict(is_grasped=info["is_grasped"], tcp_pose=ctx.tcp_pose.raw,
                   goal_pos=ctx.actor_pose("goal_site").p)
        if "state" in self.obs_mode:
            cube = ctx.actor_pose("cube")
            obs.update(obj_pose=cube.raw,
                       tcp_to_obj_pos=cube.p - ctx.tcp_pose.p,
                       obj_to_goal_pos=ctx.actor_pose("goal_site").p - cube.p)
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        cube_p = ctx.actor_pose("cube").p
        goal_p = ctx.actor_pose("goal_site").p
        tcp_to_obj_dist = torch.linalg.norm(cube_p - ctx.tcp_pose.p, dim=-1)
        reward = 1.0 - torch.tanh(5.0 * tcp_to_obj_dist)
        is_grasped = info["is_grasped"].to(torch.float32)
        reward = reward + is_grasped
        obj_to_goal_dist = torch.linalg.norm(goal_p - cube_p, dim=-1)
        reward = reward + (1.0 - torch.tanh(5.0 * obj_to_goal_dist)) * is_grasped
        qvel_arm = state.sim.qvel[..., :-2]  # excludes the gripper
        static_reward = 1.0 - torch.tanh(5.0 * torch.linalg.norm(qvel_arm, dim=-1))
        reward = reward + static_reward * info["is_obj_placed"].to(torch.float32)
        return torch.where(info["success"], torch.full_like(reward, 5.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 5.0
