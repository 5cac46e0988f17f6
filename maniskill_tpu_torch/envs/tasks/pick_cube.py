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
from ...math.rotations import quat_conjugate, quat_from_axis_angle, quat_mul
from ...physics.engine import make_step_fn
from ...physics.model import SceneSpecBuilder, box_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from ..scene_builders import TABLE_HEIGHT, TableSceneBuilder


def grasp_qpos(env, qpos: torch.Tensor, cube: torch.Tensor,
               gen: torch.Generator) -> torch.Tensor:
    """``qpos`` with the arm moved so the TCP grasps a 2 cm cube at pose
    ``cube`` (K, 7) from above: damped least-squares IK puts the TCP on the
    cube's axis, pointing down, 2-12 mm below its centre (drawn from
    ``gen``), with the fingers across two faces. The gripper joints are
    left as they are."""
    model, spec, dev = env.model, env.model.robot, env.device
    K = qpos.shape[0]
    base = const(model, "robot_base_pose", model.robot_base_pose, dev)
    tcp = spec.frame_of(env.agent.ee_link_name)[0]
    arm = np.arange(7)
    qlim = torch.as_tensor(model.robot_qlim, device=dev)
    # the cube's yaw (reset cubes are yaw-only) folded into [-pi/4, pi/4]:
    # a quarter turn maps the cube onto itself and keeps the wrist in range
    yaw = 2.0 * torch.atan2(cube[:, 6], cube[:, 3])
    yaw = yaw - (math.pi / 2) * torch.round(yaw / (math.pi / 2))
    ez = torch.zeros(K, 3, device=dev)
    ez[:, 2] = 1.0
    down = torch.tensor([0.0, 1.0, 0.0, 0.0], device=dev)  # TCP +z -> world -z
    q_goal = quat_mul(quat_from_axis_angle(ez, yaw), down.expand(K, 4))
    dz = -0.012 + 0.01 * torch.rand((K,), generator=gen, device=dev)
    p_goal = cube[:, :3] + torch.stack(
        [torch.zeros(K, device=dev), torch.zeros(K, device=dev), dz], dim=-1)
    qpos = qpos.clone()
    eye = 1e-4 * torch.eye(6, device=dev)
    for _ in range(30):  # converges to ~1e-6 m in about 20 steps
        body_pos, body_quat, axis_w = chain.fk(spec, base, qpos)
        p, q = chain.frame_pose(spec, base, body_pos, body_quat, env.agent.ee_link_name)
        q_err = quat_mul(q_goal, quat_conjugate(q))
        w_err = 2.0 * torch.sign(q_err[:, :1]) * q_err[:, 1:]
        err = torch.cat([w_err, p_goal - p], dim=-1)
        J = chain.point_jacobian(spec, body_pos, axis_w, p, tcp, arm,
                                 model.ancestor_mask)  # (K, 6, 7)
        dq = J.transpose(1, 2) @ torch.linalg.solve(
            J @ J.transpose(1, 2) + eye, err[..., None])
        qpos[:, :7] = torch.clamp(qpos[:, :7] + dq[..., 0].clamp(-0.2, 0.2),
                                  qlim[:7, 0], qlim[:7, 1])
    return qpos


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

        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

        xy = uniform((K, 2), -0.1, 0.1)
        yaw = uniform((K,), -math.pi, math.pi)
        ez = torch.zeros(K, 3, device=dev)
        ez[:, 2] = 1.0
        q = quat_from_axis_angle(ez, yaw)
        cube_pose = torch.cat([xy, torch.full((K, 1), half, device=dev), q], dim=-1)
        goal_xy = uniform((K, 2), -0.1, 0.1)
        goal_z = uniform((K, 1), 0.0, 0.3) + half
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
        0-1 mm into it. Every fourth env instead drops its cube on the floor
        beyond the table's far edge. Joint and cube velocities are random,
        the arm holds its pose and the gripper shuts; one control step of
        the plain physics step then loads the warm-start impulses. Points of
        all three pair functions (finger-cube, finger-table, cube-table,
        cube-floor) carry force, with friction, from such states, so checks
        of the physics step start from them."""
        dev = self.device
        sim = state.sim
        K = sim.qpos.shape[0]

        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

        qpos = grasp_qpos(self, sim.qpos, sim.free_pose[:, self.cube], gen)
        qpos[:, 7:9] = uniform((K, 1), self.cube_half_size - 0.001,
                               self.cube_half_size)
        qvel = 0.1 * torch.randn(qpos.shape, generator=gen, device=dev)
        free_vel = sim.free_vel.clone()
        free_vel[:, self.cube] = 0.05 * torch.randn(
            (K, 6), generator=gen, device=dev)
        free_pose = sim.free_pose.clone()
        floor = torch.arange(K, device=dev) % 4 == 3
        table = TableSceneBuilder
        free_pose[floor, self.cube, 0] = float(table.TABLE_CENTER[0] + table.TABLE_HALF[0]) + 0.1
        free_pose[floor, self.cube, 2] = self.cube_half_size - TABLE_HEIGHT
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
