"""The two-robot tabletop tasks: two Pandas in one scene.

Port of ``maniskill_tpu/envs/tasks/two_robot.py``. Two Pandas stand side by
side at y = -0.35 (agent 0, the left arm) and y = +0.35 (agent 1), merged
into one kinematic forest (``agents/multi_agent.py``); the flat action is
the left arm's 8 then the right arm's 8.

- ``TwoRobotPushCube-v1``: each arm pushes its own cube into one goal
  region on the table; success is both cubes in it.
- ``TwoRobotPickCube-v1`` (reference ``two_robot_pick_cube.py``): the cube
  within reach of the left arm only, the aerial goal of the right arm
  only; success is the cube at the goal with the right arm static.
- ``TwoRobotStackCube-v1`` (``two_robot_stack_cube.py``): cube A stacked
  on cube B, B in the goal region, and both released (each arm's grasp
  checker, ``_post_build``).

Each has ``contact_state``: the arms grasping their cubes (StackCube: cube
A set on cube B, the right arm grasping B).
"""
from __future__ import annotations

import numpy as np
import torch

from ...physics.engine import make_step_fn
from ...physics.model import SceneSpecBuilder, box_geom
from ..base_env import BaseEnv, EnvState
from ..registration import register_env
from ..scene_builders import TableSceneBuilder
from .pick_cube import grasp_qpos

ARM_POSES = [np.array([-0.615, -0.35, 0, 1, 0, 0, 0], np.float32),   # left
             np.array([-0.615, 0.35, 0, 1, 0, 0, 0], np.float32)]    # right


def install_two_pandas(env, builder: SceneSpecBuilder):
    """The two arms at their mounts, each at the table's Panda rest qpos."""
    env.table_scene = TableSceneBuilder(env)
    _, qpos = env.table_scene.robot_pose_and_qpos("panda")
    env.agent.install(builder, ARM_POSES, init_qpos=[qpos, qpos])


def two_arm_contact(env, state: EnvState, gen: torch.Generator, held, stack=None) -> EnvState:
    """``state`` moved into contact, for checks of the physics step: arm
    ``i`` grasps the free body ``held[i]`` (``None``: it stays), as
    PickCube's ``contact_state`` grasps its cube (damped least-squares IK
    on its seven joints, the fingers closed 0-1 mm into the object);
    ``stack = (upper, lower)`` first sets ``upper`` 0-1 mm into the top of
    ``lower``. Joint velocities are random, the arms hold their poses and
    the grippers shut; one control step of the plain physics step then
    loads the warm-start impulses."""
    dev, sim, model, ma = env.device, state.sim, env.model, env.agent
    K = sim.qpos.shape[0]
    free_pose = sim.free_pose.clone()
    if stack is not None:
        up, lo = (model.free_index[n] for n in stack)
        free_pose[:, up, :2] = free_pose[:, lo, :2]
        free_pose[:, up, 2] = (free_pose[:, lo, 2] + 2 * env.cube_half_size
                               - env._uniform(gen, (K,), 0.0, 1e-3))
    qpos = sim.qpos.clone()
    target = qpos.clone()
    for i, name in enumerate(held):
        sl = ma.qpos_slice_of(i)
        if name is None:
            continue
        body = model.free_index[name]
        ee = ma.agent_prefix(i) + ma.sub_agents[i].ee_link_name
        arm = range(sl.start, sl.start + 7)
        qpos = grasp_qpos(env, qpos, free_pose[:, body], gen, joints=arm, ee_link=ee)
        width = env.cube_half_size
        qpos[:, sl.start + 7:sl.stop] = env._uniform(gen, (K, 1), width - 0.001, width)
        target[:, sl] = qpos[:, sl]
        target[:, sl.start + 7:sl.stop] = 0.0  # the arm holds its pose, the gripper shuts
    qvel = 0.1 * torch.randn(qpos.shape, generator=gen, device=dev)
    sim = sim.replace(qpos=qpos, qvel=qvel, free_pose=free_pose,
                      free_vel=0.05 * torch.randn(sim.free_vel.shape, generator=gen, device=dev))
    cmd = env.agent.controller.reset(qpos).replace(target_qpos=target)
    sim = make_step_fn(model)(sim, cmd, env.sim_steps_per_control)
    return state.replace(sim=sim, cmd=cmd)


def _cube_inertia(half: float):
    m = 1000.0 * (2 * half) ** 3
    return m, (2.0 / 3.0) * m * half * half * np.eye(3)


@register_env("TwoRobotPushCube-v1", max_episode_steps=100)
class TwoRobotPushCubeEnv(BaseEnv):
    DEFAULT_ROBOT = ("panda", "panda")

    goal_radius = 0.08
    cube_half_size = 0.02
    # the push task's cubes never meet; the stacking task's must
    _exclude_cube_pair = True

    def _load_agent(self, builder: SceneSpecBuilder):
        install_two_pandas(self, builder)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        half = self.cube_half_size
        m, inertia = _cube_inertia(half)
        self.cube_a = builder.add_free_body("cube_a", m, inertia, [box_geom([half] * 3)])
        self.cube_b = builder.add_free_body("cube_b", m, inertia, [box_geom([half] * 3)])
        self.goal_region = builder.add_kinematic_body("goal_region")
        if self._exclude_cube_pair:
            builder.exclude_pair("cube_a", "cube_b")

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K, dev = state.sim.qpos.shape[0], self.device
        xy_a = self._uniform(gen, (K, 2), [-0.1, -0.35], [0.1, -0.2])
        xy_b = self._uniform(gen, (K, 2), [-0.1, 0.2], [0.1, 0.35])
        rest = torch.tensor([self.cube_half_size, 1.0, 0, 0, 0], device=dev).expand(K, 5)
        free_pose, kin_pose = state.sim.free_pose.clone(), state.sim.kin_pose.clone()
        free_pose[:, self.cube_a] = torch.cat([xy_a, rest], -1)
        free_pose[:, self.cube_b] = torch.cat([xy_b, rest], -1)
        kin_pose[:, self.goal_region] = torch.tensor([0.05, 0.0, 1e-3, 1, 0, 0, 0], device=dev)
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=torch.zeros_like(state.sim.free_vel),
            kin_pose=kin_pose))

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """Each arm grasping its cube (``two_arm_contact``)."""
        return two_arm_contact(self, state, gen, ("cube_a", "cube_b"))

    def _cube_in_goal(self, ctx, name):
        p, g = ctx.actor_pose(name).p, ctx.actor_pose("goal_region").p
        return torch.linalg.norm(p[:, :2] - g[:, :2], dim=-1) < self.goal_radius

    def evaluate(self, state, ctx):
        a_in = self._cube_in_goal(ctx, "cube_a")
        b_in = self._cube_in_goal(ctx, "cube_b")
        return dict(success=a_in & b_in, cube_a_placed=a_in, cube_b_placed=b_in)

    def _get_obs_extra(self, state, ctx, info):
        obs = dict(tcp_pose_a=self.agent.tcp_pose_of(0, ctx).raw,
                   tcp_pose_b=self.agent.tcp_pose_of(1, ctx).raw,
                   goal_pos=ctx.actor_pose("goal_region").p)
        if "state" in self.obs_mode:
            obs.update(cube_a_pose=ctx.actor_pose("cube_a").raw,
                       cube_b_pose=ctx.actor_pose("cube_b").raw)
        return obs

    def compute_dense_reward(self, state, action, info, ctx):
        goal = ctx.actor_pose("goal_region").p
        r = 0.0
        for i, name in ((0, "cube_a"), (1, "cube_b")):
            cube = ctx.actor_pose(name).p
            tcp = self.agent.tcp_pose_of(i, ctx).p
            reach = 1.0 - torch.tanh(5.0 * torch.linalg.norm(tcp - cube, dim=-1))
            push = 1.0 - torch.tanh(5.0 * torch.linalg.norm(cube[:, :2] - goal[:, :2], dim=-1))
            r = r + reach + 2.0 * push
        return torch.where(info["success"], torch.full_like(r, 8.0), r)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 8.0


@register_env("TwoRobotPickCube-v1", max_episode_steps=100)
class TwoRobotPickCubeEnv(BaseEnv):
    """The arms hand the cube over: it spawns within reach of the left arm
    only, the aerial goal within reach of the right arm only."""

    DEFAULT_ROBOT = ("panda_wristcam", "panda_wristcam")

    cube_half_size = 0.02
    goal_thresh = 0.025

    def _load_agent(self, builder: SceneSpecBuilder):
        install_two_pandas(self, builder)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        half = self.cube_half_size
        m, inertia = _cube_inertia(half)
        self.cube = builder.add_free_body("cube", m, inertia, [box_geom([half] * 3)])
        self.goal_site = builder.add_kinematic_body("goal_site")

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K, dev = state.sim.qpos.shape[0], self.device
        xy = self._uniform(gen, (K, 2), [-0.1, -0.3], [0.1, -0.15])
        goal_xy = self._uniform(gen, (K, 2), [-0.1, 0.15], [0.1, 0.3])
        goal_z = self._uniform(gen, (K, 1), 0.15, 0.3)
        free_pose, kin_pose = state.sim.free_pose.clone(), state.sim.kin_pose.clone()
        unit = torch.tensor([1.0, 0, 0, 0], device=dev).expand(K, 4)
        free_pose[:, self.cube] = torch.cat(
            [xy, torch.full((K, 1), self.cube_half_size, device=dev), unit], -1)
        kin_pose[:, self.goal_site] = torch.cat([goal_xy, goal_z, unit], -1)
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=torch.zeros_like(state.sim.free_vel),
            kin_pose=kin_pose))

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """The left arm grasping the cube (``two_arm_contact``)."""
        return two_arm_contact(self, state, gen, ("cube", None))

    def evaluate(self, state, ctx):
        placed = torch.linalg.norm(ctx.actor_pose("cube").p - ctx.actor_pose("goal_site").p,
                                   dim=-1) <= self.goal_thresh
        right_static = torch.amax(state.sim.qvel[:, self.agent.qpos_slice_of(1)].abs(),
                                  dim=-1) <= 0.2
        return dict(success=placed & right_static, is_obj_placed=placed,
                    is_right_arm_static=right_static)

    def _get_obs_extra(self, state, ctx, info):
        ltcp, rtcp = self.agent.tcp_pose_of(0, ctx), self.agent.tcp_pose_of(1, ctx)
        obs = dict(left_arm_tcp=ltcp.raw, right_arm_tcp=rtcp.raw,
                   goal_pos=ctx.actor_pose("goal_site").p)
        if "state" in self.obs_mode:
            cube = ctx.actor_pose("cube")
            obs.update(cube_pose=cube.raw, left_arm_tcp_to_cube_pos=cube.p - ltcp.p,
                       right_arm_tcp_to_cube_pos=cube.p - rtcp.p)
        return obs

    def compute_dense_reward(self, state, action, info, ctx):
        # staged: the left arm brings the cube to the middle, the right
        # reaches it there and places it at the goal
        cube = ctx.actor_pose("cube").p
        goal = ctx.actor_pose("goal_site").p
        ltcp, rtcp = self.agent.tcp_pose_of(0, ctx).p, self.agent.tcp_pose_of(1, ctx).p
        left_reach = 1.0 - torch.tanh(5.0 * torch.linalg.norm(ltcp - cube, dim=-1))
        to_middle = 1.0 - torch.tanh(5.0 * torch.abs(cube[:, 1] - 0.0))
        right_reach = 1.0 - torch.tanh(5.0 * torch.linalg.norm(rtcp - cube, dim=-1))
        in_middle = (torch.abs(cube[:, 1]) < 0.08).to(cube.dtype)
        place = 1.0 - torch.tanh(5.0 * torch.linalg.norm(cube - goal, dim=-1))
        reward = left_reach + to_middle + in_middle * (right_reach + 2.0 * place)
        return torch.where(info["success"], torch.full_like(reward, 8.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 8.0


@register_env("TwoRobotStackCube-v1", max_episode_steps=100)
class TwoRobotStackCubeEnv(TwoRobotPushCubeEnv):
    """Each arm reaches only its own cube: cube B to the goal region, cube
    A on it, both released."""

    _exclude_cube_pair = False  # cube A rests on cube B

    def _post_build(self):
        self._is_grasping_a = self.agent.build_grasp_checker_of(0, self.model, "cube_a",
                                                                self.device)
        self._is_grasping_b = self.agent.build_grasp_checker_of(1, self.model, "cube_b",
                                                                self.device)

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """Cube A set on cube B, the right arm grasping B
        (``two_arm_contact``): cube-cube ``box_box`` points."""
        return two_arm_contact(self, state, gen, (None, "cube_b"), stack=("cube_a", "cube_b"))

    def evaluate(self, state, ctx):
        half = self.cube_half_size
        pa, pb = ctx.actor_pose("cube_a").p, ctx.actor_pose("cube_b").p
        goal = ctx.actor_pose("goal_region").p
        offset = pa - pb
        stacked = (torch.linalg.norm(offset[:, :2], dim=-1) <= 0.6 * half) & (
            torch.abs(offset[:, 2] - 2 * half) <= 0.005)
        b_placed = torch.linalg.norm(pb[:, :2] - goal[:, :2], dim=-1) < self.goal_radius
        f_pt = ctx.contact_forces()
        grasped_a = self._is_grasping_a(ctx.body_quat, f_pt)
        grasped_b = self._is_grasping_b(ctx.body_quat, f_pt)
        return dict(success=stacked & b_placed & ~grasped_a & ~grasped_b,
                    is_cubeA_on_cubeB=stacked, cubeB_placed=b_placed,
                    is_cubeA_grasped=grasped_a, is_cubeB_grasped=grasped_b)

    def compute_dense_reward(self, state, action, info, ctx):
        half = self.cube_half_size
        pa, pb = ctx.actor_pose("cube_a").p, ctx.actor_pose("cube_b").p
        goal = ctx.actor_pose("goal_region").p
        ltcp, rtcp = self.agent.tcp_pose_of(0, ctx).p, self.agent.tcp_pose_of(1, ctx).p
        # stage 1: both arms reach, the left grasps cube A
        reach = (1.0 - torch.tanh(5.0 * torch.linalg.norm(ltcp - pa, dim=-1))) + (
            1.0 - torch.tanh(5.0 * torch.linalg.norm(rtcp - pb, dim=-1)))
        ga = info["is_cubeA_grasped"].to(pa.dtype)
        gb = info["is_cubeB_grasped"].to(pa.dtype)
        reward = (reach + ga + gb) / 2.0
        # stage 2: cube B to the goal region
        bring_b = 1.0 - torch.tanh(5.0 * torch.linalg.norm(pb[:, :2] - goal[:, :2], dim=-1))
        reward = torch.where(info["is_cubeA_grasped"], 2.0 + bring_b, reward)
        # stage 3: B placed, A onto it
        target = pb + torch.tensor([0.0, 0.0, 2 * half], device=pa.device)
        stack_a = 1.0 - torch.tanh(5.0 * torch.linalg.norm(pa - target, dim=-1))
        reward = torch.where(info["cubeB_placed"] & info["is_cubeA_grasped"], 4.0 + stack_a,
                             reward)
        # stage 4: stacked, both release
        ungrasp = 2.0 - ga - gb
        reward = torch.where(info["is_cubeA_on_cubeB"] & info["cubeB_placed"],
                             8.0 + ungrasp / 2.0, reward)
        return torch.where(info["success"], torch.full_like(reward, 10.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 10.0
