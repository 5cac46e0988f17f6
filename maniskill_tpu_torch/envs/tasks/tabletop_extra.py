"""RollBall-v1, PullCubeTool-v1 and Empty-v1.

Port of ``maniskill_tpu/envs/tasks/tabletop_extra.py``. ``RollBallEnv``
(``:60-165``): a 3.5 cm ball of density 1000 (a free sphere) is to be
rolled into a goal region (a kinematic body without geoms) across the
table. Same reset draw (ball xy in [0, 0.15] x [-0.1, 0.1], goal xy in
[-0.65, -0.35] x [-0.3, 0.3]), the ``reached`` latch kept in the env's
extras by ``_update_extras``, success (the ball's xy within 0.1 m of the
goal's), state obs and the staged dense reward (20 on the way after the
hit, 30 on success) with its normalized form. ``PullCubeToolEnv``
(``:265``): a cube beyond the arm's reach and an L-shaped tool (a handle
box and a hook box on one free body) to pull it in with; the same reset
ranges, success (the cube's xy within 0.6 m of the robot's base), state obs
and the staged dense reward. ``EmptyEnv`` (``:24``): the robot on the
table, no task. The JAX envs' base cameras wait for the sensors;
PlaceSphere-v1 of the same JAX module is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..._consts import const
from ...math import clamps
from ...math.rotations import quat_apply
from ...physics.engine import all_geom_poses, make_step_fn, robot_fk
from ...physics.model import SceneSpecBuilder, box_geom, sphere_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from ..scene_builders import TABLE_HEIGHT, TableSceneBuilder
from .pick_cube import grasp_qpos


@register_env("RollBall-v1", max_episode_steps=80)
class RollBallEnv(BaseEnv):
    DEFAULT_ROBOT = "panda"

    goal_radius = 0.1
    ball_radius = 0.035

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, qpos = self.table_scene.robot_pose_and_qpos(self.robot_uids)
        self.agent.install(builder, pose, init_qpos=qpos)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        r = self.ball_radius
        m = 1000.0 * (4.0 / 3.0) * np.pi * r ** 3
        inertia = (2.0 / 5.0) * m * r * r * np.eye(3)
        self.ball = builder.add_free_body("ball", m, inertia, [sphere_geom(r, friction=0.5)])
        self.goal_region = builder.add_kinematic_body("goal_region")

    def _post_build(self):
        # contact_state's support: the left finger's pad (its second box)
        self._pad = [i for i, g in enumerate(self.model.geoms)
                     if g.name == "robot:panda_leftfinger"][1]

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        bxy = self._uniform(gen, (K, 2), [0.0, -0.1], [0.15, 0.1])
        gxy = self._uniform(gen, (K, 2), [-0.65, -0.3], [-0.35, 0.3])
        rest = torch.tensor([1.0, 0, 0, 0], device=dev).expand(K, 4)
        ball = torch.cat([bxy, torch.full((K, 1), self.ball_radius, device=dev), rest], -1)
        goal = torch.cat([gxy, torch.full((K, 1), 1e-3, device=dev), rest], -1)
        free_pose = state.sim.free_pose.clone()
        free_vel = state.sim.free_vel.clone()
        kin_pose = state.sim.kin_pose.clone()
        free_pose[:, self.ball] = ball
        free_vel[:, self.ball] = 0.0
        kin_pose[:, self.goal_region] = goal
        extras = dict(state.extras, reached=torch.zeros(K, device=dev))
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=free_vel, kin_pose=kin_pose), extras=extras)

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact, for checks of the physics step; by
        env index:

        - modulo 8 is 0: the open hand pointing up 25 cm over the ball's
          place (IK), and the ball at rest on the left finger's pad, on the
          centre of its top face at zero depth (``sphere_box`` against the
          finger), arm and ball at rest;
        - modulo 4 is 3: the ball resting on the floor beyond the table's
          far edge, the arm at its reset pose (``plane_sphere``);
        - else the ball resting on the table at its reset place, the arm at
          its reset pose (``sphere_box`` against the table).

        Elsewhere than on the finger, joint velocities and the ball's
        horizontal and angular velocities are random. Four control steps of
        the plain physics step then let the ball settle (on the finger it
        bounces on the arm's compliance for the first) and load the
        warm-start impulses. (The ball on a finger is a minority: there the
        contact force of the last substep, one point of a stiff law on a
        compliant arm, is float32-sensitive; PERF.md section 6.)"""
        dev = self.device
        sim = state.sim
        K = sim.qpos.shape[0]
        r = self.ball_radius
        idx = torch.arange(K, device=dev)
        floor, held = idx % 4 == 3, idx % 8 == 0
        pose = sim.free_pose[:, self.ball].clone()
        pose[:, 2] = r
        table = TableSceneBuilder
        pose[floor, 0] = float(table.TABLE_CENTER[0] + table.TABLE_HALF[0]) + 0.1
        pose[floor, 2] -= TABLE_HEIGHT
        # the open hand pointing up, 25 cm over the ball's place (the TCP's
        # +z turned to world +z); the ball set at rest on the left finger's
        # pad, its centre on the pad's top-face normal through the face's
        # centre, r above the face (zero depth), wherever the IK left it
        up_pose = pose.clone()
        up_pose[:, 2] = 0.25
        qpos = grasp_qpos(self, sim.qpos, up_pose, gen, dz=torch.zeros(K, device=dev),
                          tool=(1.0, 0.0, 0.0, 0.0))
        qpos[:, 7:9] = 0.04  # open: the other finger 8 cm away
        qpos = torch.where(held[:, None], qpos, sim.qpos)
        body_pos, body_quat, _ = robot_fk(self.model, qpos)
        gp, gq = all_geom_poses(self.model, sim.replace(qpos=qpos), body_pos, body_quat)
        g = self._pad
        top = torch.zeros(K, 3, device=dev)
        top[:, 2] = sim.geom_size[:, g, 2] + r
        on_pad = gp[:, g] + quat_apply(gq[:, g], top)
        pose[:, :3] = torch.where(held[:, None], on_pad, pose[:, :3])
        target = qpos.clone()
        qvel = 0.1 * torch.randn(qpos.shape, generator=gen, device=dev)
        free_vel = 0.05 * torch.randn(sim.free_vel.shape, generator=gen, device=dev)
        free_vel[:, self.ball, 2] = 0.0  # resting: no velocity off the surface
        qvel[held] = 0.0  # the ball balanced on the finger: all at rest
        free_vel[held] = 0.0
        free_pose = sim.free_pose.clone()
        free_pose[:, self.ball] = pose
        sim = sim.replace(qpos=qpos, qvel=qvel, free_pose=free_pose, free_vel=free_vel)
        cmd = self.agent.controller.reset(qpos).replace(target_qpos=target)
        sim = make_step_fn(self.model)(sim, cmd, 4 * self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)

    def _hit_point(self, ctx: TaskContext):
        ball_p = ctx.actor_pose("ball").p
        goal_p = ctx.actor_pose("goal_region").p
        unit = ball_p - goal_p
        unit = unit / (torch.linalg.norm(unit, dim=-1, keepdim=True) + 1e-9)
        return ball_p, goal_p, ball_p + unit * (self.ball_radius + 0.05)

    def _update_extras(self, state: EnvState, ctx: TaskContext) -> EnvState:
        _, _, hit_p = self._hit_point(ctx)
        reached_now = torch.linalg.norm(hit_p - ctx.tcp_pose.p, dim=-1) < 0.04
        reached = clamps.maximum(state.extras["reached"], reached_now.to(hit_p.dtype))
        return state.replace(extras=dict(state.extras, reached=reached))

    def evaluate(self, state: EnvState, ctx: TaskContext):
        ball_p = ctx.actor_pose("ball").p
        goal_p = ctx.actor_pose("goal_region").p
        return dict(success=torch.linalg.norm(ball_p[..., :2] - goal_p[..., :2], dim=-1)
                    < self.goal_radius)

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if self.obs_mode in ("state", "state_dict"):
            ball = ctx.actor_pose("ball")
            goal_p = ctx.actor_pose("goal_region").p
            obs.update(goal_pos=goal_p, ball_pose=ball.raw,
                       ball_vel=state.sim.free_vel[:, self.ball, :3],
                       tcp_to_ball_pos=ball.p - ctx.tcp_pose.p,
                       ball_to_goal_pos=goal_p - ball.p)
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        ball_p, goal_p, hit_p = self._hit_point(ctx)
        tcp_dist = torch.linalg.norm(hit_p - ctx.tcp_pose.p, dim=-1)
        reached = state.extras["reached"]
        reaching = 1.0 - torch.tanh(2.0 * tcp_dist)
        goal_dist = torch.linalg.norm(ball_p[..., :2] - goal_p[..., :2], dim=-1)
        rolled = 1.0 - torch.tanh(goal_dist)
        reward = 20.0 * rolled * reached + reaching * (1 - reached) + reached
        return torch.where(info["success"], torch.full_like(reward, 30.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 30.0


@register_env("Empty-v1", max_episode_steps=200)
class EmptyEnv(BaseEnv):
    """The robot on the table with nothing to do: for driving controllers."""

    DEFAULT_ROBOT = "panda"

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, qpos = self.table_scene.robot_pose_and_qpos(self.robot_uids)
        self.agent.install(builder, pose, init_qpos=qpos)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        return dict(tcp_pose=ctx.tcp_pose.raw)


@register_env("PullCubeTool-v1", max_episode_steps=100)
class PullCubeToolEnv(BaseEnv):
    """The cube spawns beyond direct reach: grasp the L-shaped tool and hook
    the cube closer."""

    DEFAULT_ROBOT = "panda"

    cube_half = 0.02
    handle_length = 0.2
    hook_length = 0.05
    tool_width = 0.02
    tool_height = 0.02
    arm_reach = 0.35

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, qpos = self.table_scene.robot_pose_and_qpos(self.robot_uids)
        self._base_xy = np.asarray(pose[:2], np.float32)
        self.agent.install(builder, pose, init_qpos=qpos)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        half = self.cube_half
        m = 1000.0 * (2 * half) ** 3
        inertia = (2.0 / 3.0) * m * half * half * np.eye(3)
        self.cube = builder.add_free_body("cube", m, inertia,
                                          [box_geom([half] * 3, friction=0.5)])
        # the L tool: a handle along +x and a hook across +y at its far end
        hl, hk, w, ht = self.handle_length, self.hook_length, self.tool_width, self.tool_height
        tm = 500.0 * (2 * hl * 2 * w * ht + 2 * hk * 2 * w * ht)
        geoms = [box_geom([hl / 2, w, ht / 2], friction=0.8),
                 box_geom([hk / 2, w, ht / 2], offset_p=[hl / 2 - hk / 2, 2 * w, 0],
                          friction=0.8)]
        self.tool = builder.add_free_body("l_shape_tool", tm, tm * 2e-3 * np.eye(3), geoms)

    def _post_build(self):
        self._is_grasping_tool = self.agent.build_grasp_checker(
            self.model, "l_shape_tool", self.device, max_angle=20)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        cube_xy = self._uniform(gen, (K, 2), [0.15, -0.1], [0.25, 0.1])  # out of reach
        tool_xy = self._uniform(gen, (K, 2), [-0.2, -0.25], [-0.1, -0.15])
        rest = torch.tensor([1.0, 0, 0, 0], device=dev).expand(K, 4)
        free_pose = state.sim.free_pose.clone()
        free_pose[:, self.cube] = torch.cat(
            [cube_xy, torch.full((K, 1), self.cube_half, device=dev), rest], -1)
        free_pose[:, self.tool] = torch.cat(
            [tool_xy, torch.full((K, 1), self.tool_height / 2, device=dev), rest], -1)
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=torch.zeros_like(state.sim.free_vel)))

    def _base(self, device):
        return const(self, "base", np.append(self._base_xy, 0.0), device)

    def evaluate(self, state: EnvState, ctx: TaskContext):
        # the cube pulled within 0.6 m of the robot's base
        cube_p = ctx.actor_pose("cube").p
        base = self._base(cube_p.device)
        return dict(success=torch.linalg.norm(cube_p[..., :2] - base[:2], dim=-1) < 0.6)

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if self.obs_mode in ("state", "state_dict"):
            obs.update(cube_pose=ctx.actor_pose("cube").raw,
                       tool_pose=ctx.actor_pose("l_shape_tool").raw)
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        # staged: reach and grasp the tool, hook behind the cube, pull it in;
        # a penalty for a cube pushed out of reach and 5 on success
        cube_p = ctx.actor_pose("cube").p
        tool_p = ctx.actor_pose("l_shape_tool").p
        tcp = ctx.tcp_pose.p
        dev = cube_p.device
        base = self._base(dev)
        tool_grasp = tool_p + const(self, "grasp_off", [0.02, 0.0, 0.0], dev)
        reaching = 2.0 * (1.0 - torch.tanh(5.0 * torch.linalg.norm(tcp - tool_grasp, dim=-1)))
        grasped = self._is_grasping_tool(ctx.body_quat, ctx.contact_forces()).to(tcp.dtype)
        reward = reaching + 2.0 * grasped
        ideal_hook = cube_p + const(
            self, "hook_off", [-(self.hook_length + self.cube_half), -0.067, 0.0], dev)
        pos_dist = torch.linalg.norm(tool_p - ideal_hook, dim=-1)
        positioning = 1.5 * (1.0 - torch.tanh(3.0 * pos_dist))
        positioned = (pos_dist < 0.05).to(tcp.dtype)
        target = base + const(self, "target_off", [0.05, 0.0, 0.0], dev)
        cube_to_ws = torch.linalg.norm(cube_p - target, dim=-1)
        initial = float(np.linalg.norm(
            np.array([self.arm_reach + 0.1, 0.0, self.cube_half], np.float32)
            - (np.append(self._base_xy, 0.0) + np.array([0.05, 0.0, 0.0])).astype(np.float32)))
        progress = (initial - cube_to_ws) / initial
        reward = reward + (positioning + 3.0 * progress * positioned) * grasped
        reward = torch.where(cube_p[..., 0] > self.arm_reach + 0.15, reward - 2.0, reward)
        return torch.where(info["success"], reward + 5.0, reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 5.0
