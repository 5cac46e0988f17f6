"""Cube rotation with the TriFingerPro: RotateCube-v1 and
TriFingerRotateCubeLevel0-4-v1.

Port of ``maniskill_tpu/envs/tasks/rotate_cube.py``. The TriFingerPro stands
upright on the arena floor (a plane) and reaches down to a free cube.

- ``RotateCube-v1`` (``:24-160``): a 94 g cube of half size 0.035 placed
  within 2 cm of the centre; turn it about +z. ``_update_extras`` rotates
  the episode's horizontal unit vector by the cube's orientation, projects
  it off the rotation axis, and adds the angle to the previous step's
  vector (``arccos`` clipped to [0, 1 - 1e-7], the step clipped to pi/20)
  to ``cum_rotation_angle``; success past 4 pi, fail when the cube leaves
  the arena (0.19 m from the centre). The dense reward: 20 x the step's
  angle, less the cube's speed, a fall, the drives' power and torque, plus
  the fingertips' nearness to the cube.
- ``TriFingerRotateCubeLevel{0..4}-v1`` (``:163-272``): move a 6.5 cm cube
  to a goal pose (the ``cube_goal`` kinematic body) drawn per level: 0 on
  the table, 1 on the table with a random yaw, 2 a fixed point in the air,
  3 a random point in the air, 4 a random point and orientation in the air.
  Success within 2 cm and 0.1 rad of the goal.

The random draws of a reset come from ``_draw`` (the port's generator, the
JAX task's distributions), so that a test can feed another package's draws.
``contact_state`` presses the three fingertips onto the cube.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..._consts import const
from ...kinematics import chain
from ...math import clamps
from ...math.rotations import quat_apply, random_quaternion
from ...physics.engine import make_step_fn
from ...physics.model import SceneSpecBuilder, box_geom, plane_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env

KP, KD, FLIM = 1e2, 1e1, 2e1  # the TriFingerPro's drive (agents/robots/trifinger.py)


def _norm(v: torch.Tensor, eps: float = 1e-18) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1) + eps)


@register_env("RotateCube-v1", max_episode_steps=300)
class RotateCubeEnv(BaseEnv):
    DEFAULT_ROBOT = "trifingerpro"

    cube_half_size = 0.035
    success_threshold = float(np.pi * 4)

    def __init__(self, *args, robot_init_qpos_noise: float = 0.0, **kwargs):
        super().__init__(*args, robot_init_qpos_noise=robot_init_qpos_noise, **kwargs)

    def _load_agent(self, builder: SceneSpecBuilder):
        # the platform upright, the fingers reaching down to the arena floor
        self.agent.install(builder, np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                           init_qpos=np.tile(np.array([0.0, 0.65, -1.2], np.float32), 3))

    def _load_scene(self, builder: SceneSpecBuilder):
        builder.add_static_body("table", np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                                [plane_geom()])
        half, m = self.cube_half_size, 0.094
        inertia = (2.0 / 3.0) * m * half * half * np.eye(3)
        self.obj = builder.add_free_body("cube", m, inertia,
                                         [box_geom([half] * 3, friction=1.0)])

    def _default_extras(self, batch):
        z = self.device
        return dict(prev_unit_vector=torch.zeros(batch, 3, device=z),
                    unit_vector=torch.zeros(batch, 3, device=z),
                    rot_dir=torch.zeros(batch, 3, device=z),
                    cum_rotation_angle=torch.zeros(batch, device=z),
                    rotation_angle=torch.zeros(batch, device=z))

    def _draw(self, gen: torch.Generator, K: int) -> dict:
        """The cube's xy offset (K, 2) and the tracked vector's angle (K,)."""
        return dict(xy=self._uniform(gen, (K, 2), -0.02, 0.02),
                    angle=self._uniform(gen, (K,), -math.pi, math.pi))

    def _place_cube(self, state: EnvState, xy: torch.Tensor) -> EnvState:
        K = xy.shape[0]
        rest = torch.tensor([self.cube_half_size, 1.0, 0, 0, 0], device=self.device)
        free_pose = state.sim.free_pose.clone()
        free_pose[:, self.obj] = torch.cat([xy, rest.expand(K, 5)], -1)
        return state.replace(sim=state.sim.replace(free_pose=free_pose,
                                                   free_vel=torch.zeros_like(state.sim.free_vel)))

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        d = self._draw(gen, K)
        state = self._place_cube(state, d["xy"])
        # rotation axis +z; the tracked vector a random horizontal unit vector
        ang = d["angle"]
        vec = torch.stack([torch.cos(ang), torch.sin(ang), torch.zeros_like(ang)], -1)
        ez = torch.tensor([0.0, 0.0, 1.0], device=self.device).expand(K, 3)
        zero = torch.zeros(K, device=self.device)
        extras = dict(prev_unit_vector=vec, unit_vector=vec.clone(), rot_dir=ez.clone(),
                      cum_rotation_angle=zero, rotation_angle=zero.clone())
        return state.replace(extras=extras)

    def _update_extras(self, state: EnvState, ctx: TaskContext) -> EnvState:
        ex = state.extras
        rot_dir = ex["rot_dir"]
        v = quat_apply(ctx.actor_pose("cube").q, ex["unit_vector"])
        v = v - torch.sum(v * rot_dir, -1, keepdim=True) * rot_dir
        v = v / torch.sqrt(torch.sum(v * v, -1, keepdim=True) + 1e-12)
        angle = torch.arccos(clamps.clip(torch.sum(v * ex["prev_unit_vector"], -1),
                                         0.0, 1.0 - 1e-7))
        angle = clamps.clip(angle, -math.pi / 20, math.pi / 20)
        extras = dict(ex, prev_unit_vector=v, rotation_angle=angle,
                      cum_rotation_angle=ex["cum_rotation_angle"] + angle)
        return state.replace(extras=extras)

    def _tip_positions(self, ctx: TaskContext) -> torch.Tensor:
        return torch.stack([ctx.frame_pose(n).p for n in self.agent.tip_link_names], 1)

    def evaluate(self, state: EnvState, ctx: TaskContext):
        ex = state.extras
        obj = ctx.actor_pose("cube")
        obj_vel = _norm(ctx.actor_vel("cube")[:, :3])
        obj_fall = torch.linalg.norm(obj.p[:, :2], dim=-1) > 0.19  # left the arena
        tip_dist = _norm(self._tip_positions(ctx) - obj.p[:, None])
        qf = clamps.clip(KP * (state.cmd.target_qpos - state.sim.qpos) - KD * state.sim.qvel,
                         -FLIM, FLIM)
        return dict(success=ex["cum_rotation_angle"] > self.success_threshold, fail=obj_fall,
                    rotation_angle=ex["rotation_angle"], obj_vel=obj_vel, obj_fall=obj_fall,
                    obj_tip_dist=tip_dist, qf=qf, power=torch.sum(qf * state.sim.qvel, -1))

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = dict(rot_dir=state.extras["rot_dir"])
        if "state" in self.obs_mode:
            p = ctx.actor_pose("cube").p
            obs.update(obj_pose=ctx.actor_pose("cube").raw,
                       obj_tip_vec=(self._tip_positions(ctx) - p[:, None]).reshape(-1, 9))
        return obs

    def compute_dense_reward(self, state, action, info, ctx):
        reward = 20.0 * info["rotation_angle"]
        reward = reward - 0.1 * info["obj_vel"]
        reward = reward - 50.0 * info["obj_fall"].to(reward.dtype)
        reward = reward - 0.0003 * clamps.abs(info["power"])
        reward = reward - 0.0003 * _norm(info["qf"])
        distance_rew = 0.1 / (0.02 + 4.0 * info["obj_tip_dist"])
        return reward + torch.mean(clamps.clip(distance_rew, 0.0, 1.0), -1)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 4.0

    def tips_ik(self, qpos: torch.Tensor, targets: torch.Tensor, iters: int = 30) -> torch.Tensor:
        """``qpos`` with each finger's three joints moved (damped least
        squares, steps of at most 0.2 rad, within the joint limits) so that
        its tip sphere's centre reaches ``targets`` (K, 3, 3), the fingers in
        ``tip_link_names`` order."""
        model, spec, dev = self.model, self.model.robot, self.device
        base = const(model, "robot_base_pose", model.robot_base_pose, dev)
        qlim = const(model, "robot_qlim", model.robot_qlim, dev)
        qpos = qpos.clone()
        for _ in range(iters):
            body_pos, body_quat, axis_w = chain.fk(spec, base, qpos)
            for i, name in enumerate(self.agent.tip_link_names):
                joints = np.arange(3 * i, 3 * i + 3)
                p, _ = chain.frame_pose(spec, base, body_pos, body_quat, name)
                J = chain.point_jacobian(spec, body_pos, axis_w, p, spec.frame_of(name)[0],
                                         joints, model.ancestor_mask)[:, 3:]
                dq = chain.dls_ik_delta(J, targets[:, i] - p, damping=0.01)
                qpos[:, 3 * i:3 * i + 3] = torch.clamp(
                    qpos[:, 3 * i:3 * i + 3] + dq.clamp(-0.2, 0.2),
                    qlim[3 * i:3 * i + 3, 0], qlim[3 * i:3 * i + 3, 1])
        return qpos

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` with the fingertips pressed onto the cube, for checks of
        the physics step. In even envs the three tip spheres sit on the
        cube's top face, 40-70 % of the half size out from its centre
        toward each finger's side; in odd envs each presses the side face
        that faces it, 0-40 % of the half size from the face's centre line.
        IK (``tips_ik``) puts each sphere 0-0.2 mm into the cube, the
        command holds it 2 mm further in, the fingers get random velocities
        (0.1); two control steps of the plain physics step then build the
        squeeze up through the drives and load the warm-start impulses
        (sphere_box points, with friction; the cube's plane_box points
        under it). A deeper start (1 mm) throws the 94 g cube off the floor
        in some envs within a substep."""
        K = state.sim.qpos.shape[0]
        dev = self.device
        half = self.cube_half_size
        c = state.sim.free_pose[:, self.obj, :3]
        tips = self._tip_positions(TaskContext(self, state))  # (K, 3, 3)
        u = tips[..., :2] - c[:, None, :2]
        u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
        top = (torch.arange(K, device=dev) % 2 == 0)[:, None, None]
        r = 0.0155  # the tip sphere's radius
        # the top face: out from the centre toward the finger
        on_top = torch.cat([c[:, None, :2] + u * half * self._uniform(gen, (K, 3, 1), 0.4, 0.7),
                            (c[:, None, 2:] + half + r).expand(K, 3, 1)], -1)
        # the side face whose normal is nearest the finger's direction
        ax = (u[..., 0].abs() >= u[..., 1].abs())
        n = torch.zeros(K, 3, 3, device=dev)
        n[..., 0] = torch.where(ax, torch.sign(u[..., 0]), 0.0)
        n[..., 1] = torch.where(ax, 0.0, torch.sign(u[..., 1]))
        t = torch.stack([-n[..., 1], n[..., 0], torch.zeros_like(n[..., 0])], -1)
        lateral = half * self._uniform(gen, (K, 3, 1), -0.4, 0.4)
        on_side = c[:, None] + n * (half + r) + t * lateral
        surface = torch.where(top, on_top, on_side)
        inward = torch.where(top, torch.tensor([0.0, 0.0, -1.0], device=dev).expand(K, 3, 3), -n)
        depth = 2e-4 * torch.rand(K, 3, 1, generator=gen, device=dev)
        q_touch = self.tips_ik(state.sim.qpos, surface + inward * depth)
        q_press = self.tips_ik(q_touch, surface + inward * (depth + 2e-3), iters=10)
        qvel = 0.1 * torch.randn(state.sim.qpos.shape, generator=gen, device=dev)
        cmd = state.cmd.replace(target_qpos=q_press)
        step = make_step_fn(self.model)
        sim = state.sim.replace(qpos=q_touch, qvel=qvel)
        for _ in range(2):
            sim = step(sim, cmd, self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)


class TriFingerRotateCubeEnv(RotateCubeEnv):
    """Move the cube to a goal pose drawn per ``difficulty_level``."""

    difficulty_level = 0
    goal_radius = 0.02
    cube_half_size = 0.0325
    min_height = 0.0325
    max_height = 0.1
    radius_3d = 0.065 * np.sqrt(3) / 2
    max_com_dist = 0.195 - 0.065 * np.sqrt(3) / 2

    def _load_scene(self, builder: SceneSpecBuilder):
        super()._load_scene(builder)
        self.obj_goal = builder.add_kinematic_body("cube_goal")

    def _default_extras(self, batch):
        return {}

    def _update_extras(self, state, ctx):
        return state

    def _draw(self, gen: torch.Generator, K: int) -> dict:
        """The cube's xy offset (K, 2), the goal's position (K, 3) and
        orientation (K, 4) of this level (JAX ``:189-225``)."""
        dev = self.device
        xy = self._uniform(gen, (K, 2), -0.02, 0.02)
        r = torch.sqrt(torch.rand(K, generator=gen, device=dev)) * self.max_com_dist
        th = self._uniform(gen, (K,), 0.0, 2 * math.pi)
        gx, gy = r * torch.cos(th), r * torch.sin(th)
        lvl = self.difficulty_level
        ident = torch.tensor([1.0, 0, 0, 0], device=dev).expand(K, 4)
        if lvl in (0, 1):
            gp = torch.stack([gx, gy, torch.full_like(gx, self.cube_half_size)], -1)
        elif lvl == 2:
            gp = torch.tensor([0.0, 0.0, self.min_height + 0.05], device=dev).expand(K, 3)
        else:
            lo = self.min_height if lvl == 3 else self.radius_3d
            gp = torch.stack([gx, gy, self._uniform(gen, (K,), lo, self.max_height)], -1)
        if lvl == 1:
            gq = random_quaternion(gen, (K,), lock_x=True, lock_y=True, device=dev)
        elif lvl == 4:
            gq = random_quaternion(gen, (K,), device=dev)
        else:
            gq = ident
        return dict(xy=xy, goal_p=gp, goal_q=gq)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        d = self._draw(gen, state.sim.qpos.shape[0])
        state = self._place_cube(state, d["xy"])
        kin_pose = state.sim.kin_pose.clone()
        kin_pose[:, self.obj_goal] = torch.cat([d["goal_p"], d["goal_q"]], -1)
        return state.replace(sim=state.sim.replace(kin_pose=kin_pose))

    def _goal_angle(self, ctx: TaskContext) -> torch.Tensor:
        """2 arccos |<q, g>| between the cube's and the goal's orientation."""
        d = clamps.abs(torch.sum(ctx.actor_pose("cube").q * ctx.actor_pose("cube_goal").q, -1))
        return 2.0 * torch.arccos(clamps.clip(d, 0.0, 1.0))

    def evaluate(self, state: EnvState, ctx: TaskContext):
        obj, goal = ctx.actor_pose("cube"), ctx.actor_pose("cube_goal")
        pos_close = torch.linalg.norm(obj.p - goal.p, dim=-1) < self.goal_radius
        return dict(success=pos_close & (self._goal_angle(ctx) < 0.1))

    def _get_obs_extra(self, state, ctx, info):
        goal = ctx.actor_pose("cube_goal")
        obs = dict(goal_pos=goal.p, goal_q=goal.q)
        if "state" in self.obs_mode:
            obs.update(obj_pose=ctx.actor_pose("cube").raw)
        return obs

    def compute_dense_reward(self, state, action, info, ctx):
        obj, goal = ctx.actor_pose("cube"), ctx.actor_pose("cube_goal")
        tips = self._tip_positions(ctx)
        reach = torch.sum(1.0 - torch.tanh(5.0 * torch.linalg.norm(tips - obj.p[:, None],
                                                                   dim=-1)), -1)
        pos_rew = 5.0 * (1.0 - torch.tanh(5.0 * torch.linalg.norm(obj.p - goal.p, dim=-1)))
        rot_rew = 5.0 * (1.0 - torch.tanh(self._goal_angle(ctx)))
        reward = reach + pos_rew + rot_rew
        return torch.where(info["success"], torch.full_like(reward, 20.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 20.0


for _lvl in range(5):
    register_env(f"TriFingerRotateCubeLevel{_lvl}-v1", max_episode_steps=250)(
        type(f"TriFingerRotateCubeLevel{_lvl}Env", (TriFingerRotateCubeEnv,),
             dict(difficulty_level=_lvl, __module__=__name__)))
