"""Valve turning with the D'Claw: RotateValveDClaw-v1 and
RotateValveLevel0-4-v1.

Port of ``maniskill_tpu/envs/tasks/rotate_valve.py``. The D'Claw hangs
upside down 0.30 m over a valve: a hub on a damped revolute joint about z
(``ArticulationBuilder``), 5 cm above the ground, with spoke boxes
(half sizes 0.045 x 0.012 x 0.015) round it. The valve's tree is merged
into the robot's forest (``SceneSpecBuilder.add_articulation``): its dof is
passive and shares the robot's contact solve; the spokes touch the claw's
capsules across the two trees (capsule_box).

- ``RotateValveDClaw-v1`` (``:21-103``): three spokes; turn the valve a
  quarter turn past its random start angle (the ``init_angle`` and
  ``target_angle`` extras). Reward 2 x progress + 0.5 x spin, 3 on success.
- ``RotateValveLevel{0..4}-v1`` (``:105-283``): six spoke slots at 60
  degrees. Each env's valve rides in ``SimState.geom_size``: Levels 0-1 keep
  three spokes at 0, 120 and 240 degrees; Levels 2-4 draw 3-6 active
  spokes; Levels 3-4 scale each spoke's length by U[0.8, 1.2]. An inactive
  spoke shrinks to a 1 mm box and keeps its points (so the pair tables
  stay one per scene). Level 0 turns a quarter turn in +z; Levels 1-3 half
  a turn in a random direction (the ``rotate_dir`` extra), Level 4 a whole
  turn.

The random draws of a reset come from ``_draw`` (the port's generator, the
JAX task's distributions), so that a test can feed another package's draws.
``contact_state`` presses the claw's fingertips onto the spokes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..._consts import const
from ...kinematics import chain
from ...kinematics.articulation import ArticulationBuilder
from ...math import clamps
from ...physics.engine import body_contact_mask, compute_contacts, make_step_fn, robot_fk
from ...physics.model import SceneSpecBuilder, box_geom, plane_geom
from ..base_env import BaseEnv, EnvState
from ..registration import register_env

SPOKE_HALF = (0.012, 0.015)  # the spokes' half width and half height
INACTIVE = 1e-3  # an inactive spoke's half sizes


class _ValveEnv(BaseEnv):
    """The claw over a valve of ``n_spokes`` spoke slots."""

    DEFAULT_ROBOT = "dclaw"
    n_spokes = 3
    spoke_len = 0.09
    valve_z = 0.05

    def _load_agent(self, builder: SceneSpecBuilder):
        # the claw hangs over the valve, fingers down (the URDF's -z reach)
        self.agent.install(builder, np.array([0.0, 0.0, 0.30, 0, 1, 0, 0], np.float32))

    def _load_scene(self, builder: SceneSpecBuilder):
        builder.add_static_body("ground", np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                                [plane_geom(friction=0.6)])
        ab = ArticulationBuilder("valve")
        hub = ab.add_revolute_link(
            "hub", parent=None, axis=(0.0, 0.0, 1.0), limits=(-100.0, 100.0),
            joint_pose=((0.0, 0.0, self.valve_z), (1, 0, 0, 0)),
            mass=0.2, damping=0.3, friction=0.1)
        for k in range(self.n_spokes):
            ang = 2.0 * np.pi * k / self.n_spokes
            q = np.array([np.cos(ang / 2), 0, 0, np.sin(ang / 2)])
            off = 0.5 * self.spoke_len * np.array([np.cos(ang), np.sin(ang), 0.0])
            ab.add_geom(hub, box_geom([self.spoke_len / 2, *SPOKE_HALF], offset_p=tuple(off),
                                      offset_q=tuple(q), friction=1.0))
        builder.add_articulation(ab, np.array([0, 0, 0, 1, 0, 0, 0]))
        builder.exclude_pair("valve:hub", "valve:base")
        builder.exclude_groups(["valve:*"], ["ground"])

    def _post_build(self):
        self._hub = int(self.model.art_dof_index["valve"][0])
        self._spoke_geoms = np.asarray(self.model.geom_indices("valve:hub"), np.int64)
        assert len(self._spoke_geoms) == self.n_spokes

    def _set_valve(self, state: EnvState, q0: torch.Tensor) -> EnvState:
        qpos, qvel = state.sim.qpos.clone(), state.sim.qvel.clone()
        qpos[:, self._hub] = q0
        qvel[:, self._hub] = 0.0
        return state.replace(sim=state.sim.replace(qpos=qpos, qvel=qvel))

    def _spin(self, state: EnvState, sign=1.0) -> torch.Tensor:
        return clamps.clip(state.sim.qvel[:, self._hub] * sign, 0.0, 2.0) / 2.0

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 3.0

    def _active(self, state: EnvState) -> torch.Tensor:
        """(K, n_spokes) spokes of full size in each env."""
        return state.sim.geom_size[:, self._spoke_geoms, 0] > INACTIVE

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` with the claw's fingertips on the spokes, for checks of
        the physics step. The claw hangs 0.30 m up, its fingers straight
        down at most to z = 0.12 m, and cannot reach the valve's spokes
        (their tops at z = 0.065 m: the JAX scene's geometry, ROADMAP Queue
        C), so the contact states make the valve taller: the hub turned
        (+-0.1 rad) so that the env's first active spoke lies under the
        third finger's tip, the claw's joints jittered (0.05 rad), and each
        active spoke's half height (``geom_size``) grown until the deepest
        of its points against the claw's capsules lies 0-1 mm inside (the
        other active spokes grow as much; inactive spokes stay 1 mm). The
        hub turns at 0.5 rad/s and the claw's joints at random rates (0.1);
        one control step of the plain physics step then loads the
        warm-start impulses: capsule_box points across the claw's and the
        valve's trees, with friction. The command holds the claw's pose."""
        K = state.sim.qpos.shape[0]
        dev = self.device
        sim = state.sim
        active = self._active(state)
        first = torch.argmax(active.to(torch.int32), -1).to(torch.float32)
        tip = self.agent.nq - 1  # the third finger's last link
        spec = self.model.robot
        base = const(self.model, "robot_base_pose", self.model.robot_base_pose, dev)
        qpos = sim.qpos.clone()
        qpos[:, :self.agent.nq] += 0.05 * torch.randn(K, self.agent.nq, generator=gen,
                                                      device=dev)
        body_pos = chain.fk(spec, base, qpos)[0]
        xy = body_pos[:, tip, :2]
        qpos[:, self._hub] = (torch.atan2(xy[:, 1], xy[:, 0])
                              - 2 * math.pi * first / self.n_spokes
                              + self._uniform(gen, (K,), -0.1, 0.1))
        geom_size = sim.geom_size.clone()
        sp = torch.as_tensor(self._spoke_geoms, device=dev)
        # tops at z = 0.10, below the fingertips: the points' depths are
        # then minus their gaps, which the spokes grow by
        geom_size[:, sp, 2] = torch.where(active, 0.05, geom_size[:, sp, 2])
        sim = sim.replace(qpos=qpos, geom_size=geom_size)
        fk = robot_fk(self.model, qpos)
        depth = compute_contacts(self.model, sim, *fk[:2])[2]
        spoke_pts = body_contact_mask(self.model, ["valve:hub"]) > 0  # claw-spoke points
        d = torch.where(torch.as_tensor(spoke_pts, device=dev), depth, -math.inf).amax(1)
        grow = 1e-3 * torch.rand(K, generator=gen, device=dev) - d
        geom_size[:, sp, 2] = torch.where(active, geom_size[:, sp, 2] + grow[:, None],
                                          geom_size[:, sp, 2])
        qvel = 0.1 * torch.randn(qpos.shape, generator=gen, device=dev)
        qvel[:, self._hub] = 0.5
        cmd = self.agent.controller.reset(qpos)
        sim = make_step_fn(self.model)(sim.replace(geom_size=geom_size, qvel=qvel), cmd,
                                       self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)


@register_env("RotateValveDClaw-v1", max_episode_steps=200)
class RotateValveDClawEnv(_ValveEnv):
    target_angle_diff = np.pi / 2

    def _default_extras(self, batch):
        return dict(init_angle=torch.zeros(batch, device=self.device),
                    target_angle=torch.zeros(batch, device=self.device))

    def _draw(self, gen: torch.Generator, K: int) -> dict:
        """The valve's start angle (K,)."""
        return dict(q0=self._uniform(gen, (K,), -math.pi, math.pi))

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        q0 = self._draw(gen, state.sim.qpos.shape[0])["q0"]
        state = self._set_valve(state, q0)
        return state.replace(extras=dict(state.extras, init_angle=q0,
                                         target_angle=q0 + self.target_angle_diff))

    def evaluate(self, state, ctx):
        return dict(success=state.sim.qpos[:, self._hub] >= state.extras["target_angle"])

    def _get_obs_extra(self, state, ctx, info):
        if "state" in self.obs_mode:
            return dict(valve_qpos=state.sim.qpos[:, self._hub, None],
                        valve_qvel=state.sim.qvel[:, self._hub, None],
                        target_angle=state.extras["target_angle"][:, None])
        return {}

    def compute_dense_reward(self, state, action, info, ctx):
        q = state.sim.qpos[:, self._hub]
        prog = clamps.clip((q - state.extras["init_angle"]) / self.target_angle_diff, 0.0, 1.0)
        reward = 2.0 * prog + 0.5 * self._spin(state)
        return torch.where(info["success"], torch.full_like(reward, 3.0), reward)


class _RotateValveLevelEnv(_ValveEnv):
    """The difficulty ladder: six spoke slots, the valve per env in
    ``geom_size``."""

    n_spokes = 6
    success_threshold = np.pi
    random_direction = True
    random_heads = False  # levels 2-4
    random_lengths = False  # levels 3-4
    min_heads = 3

    def _default_extras(self, batch):
        return dict(init_angle=torch.zeros(batch, device=self.device),
                    rotate_dir=torch.ones(batch, device=self.device))

    def _draw(self, gen: torch.Generator, K: int) -> dict:
        """The valve's start angle (K,), the turn's direction (K,: +-1),
        the active spokes (K, 6) and their length scales (K, 6)."""
        dev, H = self.device, self.n_spokes
        q0 = self._uniform(gen, (K,), -math.pi, math.pi)
        flip = torch.rand(K, generator=gen, device=dev) < 0.5
        direction = torch.where(flip & self.random_direction, -1.0, 1.0)
        if self.random_heads:
            n = torch.randint(self.min_heads, H + 1, (K,), generator=gen, device=dev)
            rank = torch.rand(K, H, generator=gen, device=dev).argsort(-1).argsort(-1)
            active = rank < n[:, None]
        else:  # three evenly spaced spokes: 0, 120 and 240 degrees
            active = (torch.arange(H, device=dev) % (H // 3) == 0).expand(K, H)
        scale = (self._uniform(gen, (K, H), 0.8, 1.2) if self.random_lengths
                 else torch.ones(K, H, device=dev))
        return dict(q0=q0, direction=direction, active=active, scale=scale)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        d = self._draw(gen, K)
        state = self._set_valve(state, d["q0"])
        half = torch.tensor([self.spoke_len / 2, *SPOKE_HALF], device=self.device)
        size = half.expand(K, self.n_spokes, 3).clone()
        if self.random_lengths:
            size[..., 0] = size[..., 0] * d["scale"]
        size = torch.where(d["active"][..., None], size, torch.full_like(size, INACTIVE))
        geom_size = state.sim.geom_size.clone()
        geom_size[:, self._spoke_geoms] = size
        return state.replace(sim=state.sim.replace(geom_size=geom_size),
                             extras=dict(state.extras, init_angle=d["q0"],
                                         rotate_dir=d["direction"]))

    def evaluate(self, state, ctx):
        rot = (state.sim.qpos[:, self._hub] - state.extras["init_angle"]) \
            * state.extras["rotate_dir"]
        return dict(success=rot > self.success_threshold, valve_rotation=rot)

    def _get_obs_extra(self, state, ctx, info):
        if "state" in self.obs_mode:
            return dict(valve_qpos=state.sim.qpos[:, self._hub, None],
                        valve_qvel=state.sim.qvel[:, self._hub, None],
                        rotate_dir=state.extras["rotate_dir"][:, None],
                        spoke_sizes=state.sim.geom_size[:, self._spoke_geoms, 0])
        return {}

    def compute_dense_reward(self, state, action, info, ctx):
        prog = clamps.clip(info["valve_rotation"] / self.success_threshold, 0.0, 1.0)
        reward = 2.0 * prog + 0.5 * self._spin(state, state.extras["rotate_dir"])
        return torch.where(info["success"], torch.full_like(reward, 3.0), reward)


@register_env("RotateValveLevel0-v1", max_episode_steps=80)
class RotateValveLevel0Env(_RotateValveLevelEnv):
    success_threshold = np.pi / 2
    random_direction = False


@register_env("RotateValveLevel1-v1", max_episode_steps=150)
class RotateValveLevel1Env(_RotateValveLevelEnv):
    pass


@register_env("RotateValveLevel2-v1", max_episode_steps=150)
class RotateValveLevel2Env(_RotateValveLevelEnv):
    random_heads = True


@register_env("RotateValveLevel3-v1", max_episode_steps=150)
class RotateValveLevel3Env(_RotateValveLevelEnv):
    random_heads = True
    random_lengths = True


@register_env("RotateValveLevel4-v1", max_episode_steps=300)
class RotateValveLevel4Env(_RotateValveLevelEnv):
    success_threshold = 2 * np.pi
    random_heads = True
    random_lengths = True
