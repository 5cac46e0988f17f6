"""TableTopFreeDraw-v1: draw dots on the tabletop with the Panda's stick.

Port of ``maniskill_tpu/envs/tasks/draw.py``: a budget of ``MAX_DOTS``
geomless kinematic dots, parked below the table at reset; after each
control step in which the stick's tip is within 8 mm of the canvas, the
dot of index ``elapsed_steps - 1`` is placed under the tip (otherwise that
dot is parked). The placement is one scatter into each env's ``kin_pose``
on the device, with no host read. No success condition (free drawing).
"""
from __future__ import annotations

import torch

from ..._consts import const
from ...physics.engine import make_step_fn
from ...physics.model import SceneSpecBuilder
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from ..scene_builders import TableSceneBuilder
from .pick_cube import pose_ik


@register_env("TableTopFreeDraw-v1", max_episode_steps=300)
class TableTopFreeDrawEnv(BaseEnv):
    DEFAULT_ROBOT = "panda_stick"

    MAX_DOTS = 300  # one a control step of an episode
    DOT_THICKNESS = 0.003
    CANVAS_THICKNESS = 0.0  # the tabletop is at z = 0

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, _ = self.table_scene.robot_pose_and_qpos("panda")
        self.agent.install(builder, pose)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        # contiguous kinematic bodies without geoms
        self.dot_ids = [builder.add_kinematic_body(f"dot_{i}") for i in range(self.MAX_DOTS)]

    def _parked(self):
        return const(self, "parked", [0.0, 0.0, -self.DOT_THICKNESS, 1.0, 0.0, 0.0, 0.0],
                     self.device)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        kin = state.sim.kin_pose.clone()
        d0 = self.dot_ids[0]
        kin[:, d0:d0 + self.MAX_DOTS] = self._parked()
        return state.replace(sim=state.sim.replace(kin_pose=kin))

    def _touching(self, tcp_p: torch.Tensor) -> torch.Tensor:
        return tcp_p[:, 2] < self.CANVAS_THICKNESS + self.DOT_THICKNESS + 0.005

    def _update_extras(self, state: EnvState, ctx: TaskContext) -> EnvState:
        """The dot of index ``elapsed_steps - 1`` (clipped to the budget)
        under the tip where it touches the canvas, else parked."""
        tcp = ctx.tcp_pose.p
        K = tcp.shape[0]
        on = torch.cat([tcp[:, :2], torch.full_like(tcp[:, :1],
                                                    self.DOT_THICKNESS / 2 + self.CANVAS_THICKNESS),
                        const(self, "ident", [1.0, 0.0, 0.0, 0.0], self.device).expand(K, 4)], -1)
        dot = torch.where(self._touching(tcp)[:, None], on, self._parked())
        idx = self.dot_ids[0] + torch.clamp(state.elapsed_steps.long() - 1, 0, self.MAX_DOTS - 1)
        kin = state.sim.kin_pose.scatter(1, idx[:, None, None].expand(K, 1, 7), dot[:, None])
        return state.replace(sim=state.sim.replace(kin_pose=kin))

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact, for checks of the physics step: the
        stick, pointing down (IK), presses its tip 1-2 mm into the tabletop
        at a random point of the drawing area, with small random joint
        velocities and the arm holding its pose; the dots are scattered over
        the area (they have no geoms: only the kernel's input row carries
        them); one control step of the plain physics step then loads the
        warm-start impulses."""
        dev, sim = self.device, state.sim
        K = sim.qpos.shape[0]
        p = torch.cat([self._uniform(gen, (K, 2), [-0.2, -0.2], [0.1, 0.1]),
                       -self._uniform(gen, (K, 1), 1e-3, 2e-3)], -1)
        down = torch.tensor([0.0, 1.0, 0.0, 0.0], device=dev).expand(K, 4)
        qpos = pose_ik(self, sim.qpos, p, down)
        qvel = 0.02 * torch.randn(qpos.shape, generator=gen, device=dev)
        kin = sim.kin_pose.clone()
        d0 = self.dot_ids[0]
        kin[:, d0:d0 + self.MAX_DOTS, :2] = self._uniform(gen, (K, self.MAX_DOTS, 2), -0.2, 0.1)
        cmd = self.agent.controller.reset(qpos)
        sim = make_step_fn(self.model)(sim.replace(qpos=qpos, qvel=qvel, kin_pose=kin), cmd,
                                       self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)

    def _get_obs_extra(self, state, ctx, info):
        return dict(tcp_pose=ctx.tcp_pose.raw)
