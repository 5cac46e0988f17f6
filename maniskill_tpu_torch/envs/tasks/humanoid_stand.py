"""Humanoid standing: UnitreeH1Stand-v1.

Port of ``maniskill_tpu/envs/tasks/humanoid_stand.py`` (``:22-108``). The
Unitree H1 (25 dofs, ``agents/robots/quadruped.py``) stands on a floor
plane at its standing keyframe, each body joint offset by normal(0, 0.02)
rad at reset (the root's six dofs not); 100 Hz sim of 2 substeps, 50 Hz
control, ``pd_joint_delta_pos`` by default. Success while the pelvis is
between 0.8 and 1.2 m high; fail below 0.3 m. The sparse reward is the
standing flag; the dense one a height tolerance (margin 0.5 m) times
(4 + the small-control tolerance of the action) / 5.

UnitreeG1Stand-v1 (JAX ``:110``) is not ported: it needs the G1 of
``unitree.py``, whose quaternion root (nq 37) is off the kernel's path.

The reset's random draw comes from ``_draw`` (the port's generator), so
that a test can feed another package's draw.
"""
from __future__ import annotations

import torch

from .. import rewards
from ..base_env import EnvState, TaskContext
from ..registration import register_env
from .quadruped import LeggedEnv


class _HumanoidStandEnv(LeggedEnv):
    FLOOR_CONTACT = ("plane_box", "plane_sphere")  # box feet; the head sphere
    stand_low = 0.8
    stand_high = 1.2
    fallen_z = 0.3

    def _post_build(self):
        super()._post_build()
        self._base_idx = self.model.robot.link_index[self.agent.base_link]

    def _draw(self, gen: torch.Generator, K: int) -> dict:
        """The joints' offsets (K, nq): normal(0, 0.02), 0 on the root's six."""
        noise = 0.02 * torch.randn((K, self.model.nq), generator=gen, device=self.device)
        noise[:, :6] = 0.0
        return dict(noise=noise)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        noise = self._draw(gen, state.sim.qpos.shape[0])["noise"]
        qpos = torch.as_tensor(self._default_qpos, device=self.device) + noise
        return state.replace(sim=state.sim.replace(qpos=qpos,
                                                   qvel=torch.zeros_like(state.sim.qvel)))

    def _pelvis_z(self, ctx: TaskContext) -> torch.Tensor:
        return ctx.body_pos[:, self._base_idx, 2]

    def evaluate(self, state: EnvState, ctx: TaskContext):
        z = self._pelvis_z(ctx)
        is_standing = (z > self.stand_low) & (z < self.stand_high)
        return dict(success=is_standing, is_standing=is_standing, fail=z < self.fallen_z)

    def _get_obs_extra(self, state, ctx, info):
        return dict(pelvis_z=self._pelvis_z(ctx)[:, None])

    def compute_sparse_reward(self, state, action, info, ctx):
        return info["is_standing"].to(torch.float32)

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        mid = 0.5 * (self.stand_low + self.stand_high)
        standing = rewards.tolerance(self._pelvis_z(ctx), lower=self.stand_low,
                                     upper=self.stand_high, margin=mid / 2)
        small_control = rewards.tolerance(action, margin=1.0, value_at_margin=0.0,
                                          sigmoid="quadratic").mean(-1)
        return standing * (4.0 + small_control) / 5.0


@register_env("UnitreeH1Stand-v1", max_episode_steps=1000)
class UnitreeH1StandEnv(_HumanoidStandEnv):
    DEFAULT_ROBOT = "unitree_h1"
