"""Control-suite CartPole tasks: MS-CartpoleBalance-v1 and
MS-CartpoleSwingUp-v1.

Port of ``maniskill_tpu/envs/tasks/cartpole.py`` (``:22-93``): the
dm_control cart-pole with the same randomizations, the dense reward
product (upright * centered * small_control * small_velocity) and the
balance task's fail condition (pole below horizontal). The scene has no
geoms and no contact points (P=0): its physics step is the tree dynamics,
the slider's PD drive and the solve. ``CartpoleBalanceBenchmark-v1``
renders, and waits for the renderer.
"""
from __future__ import annotations

import math

import torch

from ...physics.model import SceneSpecBuilder
from .. import rewards
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env


class CartpoleEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["cart_pole"]
    DEFAULT_ROBOT = "cart_pole"

    def __init__(self, **kwargs):
        kwargs.setdefault("control_mode", "pd_joint_delta_pos")
        kwargs.setdefault("robot_init_qpos_noise", 0.0)
        super().__init__(**kwargs)

    def _load_scene(self, builder: SceneSpecBuilder):
        pass  # no collision scene: the MJCF disables contact

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        lin, ang = ctx.body_velocity(1)  # pole_1
        return dict(velocity=lin, angular_velocity=ang)

    @staticmethod
    def _pole_angle_cosine(state):
        return torch.cos(state.sim.qpos[:, 1])

    def compute_dense_reward(self, state, action, info, ctx):
        cart_pos = ctx.body_pos[:, 0, 0]  # cart x
        centered = (1 + rewards.tolerance(cart_pos, margin=2)) / 2
        small_control = (4 + rewards.tolerance(action[:, 0], margin=1, value_at_margin=0,
                                               sigmoid="quadratic")) / 5
        small_velocity = (1 + rewards.tolerance(state.sim.qvel[:, 1], margin=5)) / 2
        upright = (self._pole_angle_cosine(state) + 1) / 2
        return upright * centered * small_control * small_velocity


@register_env("MS-CartpoleBalance-v1", max_episode_steps=1000)
class CartpoleBalanceEnv(CartpoleEnv):
    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K, dev = state.sim.qpos.shape[0], self.device
        qpos = torch.stack([self._uniform(gen, (K,), -0.1, 0.1),
                            self._uniform(gen, (K,), -0.034, 0.034)], dim=-1)
        qvel = 0.01 * torch.randn((K, 2), generator=gen, device=dev)
        return state.replace(sim=state.sim.replace(qpos=qpos, qvel=qvel))

    def evaluate(self, state, ctx):
        K = state.sim.qpos.shape[0]
        return dict(fail=self._pole_angle_cosine(state) < 0,
                    success=torch.zeros(K, dtype=torch.bool, device=self.device))


@register_env("MS-CartpoleSwingUp-v1", max_episode_steps=1000)
class CartpoleSwingUpEnv(CartpoleEnv):
    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K, dev = state.sim.qpos.shape[0], self.device
        qpos = 0.01 * torch.randn((K, 2), generator=gen, device=dev)
        qpos[:, 1] += math.pi
        qvel = 0.01 * torch.randn((K, 2), generator=gen, device=dev)
        return state.replace(sim=state.sim.replace(qpos=qpos, qvel=qvel))
