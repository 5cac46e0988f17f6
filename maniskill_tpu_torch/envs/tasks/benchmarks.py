"""FrankaPickCubeBenchmark-v1 and FrankaMoveBenchmark-v1: env-step
throughput envs.

Port of ``maniskill_tpu/envs/tasks/benchmarks.py``: reward ``"none"``, a
100 Hz sim and 50 Hz control (two sim steps a control step).
FrankaPickCubeBenchmark is the PickCube scene; FrankaMoveBenchmark is a
lone Panda over a ground plane (no free body: F = 0). The JAX envs' camera
configs (``:34-47``) wait for the port's sensors, as every ported task's
camera does: the camera keywords are accepted, and no camera is built.
"""
from __future__ import annotations

import numpy as np
import torch

from ...physics.engine import make_step_fn
from ...physics.model import SceneSpecBuilder, plane_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from .pick_cube import PickCubeEnv, pose_ik


@register_env("FrankaPickCubeBenchmark-v1", max_episode_steps=1000)
class FrankaPickCubeBenchmarkEnv(PickCubeEnv):
    SUPPORTED_REWARD_MODES = ("none",)
    SIM_FREQ = 100
    CONTROL_FREQ = 50

    def __init__(self, *args, reward_mode: str = "none", camera_width: int = 128,
                 camera_height: int = 128, num_cameras: int = 1, **kwargs):
        # the camera keywords are accepted as the JAX env's; no camera is
        # built until the port has sensors
        super().__init__(*args, reward_mode="none", **kwargs)


@register_env("FrankaMoveBenchmark-v1", max_episode_steps=1000)
class FrankaMoveBenchmarkEnv(BaseEnv):
    SUPPORTED_REWARD_MODES = ("none",)
    SIM_FREQ = 100
    CONTROL_FREQ = 50

    tip_below_tcp = 0.0094  # how far the finger boxes reach below the TCP

    def __init__(self, *args, reward_mode: str = "none", **kwargs):
        super().__init__(*args, reward_mode="none", **kwargs)

    def _load_scene(self, builder: SceneSpecBuilder):
        builder.add_static_body("ground", np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                                [plane_geom()])

    def evaluate(self, state: EnvState, ctx: TaskContext):
        return dict(success=torch.zeros(state.sim.qpos.shape[0], dtype=torch.bool,
                                        device=self.device))

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact, for checks of the physics step: the
        hand pointing down (IK) with the open fingertips pressed 0-3 mm
        into the ground at a random point 0.35-0.6 m in front of the base,
        small random joint velocities, the arm holding its pose; one control
        step of the plain physics step then loads the warm-start
        impulses."""
        dev, sim = self.device, state.sim
        K = sim.qpos.shape[0]
        p = torch.cat([self._uniform(gen, (K, 2), [0.35, -0.2], [0.6, 0.2]),
                       self._uniform(gen, (K, 1), self.tip_below_tcp - 0.003,
                                     self.tip_below_tcp)], -1)
        down = torch.tensor([0.0, 1.0, 0.0, 0.0], device=dev).expand(K, 4)
        qpos = pose_ik(self, sim.qpos, p, down)
        qpos[:, 7:9] = 0.04
        qvel = 0.02 * torch.randn(qpos.shape, generator=gen, device=dev)
        cmd = self.agent.controller.reset(qpos)
        sim = make_step_fn(self.model)(sim.replace(qpos=qpos, qvel=qvel), cmd,
                                       self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)
