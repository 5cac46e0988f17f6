"""PickSingleObject-v1: pick up a box whose size and mass differ per env.

Port of ``maniskill_tpu/envs/tasks/pick_single_object.py``: PickCube with
the cube's half sizes drawn from U[0.015, 0.03]³ and a density from
U[300, 1500] per env, so its ``geom_size``, ``free_mass`` and
``free_inertia`` are per-env simulation state. ``reconfiguration_freq``:
a reset of a live env keeps its object unless the env's ``episode_count``
is a multiple of the frequency (1, the default: a new object every reset).
"""
from __future__ import annotations

import torch

from ..base_env import EnvState
from ..registration import register_env
from .pick_cube import PickCubeEnv


@register_env("PickSingleObject-v1", max_episode_steps=50)
class PickSingleObjectEnv(PickCubeEnv):
    half_lo = 0.015
    half_hi = 0.030
    density_lo = 300.0
    density_hi = 1500.0

    def __init__(self, *args, reconfiguration_freq: int = 1, **kwargs):
        self.reconfiguration_freq = max(int(reconfiguration_freq), 1)
        super().__init__(*args, **kwargs)

    def _post_build(self):
        super()._post_build()
        self._geom = self.model.geom_indices("cube")[0]

    def _default_extras(self, batch):
        return dict(super()._default_extras(batch),
                    episode_count=torch.zeros(batch, dtype=torch.int32, device=self.device))

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        return self._init_with_prev(state, gen, None)

    def _initialize_episode_prev(self, state, gen, prev):
        return self._init_with_prev(state, gen, prev)

    def _draw_object(self, gen: torch.Generator, K: int):
        """New objects' half sizes (K, 3) and densities (K,)."""
        return (self._uniform(gen, (K, 3), self.half_lo, self.half_hi),
                self._uniform(gen, (K,), self.density_lo, self.density_hi))

    def _init_with_prev(self, state: EnvState, gen: torch.Generator, prev) -> EnvState:
        """PickCube's placement, then the object: new half sizes and a new
        density, or with ``prev`` the previous episode's size, mass and
        inertia where the env's episode count is not a multiple of
        ``reconfiguration_freq``; the object rests on the table at its own
        half height (JAX ``_init_with_prev``, ``:49-90``)."""
        state = super()._initialize_episode(state, gen)
        K = state.sim.qpos.shape[0]
        half, density = self._draw_object(gen, K)
        src = state if prev is None else prev
        old_half = src.sim.geom_size[:, self._geom]
        old_m = src.sim.free_mass[:, self.cube]
        old_inertia = src.sim.free_inertia[:, self.cube]
        if prev is None:
            count = torch.zeros(K, dtype=torch.int32, device=self.device)
            resample = torch.ones(K, dtype=torch.bool, device=self.device)
        else:
            count = prev.extras["episode_count"]
            resample = count % self.reconfiguration_freq == 0
        half = torch.where(resample[:, None], half, old_half)
        hx, hy, hz = half.unbind(-1)
        m = torch.where(resample, density * (8.0 * hx * hy * hz), old_m)
        inertia = (m / 3.0)[:, None, None] * torch.diag_embed(
            torch.stack([hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy], -1))
        inertia = torch.where(resample[:, None, None], inertia, old_inertia)
        sim = state.sim
        geom_size, free_pose = sim.geom_size.clone(), sim.free_pose.clone()
        free_mass, free_inertia = sim.free_mass.clone(), sim.free_inertia.clone()
        geom_size[:, self._geom] = half
        free_mass[:, self.cube] = m
        free_inertia[:, self.cube] = inertia
        free_pose[:, self.cube, 2] = hz  # resting on the table at its own height
        return state.replace(
            sim=sim.replace(geom_size=geom_size, free_mass=free_mass,
                            free_inertia=free_inertia, free_pose=free_pose),
            extras=dict(state.extras, episode_count=count + 1))

    def _get_obs_extra(self, state, ctx, info):
        obs = super()._get_obs_extra(state, ctx, info)
        if "state" in self.obs_mode:
            obs["obj_half_size"] = state.sim.geom_size[:, self._geom]
            obs["obj_mass"] = state.sim.free_mass[:, self.cube, None]
        return obs
