"""PickSingleHull-v1: pick up a convex-hull object that differs per env.

Port of ``maniskill_tpu/envs/tasks/pick_single_hull.py``. Every env
grasps its own object: the hull's contact cloud and face planes are
per-env simulation state (``SimState.hull_verts``/``hull_faces``), so a
reset selects each env's object by indexing the padded library tables, as
do its mass, inertia, rest height and AABB half extents. Objects come from
the procedural 8-hull library (``physics/hulls.py``
``standard_object_library``). The body keeps the name "cube", so
PickCube's grasp checker, evaluate and obs extras apply as they are.

``reconfiguration_freq`` (JAX ``_init_with_prev``, ``:80-111``): a reset of
a live env keeps its object unless the env's ``episode_count`` is a
multiple of the frequency (1, the default: a new object every reset).
"""
from __future__ import annotations

import torch

from ...physics.hulls import pad_library, standard_object_library
from ..base_env import EnvState
from ..registration import register_env
from .pick_cube import PickCubeEnv


def set_hull_library(env, lib):
    """Put the hull library ``lib`` and its padded index-selectable tables
    on ``env`` (``ycb_variants.py:_set_hull_library_on``)."""
    env._lib = lib
    (env._verts_t, env._faces_t, env._vol_t, env._inert_t, env._aabb_t) = pad_library(lib)


@register_env("PickSingleHull-v1", max_episode_steps=50)
class PickSingleHullEnv(PickCubeEnv):
    density = 1000.0

    def __init__(self, *args, reconfiguration_freq: int = 1, **kwargs):
        self.reconfiguration_freq = max(int(reconfiguration_freq), 1)
        set_hull_library(self, standard_object_library())
        super().__init__(*args, **kwargs)

    def _load_scene(self, builder):
        self.table_scene.build(builder)
        self.cube = builder.add_free_hull("cube", self._lib[0], density=self.density)
        self.goal_site = builder.add_kinematic_body("goal_site")

    def _post_build(self):
        super()._post_build()
        self._geom = self.model.geom_indices("cube")[0]
        self._slot = int(self.model.geom_hull_slot[self._geom])

    def compute_dense_reward(self, state, action, info, ctx):
        # reach + grasped + place * grasped + placed * grasped
        # + static * placed * grasped; success -> 6 (JAX :47-68)
        obj_p = ctx.actor_pose("cube").p
        goal_p = ctx.actor_pose("goal_site").p
        reward = 1.0 - torch.tanh(5.0 * torch.linalg.norm(obj_p - ctx.tcp_pose.p, dim=-1))
        grasped = info["is_grasped"].to(torch.float32)
        reward = reward + grasped
        place = 1.0 - torch.tanh(5.0 * torch.linalg.norm(goal_p - obj_p, dim=-1))
        reward = reward + place * grasped
        placed = info["is_obj_placed"].to(torch.float32)
        reward = reward + placed * grasped
        static = 1.0 - torch.tanh(5.0 * torch.linalg.norm(state.sim.qvel[..., :-2], dim=-1))
        reward = reward + static * placed * grasped
        return torch.where(info["success"], torch.full_like(reward, 6.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 6.0

    def _default_extras(self, batch):
        zeros = torch.zeros(batch, dtype=torch.int32, device=self.device)
        return dict(super()._default_extras(batch), episode_count=zeros, model_id=zeros)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        return self._init_with_prev(state, gen, None)

    def _initialize_episode_prev(self, state, gen, prev):
        return self._init_with_prev(state, gen, prev)

    def _draw_model(self, gen: torch.Generator, K: int) -> torch.Tensor:
        """New objects' library rows (K,)."""
        return torch.randint(0, len(self._lib), (K,), generator=gen, device=self.device)

    def _init_with_prev(self, state: EnvState, gen: torch.Generator, prev) -> EnvState:
        """PickCube's placement, then a library object per env: a new one,
        or with ``prev`` the previous episode's where the env's episode
        count is not a multiple of ``reconfiguration_freq`` (JAX
        ``_init_with_prev``, ``:80-111``)."""
        state = super()._initialize_episode(state, gen)
        K = state.sim.qpos.shape[0]
        dev = self.device
        mid = self._draw_model(gen, K)
        count = torch.zeros(K, dtype=torch.int32, device=dev)
        if prev is not None:
            count = prev.extras["episode_count"]
            resample = count % self.reconfiguration_freq == 0
            mid = torch.where(resample, mid, prev.extras["model_id"].to(mid.dtype))

        def table(name):
            return torch.as_tensor(getattr(self, name), device=dev)[mid]

        sim = state.sim
        hull_verts, hull_faces = sim.hull_verts.clone(), sim.hull_faces.clone()
        free_mass, free_inertia = sim.free_mass.clone(), sim.free_inertia.clone()
        free_pose, geom_size = sim.free_pose.clone(), sim.geom_size.clone()
        aabb = table("_aabb_t")
        hull_verts[:, self._slot] = table("_verts_t")
        hull_faces[:, self._slot] = table("_faces_t")
        free_mass[:, self.cube] = table("_vol_t") * self.density
        free_inertia[:, self.cube] = table("_inert_t") * self.density
        # rest at the object's own height (PickCube placed a 2 cm cube)
        free_pose[:, self.cube, 2] = aabb[:, 2]
        geom_size[:, self._geom] = aabb
        extras = dict(state.extras, episode_count=count + 1, model_id=mid.to(torch.int32))
        return state.replace(sim=sim.replace(
            hull_verts=hull_verts, hull_faces=hull_faces, free_mass=free_mass,
            free_inertia=free_inertia, free_pose=free_pose, geom_size=geom_size),
            extras=extras)

    def _get_obs_extra(self, state, ctx, info):
        obs = super()._get_obs_extra(state, ctx, info)
        if "state" in self.obs_mode:
            obs["obj_aabb_half"] = state.sim.geom_size[:, self._geom]
            obs["obj_mass"] = state.sim.free_mass[:, self.cube, None]
        return obs
