"""In-hand rotation with the Allegro hand.

Port of ``maniskill_tpu/envs/tasks/rotate_in_hand.py`` (``:22-214``):
RotateCubeInHandAllegro-v1 and the RotateSingleObjectInHand ladder,
Level0-v1 to Level3-v1. An upturned Allegro hand (its base turned by a
quaternion with negative w, the palm's top near z = 0.19) holds an object
dropped on it from z = 0.26 and should turn it about +z. ``_update_extras``
accumulates the object's signed z rotation from the quaternion step of each
control step (``cum_angle``); success is a quarter turn without a drop
below z = 0.10. The dense reward is 0.1 + 2 x progress while alive and 3 on
success; the normalized one divides by 3. The state obs adds the object's
pose and the cumulative angle.

The ladder: Level0 a fixed 4 cm cube (half 0.04); Level1 a cube size per
env (``geom_size``, ``free_mass`` and ``free_inertia`` written per env);
Levels 2 and 3 a convex hull per env from the procedural library
(``physics/hulls.py``), its contact cloud, face planes, mass, inertia and
AABB written into each env's tables; Level3 also draws each env's density
in [200, 1200]. Draws use the port's generator, with the JAX task's
distributions.

``contact_state`` lets the dropped object settle on the fingers under zero
action, for checks of the physics step in contact.
"""
from __future__ import annotations

import numpy as np
import torch

from ...math import clamps
from ...math.rotations import quat_conjugate, quat_mul
from ...physics.engine import make_step_fn
from ...physics.hulls import pad_library, standard_object_library
from ...physics.model import SceneSpecBuilder, box_geom, plane_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env


@register_env("RotateCubeInHandAllegro-v1", max_episode_steps=300)
class RotateCubeInHandAllegroEnv(BaseEnv):
    DEFAULT_ROBOT = "allegro_hand_right"

    cube_half = 0.035
    density = 400.0
    target_cum_angle = np.pi / 2
    drop_height = 0.10  # below the hand plane: dropped

    def _load_agent(self, builder: SceneSpecBuilder):
        # hand horizontal (fingers along -x, thumb +x), top surface ~z=0.19
        pose = np.array([0.0, 0.0, 0.18, -0.7071068, 0.0, 0.7071068, 0.0], np.float32)
        self.agent.install(builder, pose)

    def _load_ground(self, builder: SceneSpecBuilder):
        builder.add_static_body("ground", np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                                [plane_geom(friction=0.6)])

    def _add_cube(self, builder: SceneSpecBuilder):
        half = self.cube_half
        m = self.density * (2 * half) ** 3
        inertia = (2.0 / 3.0) * m * half * half * np.eye(3)
        self.cube = builder.add_free_body("cube", m, inertia,
                                          [box_geom([half] * 3, friction=1.0)])

    def _load_scene(self, builder: SceneSpecBuilder):
        self._load_ground(builder)
        self._add_cube(builder)
        builder.exclude_groups(["cube"], ["ground"])

    def _post_build(self):
        self._geom = self.model.geom_indices("cube")[0]

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        dxy = self._uniform(gen, (K, 2), -0.01, 0.01)
        rest = torch.tensor([1.0, 0, 0, 0], device=dev).expand(K, 4)
        pose = torch.cat([dxy + torch.tensor([-0.02, 0.01], device=dev),
                          torch.full((K, 1), 0.26, device=dev), rest], -1)
        free_pose = state.sim.free_pose.clone()
        free_pose[:, self.cube] = pose
        extras = dict(state.extras, cum_angle=torch.zeros(K, device=dev),
                      prev_quat=pose[:, 3:7].clone())
        return state.replace(sim=state.sim.replace(
            free_pose=free_pose, free_vel=state.sim.free_vel * 0.0), extras=extras)

    def _update_extras(self, state: EnvState, ctx: TaskContext) -> EnvState:
        q = state.sim.free_pose[:, self.cube, 3:7]
        dq = quat_mul(q, quat_conjugate(state.extras["prev_quat"]))
        # signed z-rotation increment from the quaternion step
        dang = 2.0 * torch.atan2(dq[:, 3], clamps.maximum(clamps.abs(dq[:, 0]), 1e-9))
        dang = dang * torch.sign(dq[:, 0])
        extras = dict(state.extras, cum_angle=state.extras["cum_angle"] + dang, prev_quat=q)
        return state.replace(extras=extras)

    def evaluate(self, state: EnvState, ctx: TaskContext):
        dropped = state.sim.free_pose[:, self.cube, 2] < self.drop_height
        rotated = state.extras["cum_angle"] >= self.target_cum_angle
        return dict(success=rotated & ~dropped, fail=dropped,
                    cum_angle=state.extras["cum_angle"])

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        if "state" in self.obs_mode:
            return dict(cube_pose=ctx.actor_pose("cube").raw,
                        cum_angle=state.extras["cum_angle"][:, None])
        return {}

    def compute_dense_reward(self, state, action, info, ctx):
        prog = clamps.clip(state.extras["cum_angle"] / self.target_cum_angle, 0.0, 1.0)
        alive = 1.0 - info["fail"].to(prog.dtype)
        reward = alive * (0.1 + 2.0 * prog)
        return torch.where(info["success"], torch.full_like(reward, 3.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 3.0

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` after 5 control steps of zero action through the plain
        step: the dropped object comes to rest on the fingers (or spins on a
        fingertip, or falls off in a few envs), and its points against the
        capsules carry load. ``gen`` draws a small random finger velocity at
        the start, so that the envs settle apart."""
        sim = state.sim.replace(qvel=0.1 * torch.randn(state.sim.qpos.shape, generator=gen,
                                                       device=self.device))
        step = make_step_fn(self.model)
        ctrl = self.agent.controller
        cmd = state.cmd
        zero = torch.zeros(sim.qpos.shape[0], self.action_dim, device=self.device)
        for _ in range(5):
            cmd = ctrl.set_action(cmd, sim.qpos, zero)
            sim = step(sim, cmd, self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)


class _RotateSingleObjectLevelEnv(RotateCubeInHandAllegroEnv):
    """The RotateSingleObjectInHand ladder (JAX ``:84-187``)."""

    random_size = False  # level 1
    use_hulls = False  # levels 2 and 3
    random_density = False  # level 3
    cube_half = 0.04
    density = 400.0

    def __init__(self, *args, **kwargs):
        if self.use_hulls:
            self._lib = standard_object_library()
            (self._verts_t, self._faces_t, self._vol_t, self._inert_t,
             self._aabb_t) = pad_library(self._lib)
        super().__init__(*args, **kwargs)

    def _load_scene(self, builder: SceneSpecBuilder):
        self._load_ground(builder)
        if self.use_hulls:
            self.cube = builder.add_free_hull("cube", self._lib[0], density=self.density)
        else:
            self._add_cube(builder)
        builder.exclude_groups(["cube"], ["ground"])

    def _post_build(self):
        super()._post_build()
        self._slot = int(self.model.geom_hull_slot[self._geom])

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        state = super()._initialize_episode(state, gen)
        K = state.sim.qpos.shape[0]
        dev = self.device
        sim = state.sim
        geom_size, free_mass = sim.geom_size.clone(), sim.free_mass.clone()
        free_inertia = sim.free_inertia.clone()
        eye = torch.eye(3, device=dev)
        if self.random_size:
            half = clamps.clip((torch.randn(K, generator=gen, device=dev) * 0.1 + 1.0) * 0.04,
                               0.025, 0.055)
            m = self.density * (2.0 * half) ** 3
            geom_size[:, self._geom] = half[:, None].expand(K, 3)
            free_mass[:, self.cube] = m
            free_inertia[:, self.cube] = ((2.0 / 3.0) * m * half * half)[:, None, None] * eye
        if self.use_hulls:
            mid = torch.randint(0, len(self._lib), (K,), generator=gen, device=dev)
            if self.random_density:
                dens = self._uniform(gen, (K,), 200.0, 1200.0)
            else:
                dens = torch.full((K,), self.density, device=dev)

            def table(name):
                return torch.as_tensor(getattr(self, name), device=dev)[mid]

            hull_verts, hull_faces = sim.hull_verts.clone(), sim.hull_faces.clone()
            hull_verts[:, self._slot] = table("_verts_t")
            hull_faces[:, self._slot] = table("_faces_t")
            free_mass[:, self.cube] = table("_vol_t") * dens
            free_inertia[:, self.cube] = table("_inert_t") * dens[:, None, None]
            geom_size[:, self._geom] = table("_aabb_t")
            sim = sim.replace(hull_verts=hull_verts, hull_faces=hull_faces)
        return state.replace(sim=sim.replace(geom_size=geom_size, free_mass=free_mass,
                                             free_inertia=free_inertia))


@register_env("RotateSingleObjectInHandLevel0-v1", max_episode_steps=300)
class RotateSingleObjectLevel0Env(_RotateSingleObjectLevelEnv):
    pass


@register_env("RotateSingleObjectInHandLevel1-v1", max_episode_steps=300)
class RotateSingleObjectLevel1Env(_RotateSingleObjectLevelEnv):
    random_size = True


@register_env("RotateSingleObjectInHandLevel2-v1", max_episode_steps=300)
class RotateSingleObjectLevel2Env(_RotateSingleObjectLevelEnv):
    use_hulls = True


@register_env("RotateSingleObjectInHandLevel3-v1", max_episode_steps=300)
class RotateSingleObjectLevel3Env(_RotateSingleObjectLevelEnv):
    use_hulls = True
    random_density = True
