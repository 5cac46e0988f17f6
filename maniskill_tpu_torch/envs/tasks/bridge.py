"""BridgeData v2 digital-twin tasks (real2sim) with the WidowX-250S.

Port of ``maniskill_tpu/envs/tasks/bridge.py``: the WidowX at the measured
rig pose over a flat-table (or sink) scene, a source and a target object
placed on the reference's discrete position and orientation grids
(``_grid_xy``, ``_pair_configs``; one grid cell and one orientation pair
drawn per env), the success logic (bounding-box xy and z flags, the
source-target contact force where ``require_contact``), the
``consecutive_grasp`` count and the latched ``is_src_obj_grasped`` flag
kept in the env's extras, ``get_language_instruction``, and the shaped
dense reward the JAX package adds (the reference exposes reward "none"
only). The objects are the JAX package's procedural hulls
(``_bridge_objects``: carrot, plate, spoon, eggplant). The procedural
stand-in for the real inpainting photo (``_procedural_overlay``) is kept
as data: the greenscreen compositing is a camera path, and the port's
sensors are not written yet.

Ids: PutCarrotOnPlateInScene-v1, PutSpoonOnTableClothInScene-v1,
StackGreenCubeOnYellowCubeBakedTexInScene-v1 and PutEggplantInBasketScene-v1
(the sink: a visual counter slab, a basin of boxes and a geomless
kinematic ``basket_site`` on its floor).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..._consts import const
from ...physics.engine import make_step_fn, pair_force_signs
from ...math.rotations import quat_apply
from ...physics.hulls import _cylinder_pts, _frustum_pts, make_hull
from ...physics.model import BodyKind, SceneSpecBuilder, box_geom, plane_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from .pick_cube import pose_ik

TABLE_Z = 0.87  # the bridge rig's table height; the world's tabletop is z = 0

# a z-axis solid turned onto +x (hulls are point clouds: right-multiply)
_ROT_YX = np.array([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])

# the WidowX gripper's capsule (``gripper_link``: radius 0.022, its axis
# from 0 to 0.09 m) lies 0.085 m (its middle) behind the TCP (0.13 m)
_PALM_BACK, _PALM_R = 0.085, 0.022


def _bridge_objects() -> Dict[str, object]:
    """Procedural hulls sized like the bridge real2sim models."""
    out = {}
    # carrot: a tapered spindle ~11 cm long, 3.5 cm across, along +x
    out["carrot"] = make_hull("carrot", np.concatenate([
        _frustum_pts(0.0175, 0.010, 0.055, 8) @ _ROT_YX,
        (_frustum_pts(0.0145, 0.0175, 0.055, 8) * np.array([1, 1, -1])) @ _ROT_YX]))
    # plate: a shallow 16-gon disc, 17 cm across, 1.6 cm tall
    out["plate"] = make_hull("plate", _cylinder_pts(0.085, 0.016, 16))
    # spoon: a flat utensil ~13 x 4 x 1.4 cm along +x
    out["spoon"] = make_hull("spoon", np.concatenate([
        _cylinder_pts(0.019, 0.012, 8) + np.array([0.04, 0, 0]),  # the bowl
        np.array([[x, y, z] for x in (-0.065, 0.02) for y in (-0.008, 0.008)
                  for z in (-0.006, 0.006)])]))
    # eggplant: a fat spindle ~12 cm long, 6 cm across
    out["eggplant"] = make_hull("eggplant", np.concatenate([
        _frustum_pts(0.030, 0.016, 0.060, 8) @ _ROT_YX,
        (_frustum_pts(0.024, 0.030, 0.060, 8) * np.array([1, 1, -1])) @ _ROT_YX]))
    return out


def _procedural_overlay(h: int = 128, w: int = 128) -> np.ndarray:
    """The stand-in for the real inpainting photo: a warm table gradient
    below the horizon, a grey wall above."""
    yy = np.linspace(0, 1, h)[:, None]
    xx = np.linspace(0, 1, w)[None, :]
    wall = np.stack([150 + 20 * xx, 148 + 18 * xx, 145 + 15 * xx], -1)
    table = np.stack([170 - 40 * yy + 0 * xx, 140 - 35 * yy + 0 * xx,
                      105 - 25 * yy + 0 * xx], -1)
    img = np.where(yy[..., None] < 0.45, wall, table)
    return np.clip(img, 0, 255).astype(np.uint8)


def _grid_xy(half_x: float, half_y: float, center=(-0.16, 0.00)) -> np.ndarray:
    g = np.array([[0, 0], [0, 1], [1, 0], [1, 1]]) * 2 - 1
    return g * np.array([half_x, half_y])[None] + np.asarray(center)[None]


def _pair_configs(grid: np.ndarray) -> np.ndarray:
    """Every ordered (source, target) placement on two distinct grid cells,
    (C, 2, 2)."""
    return np.stack([np.stack([a, b]) for i, a in enumerate(grid)
                     for j, b in enumerate(grid) if i != j])


def _yaw_quat(yaw: float) -> np.ndarray:
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


class BaseBridgeEnv(BaseEnv):
    """The flat-table bridge scene: the WidowX at the measured rig pose, a
    source and a target object on discrete configuration grids."""

    DEFAULT_ROBOT = "widowx250s_bridgedataset_flat_table"
    SIM_FREQ = 100
    CONTROL_FREQ = 5

    source_name = ""
    target_name = ""
    instruction = ""
    require_contact = True
    z_flag_required_offset = 0.02
    consecutive_grasp_needed = 5

    # (C, 2, 3) positions and (Q, 2, 4) orientations of (source, target)
    xyz_configs: np.ndarray = None
    quat_configs: np.ndarray = None

    def __init__(self, *args, **kwargs):
        self.rgb_overlay_images = {"3rd_view_camera": _procedural_overlay()}
        super().__init__(*args, **kwargs)

    # -- scene -----------------------------------------------------------------
    def _load_agent(self, builder: SceneSpecBuilder):
        # the rig's robot base pose; world z = 0 is the tabletop
        pose = np.array([0.147, 0.028, 0.0, 1, 0, 0, 0], np.float32)
        self.agent.install(builder, pose, init_qpos=self.agent.keyframes["rest"].qpos)

    def _load_scene(self, builder: SceneSpecBuilder):
        builder.add_static_body("arena", np.array([0, 0, -TABLE_Z, 1, 0, 0, 0], np.float32),
                                [plane_geom(friction=0.6)])
        builder.add_static_body("table", np.array([-0.1, 0, -0.02, 1, 0, 0, 0], np.float32),
                                [box_geom([0.45, 0.6, 0.02], friction=0.6)])
        self._load_objects(builder)

    def _load_objects(self, builder: SceneSpecBuilder):
        raise NotImplementedError

    def _post_build(self):
        self._is_grasping_src = self.agent.build_grasp_checker(self.model, self.source_name,
                                                               self.device)
        if self.require_contact:
            self._src_tgt_signs = torch.as_tensor(pair_force_signs(
                self.model, (BodyKind.FREE, self.model.free_index[self.source_name]),
                (BodyKind.FREE, self.model.free_index[self.target_name])), device=self.device)

    # -- episode ---------------------------------------------------------------
    def _default_extras(self, batch: int) -> Dict[str, torch.Tensor]:
        return dict(consecutive_grasp=torch.zeros(batch, dtype=torch.int32, device=self.device),
                    is_src_obj_grasped=torch.zeros(batch, dtype=torch.bool, device=self.device))

    def _src_tgt_rest_z(self):
        """(source, target) rest heights above the tabletop."""
        raise NotImplementedError

    def _set_obj_pose(self, sim, name: str, pose: torch.Tensor):
        idx = self.model.free_index[name]
        free_pose, free_vel = sim.free_pose.clone(), sim.free_vel.clone()
        free_pose[:, idx] = pose
        free_vel[:, idx] = 0.0
        return sim.replace(free_pose=free_pose, free_vel=free_vel)

    def _draw(self, gen: torch.Generator, K: int) -> Dict[str, torch.Tensor]:
        """Each env's grid cell ``ci`` and orientation pair ``qi`` (the JAX
        ``jax.random.randint`` draws; a test hands the port those)."""
        return dict(ci=torch.randint(0, len(self.xyz_configs), (K,), generator=gen,
                                     device=self.device),
                    qi=torch.randint(0, len(self.quat_configs), (K,), generator=gen,
                                     device=self.device))

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        d = self._draw(gen, K)
        xyz = const(self, "xyz_configs", np.asarray(self.xyz_configs, np.float32), self.device)
        quat = const(self, "quat_configs", np.asarray(self.quat_configs, np.float32),
                     self.device)
        src_z, tgt_z = self._src_tgt_rest_z()
        ci, qi = d["ci"].long(), d["qi"].long()
        sim = state.sim
        for slot, name, z in ((0, self.source_name, src_z), (1, self.target_name, tgt_z)):
            pose = torch.cat([xyz[ci, slot, :2], torch.full((K, 1), z, device=self.device),
                              quat[qi, slot]], dim=-1)
            sim = self._set_obj_pose(sim, name, pose)
        return state.replace(sim=sim, extras=self._default_extras(K))

    def _z_range(self, sim, name: str):
        """The lowest and highest world z (K,) of the free body ``name``'s
        contact cloud (its hull's points, or its box's corners) relative to
        its centre at its current orientation, and the xy offset (K, 2) of
        the middle of its top (the points within 0.5 mm of the highest)."""
        model = self.model
        g = model.geom_indices(name)[0]
        q = sim.free_pose[:, model.free_index[name], 3:]
        if model.geoms[g].hull is not None and model.geoms[g].hull >= 0:
            pts = sim.hull_verts[:, int(model.geom_hull_slot[g])]
        else:
            signs = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                                  for sz in (-1, 1)], dtype=q.dtype, device=q.device)
            pts = signs * sim.geom_size[:, g, None]
        w = quat_apply(q[:, None].expand(-1, pts.shape[1], 4), pts)
        hi = w[..., 2].amax(1)
        near = (w[..., 2] >= hi[:, None] - 5e-4).to(w.dtype)[..., None]
        return w[..., 2].amin(1), hi, (near * w[..., :2]).sum(1) / near.sum(1)

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact, for checks of the physics step. The
        objects first settle for a control step (the arm holding its rest
        pose): a spindle set down on a vertex rolls onto a face. Then the
        source is set on the target where the target is a free body, 0-1
        mm into its top, and the gripper is held level over the middle of
        the source's top, pointing away from the robot's base, its capsule 0-1
        mm into it (damped least-squares IK on the six arm joints from
        the waist turned toward the source; the fingers open, clear of
        it). The arm's command holds the capsule 3 mm further in. Joint
        velocities are random; one control step of the plain physics step
        then loads the warm-start impulses. The capsule against a hull is
        ``capsule_hull`` (against the cubes ``capsule_box``); the carrot on
        the plate ``hull_hull``, the spoon on the towel ``box_hull``, the
        green cube on the yellow ``box_box``."""
        dev, model = self.device, self.model
        step = make_step_fn(model)
        sim = step(state.sim, state.cmd, self.sim_steps_per_control)
        K = sim.qpos.shape[0]
        src = model.free_index[self.source_name]
        free_pose = sim.free_pose.clone()
        lo_s, hi_s, top_xy = self._z_range(sim, self.source_name)
        if self.target_name in model.free_index:
            tgt = model.free_index[self.target_name]
            top = free_pose[:, tgt, 2] + self._z_range(sim, self.target_name)[1]
            free_pose[:, src, :2] = free_pose[:, tgt, :2]
            free_pose[:, src, 2] = top - lo_s - self._uniform(gen, (K,), 0.0, 1e-3)
        p = free_pose[:, src, :3]
        peak = p[:, :2] + top_xy  # where the capsule rests
        d = peak - torch.as_tensor(model.robot_base_pose[:2], device=dev)
        yaw = torch.atan2(d[:, 1], d[:, 0])
        xdir = torch.stack([torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], dim=-1)
        q_goal = torch.stack([torch.cos(yaw / 2), torch.zeros_like(yaw), torch.zeros_like(yaw),
                              torch.sin(yaw / 2)], dim=-1)
        press = self._uniform(gen, (K,), 0.0, 1e-3)
        p_goal = torch.cat([peak + _PALM_BACK * xdir[:, :2],
                            (p[:, 2] + hi_s + _PALM_R - press)[:, None]], dim=-1)
        # the waist turned toward the source first: the objects lie behind
        # the arm's rest pose, and from there the IK would turn the wrong way
        seed = sim.qpos.clone()
        seed[:, 0] = yaw
        qpos = pose_ik(self, seed, p_goal, q_goal, joints=range(6))
        qpos[:, 6:8] = 0.037
        qvel = 0.1 * torch.randn(qpos.shape, generator=gen, device=dev)
        qvel[:, 6:8] = 0.0
        sim = sim.replace(qpos=qpos, qvel=qvel, free_pose=free_pose,
                          free_vel=torch.zeros_like(sim.free_vel))
        down = torch.tensor([0.0, 0.0, 0.003], device=dev)
        target = pose_ik(self, qpos, p_goal - down, q_goal, joints=range(6), iters=10)
        target[:, 6:8] = 0.037
        cmd = self.agent.controller.reset(qpos).replace(target_qpos=target)
        return state.replace(sim=step(sim, cmd, self.sim_steps_per_control), cmd=cmd)

    # -- evaluation (the reference's _evaluate) --------------------------------
    def _half_bbox(self, which: str) -> np.ndarray:
        raise NotImplementedError

    def _update_extras(self, state: EnvState, ctx: TaskContext) -> EnvState:
        grasped = self._is_grasping_src(ctx.body_quat, ctx.contact_forces())
        ex = state.extras
        cg = torch.where(grasped, ex["consecutive_grasp"] + 1,
                         torch.zeros_like(ex["consecutive_grasp"])).to(torch.int32)
        return state.replace(extras=dict(ex, consecutive_grasp=cg,
                                         is_src_obj_grasped=ex["is_src_obj_grasped"] | grasped))

    def _grasp_flags(self, state: EnvState):
        ex = state.extras
        return dict(is_src_obj_grasped=ex["is_src_obj_grasped"],
                    consecutive_grasp=ex["consecutive_grasp"] >= self.consecutive_grasp_needed)

    def evaluate(self, state: EnvState, ctx: TaskContext):
        src_p = ctx.actor_pose(self.source_name).p
        tgt_p = ctx.actor_pose(self.target_name).p
        tgt_half = np.asarray(self._half_bbox("target"), np.float32)
        src_half = np.asarray(self._half_bbox("source"), np.float32)
        offset = src_p - tgt_p
        xy_flag = (torch.linalg.norm(offset[:, :2], dim=-1)
                   <= float(np.linalg.norm(tgt_half[:2])) + 0.003)
        z_flag = (offset[:, 2] > 0) & (
            offset[:, 2] - float(tgt_half[2]) - float(src_half[2]) <= self.z_flag_required_offset)
        src_on_target = xy_flag & z_flag
        if self.require_contact:
            net = torch.einsum("p,Kpc->Kc", self._src_tgt_signs.to(src_p.dtype),
                               ctx.contact_forces())
            src_on_target = src_on_target & (torch.linalg.norm(net, dim=-1) > 0.05)
        return dict(success=src_on_target, src_on_target=src_on_target,
                    **self._grasp_flags(state))

    def get_language_instruction(self):
        return [self.instruction] * self.num_envs

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if self.obs_mode in ("state", "state_dict"):
            obs.update(src_pose=ctx.actor_pose(self.source_name).raw,
                       tgt_pos=ctx.actor_pose(self.target_name).p)
        return obs

    # the height above the target the dense reward carries the source to
    carry_height = 0.08

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        src_p = ctx.actor_pose(self.source_name).p
        tgt_p = ctx.actor_pose(self.target_name).p
        reach = 1.0 - torch.tanh(5.0 * torch.linalg.norm(src_p - ctx.tcp_pose.p, dim=-1))
        grasped = self._is_grasping_src(ctx.body_quat, ctx.contact_forces()).to(src_p.dtype)
        above = tgt_p + torch.tensor([0.0, 0.0, self.carry_height], device=src_p.device)
        place = 1.0 - torch.tanh(5.0 * torch.linalg.norm(src_p - above, dim=-1))
        reward = reach + grasped * (1.0 + place)
        return torch.where(info["success"], torch.full_like(reward, 5.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 5.0


@register_env("PutCarrotOnPlateInScene-v1", max_episode_steps=60)
class PutCarrotOnPlateInScene(BaseBridgeEnv):
    source_name = "carrot"
    target_name = "plate"
    instruction = "put carrot on plate"

    def __init__(self, *args, **kwargs):
        self._hulls = _bridge_objects()
        xy = _pair_configs(_grid_xy(0.075, 0.075))
        self.xyz_configs = np.concatenate([xy, np.zeros((len(xy), 2, 1))], axis=-1)
        self.quat_configs = np.stack([np.stack([_yaw_quat(np.pi), [1, 0, 0, 0]]),
                                      np.stack([_yaw_quat(-np.pi / 2), [1, 0, 0, 0]])
                                      ]).astype(np.float32)
        super().__init__(*args, **kwargs)

    def _load_objects(self, builder):
        builder.add_free_hull("carrot", self._hulls["carrot"], density=600, friction=0.5)
        builder.add_free_hull("plate", self._hulls["plate"], density=500, friction=0.5)

    def _src_tgt_rest_z(self):
        return (float(self._hulls["carrot"].aabb_half[2]),
                float(self._hulls["plate"].aabb_half[2]))

    def _half_bbox(self, which):
        return self._hulls["carrot" if which == "source" else "plate"].aabb_half


@register_env("PutSpoonOnTableClothInScene-v1", max_episode_steps=60)
class PutSpoonOnTableClothInScene(BaseBridgeEnv):
    """Partly on the target counts; no contact force is asked."""

    source_name = "spoon"
    target_name = "towel"
    instruction = "put the spoon on the towel"
    require_contact = False
    towel_half = np.array([0.085, 0.085, 0.004], np.float32)

    def __init__(self, *args, **kwargs):
        self._hulls = _bridge_objects()
        xy = _pair_configs(_grid_xy(0.075, 0.075))
        self.xyz_configs = np.concatenate([xy, np.zeros((len(xy), 2, 1))], axis=-1)
        self.quat_configs = np.stack([np.stack([[1, 0, 0, 0], [1, 0, 0, 0]]),
                                      np.stack([_yaw_quat(np.pi / 2), [1, 0, 0, 0]])
                                      ]).astype(np.float32)
        super().__init__(*args, **kwargs)

    def _load_objects(self, builder):
        builder.add_free_hull("spoon", self._hulls["spoon"], density=800, friction=0.5)
        # the towel: a thin, light slab
        th = self.towel_half
        m = 8 * 60.0 * float(th[0] * th[1] * th[2])
        inertia = (m / 3.0) * np.diag([th[1] ** 2 + th[2] ** 2, th[0] ** 2 + th[2] ** 2,
                                       th[0] ** 2 + th[1] ** 2])
        builder.add_free_body("towel", m, inertia, [box_geom(th, friction=0.8)])

    def _src_tgt_rest_z(self):
        return float(self._hulls["spoon"].aabb_half[2]), float(self.towel_half[2])

    def _half_bbox(self, which):
        return self._hulls["spoon"].aabb_half if which == "source" else self.towel_half


@register_env("StackGreenCubeOnYellowCubeBakedTexInScene-v1", max_episode_steps=60)
class StackGreenCubeOnYellowCubeInScene(BaseBridgeEnv):
    """3 cm cubes on two grid spacings."""

    source_name = "green_cube"
    target_name = "yellow_cube"
    instruction = "stack the green block on the yellow block"
    cube_half = 0.015

    def __init__(self, *args, **kwargs):
        self.xyz_configs = np.concatenate([
            np.concatenate([_pair_configs(_grid_xy(h, h)), np.zeros((12, 2, 1))], axis=-1)
            for h in (0.05, 0.1)])
        self.quat_configs = np.stack([np.stack([[1, 0, 0, 0], [1, 0, 0, 0]])]).astype(np.float32)
        super().__init__(*args, **kwargs)

    def _load_objects(self, builder):
        half = self.cube_half
        m = 1000.0 * (2 * half) ** 3
        inertia = (2.0 / 3.0) * m * half * half * np.eye(3)
        for name in ("green_cube", "yellow_cube"):
            builder.add_free_body(name, m, inertia, [box_geom([half] * 3, friction=0.5)])

    def _src_tgt_rest_z(self):
        return self.cube_half, self.cube_half

    def _half_bbox(self, which):
        return np.array([self.cube_half] * 3, np.float32)


@register_env("PutEggplantInBasketScene-v1", max_episode_steps=120)
class PutEggplantInBasketScene(BaseBridgeEnv):
    """The sink: the target is a geomless kinematic site on the basin's
    floor; no contact force is asked, the z flag is loose, and success is
    the eggplant inside the basin's footprint and down in it."""

    source_name = "eggplant"
    target_name = "basket_site"
    instruction = "put eggplant into yellow basket"
    require_contact = False
    z_flag_required_offset = 0.06
    basin_half = np.array([0.10, 0.11, 0.01], np.float32)
    carry_height = 0.15

    def __init__(self, *args, **kwargs):
        self._hulls = _bridge_objects()
        xy_center = np.array([-0.105, 0.206])
        grid = [np.array([x, y]) + xy_center for x in np.linspace(-0.01, 0.01, 2)
                for y in np.linspace(-0.015, 0.015, 4)]
        tgt = np.array([-0.125, 0.025])
        self.xyz_configs = np.stack([np.stack([np.append(g, 0.0), np.append(tgt, 0.0)])
                                     for g in grid]).astype(np.float32)
        self.quat_configs = np.stack([np.stack([_yaw_quat(a), [1, 0, 0, 0]])
                                      for a in (-np.pi / 4, 0.0, np.pi / 4)]).astype(np.float32)
        super().__init__(*args, **kwargs)

    def _load_scene(self, builder: SceneSpecBuilder):
        builder.add_static_body("arena", np.array([0, 0, -TABLE_Z, 1, 0, 0, 0], np.float32),
                                [plane_geom(friction=0.6)])
        # a counter with a sunken basin: slabs around the basin's cutout
        bh = self.basin_half
        cx, cy = -0.125, 0.025
        builder.add_static_body("counter", np.array([0, 0, 0, 1, 0, 0, 0], np.float32), [
            # the visual slab (the basin's area open)
            box_geom([0.45, 0.6, 0.02], offset_p=[-0.1, 0, -0.02], friction=0.6,
                     collision=False),
            # the basin's floor, 6 cm below the counter's top
            box_geom([bh[0], bh[1], 0.01], offset_p=[cx, cy, -0.07], friction=0.6),
            # the counter's ring: four slabs around the basin
            box_geom([0.45, (0.6 - (cy + bh[1])) / 2, 0.02],
                     offset_p=[-0.1, (cy + bh[1] + 0.6) / 2, -0.02], friction=0.6),
            box_geom([0.45, (0.6 + (cy - bh[1])) / 2, 0.02],
                     offset_p=[-0.1, (cy - bh[1] - 0.6) / 2, -0.02], friction=0.6),
            box_geom([(0.35 + (cx - bh[0])) / 2, bh[1], 0.02],
                     offset_p=[((cx - bh[0]) - 0.35) / 2, cy, -0.02], friction=0.6),
            box_geom([(0.35 - (cx + bh[0])) / 2, bh[1], 0.02],
                     offset_p=[((cx + bh[0]) + 0.35) / 2, cy, -0.02], friction=0.6),
        ])
        self._load_objects(builder)

    def _load_objects(self, builder):
        builder.add_free_hull("eggplant", self._hulls["eggplant"], density=400, friction=0.6)
        self.basket_site = builder.add_kinematic_body("basket_site")

    def _post_build(self):
        self._is_grasping_src = self.agent.build_grasp_checker(self.model, self.source_name,
                                                               self.device)

    def _set_obj_pose(self, sim, name, pose):
        if name != "basket_site":
            return super()._set_obj_pose(sim, name, pose)
        # the kinematic marker on the basin's floor
        kin_pose = sim.kin_pose.clone()
        kin_pose[:, self.basket_site] = pose
        kin_pose[:, self.basket_site, 2] = -0.06
        return sim.replace(kin_pose=kin_pose)

    def evaluate(self, state: EnvState, ctx: TaskContext):
        src_p = ctx.actor_pose(self.source_name).p
        off = src_p - ctx.actor_pose("basket_site").p
        xy_flag = (off[:, 0].abs() <= float(self.basin_half[0])) & (
            off[:, 1].abs() <= float(self.basin_half[1]))
        # down in the basin: above its floor, and the centre no higher than
        # one half extent above the counter's top (a grasped eggplant over
        # the basin does not count)
        half_z = float(self._hulls["eggplant"].aabb_half[2])
        z_flag = (off[:, 2] > 0.0) & (src_p[:, 2] <= half_z + 0.005)
        success = xy_flag & z_flag
        return dict(success=success, src_on_target=success, **self._grasp_flags(state))

    def _src_tgt_rest_z(self):
        return float(self._hulls["eggplant"].aabb_half[2]), -0.06

    def _half_bbox(self, which):
        return self._hulls["eggplant"].aabb_half if which == "source" else self.basin_half
