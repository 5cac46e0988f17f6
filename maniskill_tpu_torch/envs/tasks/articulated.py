"""Articulated-object tasks: OpenCabinetDrawer-v1, OpenCabinetDoor-v1,
OpenCabinetDrawerModels-v1 and TurnFaucet-v1.

Port of ``maniskill_tpu/envs/tasks/articulated.py``. Each object is a
primitive articulation (``ArticulationBuilder``) merged into the robot's
kinematic forest: its dofs are passive and share the robot's contact
solve, and the robot's links touch its links across the two trees.

- ``OpenCabinetDrawer-v1`` (``:33-147``): a Fetch in front of a cabinet (a
  carcass of five static walls and one prismatic drawer with a handle
  bar); pull the drawer out past 75 % of its 0.22 m travel and hold it
  there (its speed at most 0.1). Staged reach/open reward, 5 on success.
- ``OpenCabinetDoor-v1`` (``:250-309``): the same cabinet with a revolute
  door, opened past 75 % of a quarter turn.
- ``OpenCabinetDrawerModels-v1`` (``:311-474``): a two-drawer cabinet, one
  of four drawer models per env (tray sizes and handle offsets through
  ``geom_size``/``geom_pos``) and a target drawer per env (the
  ``model_id`` and ``target_link`` extras).
- ``TurnFaucet-v1`` (``:149-247``): a Panda turns a faucet's lever handle
  (revolute about z, starting at -0.3-0.3 rad) a quarter of pi past its
  start (the ``init_angle`` and ``target_angle`` extras).

As in the JAX scene, TurnFaucet's exclusion patterns name ``"table"``,
which matches no geom (the table is ``"table-workspace"``), so the
handle-table pair stays in the pair table (ROADMAP Queue C).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...kinematics.articulation import ArticulationBuilder
from ...math.rotations import quat_apply, quat_from_axis_angle
from ...physics.engine import make_step_fn
from ...physics.model import SceneSpecBuilder, box_geom, plane_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from ..scene_builders import TableSceneBuilder
from .pick_cube import box_corners, grasp_qpos, pose_ik


def cabinet_prior(h: int) -> np.ndarray:
    """The cabinet's approach prior (H, 13), the JAX package's
    ``tools/solve_tasks.py:22-30``: the base forward at half speed, the
    shoulder lowering, the torso down."""
    nom = np.zeros((h, 13), np.float32)
    nom[:, 11] = 0.5  # base forward
    nom[:, 1] = 0.6  # shoulder lift
    nom[:, 8] = -0.3  # torso down
    return nom


def _cabinet_walls(ab, walls):
    for (off, half) in walls:
        ab.add_base_geom(box_geom(half, offset_p=off, friction=0.5))


@register_env("OpenCabinetDrawer-v1", max_episode_steps=100)
class OpenCabinetDrawerEnv(BaseEnv):
    """Pull the cabinet drawer out past ``min_open_frac`` of its travel."""

    DEFAULT_ROBOT = "fetch"
    # the JAX package's planner config (tools/solve_tasks.py:49-54): the
    # Fetch's 13 actions (arm 7, gripper 1, body 3, base 2), the approach
    # prior as the first nominal
    MPPI_CONFIG = dict(horizon=40, num_samples=2048,
                       sigma=[0.4] * 7 + [0.15] + [0.1] * 3 + [0.2] * 2, temperature=0.2,
                       nominal_init=cabinet_prior(40))

    min_open_frac = 0.75
    drawer_travel = 0.22
    drawer_z = 0.5

    def _load_agent(self, builder: SceneSpecBuilder):
        self.agent.install(builder, np.array([-1.05, 0, 0.02, 1, 0, 0, 0], np.float32))

    def _ground(self, builder: SceneSpecBuilder):
        builder.add_static_body("ground", np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                                [plane_geom(friction=0.5)])

    def _load_scene(self, builder: SceneSpecBuilder):
        self._ground(builder)
        z = self.drawer_z
        ab = ArticulationBuilder("cabinet")
        drawer = ab.add_prismatic_link(
            "drawer", parent=None, axis=(-1.0, 0.0, 0.0), limits=(0.0, self.drawer_travel),
            joint_pose=((0.0, 0.0, z), (1, 0, 0, 0)), mass=1.5, damping=5.0, friction=2.0)
        # the tray, and a handle bar on its front (-x) face
        ab.add_geom(drawer, box_geom([0.12, 0.16, 0.055], friction=0.6))
        ab.add_geom(drawer, box_geom([0.012, 0.05, 0.012], offset_p=(-0.16, 0.0, 0.0),
                                     friction=1.0))
        # the carcass: top, bottom, left, right and back walls
        w = 0.02
        _cabinet_walls(ab, [
            ((0.0, 0.0, 0.075 + w / 2 + z), (0.14, 0.20, w / 2)),
            ((0.0, 0.0, -0.075 - w / 2 + z), (0.14, 0.20, w / 2)),
            ((0.0, 0.19 + w / 2, z), (0.14, w / 2, 0.075)),
            ((0.0, -0.19 - w / 2, z), (0.14, w / 2, 0.075)),
            ((0.14 + w / 2, 0.0, z), (w / 2, 0.20, 0.095)),
        ])
        builder.add_articulation(ab, np.array([0, 0, 0, 1, 0, 0, 0]))
        # the prismatic joint constrains the drawer in its carcass
        builder.exclude_pair("cabinet:drawer", "cabinet:base")
        builder.exclude_groups(["cabinet:*"], ["ground"])

    def _post_build(self):
        self._drawer_body = int(self.model.art_dof_index["cabinet"][0])
        self.target_qpos = self.min_open_frac * self.drawer_travel

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        # the drawer starts closed
        qpos, qvel = state.sim.qpos.clone(), state.sim.qvel.clone()
        qpos[:, self._drawer_body] = 0.0
        qvel[:, self._drawer_body] = 0.0
        return state.replace(sim=state.sim.replace(qpos=qpos, qvel=qvel))

    def _target_dof(self, state: EnvState):
        return self._drawer_body

    def _handle_pos(self, ctx: TaskContext):
        b = self._drawer_body
        off = torch.tensor([-0.172, 0.0, 0.0], device=ctx.body_pos.device)
        return ctx.body_pos[:, b] + quat_apply(ctx.body_quat[:, b], off.expand(
            ctx.body_pos.shape[0], 3))

    def _target_qpos_of(self, state: EnvState):
        d = self._target_dof(state)
        if isinstance(d, int):
            return state.sim.qpos[:, d], state.sim.qvel[:, d]
        return (state.sim.qpos.gather(1, d[:, None])[:, 0],
                state.sim.qvel.gather(1, d[:, None])[:, 0])

    def evaluate(self, state: EnvState, ctx: TaskContext):
        q, qd = self._target_qpos_of(state)
        open_enough = q >= self.target_qpos
        static = torch.abs(qd) <= 0.1
        return dict(success=open_enough & static, open_enough=open_enough,
                    open_frac=q / self.drawer_travel)

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if "state" in self.obs_mode:
            hp = self._handle_pos(ctx)
            obs.update(tcp_to_handle_pos=hp - ctx.tcp_pose.p,
                       target_link_qpos=self._target_qpos_of(state)[0][:, None],
                       target_handle_pos=hp)
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        d = torch.linalg.norm(ctx.tcp_pose.p - self._handle_pos(ctx), dim=-1)
        reaching = 1.0 - torch.tanh(5.0 * d)
        q = self._target_qpos_of(state)[0]
        frac_left = (self.target_qpos - q) / self.target_qpos
        open_reward = 2.0 * (1.0 - frac_left)
        reaching = torch.where(frac_left < 0.999, torch.full_like(reaching, 2.0), reaching)
        open_reward = torch.where(info["open_enough"], torch.full_like(open_reward, 3.0),
                                  open_reward)
        reward = reaching + open_reward
        return torch.where(info["success"], torch.full_like(reward, 5.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 5.0

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact, for checks of the physics step:
        the Fetch's base driven 0.3-0.4 m nearer the cabinet, and damped
        least-squares IK on its arm points the gripper at the drawer's
        front face (approach along +x, the fingers closing along z) beside
        the handle, 8-12 cm to the left or right of the drawer's centre
        line (3-7 cm beyond the handle's ends) and 0-2 cm off the tray's
        mid-height; the drawer is then pulled out until the finger corner
        deepest beyond the front face lies 0-1.5 mm inside it (the drawer
        3-15 cm out for the gripper's reach). Every fourth env instead
        holds the drawer 0-10 mm past its open limit, still opening at
        0-0.05 m/s. The fingers against the drawer are ``box_box_corners``
        points with a robot link on each side; the arm's command holds the
        gripper 2 mm further in, the gripper shuts. Arm velocities are
        random; one control step of the plain physics step then loads the
        warm-start impulses."""
        if type(self) is not OpenCabinetDrawerEnv:
            raise NotImplementedError("contact states are built for the one-drawer cabinet")
        dev = self.device
        sim = state.sim
        K = sim.qpos.shape[0]
        spec = self.model.robot
        names = spec.joint_names
        arm = [names.index(n) for n in ("shoulder_pan_joint", "shoulder_lift_joint",
                                        "upperarm_roll_joint", "elbow_flex_joint",
                                        "forearm_roll_joint", "wrist_flex_joint",
                                        "wrist_roll_joint")]
        grip = [names.index(n) for n in ("l_gripper_finger_joint", "r_gripper_finger_joint")]
        i = self._drawer_body
        press = torch.arange(K, device=dev) % 4 != 3
        qpos = sim.qpos.clone()
        qpos[:, names.index("root_x_axis_joint")] += self._uniform(gen, (K,), 0.3, 0.4)
        qpos[:, names.index("torso_lift_joint")] = 0.0
        qpos[:, grip] = 0.0
        q0 = self._uniform(gen, (K,), 0.03, 0.15)
        side = torch.where(torch.rand((K,), generator=gen, device=dev) < 0.5, -1.0, 1.0)
        y = side * self._uniform(gen, (K,), 0.08, 0.12)
        z = self.drawer_z + self._uniform(gen, (K,), -0.02, 0.02)
        p_goal = torch.stack([-0.12 - q0 - 0.05, y, z], dim=-1)
        # the gripper's x axis (its approach) along +x, its y axis (the
        # fingers' closing axis) along z: a quarter turn about x
        ex = torch.zeros(K, 3, device=dev)
        ex[:, 0] = 1.0
        q_goal = quat_from_axis_angle(ex, torch.full((K,), math.pi / 2, device=dev))
        qpos = pose_ik(self, qpos, p_goal, q_goal, joints=arm, iters=40)
        fingers = [g for g, gs in enumerate(self.model.geoms)
                   if gs.name in ("robot:l_gripper_finger_link", "robot:r_gripper_finger_link")]
        tip_x = box_corners(self.model, qpos, fingers)[..., 0].amax(dim=1)
        # the front face is at x = -0.12 - q: a corner at tip_x lies
        # tip_x + 0.12 + q inside it
        depth = self._uniform(gen, (K,), 0.0, 1.5e-3)
        q_open = depth - 0.12 - tip_x
        qpos = torch.where(press[:, None], qpos, sim.qpos)
        qpos[:, i] = torch.where(press, q_open,
                                 self.drawer_travel + self._uniform(gen, (K,), 0.0, 0.01))
        qvel = torch.zeros_like(qpos)
        qvel[:, arm] = 0.1 * torch.randn((K, len(arm)), generator=gen, device=dev)
        qvel[:, i] = torch.where(press, 0.0, self._uniform(gen, (K,), 0.0, 0.05))
        sim = sim.replace(qpos=qpos, qvel=qvel)
        target = pose_ik(self, qpos, p_goal + torch.tensor([0.002, 0.0, 0.0], device=dev),
                         q_goal, joints=arm, iters=10)
        target = torch.where(press[:, None], target, qpos)
        target[:, grip] = 0.0
        cmd = self.agent.controller.reset(qpos).replace(target_qpos=target)
        sim = make_step_fn(self.model)(sim, cmd, self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)


@register_env("TurnFaucet-v1", max_episode_steps=100)
class TurnFaucetEnv(BaseEnv):
    """Turn the faucet's handle ``target_angle_diff`` past its start."""

    DEFAULT_ROBOT = "panda"
    # the JAX package's planner config (tools/solve_tasks.py:55-56)
    MPPI_CONFIG = dict(horizon=20, num_samples=2048, sigma=0.5, temperature=0.2)

    target_angle_diff = np.pi / 4
    handle_len = 0.08
    column_h = 0.10

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, qpos = self.table_scene.robot_pose_and_qpos(self.robot_uids)
        self.agent.install(builder, pose, init_qpos=qpos)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        ab = ArticulationBuilder("faucet")
        handle = ab.add_revolute_link(
            "handle", parent=None, axis=(0.0, 0.0, 1.0), limits=(-2.4, 2.4),
            joint_pose=((0.0, 0.0, self.column_h), (1, 0, 0, 0)),
            mass=0.3, damping=0.4, friction=0.25)
        # the lever, along +x from the hinge
        ab.add_geom(handle, box_geom([self.handle_len / 2, 0.012, 0.012],
                                     offset_p=(self.handle_len / 2 + 0.02, 0.0, 0.0),
                                     friction=1.0))
        # the column (the static base)
        ab.add_base_geom(box_geom([0.025, 0.025, self.column_h / 2],
                                  offset_p=(0.0, 0.0, self.column_h / 2), friction=0.5))
        builder.add_articulation(ab, np.array([0.0, 0.0, 0.0, 1, 0, 0, 0]))
        builder.exclude_pair("faucet:handle", "faucet:base")
        # "table" matches no geom (the JAX scene's quirk, mirrored): the
        # handle-table pair stays
        builder.exclude_groups(["faucet:*"], ["table", "ground"])

    def _post_build(self):
        self._handle_body = int(self.model.art_dof_index["faucet"][0])
        self._handle_geom = self.model.geom_indices("faucet:handle")[0]

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        i = self._handle_body
        q0 = self._uniform(gen, (K,), -0.3, 0.3)
        qpos, qvel = state.sim.qpos.clone(), state.sim.qvel.clone()
        qpos[:, i] = q0
        qvel[:, i] = 0.0
        extras = dict(state.extras, init_angle=q0, target_angle=q0 + self.target_angle_diff)
        return state.replace(sim=state.sim.replace(qpos=qpos, qvel=qvel), extras=extras)

    def _tip_pos(self, ctx: TaskContext):
        b = self._handle_body
        off = torch.tensor([self.handle_len + 0.02, 0.0, 0.0], device=ctx.body_pos.device)
        return ctx.body_pos[:, b] + quat_apply(ctx.body_quat[:, b], off.expand(
            ctx.body_pos.shape[0], 3))

    def evaluate(self, state: EnvState, ctx: TaskContext):
        return dict(success=state.sim.qpos[:, self._handle_body]
                    >= state.extras["target_angle"])

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if "state" in self.obs_mode:
            obs.update(handle_qpos=state.sim.qpos[:, self._handle_body, None],
                       target_angle=state.extras["target_angle"][:, None],
                       tip_pos=self._tip_pos(ctx))
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        d = torch.linalg.norm(ctx.tcp_pose.p - self._tip_pos(ctx), dim=-1)
        reaching = 1.0 - torch.tanh(5.0 * d)
        q = state.sim.qpos[:, self._handle_body]
        init, target = state.extras["init_angle"], state.extras["target_angle"]
        prog = torch.clamp((q - init) / (target - init), 0.0, 1.0)
        reward = reaching + 2.0 * prog
        return torch.where(info["success"], torch.full_like(reward, 5.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 5.0

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact, for checks of the physics step:
        damped least-squares IK puts the TCP on the handle's lever, pointing
        down, at 35-75 % of its length, within 1.5 mm of its centre height,
        with the fingers closing across it and 0-1 mm into it (the lever is
        24 mm thick): ``box_box_corners`` points with a robot link on each
        side (a finger and the handle). Every fourth env instead
        holds the gripper 1-3 cm beside the lever, open, and turns the
        handle toward it at 0.5-1 rad/s, so that a finger's side meets the
        lever within the step. Arm velocities are random; the arm holds
        its pose and the gripper shuts; one control step of the plain
        physics step then loads the warm-start impulses."""
        dev = self.device
        sim = state.sim
        K = sim.qpos.shape[0]
        i = self._handle_body
        q = sim.qpos[:, i]
        grasp = torch.arange(K, device=dev) % 4 != 3
        r = self.handle_len * self._uniform(gen, (K,), 0.35, 0.75) + 0.02
        # the grasp point on the lever; the fourth group 1-3 cm beside it
        # (the -y side of the lever, which a positive turn sweeps toward)
        off = torch.where(grasp, 0.0, -(0.012 + self._uniform(gen, (K,), 0.01, 0.03)))
        pos = torch.stack([r * torch.cos(q) - off * torch.sin(q),
                           r * torch.sin(q) + off * torch.cos(q),
                           torch.full_like(q, self.column_h)], dim=-1)
        ez = torch.zeros(K, 3, device=dev)
        ez[:, 2] = 1.0
        pose = torch.cat([pos, quat_from_axis_angle(ez, q)], dim=-1)
        dz = self._uniform(gen, (K,), -1.5e-3, 1.5e-3)
        qpos = grasp_qpos(self, sim.qpos, pose, gen, dz=dz)
        qpos[:, 7:9] = torch.where(grasp, 0.012 - self._uniform(gen, (K,), 0.0, 0.001),
                                   torch.full((K,), 0.012, device=dev))[:, None]
        qvel = 0.1 * torch.randn(qpos.shape, generator=gen, device=dev)
        qvel[:, 7:9] = 0.0
        qvel[:, i] = torch.where(grasp, 0.0, -self._uniform(gen, (K,), 0.5, 1.0))
        sim = sim.replace(qpos=qpos, qvel=qvel)
        target = qpos.clone()
        target[:, 7:9] = 0.0  # the arm holds its pose, the gripper shuts
        cmd = self.agent.controller.reset(qpos).replace(target_qpos=target)
        sim = make_step_fn(self.model)(sim, cmd, self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)


@register_env("OpenCabinetDoor-v1", max_episode_steps=100)
class OpenCabinetDoorEnv(OpenCabinetDrawerEnv):
    """Swing the cabinet's door open past ``min_open_frac`` of its travel."""

    door_travel = np.pi / 2

    def _load_scene(self, builder: SceneSpecBuilder):
        self._ground(builder)
        z = self.drawer_z
        ab = ArticulationBuilder("cabinet")
        door = ab.add_revolute_link(
            "door", parent=None, axis=(0.0, 0.0, 1.0), limits=(0.0, self.door_travel),
            # the hinge on the left edge of the front face
            joint_pose=((-0.14, 0.19, z), (1, 0, 0, 0)), mass=1.2, damping=1.5, friction=0.8)
        # the panel toward -y from the hinge, a handle bar near its free edge
        ab.add_geom(door, box_geom([0.01, 0.18, 0.095], offset_p=(-0.01, -0.19, 0.0),
                                   friction=0.6))
        ab.add_geom(door, box_geom([0.012, 0.012, 0.05], offset_p=(-0.035, -0.33, 0.0),
                                   friction=1.0))
        w = 0.02
        _cabinet_walls(ab, [
            ((0.0, 0.0, 0.095 + w / 2 + z), (0.14, 0.20, w / 2)),
            ((0.0, 0.0, -0.095 - w / 2 + z), (0.14, 0.20, w / 2)),
            ((0.0, 0.21 + w / 2, z), (0.14, w / 2, 0.095)),
            ((0.0, -0.21 - w / 2, z), (0.14, w / 2, 0.095)),
            ((0.14 + w / 2, 0.0, z), (w / 2, 0.22, 0.115)),
        ])
        builder.add_articulation(ab, np.array([0, 0, 0, 1, 0, 0, 0]))
        builder.exclude_pair("cabinet:door", "cabinet:base")
        builder.exclude_groups(["cabinet:*"], ["ground"])

    def _post_build(self):
        self._drawer_body = int(self.model.art_dof_index["cabinet"][0])
        self.target_qpos = self.min_open_frac * self.door_travel

    @property
    def drawer_travel(self):  # the open fraction's denominator
        return self.door_travel

    def _handle_pos(self, ctx: TaskContext):
        b = self._drawer_body
        off = torch.tensor([-0.047, -0.33, 0.0], device=ctx.body_pos.device)
        return ctx.body_pos[:, b] + quat_apply(ctx.body_quat[:, b], off.expand(
            ctx.body_pos.shape[0], 3))


@register_env("OpenCabinetDrawerModels-v1", max_episode_steps=100)
class OpenCabinetDrawerModelsEnv(OpenCabinetDrawerEnv):
    """A two-drawer cabinet with one of four drawer models per env (tray
    sizes and handle offsets through ``geom_size``/``geom_pos``) and a
    target drawer per env."""

    drawer_zs = (0.60, 0.40)  # the two cavities' centres

    # (name, tray_half, handle_y); the handle bar sits on the front face at
    # x = -(tray_x + 0.04)
    MODELS = [
        ("wide", (0.12, 0.16, 0.055), 0.0),
        ("narrow", (0.12, 0.10, 0.055), 0.0),
        ("shallow", (0.09, 0.14, 0.040), 0.05),
        ("deep", (0.14, 0.12, 0.050), -0.05),
    ]

    def _load_scene(self, builder: SceneSpecBuilder):
        self._ground(builder)
        ab = ArticulationBuilder("cabinet")
        for k, z in enumerate(self.drawer_zs):
            drawer = ab.add_prismatic_link(
                f"drawer{k}", parent=None, axis=(-1.0, 0.0, 0.0),
                limits=(0.0, self.drawer_travel), joint_pose=((0.0, 0.0, z), (1, 0, 0, 0)),
                mass=1.5, damping=5.0, friction=2.0)
            ab.add_geom(drawer, box_geom([0.12, 0.16, 0.055], friction=0.6))
            ab.add_geom(drawer, box_geom([0.012, 0.05, 0.012], offset_p=(-0.16, 0.0, 0.0),
                                         friction=1.0))
        # the carcass around both cavities (cavity k spans drawer_zs[k] +- 0.075)
        w = 0.02
        z_top = self.drawer_zs[0] + 0.075
        z_mid = 0.5 * (self.drawer_zs[0] + self.drawer_zs[1])
        z_bot = self.drawer_zs[1] - 0.075
        side_c = 0.5 * (z_top + z_bot)
        side_h = 0.5 * (z_top - z_bot) + w
        _cabinet_walls(ab, [
            ((0.0, 0.0, z_top + w / 2), (0.14, 0.20, w / 2)),
            ((0.0, 0.0, z_mid), (0.14, 0.20, 0.025)),
            ((0.0, 0.0, z_bot - w / 2), (0.14, 0.20, w / 2)),
            ((0.0, 0.19 + w / 2, side_c), (0.14, w / 2, side_h)),
            ((0.0, -0.19 - w / 2, side_c), (0.14, w / 2, side_h)),
            ((0.14 + w / 2, 0.0, side_c), (w / 2, 0.20, side_h)),
        ])
        builder.add_articulation(ab, np.array([0, 0, 0, 1, 0, 0, 0]))
        for k in range(2):
            builder.exclude_pair(f"cabinet:drawer{k}", "cabinet:base")
        builder.exclude_pair("cabinet:drawer0", "cabinet:drawer1")
        builder.exclude_groups(["cabinet:*"], ["ground"])

    def _post_build(self):
        self._dofs = [int(d) for d in self.model.art_dof_index["cabinet"]]
        self._drawer_body = self._dofs[0]
        self.target_qpos = self.min_open_frac * self.drawer_travel
        self._tray_geoms = [self.model.geom_indices(f"cabinet:drawer{k}")[0] for k in range(2)]
        self._handle_geoms = [self.model.geom_indices(f"cabinet:drawer{k}")[1]
                              for k in range(2)]
        dev = self.device
        self._tray_t = torch.tensor([m[1] for m in self.MODELS], device=dev)
        self._hy_t = torch.tensor([m[2] for m in self.MODELS], device=dev)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        mid = torch.randint(0, len(self.MODELS), (K,), generator=gen, device=dev)
        target = torch.randint(0, 2, (K,), generator=gen, device=dev)
        tray = self._tray_t[mid]
        handle_off = torch.stack([-(tray[:, 0] + 0.04), self._hy_t[mid],
                                  torch.zeros(K, device=dev)], dim=-1)
        gs, gp = state.sim.geom_size.clone(), state.sim.geom_pos.clone()
        qpos, qvel = state.sim.qpos.clone(), state.sim.qvel.clone()
        for k in range(2):
            gs[:, self._tray_geoms[k]] = tray
            gp[:, self._handle_geoms[k]] = handle_off
            qpos[:, self._dofs[k]] = 0.0
            qvel[:, self._dofs[k]] = 0.0
        extras = dict(state.extras, model_id=mid.to(torch.int32),
                      target_link=target.to(torch.int32))
        return state.replace(sim=state.sim.replace(qpos=qpos, qvel=qvel, geom_size=gs,
                                                   geom_pos=gp), extras=extras)

    def _target_dof(self, state: EnvState):
        d0, d1 = self._dofs
        return torch.where(state.extras["target_link"] == 0, d0, d1).long()

    def _handle_pos(self, ctx: TaskContext):
        # per env: the target drawer's body, its handle offset from geom_pos
        t = ctx.state.extras["target_link"] == 0
        b = torch.where(t, self._dofs[0], self._dofs[1]).long()
        g = torch.where(t, self._handle_geoms[0], self._handle_geoms[1]).long()
        rows = torch.arange(t.shape[0], device=t.device)
        off = ctx.state.sim.geom_pos[rows, g] - torch.tensor([0.012, 0.0, 0.0],
                                                             device=t.device)
        return ctx.body_pos[rows, b] + quat_apply(ctx.body_quat[rows, b], off)

    def evaluate(self, state: EnvState, ctx: TaskContext):
        info = super().evaluate(state, ctx)
        info.update(model_id=state.extras["model_id"],
                    target_link=state.extras["target_link"])
        return info

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = super()._get_obs_extra(state, ctx, info)
        if "state" in self.obs_mode:
            obs["target_onehot"] = torch.nn.functional.one_hot(
                state.extras["target_link"].long(), 2).to(torch.float32)
        return obs
