"""FoldSuitcase-v1 and FoldSuitcaseModels-v1.

Port of ``maniskill_tpu/envs/tasks/fold_suitcase.py``: a primitive suitcase
(a base shell on the table and a lid on a revolute hinge along its back
edge, built with ``ArticulationBuilder`` and merged into the robot's
kinematic forest as one passive dof with gravity) starts open 0.05-0.35 rad
below its 2.2 rad limit, and the robot folds the lid shut. Same scene
(the lid excluded against the base and the ground), reset draw, success
(the lid at or below ``max_close_frac`` of its range and its hinge rate at
most 0.37 rad/s), state obs and dense reward (reach the lid's free edge,
close progress; 5 on success) with its normalized form. The robot is
``panda_wristcam``.

``FoldSuitcaseModels-v1`` draws one of four containers per env (suitcase,
laptop, small box, deep case): the lid's and the base's sizes and offsets
are per-env ``geom_size``/``geom_pos``, with a close fraction and an
opening range per model (the ``model_id`` and ``target_qpos`` extras).
"""
from __future__ import annotations

import numpy as np
import torch

from ...kinematics.articulation import ArticulationBuilder
from ...math.rotations import quat_apply
from ...physics.engine import make_step_fn
from ...physics.model import SceneSpecBuilder, box_geom
from ..base_env import BaseEnv, EnvState, TaskContext
from ..registration import register_env
from ..scene_builders import TableSceneBuilder
from .pick_cube import box_corners, pose_ik


@register_env("FoldSuitcase-v1", max_episode_steps=100)
class FoldSuitcaseEnv(BaseEnv):
    DEFAULT_ROBOT = "panda_wristcam"

    max_close_frac = 0.25
    base_half = (0.13, 0.09, 0.015)
    lid_half = (0.13, 0.09, 0.008)
    lid_qmax = 2.2  # the open limit, past vertical
    suitcase_x = -0.10  # the base's centre on the table

    def _load_agent(self, builder: SceneSpecBuilder):
        self.table_scene = TableSceneBuilder(self)
        pose, qpos = self.table_scene.robot_pose_and_qpos(self.robot_uids)
        self.agent.install(builder, pose, init_qpos=qpos)

    def _load_scene(self, builder: SceneSpecBuilder):
        self.table_scene.build(builder)
        bh, lh = self.base_half, self.lid_half
        hinge_x = self.suitcase_x + bh[0]
        hinge_z = 2 * bh[2]
        ab = ArticulationBuilder("suitcase")
        m = 0.4
        inertia = (m / 3.0) * np.diag([lh[1] ** 2 + lh[2] ** 2, lh[0] ** 2 + lh[2] ** 2,
                                       lh[0] ** 2 + lh[1] ** 2])
        # the lid, hinged at the back (+x) edge about +y: q > 0 swings it up
        # and over toward +x; q = 0 is closed
        lid = ab.add_revolute_link(
            "lid", parent=None, axis=(0.0, 1.0, 0.0), limits=(0.0, self.lid_qmax),
            joint_pose=((hinge_x, 0.0, hinge_z), (1, 0, 0, 0)),
            mass=m, com=(-lh[0], 0.0, lh[2]), inertia=inertia, damping=0.3, friction=0.5)
        ab.add_geom(lid, box_geom(lh, offset_p=(-lh[0], 0.0, lh[2]), friction=0.8))
        ab.add_base_geom(box_geom(bh, offset_p=(self.suitcase_x, 0.0, bh[2]), friction=0.8))
        builder.add_articulation(ab, np.array([0, 0, 0, 1, 0, 0, 0], np.float32))
        builder.exclude_pair("suitcase:lid", "suitcase:base")
        builder.exclude_groups(["suitcase:*"], ["ground"])

    def _post_build(self):
        self._lid_body = int(self.model.art_dof_index["suitcase"][0])
        self._lid_geom = self.model.geom_indices("suitcase:lid")[0]
        self._hinge = np.array([self.suitcase_x + self.base_half[0], 0.0,
                                2 * self.base_half[2]], np.float32)
        self.target_qpos = self.max_close_frac * self.lid_qmax

    def _set_lid(self, state: EnvState, q0: torch.Tensor) -> EnvState:
        i = self._lid_body
        qpos, qvel = state.sim.qpos.clone(), state.sim.qvel.clone()
        qpos[:, i] = q0
        qvel[:, i] = 0.0
        return state.replace(sim=state.sim.replace(qpos=qpos, qvel=qvel))

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        return self._set_lid(state, self._uniform(gen, (K,), self.lid_qmax - 0.35,
                                                  self.lid_qmax - 0.05))

    def _lid_half(self, state: EnvState) -> torch.Tensor:
        """(K, 3) half extents of each env's lid."""
        return state.sim.geom_size[:, self._lid_geom]

    def _lid_tip_pos(self, ctx: TaskContext):
        """World position of the lid's free edge."""
        b = self._lid_body
        lh = self._lid_half(ctx.state)
        off = torch.stack([-2.0 * lh[:, 0], torch.zeros_like(lh[:, 0]), lh[:, 2]], dim=-1)
        return ctx.body_pos[:, b] + quat_apply(ctx.body_quat[:, b], off)

    def _target_qpos(self, state: EnvState):
        return self.target_qpos

    def evaluate(self, state: EnvState, ctx: TaskContext):
        q = state.sim.qpos[:, self._lid_body]
        qd = state.sim.qvel[:, self._lid_body]
        close_enough = q <= self._target_qpos(state)
        static = torch.abs(qd) <= 0.37  # the hinge rate bounds |w| <= 1, |v| <= 0.1
        return dict(success=close_enough & static, close_enough=close_enough, lid_qpos=q)

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info):
        obs = dict(tcp_pose=ctx.tcp_pose.raw)
        if "state" in self.obs_mode:
            lp = self._lid_tip_pos(ctx)
            obs.update(tcp_to_lid_pos=lp - ctx.tcp_pose.p,
                       target_link_qpos=state.sim.qpos[:, self._lid_body, None],
                       target_lid_pos=lp)
        return obs

    def compute_dense_reward(self, state, action, info, ctx: TaskContext):
        d = torch.linalg.norm(ctx.tcp_pose.p - self._lid_tip_pos(ctx), dim=-1)
        reaching = 1.0 - torch.tanh(5.0 * d)
        q = state.sim.qpos[:, self._lid_body]
        tq = self._target_qpos(state)
        frac_left = torch.clamp((q - tq) / (self.lid_qmax - tq), 0.0, 1.0)
        reward = reaching + 2.0 * (1.0 - frac_left)
        return torch.where(info["success"], torch.full_like(reward, 5.0), reward)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx) / 5.0

    def contact_state(self, state: EnvState, gen: torch.Generator) -> EnvState:
        """``state`` moved into contact, for checks of the physics step; by
        env index modulo 4:

        0-2. the closed fingertips pressed 0-1.5 mm into the lid's inner face
           (the face toward the robot), a third to two thirds of the way
           from the hinge to the free edge: damped least-squares IK points
           the TCP along the face's inward normal, and the lid is then
           turned about its hinge until the deepest finger corner is that
           far inside. The fingers against the lid are ``box_box_corners``
           points with a robot link on each side (the robot's tree and the
           lid's); the arm's command holds it 2 mm further in, so the
           fingers push the lid open;
        3. the lid 0-20 mm past its open limit, swinging further open at
           0-0.3 rad/s: the limit spring and damper act from the first
           substep.

        Joint velocities of the arm are random; one control step of the
        plain physics step then loads the warm-start impulses."""
        dev = self.device
        sim = state.sim
        K = sim.qpos.shape[0]
        i = self._lid_body
        lh = self._lid_half(state)
        hinge = torch.as_tensor(self._hinge, device=dev)
        press = torch.arange(K, device=dev) % 4 != 3
        q = sim.qpos[:, i]
        # the lid's frame: its hinge-to-edge direction e and the inner
        # face's outward normal n, in the xz plane
        e = torch.stack([-torch.cos(q), torch.zeros_like(q), torch.sin(q)], dim=-1)
        n = torch.stack([-torch.sin(q), torch.zeros_like(q), -torch.cos(q)], dim=-1)
        along = 2.0 * lh[:, :1] * self._uniform(gen, (K, 1), 1.0 / 3.0, 2.0 / 3.0)
        p_goal = hinge + along * e
        # the TCP's z axis along -n, its y axis (the closing axis) along
        # the hinge, toward -y as at the rest pose: the rotation whose
        # columns are (y x z, y, z)
        z = -n
        y = torch.zeros_like(z)
        y[:, 1] = -1.0
        x = torch.linalg.cross(y, z, dim=-1)
        q_goal = _quat_from_matrix(torch.stack([x, y, z], dim=-1))
        ee_link, arm, grip, _ = self._pressing_arm()
        qpos = pose_ik(self, sim.qpos, p_goal + 0.01 * n, q_goal, joints=arm, ee_link=ee_link)
        qpos[:, grip] = 0.0
        # the lid turned about the hinge until the deepest finger corner is
        # 0-1.5 mm inside the inner face
        depth = self._uniform(gen, (K,), 0.0, 1.5e-3)
        q_lid = self._lid_angle_for_depth(qpos, depth, q)
        q_lid = torch.where(press, q_lid,
                            self.lid_qmax + self._uniform(gen, (K,), 0.0, 0.02))
        qpos = torch.where(press[:, None], qpos, sim.qpos)
        qpos[:, i] = q_lid
        qvel = 0.1 * torch.randn(qpos.shape, generator=gen, device=dev)
        qvel[:, grip] = 0.0
        qvel[:, i] = torch.where(press, torch.zeros_like(q),
                                 self._uniform(gen, (K,), 0.0, 0.3))
        sim = sim.replace(qpos=qpos, qvel=qvel)
        target = pose_ik(self, qpos, p_goal + 0.008 * n, q_goal, joints=arm, iters=10,
                         ee_link=ee_link)
        target = torch.where(press[:, None], target, qpos)
        target[:, grip] = 0.0
        cmd = self.agent.controller.reset(qpos).replace(target_qpos=target)
        sim = make_step_fn(self.model)(sim, cmd, self.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd)

    def _pressing_arm(self):
        """The arm that presses the lid in ``contact_state``: its TCP frame,
        arm joints, gripper joints and finger geoms."""
        return (self.agent.ee_link_name, range(7), slice(7, 9),
                ("robot:panda_leftfinger", "robot:panda_rightfinger"))

    def _lid_angle_for_depth(self, qpos, depth, q0):
        """The lid angle near ``q0`` at which the finger corner deepest
        beyond the lid's inner face lies ``depth`` inside it (Newton steps
        on the corners' signed distances)."""
        model = self.model
        names = self._pressing_arm()[3]
        fingers = [g for g, gs in enumerate(model.geoms) if gs.name in names]
        corners = box_corners(model, qpos, fingers)  # (K, C, 3)
        rel = corners - torch.as_tensor(self._hinge, device=qpos.device)
        a, c = rel[..., 0], rel[..., 2]
        q = q0.clone()
        for _ in range(8):
            # signed distance outside the inner face: rel . n(q)
            s = -(a * torch.sin(q)[:, None] + c * torch.cos(q)[:, None])
            ds = -(a * torch.cos(q)[:, None] - c * torch.sin(q)[:, None])
            j = torch.argmin(s, dim=1, keepdim=True)
            f = s.gather(1, j)[:, 0] + depth
            q = q - f / ds.gather(1, j)[:, 0]
        return q


@register_env("FoldSuitcaseModels-v1", max_episode_steps=100)
class FoldSuitcaseModelsEnv(FoldSuitcaseEnv):
    """One of four containers per env: the lid's and the base's sizes and
    in-body offsets are per-env ``geom_size``/``geom_pos``, the hinge line
    stays where it is, and each model has its close fraction and opening
    range."""

    # (name, base_half, lid_half, close_frac, open_range)
    MODELS = [
        ("suitcase", (0.13, 0.09, 0.015), (0.13, 0.09, 0.008), 0.25, (1.85, 2.15)),
        ("laptop", (0.15, 0.11, 0.008), (0.15, 0.11, 0.005), 0.15, (1.7, 2.0)),
        ("small_box", (0.09, 0.07, 0.02), (0.09, 0.07, 0.01), 0.3, (1.9, 2.15)),
        ("deep_case", (0.11, 0.08, 0.035), (0.11, 0.08, 0.008), 0.25, (1.8, 2.1)),
    ]

    def _post_build(self):
        super()._post_build()
        self._base_geom = self.model.geom_indices("suitcase:base")[0]
        self._hinge_x = self.suitcase_x + self.base_half[0]
        dev = self.device
        self._bh_t = torch.tensor([m[1] for m in self.MODELS], device=dev)
        self._lh_t = torch.tensor([m[2] for m in self.MODELS], device=dev)
        self._frac_t = torch.tensor([m[3] for m in self.MODELS], device=dev)
        self._open_t = torch.tensor([m[4] for m in self.MODELS], device=dev)

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        K = state.sim.qpos.shape[0]
        dev = self.device
        mid = torch.randint(0, len(self.MODELS), (K,), generator=gen, device=dev)
        bh, lh = self._bh_t[mid], self._lh_t[mid]
        lo, hi = self._open_t[mid, 0], self._open_t[mid, 1]
        state = self._set_lid(state, lo + (hi - lo) * torch.rand((K,), generator=gen,
                                                                  device=dev))
        zero = torch.zeros(K, device=dev)
        gs, gp = state.sim.geom_size.clone(), state.sim.geom_pos.clone()
        gs[:, self._lid_geom] = lh
        gs[:, self._base_geom] = bh
        gp[:, self._lid_geom] = torch.stack([-lh[:, 0], zero, lh[:, 2]], dim=-1)
        # the base extends backward from the fixed hinge line
        gp[:, self._base_geom] = torch.stack([self._hinge_x - bh[:, 0], zero, bh[:, 2]], dim=-1)
        extras = dict(state.extras, model_id=mid.to(torch.int32),
                      target_qpos=self._frac_t[mid] * self.lid_qmax)
        return state.replace(sim=state.sim.replace(geom_size=gs, geom_pos=gp), extras=extras)

    def _target_qpos(self, state: EnvState):
        return state.extras["target_qpos"]

    def evaluate(self, state: EnvState, ctx: TaskContext):
        info = super().evaluate(state, ctx)
        info["model_id"] = state.extras["model_id"]
        return info


def _quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """(K, 4) wxyz unit quaternions of rotation matrices (K, 3, 3) (the
    trace branch; the rotations asked for here are far from a half turn)."""
    w = 0.5 * torch.sqrt(torch.clamp(1.0 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2], min=1e-12))
    return torch.stack([w, (R[:, 2, 1] - R[:, 1, 2]) / (4 * w),
                        (R[:, 0, 2] - R[:, 2, 0]) / (4 * w),
                        (R[:, 1, 0] - R[:, 0, 1]) / (4 * w)], dim=-1)
