"""Several robots in one scene.

Port of ``maniskill_tpu/agents/multi_agent.py``: the sub-agents' kinematic
trees merge into one forest (``kinematics/articulation.py``
``merge_forest``, each root placed from the first robot's base pose), so
every robot shares the engine's one contact solve and the CUDA
mega-kernel sees one robot of ``sum(nq)`` dofs. Every frame, link and
joint of agent ``i`` is renamed with the prefix ``"{uid}-{i}:"``
(``_prefix_spec``), and robot-robot collisions across the trees are on
(the builder's ``_forest_tree_id``), as within one tree they are off.

The flat action is the concatenation of the sub-agents' actions in agent
order; ``split_action``, ``proprioception``, ``qpos_slice_of``,
``tcp_pose_of`` and ``build_grasp_checker_of`` give the per-agent views.
As in the JAX package, only joint-space controllers are taken: a
task-space (EE) controller raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import List, Sequence

import numpy as np
import torch

from ..kinematics.articulation import merge_forest
from ..kinematics.urdf import RobotSpec
from ..physics.model import DriveCmd
from .base_agent import REGISTERED_AGENTS, BaseAgent
from .controllers.ee import EEController


def _prefix_spec(spec: RobotSpec, prefix: str) -> RobotSpec:
    """``spec`` with every frame, link and joint renamed with ``prefix``, so
    that two identical robots coexist in one forest."""
    return dc_replace(
        spec,
        name=prefix + spec.name,
        frames={prefix + k: v for k, v in spec.frames.items()},
        link_index={prefix + k: v for k, v in spec.link_index.items()},
        joint_names=[prefix + n for n in spec.joint_names],
        link_names=[prefix + n for n in spec.link_names],
        base_link=prefix + spec.base_link,
    )


class MultiAgent:
    """N sub-agents acting in one scene."""

    def __init__(self, uids: Sequence[str], device="cpu", control_mode=None):
        self.uids = list(uids)
        self.sub_agents: List[BaseAgent] = [
            REGISTERED_AGENTS[u](device=device, control_mode=control_mode) for u in self.uids]
        self.control_mode = self.sub_agents[0].control_mode
        for a in self.sub_agents:
            if any(isinstance(c, EEController) for c in a.controller.controllers.values()):
                raise NotImplementedError("MultiAgent v1 supports joint-space controllers only")
        self.nq = sum(a.nq for a in self.sub_agents)
        self._dof_offsets = np.cumsum([0] + [a.nq for a in self.sub_agents])[:-1]
        self._action_dims = [a.controller.action_dim for a in self.sub_agents]
        self.action_dim = sum(self._action_dims)
        self.action_low = np.concatenate([a.controller.action_low for a in self.sub_agents])
        self.action_high = np.concatenate([a.controller.action_high for a in self.sub_agents])
        self.balance_passive_force = all(a.balance_passive_force for a in self.sub_agents)
        self.ee_link_name = None  # one per agent: tcp_pose_of
        self.keyframes = {}
        self.supported_control_modes = self.sub_agents[0].supported_control_modes
        self.controller = _MultiController(self, device)

    @property
    def agents(self):
        return self.sub_agents

    def agent_prefix(self, i: int) -> str:
        return f"{self.uids[i]}-{i}:"

    def split_action(self, action):
        """Flat (..., A) action -> list of per-agent actions."""
        out, off = [], 0
        for d in self._action_dims:
            out.append(action[..., off:off + d])
            off += d
        return out

    def proprioception(self, qpos: torch.Tensor, qvel: torch.Tensor) -> dict:
        """``{"{uid}-{i}": agent i's proprioception}``."""
        out = {}
        for i, a in enumerate(self.sub_agents):
            sl = self.qpos_slice_of(i)
            out[f"{self.uids[i]}-{i}"] = a.proprioception(qpos[..., sl], qvel[..., sl])
        return out

    def install(self, builder, base_poses: Sequence[np.ndarray],
                init_qpos: Sequence[np.ndarray] = None):
        """Merge the sub-agents into one forest robot and add it, with each
        agent's drive gains and robot-robot collisions across the trees."""
        trees, coll, inits = [], [], []
        for i, a in enumerate(self.sub_agents):
            pre = self.agent_prefix(i)
            trees.append((_prefix_spec(a.robot_spec, pre), np.asarray(base_poses[i], np.float32)))
            for g in a.collision_geoms():
                coll.append(dict(g, link=pre + g["link"]))
            if init_qpos is not None:
                inits.append(np.asarray(init_qpos[i], np.float32))
            elif "rest" in a.keyframes:
                inits.append(np.asarray(a.keyframes["rest"].qpos, np.float32))
            else:
                inits.append(np.zeros(a.nq, np.float32))
        forest, _tree_id, offs = merge_forest(trees, np.asarray(base_poses[0], np.float32))
        assert list(offs) == list(self._dof_offsets)
        builder.add_robot(forest, np.asarray(base_poses[0], np.float32), collision_geoms=coll,
                          init_qpos=np.concatenate(inits),
                          balance_passive_force=self.balance_passive_force)
        c = self.controller
        builder.set_drive_properties(c.kp, c.kd, c.force_limit)
        # the builder skips robot-robot pairs within one tree: each agent's
        # bodies are a tree of their own
        builder._forest_tree_id = np.concatenate(
            [np.full(t[0].nb, i, np.int32) for i, t in enumerate(trees)])

    def qpos_slice_of(self, i: int) -> slice:
        """qpos/qvel slice of agent ``i`` in the merged forest."""
        o = int(self._dof_offsets[i])
        return slice(o, o + self.sub_agents[i].nq)

    def tcp_pose_of(self, i: int, ctx):
        """TCP pose of agent ``i``: its prefixed end-effector frame."""
        return ctx.frame_pose(self.agent_prefix(i) + self.sub_agents[i].ee_link_name)

    def build_grasp_checker_of(self, i: int, model, obj_name: str, device, **kw):
        """Agent ``i``'s grasp checker against the merged scene model: its
        own ``build_grasp_checker``, with its finger links looked up under
        its prefix in the forest."""
        sub, pre = self.sub_agents[i], self.agent_prefix(i)
        shim = dc_replace(sub.robot_spec, link_index={
            k[len(pre):]: v for k, v in model.robot.link_index.items() if k.startswith(pre)})
        orig, sub.robot_spec = sub.robot_spec, shim
        try:
            return sub.build_grasp_checker(model, obj_name, device, **kw)
        finally:
            sub.robot_spec = orig


class _MultiController:
    """The sub-agents' composite controllers over the merged dofs. Dofs
    past the robots' (articulated objects' trees after the forest) keep
    their targets."""

    def __init__(self, ma: MultiAgent, device):
        self._ma = ma
        self.nq = ma.nq
        self.device = device
        self.action_dim = ma.action_dim
        self.action_low = ma.action_low
        self.action_high = ma.action_high
        self.needs_fk_aux = False
        self.kp = np.concatenate([a.controller.kp for a in ma.sub_agents])
        self.kd = np.concatenate([a.controller.kd for a in ma.sub_agents])
        self.force_limit = np.concatenate([a.controller.force_limit for a in ma.sub_agents])
        self._writes_qf = [any(hasattr(c, "compute_qf") for c in a.controller.controllers.values())
                           for a in ma.sub_agents]

    def reset(self, qpos: torch.Tensor) -> DriveCmd:
        """Drive command holding the current qpos; the gains are the
        model's (the JAX ``_MultiController.reset`` sets none)."""
        return DriveCmd(target_qpos=qpos.clone(), target_qvel=torch.zeros_like(qpos),
                        qf=torch.zeros_like(qpos))

    def set_action(self, cmd: DriveCmd, qpos: torch.Tensor, action: torch.Tensor,
                   aux=None) -> DriveCmd:
        ma = self._ma
        tq = cmd.target_qpos.clone()
        tv = torch.zeros_like(tq)
        qf = None
        for i, (a, act) in enumerate(zip(ma.sub_agents, ma.split_action(action))):
            sl = ma.qpos_slice_of(i)
            sub = DriveCmd(target_qpos=cmd.target_qpos[..., sl],
                           target_qvel=cmd.target_qvel[..., sl], qf=cmd.qf[..., sl])
            new = a.controller.set_action(sub, qpos[..., sl], act)
            tq[..., sl] = new.target_qpos
            tv[..., sl] = new.target_qvel
            if self._writes_qf[i]:
                if qf is None:
                    qf = torch.zeros_like(tq)
                qf[..., sl] = new.qf
        if qf is None:
            return cmd.replace(target_qpos=tq, target_qvel=tv)
        return cmd.replace(target_qpos=tq, target_qvel=tv, qf=qf)
