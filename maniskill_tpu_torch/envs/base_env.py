"""Batched environment runtime.

Port of ``maniskill_tpu/envs/base_env.py``: ``EnvState``, ``TaskContext``,
``reset``, the per-step core (``_step`` for ``step``, ``_rollout_step`` for
planners), the ``state``/``state_dict``/``none`` obs modes and the four
reward modes (``dense``, ``normalized_dense``, ``sparse``: success minus
fail, ``none``: zeros). The JAX package writes single-env functions and
vmaps them; here every function takes the batch dimension K leading. A
task sets its solver parameters by overriding ``_sim_params`` (the JAX
``sim_params`` keyword's default).

``reset`` follows the JAX package's surface (``envs/base_env.py:401-437``,
``:668-720``): the first reset starts every env from scratch; a later one
hands the previous state to ``_initialize_episode_prev`` (a task keeps
what persists across episodes there, as ``reconfiguration_freq`` does);
``reset(options={"env_idx": ...})`` resets only the named envs, from their
previous state, and keeps every other env's state bit for bit. As in the
JAX package, the obs and info that a partial reset returns are those of
the freshly reset states of all envs, the kept ones included. A tuple of
robot uids (``DEFAULT_ROBOT``) builds a ``MultiAgent``: the robots merged
into one forest (JAX ``:255-262``). The state surface: ``get_state_dict``,
``set_state_dict`` (the reference's layout plus the controller's targets
and the warm-start impulses, so a restore is exact), ``get_state``,
``set_drive_properties`` (per-env drive gains, live until the next reset)
and ``sample_action`` (``:728-835``). Not ported yet: the visual obs modes.

The physics dispatch takes the CUDA mega-kernel (``physics/megakernel.py``)
for every batch of a model it supports, through ``KernelStep``: the kernel
computes the step, and derivatives (forward or reverse mode) come from the
plain PyTorch step, as the JAX ``custom_jvp`` seam does
(``envs/base_env.py:495-513``). CPU tensors take the plain step directly;
``sim_backend="torch"`` asks for the plain step everywhere. On CUDA a
model the kernel's ``supports`` refuses raises, unless its task declares
that refusal as its route (``PLAIN_STEP_REFUSAL``: TwoRobotPickCubeYCB-v1,
n_all 36 > NALL_MAX 32), and then runs on the plain step, as the JAX
package runs it on its XLA engine; ``kernel_refusal`` names the cap it
breaks (``megakernel.refusal``). A kernel that fails to build or launch
raises: it never hands its batch to the plain step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .._consts import const
from ..agents.base_agent import REGISTERED_AGENTS, BaseAgent
from ..kinematics import chain
from ..math.pose import Pose
from ..math.rotations import _cross
from ..physics import megakernel
from ..physics.engine import body_velocities, make_force_query, make_step_fn, robot_fk
from ..physics.model import (DriveCmd, SceneModel, SceneSpecBuilder, SimParams,
                             SimState, _Struct, tree_map)


def resolve_device(device) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


@dataclass
class EnvState(_Struct):
    """Batched per-env state: simulation + controller + episode bookkeeping."""

    sim: SimState
    cmd: DriveCmd
    elapsed_steps: torch.Tensor  # (K,) int32
    extras: Dict[str, torch.Tensor]


class TaskContext:
    """Per-step derived kinematics handed to task hooks, so FK is computed
    once per step."""

    def __init__(self, env: "BaseEnv", state: EnvState, fk=None, f_pt=None):
        self.env = env
        self.state = state
        if fk is None:
            fk = robot_fk(env.model, state.sim.qpos)
        self.body_pos, self.body_quat, self.axis_w = fk
        self._frames: Dict[str, Pose] = {}
        self._f_pt = f_pt

    def contact_forces(self) -> torch.Tensor:
        """Per-candidate-point contact forces (K, P, 3)."""
        if self._f_pt is None:
            self._f_pt = self.env._force_query(
                self.state.sim, fk=(self.body_pos, self.body_quat, self.axis_w))[0]
        return self._f_pt

    def frame_pose(self, name: str) -> Pose:
        if name not in self._frames:
            model = self.env.model
            base = const(model, "robot_base_pose", model.robot_base_pose,
                         self.body_pos.device)
            p, q = chain.frame_pose(model.robot, base, self.body_pos,
                                    self.body_quat, name)
            self._frames[name] = Pose(p, q)
        return self._frames[name]

    @property
    def tcp_pose(self) -> Pose:
        return self.frame_pose(self.env.agent.ee_link_name)

    def body_velocity(self, body_idx: int):
        """(linear, angular) world velocity (K, 3) each of a robot body's
        origin."""
        model = self.env.model
        ref = const(model, "robot_base_pose", model.robot_base_pose, self.body_pos.device)[:3]
        v = body_velocities(model, self.body_pos, self.axis_w, self.state.sim.qvel)[:, body_idx]
        lin = v[:, 3:] + _cross(v[:, :3], self.body_pos[:, body_idx] - ref)
        return lin, v[:, :3]

    def actor_pose(self, name: str) -> Pose:
        i = self.env.model.free_index.get(name)
        if i is not None:
            return Pose.from_raw(self.state.sim.free_pose[:, i])
        return Pose.from_raw(self.state.sim.kin_pose[:, self.env.model.kin_index[name]])

    def actor_vel(self, name: str) -> torch.Tensor:
        """(K, 6) [linear, angular] velocity of a free actor; zeros for a
        kinematic one."""
        i = self.env.model.free_index.get(name)
        if i is not None:
            return self.state.sim.free_vel[:, i]
        return self.state.sim.qpos.new_zeros(self.state.sim.qpos.shape[0], 6)


class BaseEnv:
    """Subclass per task; override ``_load_scene``, ``_initialize_episode``,
    ``evaluate``, ``_get_obs_extra`` and the reward hooks."""

    SUPPORTED_OBS_MODES = ("state", "state_dict", "none")
    SUPPORTED_REWARD_MODES = ("normalized_dense", "dense", "sparse", "none")
    DEFAULT_ROBOT = "panda"
    SIM_FREQ = 100
    CONTROL_FREQ = 20
    # the task's MPPI settings (``MPPIConfig`` keyword arguments), as
    # ``chip_smoke.py`` and ``mppi_ab`` run it: the bench shape unless the
    # task has a planner config of its own
    MPPI_CONFIG = dict(horizon=50, num_samples=4096, sigma=0.6, temperature=0.3)
    # the mega-kernel's refusal of this task's scene (``megakernel.refusal``)
    # where the task runs on the plain step by design, as the JAX package
    # runs it on its XLA engine; any other refusal raises on CUDA
    PLAIN_STEP_REFUSAL: Optional[str] = None
    max_episode_steps: Optional[int] = None

    def __init__(self, num_envs: int = 1, obs_mode: str = "state",
                 reward_mode: str = "normalized_dense",
                 robot_init_qpos_noise: float = 0.02,
                 control_mode: Optional[str] = "pd_joint_delta_pos",
                 sim_backend: str = "auto", device=None):
        if obs_mode not in self.SUPPORTED_OBS_MODES:
            raise ValueError(f"obs_mode {obs_mode!r} not in {self.SUPPORTED_OBS_MODES}")
        if reward_mode not in self.SUPPORTED_REWARD_MODES:
            raise ValueError(f"reward_mode {reward_mode!r} not in "
                             f"{self.SUPPORTED_REWARD_MODES}")
        if sim_backend not in ("auto", "torch"):
            raise ValueError(f"sim_backend {sim_backend!r} not in ('auto', 'torch')")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.num_envs = num_envs
        self.obs_mode = obs_mode
        self.reward_mode = reward_mode
        self.robot_uids = self.DEFAULT_ROBOT
        self.robot_init_qpos_noise = robot_init_qpos_noise
        self.sim_backend = sim_backend
        self.sim_steps_per_control = self.SIM_FREQ // self.CONTROL_FREQ

        if isinstance(self.robot_uids, (tuple, list)):
            from ..agents.multi_agent import MultiAgent

            self.agent = MultiAgent(self.robot_uids, device=self.device,
                                    control_mode=control_mode)
        else:
            self.agent: BaseAgent = REGISTERED_AGENTS[self.robot_uids](
                device=self.device, control_mode=control_mode)
        self.control_mode = self.agent.control_mode
        builder = SceneSpecBuilder(self._sim_params())
        self._load_agent(builder)
        self._load_scene(builder)
        self.model: SceneModel = builder.build()
        self.kernel: Optional[megakernel.MegaKernel] = None
        self.kernel_refusal: Optional[str] = None
        self._physics_step = self._build_physics_dispatch()
        self._force_query = make_force_query(self.model)
        self._post_build()
        self.single_action_space = (self.agent.controller.action_low,
                                    self.agent.controller.action_high)
        self.action_dim = self.agent.controller.action_dim
        self._state: Optional[EnvState] = None
        self._main_seed = None

    # -- task-authoring contract ------------------------------------------
    def _sim_params(self) -> SimParams:
        """Solver parameters of the scene (the JAX ``sim_params`` argument's
        default; a task that needs finer substeps overrides this)."""
        return SimParams(dt=1.0 / self.SIM_FREQ)

    def _load_agent(self, builder: SceneSpecBuilder):
        self.agent.install(builder, np.array([0, 0, 0, 1, 0, 0, 0], np.float32))

    def _load_scene(self, builder: SceneSpecBuilder):
        raise NotImplementedError

    def _post_build(self):
        """Hook after the SceneModel exists."""

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        return state

    def _initialize_episode_prev(self, state: EnvState, gen: torch.Generator,
                                 prev: EnvState) -> EnvState:
        """Episode init with the env's previous state ``prev`` (a reset of a
        live env); override for what persists across episodes. The default
        ignores ``prev``."""
        return self._initialize_episode(state, gen)

    def evaluate(self, state: EnvState, ctx: TaskContext) -> Dict[str, torch.Tensor]:
        return dict(success=torch.zeros(self.num_envs, dtype=torch.bool,
                                        device=self.device))

    def _get_obs_extra(self, state: EnvState, ctx: TaskContext, info) -> Dict:
        return {}

    def _default_extras(self, batch: int) -> Dict[str, torch.Tensor]:
        """Zero-valued extras of ``batch`` envs, before ``_initialize_episode``
        (so that reset and step give extras of one structure)."""
        return {}

    def _update_extras(self, state: EnvState, ctx: TaskContext) -> EnvState:
        """Per-step task bookkeeping, after physics and before evaluate."""
        return state

    def compute_dense_reward(self, state, action, info, ctx) -> torch.Tensor:
        return torch.zeros(state.sim.qpos.shape[0], device=self.device)

    def compute_normalized_dense_reward(self, state, action, info, ctx):
        return self.compute_dense_reward(state, action, info, ctx)

    def compute_sparse_reward(self, state, action, info, ctx) -> torch.Tensor:
        """``info["success"] - info["fail"]`` (JAX ``base_env.py:377-382``)."""
        r = info["success"].to(torch.float32)
        if "fail" in info:
            r = r - info["fail"].to(torch.float32)
        return r

    def _uniform(self, gen: torch.Generator, shape, lo, hi) -> torch.Tensor:
        """Draws from U[lo, hi) of ``shape`` with ``gen``; ``lo`` and ``hi``
        are numbers, tensors or per-column sequences."""
        if isinstance(lo, (list, tuple)):
            lo = torch.as_tensor(lo, dtype=torch.float32, device=self.device)
            hi = torch.as_tensor(hi, dtype=torch.float32, device=self.device)
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=self.device)

    # -- functional core (batched) -----------------------------------------
    def _build_physics_dispatch(self):
        """``(sim, cmd) -> sim`` advancing one control step: the kernel
        where ``supports`` takes the model, else the plain step, the reason
        kept in ``kernel_refusal``. On CUDA a refusal raises unless it is
        the task's declared ``PLAIN_STEP_REFUSAL``."""
        n_steps = self.sim_steps_per_control
        if self.sim_backend == "auto":
            self.kernel_refusal = megakernel.refusal(self.model)
            if (self.kernel_refusal is not None and self.device.type == "cuda"
                    and self.kernel_refusal != self.PLAIN_STEP_REFUSAL):
                raise NotImplementedError(
                    f"the CUDA mega-kernel does not support this model "
                    f"({self.kernel_refusal}); pass sim_backend='torch' to run the "
                    f"plain PyTorch step")
        if self.sim_backend == "torch" or self.kernel_refusal is not None:
            step = make_step_fn(self.model)
            return lambda sim, cmd: step(sim, cmd, n_steps)
        self.kernel = megakernel.MegaKernel(self.model)
        return lambda sim, cmd: self.kernel.step(sim, cmd, n_steps)

    def _initial_sim_state(self, batch: int, gen: torch.Generator) -> SimState:
        state = self.model.initial_state(batch, self.device)
        if self.robot_init_qpos_noise > 0:
            noise = self.robot_init_qpos_noise * torch.randn(
                state.qpos.shape, generator=gen, device=self.device)
            # gripper (prismatic) joints get no noise
            mask = torch.as_tensor(
                (self.model.robot.joint_type == 0).astype(np.float32),
                device=self.device)
            state = state.replace(qpos=state.qpos + noise * mask)
        return state

    def _reset_all(self, gen: torch.Generator, prev: Optional[EnvState] = None):
        """Every env reset: from scratch, or from ``prev``, its previous
        state (JAX ``_reset_one``)."""
        K = self.num_envs
        sim = self._initial_sim_state(K, gen)
        zeros = torch.zeros_like(sim.qpos)
        state = EnvState(
            sim=sim,
            cmd=DriveCmd(target_qpos=sim.qpos, target_qvel=zeros, qf=zeros),
            elapsed_steps=torch.zeros(K, dtype=torch.int32, device=self.device),
            extras=self._default_extras(K),
        )
        if prev is None:
            state = self._initialize_episode(state, gen)
        else:
            state = self._initialize_episode_prev(state, gen, prev)
        state = state.replace(cmd=self.agent.controller.reset(state.sim.qpos))
        ctx = TaskContext(self, state)
        info = self.evaluate(state, ctx)
        return state, self._get_obs(state, ctx, info), info

    def _advance(self, state: EnvState, action: torch.Tensor):
        """Controller, physics and bookkeeping of one control step. A
        task-space controller gets the FK of the pre-step state as ``aux``
        (the JAX ``_step_one``/``_rollout_step``, ``envs/base_env.py:524-564``)."""
        controller = self.agent.controller
        aux = None
        if controller.needs_fk_aux:
            ctx0 = TaskContext(self, state)
            base = const(self.model, "robot_base_pose", self.model.robot_base_pose, self.device)
            aux = (base, ctx0.body_pos, ctx0.body_quat, ctx0.axis_w)
        cmd = controller.set_action(state.cmd, state.sim.qpos, action, aux=aux)
        sim = self._physics_step(state.sim, cmd)
        state = state.replace(sim=sim, cmd=cmd,
                              elapsed_steps=state.elapsed_steps + 1)
        ctx = TaskContext(self, state)
        state = self._update_extras(state, ctx)
        return state, ctx, self.evaluate(state, ctx)

    def _step(self, state: EnvState, action: torch.Tensor):
        action = torch.nan_to_num(action.to(torch.float32))
        state, ctx, info = self._advance(state, action)
        obs = self._get_obs(state, ctx, info)
        reward = self._get_reward(state, action, info, ctx)
        terminated = info["success"]
        if "fail" in info:
            terminated = terminated | info["fail"]
        return state, obs, reward, terminated, info

    def _rollout_step(self, state: EnvState, action: torch.Tensor):
        """Planning-grade step: ``(state', reward, success)`` without obs.
        This is what MPPI runs over its K rollouts."""
        state, ctx, info = self._advance(state, action)
        reward = self._get_reward(state, action, info, ctx)
        return state, reward, info["success"]

    def _get_reward(self, state, action, info, ctx):
        if self.reward_mode == "dense":
            return self.compute_dense_reward(state, action, info, ctx)
        if self.reward_mode == "normalized_dense":
            return self.compute_normalized_dense_reward(state, action, info, ctx)
        if self.reward_mode == "sparse":
            return self.compute_sparse_reward(state, action, info, ctx)
        return torch.zeros(state.sim.qpos.shape[0], device=self.device)

    def _get_obs(self, state: EnvState, ctx: TaskContext, info):
        if self.obs_mode == "none":
            return torch.zeros((state.sim.qpos.shape[0], 0), device=self.device)
        obs = dict(agent=self.agent.proprioception(state.sim.qpos, state.sim.qvel),
                   extra=self._get_obs_extra(state, ctx, info))
        if self.obs_mode == "state_dict":
            return obs
        return flatten_state_dict(obs)

    # -- stateful batched API ----------------------------------------------
    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        """Reset every env (from its previous state after the first reset),
        or with ``options={"env_idx": ...}`` the named envs only."""
        if seed is None:
            seed = 0 if self._main_seed is None else self._main_seed + 1
        self._main_seed = seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        prev = self._state
        env_idx = (options or {}).get("env_idx")
        new, obs, info = self._reset_all(gen, prev)
        if env_idx is not None and prev is not None:
            mask = torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)
            mask[torch.as_tensor(env_idx, device=self.device)] = True
            new = tree_map(lambda n, o: torch.where(mask.view((-1,) + (1,) * (n.ndim - 1)), n, o),
                           new, prev)
        self._state = new
        return obs, info

    def step(self, action):
        action = torch.as_tensor(action, dtype=torch.float32, device=self.device)
        if action.ndim == 1:
            action = action.expand(self.num_envs, -1)
        self._state, obs, reward, terminated, info = self._step(self._state, action)
        if self.max_episode_steps is not None:
            truncated = self._state.elapsed_steps >= self.max_episode_steps
        else:
            truncated = torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)
        return obs, reward, terminated, truncated, info

    # -- state get/set (JAX ``:727-835``) ----------------------------------
    def get_state_dict(self) -> Dict:
        """``{"actors": {name: (K, 13)}, "articulations": {uids: (K, 13 +
        2 nq)}, "controller": {"target_qpos"}, "contacts": {"lam",
        "lam_t"}}``: the reference's layout (pose, velocity; the robot's
        root pose, zero root velocity, qpos, qvel), plus the controller's
        targets and the warm-started contact impulses, with which
        ``set_state_dict`` restores the state exactly."""
        s, K = self._state.sim, self.num_envs
        zeros6 = s.qpos.new_zeros(K, 6)
        actors = {name: torch.cat([s.free_pose[:, i], s.free_vel[:, i]], dim=-1)
                  for name, i in self.model.free_index.items()}
        actors.update({name: torch.cat([s.kin_pose[:, i], zeros6], dim=-1)
                       for name, i in self.model.kin_index.items()})
        arts = {}
        if self.model.nq > 0:
            root = const(self.model, "robot_base_pose", self.model.robot_base_pose,
                         self.device).expand(K, 7)
            arts[self.robot_uids] = torch.cat([root, zeros6, s.qpos, s.qvel], dim=-1)
        return dict(actors=actors, articulations=arts,
                    controller=dict(target_qpos=self._state.cmd.target_qpos),
                    contacts=dict(lam=s.contact_lam, lam_t=s.contact_lam_t))

    def set_state_dict(self, sd: Dict):
        """Restore a ``get_state_dict`` payload (one without ``contacts``
        starts the warm start from zero impulses)."""
        s, dev = self._state.sim, self.device
        free_pose, free_vel, kin_pose = s.free_pose.clone(), s.free_vel.clone(), s.kin_pose.clone()
        for name, val in sd.get("actors", {}).items():
            val = torch.as_tensor(val, device=dev)
            if name in self.model.free_index:
                i = self.model.free_index[name]
                free_pose[:, i] = val[:, :7]
                free_vel[:, i] = val[:, 7:13]
            elif name in self.model.kin_index:
                kin_pose[:, self.model.kin_index[name]] = val[:, :7]
        qpos, qvel, nq = s.qpos, s.qvel, self.model.nq
        for val in sd.get("articulations", {}).values():
            val = torch.as_tensor(val, device=dev)
            qpos, qvel = val[:, 13:13 + nq], val[:, 13 + nq:13 + 2 * nq]
        if "contacts" in sd:
            lam = torch.as_tensor(sd["contacts"]["lam"], device=dev)
            lam_t = torch.as_tensor(sd["contacts"]["lam_t"], device=dev)
        else:
            lam, lam_t = torch.zeros_like(s.contact_lam), torch.zeros_like(s.contact_lam_t)
        sim = s.replace(free_pose=free_pose, free_vel=free_vel, kin_pose=kin_pose, qpos=qpos,
                        qvel=qvel, contact_lam=lam, contact_lam_t=lam_t)
        cmd = self._state.cmd
        if "controller" in sd:
            cmd = cmd.replace(target_qpos=torch.as_tensor(sd["controller"]["target_qpos"],
                                                          device=dev))
        self._state = self._state.replace(sim=sim, cmd=cmd)

    def get_state(self) -> torch.Tensor:
        return flatten_state_dict(self.get_state_dict())

    def set_drive_properties(self, stiffness=None, damping=None, force_limit=None,
                             joint_names=None, env_idx=None):
        """Change the PD drive gains of ``joint_names`` (default: every
        joint) in the envs ``env_idx`` (default: all) until the next reset,
        which restores the controller's gains. A command that carries no
        gains of its own (the model's) is given them first."""
        cmd, model, dev = self._state.cmd, self.model, self.device
        names = list(model.robot.joint_names)
        jidx = (np.arange(model.nq) if joint_names is None
                else np.asarray([names.index(n) for n in joint_names]))
        eidx = np.arange(self.num_envs) if env_idx is None else np.asarray(env_idx)
        rows = torch.as_tensor(eidx, device=dev)[:, None]
        cols = torch.as_tensor(jidx, device=dev)[None, :]

        def upd(cur, default, val):
            if cur is None:
                cur = torch.as_tensor(default, dtype=torch.float32,
                                      device=dev).expand(self.num_envs, -1)
            if val is None:
                return cur
            cur = cur.clone()
            cur[rows, cols] = torch.as_tensor(val, dtype=torch.float32,
                                              device=dev).expand(len(eidx), len(jidx))
            return cur

        self._state = self._state.replace(cmd=cmd.replace(
            kp=upd(cmd.kp, model.drive_kp, stiffness),
            kd=upd(cmd.kd, model.drive_kd, damping),
            force_limit=upd(cmd.force_limit, model.drive_force_limit, force_limit)))

    def sample_action(self, gen: torch.Generator) -> torch.Tensor:
        """(K, A) actions uniform in the action space, drawn with ``gen``
        (the JAX env's takes a numpy ``RandomState``)."""
        lo, hi = self.single_action_space
        return self._uniform(gen, (self.num_envs, self.action_dim), list(lo), list(hi))


def flatten_state_dict(d: Dict) -> torch.Tensor:
    """Insertion-ordered flatten of a nested dict of (K, ...) tensors into
    (K, n); per-env scalars (K,) become one column, and a leaf of more
    dimensions its rows (the warm-start impulses (K, P, 3) of
    ``get_state``: the JAX ``flatten_state_dict`` cannot concatenate them,
    so JAX ``get_state`` raises on a scene with contact points)."""
    leaves = []

    def rec(x):
        if isinstance(x, dict):
            for k in x:
                rec(x[k])
        else:
            a = x.to(torch.float32) if x.dtype == torch.bool else x
            leaves.append(a.reshape(a.shape[0], -1))

    rec(d)
    return torch.cat(leaves, dim=-1)
