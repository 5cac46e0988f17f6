"""Receding-horizon MPC driver and the CEM + iLQR planner.

Port of ``maniskill_tpu/planners/mpc.py``: ``CEMILQRConfig``, ``CEMILQR``
(BASELINE config #3: a CEM solve proposes a nominal sequence, iLQR refines
it through the differentiable physics step, and the refined sequence is
executed and shifted into the CEM state, ``:99-114``), ``make_planner``
(``mppi``, ``cem``, ``cem-ilqr``), ``run_episode`` and ``solve_task``. The
port runs the JAX "split" mode: CEM and iLQR are two host-sequenced calls,
as eager PyTorch is anyway. Not ported yet: ``run_episode_device`` (the
fused on-device episode scan) and the multi-chip mesh argument.
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .cem import CEM, CEMConfig, CEMState
from .ilqr import ILQR, ILQRConfig
from .mppi import MPPI, MPPIConfig


class CEMILQRConfig(NamedTuple):
    cem: CEMConfig = CEMConfig()
    ilqr: ILQRConfig = ILQRConfig()


class CEMILQR:
    """CEM warm start + iLQR refinement; the planner state is the CEM
    state."""

    def __init__(self, env, config: CEMILQRConfig = CEMILQRConfig()):
        if config.cem.horizon != config.ilqr.horizon:
            raise ValueError(f"CEM horizon {config.cem.horizon} != iLQR horizon "
                             f"{config.ilqr.horizon}")
        self.env = env
        self.config = config
        self.action_dim = env.action_dim
        self.cem = CEM(env, config.cem)
        self.ilqr = ILQR(env, config.ilqr)

    def init(self, seed: int = 0) -> CEMState:
        return self.cem.init(seed=seed)

    def plan_step(self, ps: CEMState, env_state):
        ps2, cinfo = self.cem.solve(ps, env_state)
        U, rinfo = self.ilqr.solve(env_state, ps2.mean)
        info = dict(cem_best_return=cinfo["best_return"],
                    ilqr_initial_cost=rinfo["initial_cost"],
                    ilqr_final_cost=rinfo["final_cost"])
        return self.cem.shift(ps2, U), U[0], info


def make_planner(env, planner: str = "mppi", config=None):
    if planner == "mppi":
        return MPPI(env, config or MPPIConfig())
    if planner == "cem":
        return CEM(env, config or CEMConfig())
    if planner == "cem-ilqr":
        return CEMILQR(env, config or CEMILQRConfig())
    raise ValueError(f"unknown planner {planner!r}")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_episode(env, planner_obj, seed: int = 0, max_steps: Optional[int] = None,
                stop_on_success: bool = True) -> Dict[str, Any]:
    """One receding-horizon episode on a ``num_envs=1`` env: success,
    steps, return, the executed actions (T, A) and the replanning rate
    after the first plan step (synchronized wall time of ``plan_step``)."""
    if env.num_envs != 1:
        raise ValueError("the MPC driver plans for a single env")
    max_steps = max_steps or env.max_episode_steps or 50
    env.reset(seed=seed)
    ps = planner_obj.init(seed=seed)
    actions, rewards, infos = [], [], []
    success = False
    plan_wall, plans_timed = 0.0, 0
    for t in range(max_steps):
        t0 = time.perf_counter()
        ps, action, _ = planner_obj.plan_step(ps, env._state)
        _sync(env.device)
        if t > 0:  # the first plan step pays the kernel build
            plan_wall += time.perf_counter() - t0
            plans_timed += 1
        _obs, reward, _term, _trunc, step_info = env.step(action)
        actions.append(action.detach().cpu().numpy())
        rewards.append(float(reward[0]))
        infos.append({k: v[0].cpu().numpy() for k, v in step_info.items()})
        if bool(step_info["success"][0]):
            success = True
            if stop_on_success:
                break
    return dict(success=success, steps=len(actions),
                episode_return=float(np.sum(rewards)),
                actions=np.stack(actions) if actions else np.zeros((0, env.action_dim)),
                rewards=np.asarray(rewards), final_info=infos[-1] if infos else {},
                seed=seed, replan_hz=(plans_timed / plan_wall) if plan_wall > 0 else 0.0)


def solve_task(env_id: str, planner: str = "mppi", config=None, episodes: int = 5,
               seed: int = 0, max_steps: Optional[int] = None,
               env_kwargs: Optional[dict] = None) -> Dict[str, Any]:
    """``episodes`` seeded receding-horizon episodes of a registered task;
    returns the success rate and the per-episode results. ``env_kwargs``
    go to ``make`` (``device="cpu"`` for the plain step on the CPU)."""
    from ..envs.registration import make

    kwargs = dict(num_envs=1, obs_mode="none", reward_mode="dense")
    kwargs.update(env_kwargs or {})
    env = make(env_id, **kwargs)
    planner_obj = make_planner(env, planner, config)
    results = [run_episode(env, planner_obj, seed=seed + i, max_steps=max_steps)
               for i in range(episodes)]
    out = dict(env_id=env_id, planner=planner,
               success_rate=float(np.mean([r["success"] for r in results])),
               mean_return=float(np.mean([r["episode_return"] for r in results])),
               mean_steps=float(np.mean([r["steps"] for r in results])),
               episodes=results)
    hzs = [r["replan_hz"] for r in results if r["replan_hz"]]
    if hzs:
        out["replan_hz"] = float(np.mean(hzs))
    return out
