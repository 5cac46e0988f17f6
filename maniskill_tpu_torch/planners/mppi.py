"""MPPI (Model-Predictive Path Integral) planner on batched tensors.

Port of ``maniskill_tpu/planners/mppi.py``: ``MPPIConfig``, ``init``,
``solve`` and ``plan_step``, with the OU noise smoothing, the quadratic
``ctrl_cost`` and the masking of non-finite returns. The K rollouts are the
env's batch dimension (the JAX ``vmap``) and the horizon is a Python loop
(the JAX ``scan``). The multi-chip mesh argument is not ported.

``solve(..., noise=)`` takes the white noise (K, H, A) instead of drawing it
from the planner's generator, so a test can feed both packages the same
draw.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Sequence, Union

import torch

from ..physics.model import tree_map


class MPPIConfig(NamedTuple):
    horizon: int = 50
    num_samples: int = 1024
    # exploration std in normalized action units: one for every action
    # dimension, or one per dimension (held as an (A,) tensor, as the JAX
    # MPPIState.sigma)
    sigma: Union[float, Sequence[float]] = 0.5
    temperature: float = 0.5  # softmax temperature λ
    ctrl_cost: float = 0.0  # quadratic control cost per step
    noise_beta: float = 0.0  # OU temporal noise correlation (0 = white)
    # the first solve's nominal, (H, A) in normalized action units (a task
    # prior, such as the cabinet's approach); None: zeros
    nominal_init: object = None


@dataclass
class MPPIState:
    nominal: torch.Tensor  # (H, A)
    generator: torch.Generator


class MPPI:
    """Sampling MPC over a maniskill_tpu_torch env's batched core."""

    def __init__(self, env, config: MPPIConfig = MPPIConfig()):
        self.env = env
        self.config = config
        self.action_dim = env.action_dim
        self.device = env.device
        self.sigma = torch.as_tensor(config.sigma, dtype=torch.float32,
                                     device=self.device).expand(self.action_dim).clone()

    def init(self, seed: int = 0) -> MPPIState:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        shape = (self.config.horizon, self.action_dim)
        if self.config.nominal_init is not None:
            nom = torch.as_tensor(self.config.nominal_init, dtype=torch.float32,
                                  device=self.device).clone()
            if tuple(nom.shape) != shape:
                raise ValueError(f"nominal_init has shape {tuple(nom.shape)}, expected {shape}")
        else:
            nom = torch.zeros(shape, device=self.device)
        return MPPIState(nominal=nom, generator=gen)

    def _rollout(self, env_state, controls: torch.Tensor):
        """Returns and any-success of K control sequences (K, H, A) from one
        single-env start state."""
        K, H, _ = controls.shape
        st = tree_map(lambda x: x.expand((K,) + x.shape[1:]).clone(), env_state)
        ret = torch.zeros(K, device=self.device)
        succ = torch.zeros(K, dtype=torch.bool, device=self.device)
        for t in range(H):
            st, r, s = self.env._rollout_step(st, controls[:, t])
            ret = ret + r
            succ = succ | s
        return ret, succ

    def solve(self, ps: MPPIState, env_state, noise: Optional[torch.Tensor] = None):
        """One MPPI solve from a single-env state (batch dimension 1)."""
        cfg = self.config
        shape = (cfg.num_samples, cfg.horizon, self.action_dim)
        white = noise if noise is not None else torch.randn(
            shape, generator=ps.generator, device=self.device)
        beta = cfg.noise_beta
        eps = torch.zeros(cfg.num_samples, self.action_dim, device=self.device)
        smoothed = []
        for t in range(cfg.horizon):
            eps = beta * eps + (1.0 - beta * beta) ** 0.5 * white[:, t]
            smoothed.append(eps)
        noise_s = torch.stack(smoothed, dim=1) * self.sigma
        controls = torch.clamp(ps.nominal[None] + noise_s, -1.0, 1.0)
        returns, succ = self._rollout(env_state, controls)
        returns = returns - cfg.ctrl_cost * torch.sum(controls * controls, dim=(1, 2))
        # a rollout that blew up gets zero weight instead of poisoning the
        # softmax
        returns = torch.where(torch.isfinite(returns), returns,
                              torch.full_like(returns, -float("inf")))
        w = torch.softmax(returns / cfg.temperature, dim=0)
        nominal = torch.einsum("k,khA->hA", w, controls)
        info = dict(best_return=returns.max(), mean_return=returns.mean(),
                    ess=1.0 / torch.sum(w * w), any_success=succ.any(),
                    returns=returns)
        return replace(ps, nominal=nominal), info

    def plan_step(self, ps: MPPIState, env_state):
        """Receding horizon: solve, return the first action, shift."""
        ps, info = self.solve(ps, env_state)
        action = ps.nominal[0]
        shifted = torch.cat([ps.nominal[1:], ps.nominal[-1:]])
        return replace(ps, nominal=shifted), action, info
