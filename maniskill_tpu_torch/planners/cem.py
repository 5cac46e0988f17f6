"""CEM (cross-entropy method) planner on batched tensors.

Port of ``maniskill_tpu/planners/cem.py``: ``CEMConfig``, ``CEMState``,
``init``, ``solve`` and ``plan_step``. Each solve runs ``iterations``
rounds of sample -> roll out -> top-k elites -> refit mean and std, with
the momentum update and the ``min_sigma`` floor. The K rollouts are the
env's batch dimension (the JAX ``vmap``), the horizon is a Python loop (the
JAX ``scan``), and a non-finite return is never an elite (``:67-69``). The
multi-chip mesh argument is not ported.

``solve(..., noise=)`` takes the white noise (iterations, K, H, A) instead
of drawing it from the planner's generator, so a test can feed both
packages the same draw.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import torch

from ..physics.model import tree_map


class CEMConfig(NamedTuple):
    horizon: int = 50
    num_samples: int = 512
    num_elites: int = 64
    iterations: int = 4
    init_sigma: float = 0.6
    min_sigma: float = 0.05
    momentum: float = 0.1  # mean/std update momentum
    gamma: float = 1.0


@dataclass
class CEMState:
    mean: torch.Tensor  # (H, A)
    sigma: torch.Tensor  # (H, A)
    generator: torch.Generator


def rollout_returns(env, env_state, controls: torch.Tensor, gamma: float = 1.0):
    """Discounted returns (K,) of K control sequences (K, H, A) from one
    single-env start state (batch dimension 1)."""
    K, H, _ = controls.shape
    st = tree_map(lambda x: x.expand((K,) + x.shape[1:]).clone(), env_state)
    ret = torch.zeros(K, device=controls.device)
    disc = 1.0
    for t in range(H):
        st, r, _ = env._rollout_step(st, controls[:, t])
        ret = ret + r * disc
        disc *= gamma
    return ret


class CEM:
    """Cross-entropy MPC over a maniskill_tpu_torch env's batched core."""

    def __init__(self, env, config: CEMConfig = CEMConfig()):
        self.env = env
        self.config = config
        self.action_dim = env.action_dim
        self.device = env.device

    def init(self, seed: int = 0) -> CEMState:
        cfg = self.config
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        shape = (cfg.horizon, self.action_dim)
        return CEMState(mean=torch.zeros(shape, device=self.device),
                        sigma=torch.full(shape, cfg.init_sigma, device=self.device),
                        generator=gen)

    def solve(self, ps: CEMState, env_state, noise: Optional[torch.Tensor] = None):
        """One CEM solve from a single-env state; returns the refit state
        and ``best_return`` of the last iteration."""
        cfg = self.config
        shape = (cfg.num_samples, cfg.horizon, self.action_dim)
        mean, sigma = ps.mean, ps.sigma
        for i in range(cfg.iterations):
            eps = noise[i] if noise is not None else torch.randn(
                shape, generator=ps.generator, device=self.device)
            controls = torch.clamp(mean[None] + sigma[None] * eps, -1.0, 1.0)
            returns = rollout_returns(self.env, env_state, controls, cfg.gamma)
            returns = torch.where(torch.isfinite(returns), returns,
                                  torch.full_like(returns, -float("inf")))
            elites = controls[torch.topk(returns, cfg.num_elites).indices]  # (E, H, A)
            mean = cfg.momentum * mean + (1 - cfg.momentum) * elites.mean(dim=0)
            sigma = torch.clamp_min(
                cfg.momentum * sigma + (1 - cfg.momentum) * elites.std(dim=0, unbiased=False),
                cfg.min_sigma)
        return replace(ps, mean=mean, sigma=sigma), dict(best_return=returns.max())

    def shift(self, ps: CEMState, mean: torch.Tensor) -> CEMState:
        """Receding horizon: drop the first step of ``mean`` and of the
        sigma, repeat the last mean and restart the last sigma."""
        cfg = self.config
        return replace(
            ps, mean=torch.cat([mean[1:], mean[-1:]]),
            sigma=torch.cat([ps.sigma[1:], torch.full_like(ps.sigma[-1:], cfg.init_sigma)]))

    def plan_step(self, ps: CEMState, env_state):
        """Solve, return the first action of the mean, shift."""
        ps, info = self.solve(ps, env_state)
        return self.shift(ps, ps.mean), ps.mean[0], info
