"""iLQR trajectory refinement through the differentiable physics step.

Port of ``maniskill_tpu/planners/ilqr.py``: ``ILQRConfig`` and ``ILQR``.
The forward rollouts and the line search step the full env state (warm
starts, controller command, counters carried exactly); the Riccati pass
linearizes only the reduced state x = (qpos, qvel, free_pose, free_vel),
nx = 2 nq + 13 F (44 for StackCube), with the rest of each state taken from
the nominal rollout as a per-step template (``dyn``/``cost``, ``:77-87``).

The linearization (``f_x``, ``f_u``, ``c_x``, ``c_u`` at every step, the
JAX ``jacfwd``/``grad`` at ``:108-111``) is ONE forward-mode pass: the
H (nx + nu) basis directions are stacked along the env batch, each batch
row a copy of its step's template, and ``torch.func.jvp`` carries them
through one ``_rollout_step``. On a CUDA env the physics primal of that
pass is one kernel launch and the tangents come from the plain step
(``megakernel.KernelStep``). The line search's ``line_search_steps`` step
sizes run as one batch (the JAX ``vmap`` over alphas).

``riccati_backward`` (``:124-150``) and ``select_step`` (``:165-181``) are
plain functions of arrays, so they can be checked without physics.
``jnp.linalg.inv`` stays ``torch.linalg.inv``: in JAX it runs outside any
Pallas kernel too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..physics.model import tree_cat, tree_map


class ILQRConfig(NamedTuple):
    horizon: int = 30
    iterations: int = 10
    reg_init: float = 1.0
    reg_factor: float = 10.0
    reg_max: float = 1e6
    action_penalty: float = 1e-3
    line_search_steps: int = 5


def riccati_backward(A, B, cx, cu, reg, action_penalty: float):
    """Backward Riccati pass with Gauss-Newton Hessians (cost curvature
    dropped, identity-scaled regularization ``2 action_penalty + reg`` on
    Quu). A (H, nx, nx), B (H, nx, nu), cx (H, nx), cu (H, nu) -> the
    feed-forward ks (H, nu) and feedback gains Ks (H, nu, nx)."""
    H, nx, nu = B.shape
    Vx = A.new_zeros(nx)
    Vxx = A.new_zeros(nx, nx)
    eye = torch.eye(nu, dtype=A.dtype, device=A.device)
    ks, Ks = [None] * H, [None] * H
    for t in range(H - 1, -1, -1):
        At, Bt = A[t], B[t]
        Qx = cx[t] + At.T @ Vx
        Qu = cu[t] + Bt.T @ Vx
        Qxx = At.T @ Vxx @ At
        Quu = Bt.T @ Vxx @ Bt + (2 * action_penalty + reg) * eye
        Qux = Bt.T @ Vxx @ At
        Quu_inv = torch.linalg.inv(Quu)
        k = -Quu_inv @ Qu
        K = -Quu_inv @ Qux
        Vx = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
        Vxx = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
        Vxx = 0.5 * (Vxx + Vxx.T)
        ks[t], Ks[t] = k, K
    return torch.stack(ks), torch.stack(Ks)


def select_step(costs, Us, U, reg, best_cost, config: ILQRConfig):
    """The line search's choice and the regularization schedule: the
    cheapest finite candidate replaces ``U`` if it beats ``best_cost``; reg
    shrinks by ``reg_factor`` (floor 1e-6) on success, else grows (cap
    ``reg_max``). Returns ``(U, reg, best_cost, cost of the candidate)``;
    everything stays on the device (no host sync)."""
    costs = torch.where(torch.isfinite(costs), costs, torch.full_like(costs, float("inf")))
    best = torch.argmin(costs)
    new_cost = costs[best]
    improved = new_cost < best_cost
    U = torch.where(improved, Us[best], U)
    reg = torch.where(improved, torch.clamp_min(reg / config.reg_factor, 1e-6),
                      torch.clamp_max(reg * config.reg_factor, config.reg_max))
    return U, reg, torch.minimum(new_cost, best_cost), new_cost


class ILQR:
    """iLQR over a maniskill_tpu_torch env's batched core."""

    def __init__(self, env, config: ILQRConfig = ILQRConfig()):
        self.env = env
        self.config = config
        self.action_dim = env.action_dim
        self.device = env.device
        self.nq, self.F = env.model.nq, env.model.n_free
        self.nx = 2 * self.nq + 13 * self.F

    # -- reduced state --------------------------------------------------------
    def reduce(self, sim):
        K = sim.qpos.shape[0]
        return torch.cat([sim.qpos, sim.qvel, sim.free_pose.reshape(K, -1),
                          sim.free_vel.reshape(K, -1)], dim=-1)

    def inject(self, sim, x):
        nq, F = self.nq, self.F
        K = x.shape[0]
        return sim.replace(qpos=x[:, :nq], qvel=x[:, nq:2 * nq],
                           free_pose=x[:, 2 * nq:2 * nq + 7 * F].reshape(K, F, 7),
                           free_vel=x[:, 2 * nq + 7 * F:].reshape(K, F, 6))

    def step_cost(self, state, u):
        """One control step of the full state: ``(state', cost (K,))``."""
        st2, reward, _ = self.env._rollout_step(state, u)
        return st2, -reward + self.config.action_penalty * torch.sum(u * u, dim=-1)

    # -- passes ---------------------------------------------------------------
    def rollout(self, env_state, U):
        """Full-state rollout of U (H, nu) from a single-env state: the
        states before each step, concatenated (batch H: the templates),
        and the total cost."""
        st, traj, total = env_state, [], 0.0
        for t in range(U.shape[0]):
            traj.append(st)
            st, c = self.step_cost(st, U[t:t + 1])
            total = total + c[0]
        return tree_cat(traj), total

    def step_jvp(self, templates, x, u, dx, du):
        """Forward-mode derivative of one step on the reduced state at B
        points, each along its own direction: templates (B-batch env
        state), x, dx (B, nx), u, du (B, nu) -> (d x', d cost) of shapes
        (B, nx), (B,)."""
        def g(x_, u_):
            st2, c = self.step_cost(templates.replace(sim=self.inject(templates.sim, x_)), u_)
            return self.reduce(st2.sim), c

        _, (dy, dc) = torch.func.jvp(g, (x, u), (dx, du))
        return dy, dc

    def linearize(self, templates, xs, U):
        """``(A, B, cx, cu)`` at every step of the nominal trajectory in one
        forward-mode pass over H (nx + nu) stacked directions."""
        H, nu = U.shape
        nx = self.nx
        n = nx + nu
        rep = tree_map(lambda v: v.repeat_interleave(n, dim=0), templates)
        basis = torch.eye(n, device=U.device).repeat(H, 1)  # row t*n + i: e_i
        dy, dc = self.step_jvp(rep, xs.repeat_interleave(n, dim=0),
                               U.repeat_interleave(n, dim=0), basis[:, :nx], basis[:, nx:])
        J = dy.reshape(H, n, nx).transpose(1, 2)  # (H, nx, n)
        g = dc.reshape(H, n)
        return J[..., :nx], J[..., nx:], g[:, :nx], g[:, nx:]

    def line_search(self, env_state, U, xs, ks, Ks):
        """All step sizes 0.5^i as one batch: full-state forward passes with
        feedback on the reduced deviation from the nominal. Returns the
        total costs (L,) and the applied controls (L, H, nu)."""
        L = self.config.line_search_steps
        alphas = 0.5 ** torch.arange(L, device=U.device, dtype=U.dtype)
        st = tree_map(lambda v: v.expand((L,) + v.shape[1:]).clone(), env_state)
        total, Us = 0.0, []
        for t in range(U.shape[0]):
            dx = self.reduce(st.sim) - xs[t]
            u = torch.clamp(U[t] + alphas[:, None] * ks[t] + dx @ Ks[t].T, -1.0, 1.0)
            st, c = self.step_cost(st, u)
            total = total + c
            Us.append(u)
        return total, torch.stack(Us, dim=1)

    def solve(self, env_state, U0: Optional[torch.Tensor] = None):
        """Refine U0 (H, nu) from a single-env state (batch dimension 1)."""
        cfg = self.config
        if U0 is None:
            U0 = torch.zeros((cfg.horizon, self.action_dim), device=self.device)
        _, cost0 = self.rollout(env_state, U0)
        U, reg, best, history = U0, torch.tensor(cfg.reg_init, device=U0.device), cost0, []
        for _ in range(cfg.iterations):
            traj, _ = self.rollout(env_state, U)
            xs = self.reduce(traj.sim)
            A, B, cx, cu = self.linearize(traj, xs, U)
            ks, Ks = riccati_backward(A, B, cx, cu, reg, cfg.action_penalty)
            costs, Us = self.line_search(env_state, U, xs, ks, Ks)
            U, reg, best, new_cost = select_step(costs, Us, U, reg, best, cfg)
            history.append(new_cost)
        return U, dict(initial_cost=cost0, final_cost=best, cost_history=torch.stack(history))
