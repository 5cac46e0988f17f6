"""CEM, iLQR and CEM + iLQR of the PyTorch port against the JAX package, on
the CPU.

The planners are compared where a JAX compile stays cheap (a JAX
StackCube iLQR solve takes minutes to compile here, a CEM solve half a
minute). CEM runs on a small time-varying linear system that both
packages step through the same planner code as an env; torch and JAX draw
different random numbers, so the JAX CEM noise is replayed into the port.
iLQR is compared in three ways:
- the whole algorithm (rollouts, linearization, Riccati pass, line search,
  regularization schedule) on the same linear system;
- the linearization of one StackCube step: one ``jax.jvp`` of the JAX
  ``dyn``/``cost`` (``maniskill_tpu/planners/ilqr.py:77-87``, written out
  here since they are closures) along two seeded directions, against the
  port's batched forward-mode pass along the same directions;
- the full-Jacobian comparison and a StackCube solve under the ``slow``
  marker.

Tolerances: CEM mean/sigma 1e-4 and returns 1e-4 relative (float32 sums);
iLQR on the linear system 1e-4 relative (float32 Riccati
recursions over 4 steps); the StackCube tangents 2e-3 relative to the
tangent's scale (a stiff contact step amplifies float32 rounding of the
primal, which the tangent is evaluated at).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maniskill_tpu as mst
from maniskill_tpu.planners.cem import CEM as JCEM, CEMConfig as JCEMConfig
from maniskill_tpu.planners.ilqr import ILQR as JILQR, ILQRConfig as JILQRConfig

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.physics.model import _Struct, tree_map
from maniskill_tpu_torch.planners import (CEM, CEMConfig, CEMILQR, CEMILQRConfig, ILQR,
                                          ILQRConfig, make_planner, solve_task)
from maniskill_tpu_torch.planners.ilqr import select_step


def _np(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _np(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.name != "rng"}
    if isinstance(obj, dict):
        return {k: _np(v) for k, v in obj.items()}
    return None if obj is None else np.asarray(obj)


@pytest.fixture(scope="module")
def jenv():
    env = mst.make("StackCube-v1", num_envs=1, reward_mode="dense", sim_backend="xla")
    env.reset(seed=0)
    return env


@pytest.fixture(scope="module")
def tenv():
    return mtt.make("StackCube-v1", num_envs=1, reward_mode="dense", device="cpu")


def test_ilqr_linearization_matches_jax_jvp(jenv, tenv):
    """The derivative of one StackCube control step on the reduced state
    (nx = 44) and its cost, at a state with cubeA stacked on cubeB (the
    box_box points loaded), along two seeded directions (dx, du): the
    port's batched forward-mode pass against ``jax.jvp``."""
    st_t = tenv.contact_state(convert.env_state_from_numpy(_np(jenv._state)),
                              torch.Generator().manual_seed(0))
    assert (st_t.sim.contact_lam[0, :28] > 0).any()
    il = ILQR(tenv, ILQRConfig(horizon=1))
    assert il.nx == 44
    x0 = il.reduce(st_t.sim)[0].numpy()
    rng = np.random.default_rng(0)
    u0 = rng.uniform(-0.5, 0.5, 8).astype(np.float32)
    dxs = rng.normal(size=(2, 44)).astype(np.float32)
    dus = rng.normal(size=(2, 8)).astype(np.float32)

    # the JAX dyn/cost of ilqr.py:77-87 at the same template
    template = jax.tree.map(lambda x: x[0], jenv._state)
    template = template.replace(sim=template.sim.replace(**{
        k: jnp.asarray(v[0]) for k, v in convert.to_numpy(st_t.sim).items()}),
        cmd=template.cmd.replace(**{k: jnp.asarray(v[0]) for k, v in
                                    convert.to_numpy(st_t.cmd).items() if v is not None}))
    nq, F = 9, 2

    def dyn_cost(x, u):
        sim = template.sim.replace(qpos=x[:nq], qvel=x[nq:2 * nq],
                                   free_pose=x[2 * nq:2 * nq + 7 * F].reshape(F, 7),
                                   free_vel=x[2 * nq + 7 * F:].reshape(F, 6))
        st2, reward, _ = jenv._rollout_step(template.replace(sim=sim), u)
        y = jnp.concatenate([st2.sim.qpos, st2.sim.qvel, st2.sim.free_pose.reshape(-1),
                             st2.sim.free_vel.reshape(-1)])
        return y, -reward + 1e-3 * jnp.sum(u * u)

    jt = jax.jit(jax.vmap(lambda dx, du: jax.jvp(dyn_cost, (x0, u0), (dx, du))[1]))
    dy_j, dc_j = map(np.asarray, jt(jnp.asarray(dxs), jnp.asarray(dus)))
    rep = tree_map(lambda v: v.repeat_interleave(2, dim=0), st_t)
    dy_t, dc_t = il.step_jvp(rep, torch.tensor(x0).repeat(2, 1), torch.tensor(u0).repeat(2, 1),
                             torch.tensor(dxs), torch.tensor(dus))
    assert np.isfinite(dy_j).all() and np.abs(dy_j).max() > 1e-3
    scale = np.abs(dy_j).max(axis=1, keepdims=True)
    np.testing.assert_allclose(dy_t.numpy() / scale, dy_j / scale, atol=2e-3)
    np.testing.assert_allclose(dc_t.numpy(), dc_j, atol=2e-3 * max(1.0, np.abs(dc_j).max()))


# ---- the whole iLQR algorithm on a time-varying linear system ----------------

NQ, NU, H = 2, 3, 4
NX = 2 * NQ + 13


def _linear_problem():
    rng = np.random.default_rng(7)
    A = (np.eye(NX) + 0.1 * rng.normal(size=(H, NX, NX))).astype(np.float32)
    B = (0.3 * rng.normal(size=(H, NX, NU))).astype(np.float32)
    w = rng.normal(size=NX).astype(np.float32)
    d = rng.uniform(0.5, 2.0, NX).astype(np.float32)
    x0 = rng.normal(size=NX).astype(np.float32)
    return A, B, w, d, x0


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class _JSim:
    qpos: jnp.ndarray
    qvel: jnp.ndarray
    free_pose: jnp.ndarray
    free_vel: jnp.ndarray

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class _JState:
    sim: _JSim
    t: jnp.ndarray

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class _TSim(_Struct):
    qpos: torch.Tensor
    qvel: torch.Tensor
    free_pose: torch.Tensor
    free_vel: torch.Tensor


@dataclasses.dataclass
class _TState(_Struct):
    sim: _TSim
    t: torch.Tensor


def _split(x):
    return x[..., :NQ], x[..., NQ:2 * NQ], x[..., 2 * NQ:2 * NQ + 7], x[..., 2 * NQ + 7:]


class _JLinearEnv:
    """x' = A_t x + B_t u, reward -(w . x' + 0.5 d . x'^2); one env."""

    action_dim = NU

    def __init__(self):
        self.A, self.B, self.w, self.d, x0 = map(jnp.asarray, _linear_problem())
        q, v, p, fv = _split(x0)
        self.state0 = _JState(_JSim(q, v, p.reshape(1, 7), fv.reshape(1, 6)), jnp.asarray(0))

        class _Model:
            def initial_state(_self):
                return self.state0.sim

        self.model = _Model()

    def _rollout_step(self, st, u):
        s = st.sim
        x = jnp.concatenate([s.qpos, s.qvel, s.free_pose.reshape(-1), s.free_vel.reshape(-1)])
        y = self.A[st.t] @ x + self.B[st.t] @ u
        q, v, p, fv = _split(y)
        reward = -(self.w @ y + 0.5 * jnp.sum(self.d * y * y))
        return _JState(_JSim(q, v, p.reshape(1, 7), fv.reshape(1, 6)), st.t + 1), reward, False


class _TLinearEnv:
    """The same system, batched, for the port's planners."""

    action_dim = NU
    device = torch.device("cpu")

    def __init__(self):
        self.A, self.B, self.w, self.d, x0 = map(torch.as_tensor, _linear_problem())
        q, v, p, fv = _split(x0[None])
        self.state0 = _TState(_TSim(q, v, p.reshape(1, 1, 7), fv.reshape(1, 1, 6)),
                              torch.zeros(1, dtype=torch.long))
        self.model = type("M", (), dict(nq=NQ, n_free=1))()

    def _rollout_step(self, st, u):
        s = st.sim
        K = s.qpos.shape[0]
        x = torch.cat([s.qpos, s.qvel, s.free_pose.reshape(K, -1), s.free_vel.reshape(K, -1)], -1)
        y = (self.A[st.t] @ x[..., None] + self.B[st.t] @ u[..., None])[..., 0]
        q, v, p, fv = _split(y)
        reward = -(y @ self.w + 0.5 * (self.d * y * y).sum(-1))
        return (_TState(_TSim(q, v, p.reshape(K, 1, 7), fv.reshape(K, 1, 6)), st.t + 1),
                reward, torch.zeros(K, dtype=torch.bool))


def test_cem_solve_matches_jax():
    """One CEM solve at K=8, H=3, 2 iterations, 3 elites, discount 0.9 on
    the linear system, with the JAX noise injected: the refit mean and
    sigma (the min_sigma floor binds in some entries) and the best return;
    then plan_step's first action and shift."""
    cfg = dict(horizon=3, num_samples=8, num_elites=3, iterations=2, init_sigma=0.5,
               min_sigma=0.2, gamma=0.9)
    jenv = _JLinearEnv()
    jp = JCEM(jenv, JCEMConfig(**cfg))
    ps_j = jp.init(seed=0)
    ps_j2, info_j = jp.solve(ps_j, jenv.state0)
    key, noise = ps_j.key, []
    for _ in range(cfg["iterations"]):
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k, (8, 3, NU))))
    tenv = _TLinearEnv()
    tp = CEM(tenv, CEMConfig(**cfg))
    ps_t = convert.cem_state_from_numpy(dict(mean=np.asarray(ps_j.mean),
                                             sigma=np.asarray(ps_j.sigma)))
    ps_t2, info_t = tp.solve(ps_t, tenv.state0, noise=torch.tensor(np.stack(noise)))
    best = float(info_j["best_return"])
    np.testing.assert_allclose(float(info_t["best_return"]), best, atol=1e-4 * max(1, abs(best)))
    np.testing.assert_allclose(ps_t2.mean.numpy(), np.asarray(ps_j2.mean), atol=1e-4)
    np.testing.assert_allclose(ps_t2.sigma.numpy(), np.asarray(ps_j2.sigma), atol=1e-4)
    assert (np.asarray(ps_j2.sigma) == np.float32(0.2)).any()
    assert (np.asarray(ps_j2.sigma) > 0.2).any()
    # plan_step: the first action of the mean, then the shift
    ps3, action, _ = tp.plan_step(ps_t, tenv.state0)
    assert action.shape == (NU,) and torch.equal(ps3.sigma[-1], torch.full((NU,), 0.5))


def test_ilqr_solve_matches_jax_on_linear_system():
    """Two iLQR iterations from a fixed U0: the refined controls, the
    initial and final costs and the per-iteration history match the JAX
    ILQR run on the same system."""
    cfg = dict(horizon=H, iterations=2, reg_init=0.1)
    U0 = np.random.default_rng(3).uniform(-0.5, 0.5, (H, NU)).astype(np.float32)
    jenv = _JLinearEnv()
    U_j, info_j = JILQR(jenv, JILQRConfig(**cfg)).solve(jenv.state0, jnp.asarray(U0))
    tenv = _TLinearEnv()
    U_t, info_t = ILQR(tenv, ILQRConfig(**cfg)).solve(tenv.state0, torch.tensor(U0))
    assert float(info_j["final_cost"]) < float(info_j["initial_cost"])  # it refined
    assert not np.allclose(np.asarray(U_j), U0)
    for got, ref in ((U_t, U_j), (info_t["initial_cost"], info_j["initial_cost"]),
                     (info_t["final_cost"], info_j["final_cost"]),
                     (info_t["cost_history"], info_j["cost_history"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_select_step_rules():
    """The line-search choice: non-finite costs never win, the cheapest
    candidate replaces U only if it beats the best cost so far, and the
    regularization shrinks (floor 1e-6) or grows (cap reg_max)."""
    cfg = ILQRConfig(reg_factor=10.0, reg_max=100.0)
    U = torch.zeros(2, 1)
    Us = torch.arange(3.0)[:, None, None].expand(3, 2, 1) + 1
    costs = torch.tensor([float("nan"), 2.0, 1.0])
    U2, reg, best, new = select_step(costs, Us, U, torch.tensor(1e-6), torch.tensor(5.0), cfg)
    assert torch.equal(U2, Us[2]) and float(reg) == pytest.approx(1e-6) and float(best) == 1.0
    U3, reg, best, new = select_step(costs, Us, U, torch.tensor(50.0), torch.tensor(0.5), cfg)
    assert torch.equal(U3, U) and float(reg) == 100.0 and float(best) == 0.5 and float(new) == 1.0


def test_cem_ilqr_plan_step_and_driver(tenv):
    """CEM + iLQR through ``make_planner`` at a tiny size: a finite plan
    step whose iLQR never ends above its start, the executed action is the
    refined sequence's first, and the MPC driver runs an episode."""
    cfg = CEMILQRConfig(cem=CEMConfig(horizon=1, num_samples=4, num_elites=2, iterations=1),
                        ilqr=ILQRConfig(horizon=1, iterations=1))
    planner = make_planner(tenv, "cem-ilqr", cfg)
    assert isinstance(planner, CEMILQR)
    tenv.reset(seed=0)
    ps = planner.init(seed=0)
    ps2, action, info = planner.plan_step(ps, tenv._state)
    assert torch.isfinite(action).all() and action.shape == (8,)
    assert float(info["ilqr_final_cost"]) <= float(info["ilqr_initial_cost"])
    assert torch.equal(ps2.sigma[-1], torch.full((8,), cfg.cem.init_sigma))
    out = solve_task("StackCube-v1", "cem", cfg.cem, episodes=1, max_steps=2,
                     env_kwargs=dict(device="cpu"))
    res = out["episodes"][0]
    assert res["steps"] == 2 and res["actions"].shape == (2, 8) and out["success_rate"] == 0.0
    with pytest.raises(ValueError):
        make_planner(tenv, "nope")


@pytest.mark.slow
def test_ilqr_solve_matches_jax_stackcube(jenv, tenv):
    """Slow (minutes of JAX compile): a 1-iteration StackCube iLQR solve at
    H=2 from the reset state against the JAX ILQR."""
    cfg = dict(horizon=2, iterations=1)
    U0 = np.random.default_rng(5).uniform(-0.3, 0.3, (2, 8)).astype(np.float32)
    start = jax.tree.map(lambda x: x[0], jenv._state)
    U_j, info_j = JILQR(jenv, JILQRConfig(**cfg)).solve(start, jnp.asarray(U0))
    st_t = convert.env_state_from_numpy(_np(jenv._state))
    U_t, info_t = ILQR(tenv, ILQRConfig(**cfg)).solve(st_t, torch.tensor(U0))
    np.testing.assert_allclose(float(info_t["initial_cost"]), float(info_j["initial_cost"]),
                               atol=1e-4)
    np.testing.assert_allclose(float(info_t["final_cost"]), float(info_j["final_cost"]),
                               atol=1e-3)
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), atol=1e-3)


@pytest.mark.slow
def test_ilqr_full_jacobian_matches_jax_stackcube(jenv, tenv):
    """Slow: the full (A, B, cx, cu) of one step, from the port's batched
    forward-mode linearization, against ``jax.jacfwd``/``jax.grad`` of the
    JAX dyn/cost, at the second step of a nominal rollout from the reset
    state. The reset state itself sits on kinks (cubes resting at exactly
    zero depth and zero velocity), where the derivative conventions of the
    two frameworks differ (ROADMAP Queue C); one step later it does not."""
    U0 = torch.tensor(np.random.default_rng(5).uniform(-0.3, 0.3, (2, 8)).astype(np.float32))
    il = ILQR(tenv, ILQRConfig(horizon=2))
    traj, _ = il.rollout(convert.env_state_from_numpy(_np(jenv._state)), U0)
    xs = il.reduce(traj.sim)
    A_t, B_t, cx_t, cu_t = il.linearize(traj, xs, U0)
    st1 = tree_map(lambda v: v[1:2], traj)
    template = jax.tree.map(lambda x: x[0], jenv._state)
    template = template.replace(
        sim=template.sim.replace(**{k: jnp.asarray(v[0]) for k, v in
                                    convert.to_numpy(st1.sim).items()}),
        cmd=template.cmd.replace(**{k: jnp.asarray(v[0]) for k, v in
                                    convert.to_numpy(st1.cmd).items() if v is not None}),
        elapsed_steps=jnp.asarray(int(st1.elapsed_steps[0]), jnp.int32))
    nq, F = 9, 2

    def dyn_cost(x, u):
        sim = template.sim.replace(qpos=x[:nq], qvel=x[nq:2 * nq],
                                   free_pose=x[2 * nq:2 * nq + 7 * F].reshape(F, 7),
                                   free_vel=x[2 * nq + 7 * F:].reshape(F, 6))
        st2, reward, _ = jenv._rollout_step(template.replace(sim=sim), u)
        y = jnp.concatenate([st2.sim.qpos, st2.sim.qvel, st2.sim.free_pose.reshape(-1),
                             st2.sim.free_vel.reshape(-1)])
        return y, -reward + 1e-3 * jnp.sum(u * u)

    x1, u1 = jnp.asarray(xs[1].numpy()), jnp.asarray(U0[1].numpy())
    Jx, Ju = jax.jit(jax.jacfwd(lambda x, u: dyn_cost(x, u)[0], argnums=(0, 1)))(x1, u1)
    gx, gu = jax.jit(jax.grad(lambda x, u: dyn_cost(x, u)[1], argnums=(0, 1)))(x1, u1)
    for got, ref in ((A_t[1], Jx), (B_t[1], Ju), (cx_t[1], gx), (cu_t[1], gu)):
        ref = np.asarray(ref)
        assert np.isfinite(ref).all()
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-3 * max(1.0, np.abs(ref).max()))
