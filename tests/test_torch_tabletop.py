"""The rest of the BASELINE MPC set through the PyTorch port against the JAX
package, on the CPU: PushCube-v1 and PushCubeKitchen-v1 (the kitchen
counter of the scene-builder registry), PullCube-v1, PokeCube-v1 (two free
bodies: a peg and a cube), LiftPegUpright-v1 and PegInsertionSide-v1 (a
peg sized per env through ``geom_size`` and the ``peg_half_size`` extra,
against a four-wall kinematic hole), MPPI on PushCube-v1 and
PegInsertionSide-v1, and the fused episode ``run_episode_device``.

The same inputs go through both: JAX reset states carried across with
``maniskill_tpu_torch.convert``, states in contact built by the port
(``contact_state``) and carried back, random actions from a numpy seed,
the JAX MPPI noise. The JAX side runs its XLA engine
(``sim_backend="xla"``), the plain reference of its Pallas kernel. Each
task's JAX env and its jitted env step are built once per process and
shared by the cases of that task; the cases are task-major.

Tolerances: the env step those of tests/test_megakernel.py:48-67 (qpos
2e-5, qvel 2e-4, free pose 2e-5, free vel 5e-4, impulses 5e-3); obs 2e-4,
reward and MPPI 1e-4; the port's device episode against its host loop
exactly (one program, the same draws).
"""
import ast
import functools
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.envs.base_env import TaskContext as JTaskContext
from maniskill_tpu.physics import engine as jeng
from maniskill_tpu.planners import mpc as jmpc
from maniskill_tpu.planners.mppi import MPPI as JMPPI, MPPIConfig as JMPPIConfig

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.envs.base_env import TaskContext
from maniskill_tpu_torch.physics import engine as teng
from maniskill_tpu_torch.physics import megakernel
from maniskill_tpu_torch.physics.model import tree_map
from maniskill_tpu_torch.planners import MPPI, MPPIConfig, run_episode, run_episode_device, solve_task
from torch_parity import (fast_trace_metadata, shared_jit, make_jax_env, np_tree as _np,
                         to_jax as _to_jax)

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _fast_jax_tables():
    """The JAX package's static contact tables through one jitted program
    (tests/torch_parity.py); the module's envs and compiled steps are
    dropped at its end."""
    with fast_trace_metadata():
        yield
    for fn in (_jax, _port):
        fn.cache_clear()


K = 8
TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
           contact_lam=5e-3, contact_lam_t=5e-3)
# (nq, F, G, P, obs dim, pair functions) of each id's model
TASKS = {
    "PushCube-v1": (9, 1, 8, 136, 35, ["box_box_onesided", "box_box_corners", "plane_box"]),
    "PushCubeKitchen-v1": (9, 1, 10, 232, 35,
                           ["box_box_onesided", "box_box_corners", "plane_box"]),
    "PullCube-v1": (9, 1, 8, 136, 35, ["box_box_onesided", "box_box_corners", "plane_box"]),
    "PokeCube-v1": (9, 2, 9, 260, 42,
                    ["box_box_onesided", "box_box_corners", "box_box", "plane_box"]),
    "LiftPegUpright-v1": (9, 1, 8, 136, 32, ["box_box_onesided", "box_box_corners", "plane_box"]),
    "PegInsertionSide-v1": (9, 1, 12, 328, 43,
                            ["box_box_onesided", "box_box_corners", "plane_box"]),
}


@functools.lru_cache(maxsize=None)
def _jax(task):
    """The task's JAX env (K envs, reset with seed 0, its reset outputs in
    ``reset_out``) and its env step, vmapped and jitted."""
    env = make_jax_env(task, num_envs=K, reward_mode="dense", sim_backend="xla")
    env.reset_out = env.reset(seed=0)
    return env, shared_jit(jax.vmap(env._step_one))


@functools.lru_cache(maxsize=None)
def _port(task):
    return mtt.make(task, num_envs=K, reward_mode="dense", device="cpu")


def _check_tables(task):
    """nq, F, G, P, the pair groups letter for letter (functions, point
    counts, sides, friction), the per-point side tables, the initial
    contacts, the geoms (sizes, offsets) and the model constants; the
    kernel takes the model."""
    jm, tm = _jax(task)[0].model, _port(task).model
    nq, F, G, P, _, fns = TASKS[task]
    assert (tm.nq, tm.n_free, len(tm.geoms), tm.n_points) == (nq, F, G, P)
    assert (jm.nq, jm.n_free, len(jm.geoms), jm.n_points) == (nq, F, G, P)
    assert [g[0].__name__ for g in tm.pair_groups] == [g[0].__name__ for g in jm.pair_groups]
    assert sorted({g[0].__name__ for g in tm.pair_groups}) == sorted(fns)
    for gt, gj in zip(tm.pair_groups, jm.pair_groups):
        assert gt[1] == gj[1]
        for a, b in zip(gt[2:], gj[2:]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(teng._assignment_tables(tm), jeng._assignment_tables(jm)):
        np.testing.assert_array_equal(a, b)
    mt, mj = teng._trace_metadata(tm), jeng._trace_metadata(jm)
    for i in range(3):
        np.testing.assert_allclose(mt[i].numpy(), np.asarray(mj[i]), atol=1e-5)
    for i in range(3, 7):
        np.testing.assert_array_equal(mt[i].numpy(), np.asarray(mj[i]))
    for i in (7, 8):
        assert [tuple(map(int, m)) for m in mt[i]] == [tuple(map(int, m)) for m in mj[i]]
    for name in ("ancestor_mask", "init_qpos", "static_pose", "free_mass", "free_inertia",
                 "drive_kp", "drive_kd", "robot_base_pose"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    for a, b in zip(tm.geoms, jm.geoms):
        assert (a.kind, a.body, int(a.gtype), a.name) == (b.kind, b.body, int(b.gtype), b.name)
        for f in ("size", "offset_p", "offset_q", "friction"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert megakernel.supports(tm)


def _check_reset(task):
    """Evaluate, the state obs and the dense reward of the port at the JAX
    reset state."""
    jenv, _ = _jax(task)
    tenv = _port(task)
    obs_j, info_j = jenv.reset_out
    st = convert.env_state_from_numpy(_np(jenv._state))
    ctx = TaskContext(tenv, st)
    info = tenv.evaluate(st, ctx)
    obs = tenv._get_obs(st, ctx, info)
    assert obs.shape == np.shape(obs_j) == (K, TASKS[task][4])
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=2e-4)
    assert sorted(info) == sorted(info_j)
    for key in info_j:
        np.testing.assert_allclose(info[key].numpy(), np.asarray(info_j[key]), atol=1e-5,
                                   err_msg=key)
    action = np.zeros((K, 8), np.float32)

    def reward_one(s):
        ctx_j = JTaskContext(jenv, s)
        return jenv.compute_dense_reward(s, jnp.zeros(8), jenv.evaluate(s, ctx_j), ctx_j)

    rew_j = jax.jit(jax.vmap(reward_one))(jenv._state)
    rew = tenv.compute_dense_reward(st, torch.as_tensor(action), info, ctx)
    np.testing.assert_allclose(rew.numpy(), np.asarray(rew_j), atol=1e-4)


def _check_step(task, states):
    """One env step from the JAX reset state with random actions, or from
    the port's ``contact_state`` states carried to the JAX env, with the
    action that keeps their command (the arm holds, the gripper shuts):
    the physics state, obs, dense reward, every info entry and the extras.
    In contact, the contact state's own pair functions carry force in the
    JAX step (PokeCube's peg-cube box_box; PegInsertionSide's peg against
    the hole's walls)."""
    jenv, jstep = _jax(task)
    tenv = _port(task)
    if states == "reset":
        st_t, st_j = convert.env_state_from_numpy(_np(jenv._state)), jenv._state
        action = np.random.default_rng(1).uniform(-0.3, 0.3, (K, 8)).astype(np.float32)
    else:
        st_t = tenv.contact_state(convert.env_state_from_numpy(_np(jenv._state)),
                                  torch.Generator().manual_seed(0))
        st_j = _to_jax(jenv._state, st_t)
        action = np.tile(np.float32([0.0] * 7 + [-0.6]), (K, 1))
    st_j2, obs_j, rew_j, _, info_j = jstep(st_j, jnp.asarray(action))
    st_t2, obs_t, rew_t, _, info_t = tenv._step(st_t, torch.as_tensor(action))
    got = convert.to_numpy(st_t2.sim)
    for name, tol in TOL.items():
        np.testing.assert_allclose(got[name], np.asarray(getattr(st_j2.sim, name)), atol=tol,
                                   err_msg=f"{states} {name}")
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=2e-4)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-4)
    for key in info_j:
        np.testing.assert_allclose(info_t[key].numpy(), np.asarray(info_j[key]), atol=1e-5,
                                   err_msg=key)
    assert sorted(st_t2.extras) == sorted(st_j2.extras)
    for key in st_j2.extras:
        np.testing.assert_array_equal(st_t2.extras[key].numpy(), np.asarray(st_j2.extras[key]))
    if states == "contact":
        plan = megakernel._Plan(tenv.model)
        pfn = np.asarray(megakernel._FNS)[plan.pfn]
        lam = np.asarray(st_j2.sim.contact_lam) > 0
        if task == "PokeCube-v1":
            assert lam[:, pfn == "box_box"].any(1).mean() >= 0.5
        if task == "PegInsertionSide-v1":
            walls = tenv.model.geom_indices("box_with_hole")
            wall = np.isin(plan.pga, walls) | np.isin(plan.pgb, walls)
            assert lam[:, wall].any(1).all()
        robot = (plan.pra >= 0) | (plan.prb >= 0)
        assert lam[:, (pfn == "box_box_corners") & robot].any(1).mean() >= 0.5


def _check_mppi(task):
    """One MPPI solve at K=8, H=3 at the task's sigma and temperature
    (PegInsertionSide: a sigma per action dimension) with the JAX noise
    injected: the nominal and the rollout returns match."""
    jenv, _ = _jax(task)
    tenv = _port(task)
    Ks, H = 8, 3
    cfg = dict(type(tenv).MPPI_CONFIG, horizon=H, num_samples=Ks)
    jcfg = dict(cfg, sigma=np.asarray(cfg["sigma"], np.float32))
    jp = JMPPI(jenv, JMPPIConfig(**jcfg))
    ps_j = jp.init(seed=0)
    ps_j2, info_j = jp.solve(ps_j, jax.tree.map(lambda x: x[0], jenv._state))
    white = np.asarray(jax.random.normal(jax.random.split(ps_j.key)[1], (Ks, H, 8)))
    tp = MPPI(tenv, MPPIConfig(**cfg))
    st_t = convert.env_state_from_numpy(_np(jax.tree.map(lambda x: x[:1], jenv._state)))
    ps_t, info_t = tp.solve(tp.init(seed=0), st_t, noise=torch.tensor(white))
    for key in ("best_return", "mean_return"):
        np.testing.assert_allclose(float(info_t[key]), float(info_j[key]), atol=1e-4)
    np.testing.assert_allclose(ps_t.nominal.numpy(), np.asarray(ps_j2.nominal), atol=1e-4)


TASK_CHECKS = [(task, check) for task in TASKS
               for check in ("tables", "reset", "step_reset", "step_contact")
               + (("mppi",) if task in ("PushCube-v1", "PegInsertionSide-v1") else ())]


@pytest.mark.parametrize("task, check", TASK_CHECKS,
                         ids=[f"{t}-{c}" for t, c in TASK_CHECKS])
def test_task_matches_jax(task, check):
    """One check of a task against the JAX package, on the process's one
    JAX env and one compiled JAX env step of that task (``_jax``)."""
    if check == "tables":
        _check_tables(task)
    elif check == "reset":
        _check_reset(task)
    elif check == "mppi":
        _check_mppi(task)
    else:
        _check_step(task, check.split("_")[1])


def _yaw(q):
    return 2 * torch.atan2(q[..., 3], q[..., 0])


@pytest.mark.parametrize("task", list(TASKS))
def test_reset_draws_follow_the_jax_ranges(task):
    """The port's own reset draws (its generator, not JAX's) within the JAX
    task's ranges, and the goal at its exact offset from the cube."""
    env = mtt.make(task, num_envs=256, device="cpu")
    env.reset(seed=3)
    sim = env._state.sim
    fp, kp = sim.free_pose, sim.kin_pose

    def within(x, lo, hi):
        assert float(x.min()) >= lo and float(x.max()) <= hi, (float(x.min()), float(x.max()))
        assert float(x.max()) - float(x.min()) > 0.8 * (hi - lo)  # the range is drawn from

    ident = torch.tensor([1.0, 0, 0, 0])
    if task in ("PushCube-v1", "PushCubeKitchen-v1", "PullCube-v1"):
        cube, goal = fp[:, 0], kp[:, 0]
        within(cube[:, 0], -0.1, 0.1)
        within(cube[:, 1], -0.1, 0.1)
        np.testing.assert_allclose(cube[:, 2].numpy(), 0.02)
        sign = -1.0 if task == "PullCube-v1" else 1.0
        torch.testing.assert_close(goal[:, :2], cube[:, :2] + torch.tensor([sign * 0.2, 0.0]))
        np.testing.assert_allclose(goal[:, 2].numpy(), 1e-3)
        torch.testing.assert_close(cube[:, 3:], ident.expand(256, 4))
    elif task == "PokeCube-v1":
        cube, peg, goal = fp[:, env.cube], fp[:, env.peg], kp[:, 0]
        within(peg[:, 0], -0.1, 0.1)
        within(peg[:, 1], -0.1, 0.1)
        np.testing.assert_allclose(peg[:, 2].numpy(), 0.025)
        torch.testing.assert_close(cube[:, 0], peg[:, 0] + 0.22)
        within(cube[:, 1], -0.1, 0.1)
        torch.testing.assert_close(goal[:, :2], cube[:, :2] + torch.tensor([0.1, 0.0]))
    elif task == "LiftPegUpright-v1":
        peg = fp[:, 0]
        within(peg[:, 0], -0.1, 0.1)
        within(peg[:, 1], -0.1, 0.1)
        np.testing.assert_allclose(peg[:, 2].numpy(), 0.025)
        c = math.cos(math.pi / 4)
        torch.testing.assert_close(peg[:, 3:], torch.tensor([c, c, 0, 0]).expand(256, 4))
    else:
        size = env._state.extras["peg_half_size"]
        torch.testing.assert_close(sim.geom_size[:, env.model.geom_indices("peg")[0]], size)
        within(size[:, 0], 0.085, 0.125)
        within(size[:, 1], 0.015, 0.025)
        torch.testing.assert_close(size[:, 2], size[:, 1])
        peg, box = fp[:, 0], kp[:, env.box]
        within(peg[:, 0], -0.1, 0.1)
        within(peg[:, 1], -0.3, 0.0)
        torch.testing.assert_close(peg[:, 2], size[:, 1])
        within(_yaw(peg[:, 3:]) - math.pi / 2, -math.pi / 3, math.pi / 3)
        within(box[:, 0], -0.05, 0.05)
        within(box[:, 1], 0.2, 0.4)
        np.testing.assert_allclose(box[:, 2].numpy(), 0.105)
        within(_yaw(box[:, 3:]) - math.pi / 2, -math.pi / 8, math.pi / 8)


# ---- the fused episode ----------------------------------------------------------

EP_CFG = MPPIConfig(horizon=3, num_samples=8, sigma=0.6, temperature=0.3)


@functools.lru_cache(maxsize=None)
def _push1():
    return mtt.make("PushCube-v1", num_envs=1, device="cpu", obs_mode="none",
                    reward_mode="dense")


def test_device_episode_matches_the_host_loop():
    """``run_episode_device`` on the CPU (the same step as on a card, run
    eagerly) against ``run_episode(stop_on_success=False)``: PushCube-v1,
    K=8, H=3, 4 steps, the same seed: equal actions and rewards."""
    env = _push1()
    planner = MPPI(env, EP_CFG)
    host = run_episode(env, planner, seed=0, max_steps=4, stop_on_success=False)
    dev = run_episode_device(env, planner, seed=0, max_steps=4)
    assert not host["success"] and dev["steps"] == 4
    np.testing.assert_array_equal(dev["actions"], host["actions"])
    np.testing.assert_array_equal(dev["rewards"], np.float32(host["rewards"]))
    assert dev["episode_return"] == pytest.approx(host["episode_return"], abs=1e-5)
    assert dev["replan_hz"] > 0


def test_device_episode_freezes_after_success(monkeypatch):
    """An episode whose reset state already succeeds (the cube set on its
    goal): ``steps`` is 1, and the state after 3 steps is the one after 1
    (the freeze); the return is the first step's reward alone."""
    env = _push1()
    init = type(env)._initialize_episode

    def solved(state, gen):
        state = init(env, state, gen)
        fp = state.sim.free_pose.clone()
        fp[:, env.cube, :2] = state.sim.kin_pose[:, env.goal_region, :2]
        return state.replace(sim=state.sim.replace(free_pose=fp))

    monkeypatch.setattr(env, "_initialize_episode", solved)
    planner = MPPI(env, EP_CFG)
    one = run_episode_device(env, planner, seed=0, max_steps=1)
    after_one = convert.to_numpy(env._state)
    three = run_episode_device(env, planner, seed=0, max_steps=3)
    assert one["success"] and three["success"] and three["steps"] == one["steps"] == 1
    np.testing.assert_array_equal(three["actions"], one["actions"])
    assert three["episode_return"] == one["episode_return"] == 3.0
    after_three = convert.to_numpy(env._state)
    for part in ("sim", "cmd"):
        for name, value in after_one[part].items():
            if value is not None:
                np.testing.assert_array_equal(after_three[part][name], value, err_msg=name)
    np.testing.assert_array_equal(after_three["elapsed_steps"], after_one["elapsed_steps"])


def _return_keys(fn):
    """The keys of the ``return dict(...)`` of a function's source."""
    tree = ast.parse(inspect.getsource(fn).lstrip())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Return) and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", None) == "dict"):
            return sorted(k.arg for k in node.value.keywords)
    raise AssertionError("no return dict(...)")


def test_device_episode_keys_match_jax():
    """The result of ``run_episode_device`` has the keys the JAX package's
    ``run_episode_device`` returns."""
    out = run_episode_device(_push1(), MPPI(_push1(), EP_CFG), seed=1, max_steps=1)
    assert sorted(out) == _return_keys(jmpc.run_episode_device)
    assert out["actions"].shape == (out["steps"], 8) and out["rewards"].shape == (out["steps"],)


def test_solve_task_runs_the_device_loop():
    """``solve_task(..., device_loop=True)`` on the CPU, a tiny config: one
    episode of 2 steps through ``run_episode_device``."""
    out = solve_task("PushCube-v1", config=EP_CFG, episodes=1, max_steps=2,
                     env_kwargs=dict(device="cpu"), device_loop=True)
    ep = out["episodes"][0]
    assert out["env_id"] == "PushCube-v1" and ep["steps"] == 2 and out["replan_hz"] > 0
    assert np.isfinite(ep["actions"]).all() and ep["actions"].shape == (2, 8)


def test_tree_map_pairs_nests_by_key():
    """``tree_map`` over several nests (the device episode's freeze and
    write-back) matches dict entries by key, not by position, and raises
    on nests that differ in their keys or where a field is None."""
    a = dict(x=torch.zeros(2), y=torch.ones(2))
    b = dict(y=torch.full((2,), 3.0), x=torch.full((2,), 5.0))
    out = tree_map(lambda p, q: p + q, a, b)
    np.testing.assert_array_equal(out["x"].numpy(), [5.0, 5.0])
    np.testing.assert_array_equal(out["y"].numpy(), [4.0, 4.0])
    st = _push1()._state
    tree_map(lambda d, s: d.copy_(s), tree_map(torch.clone, st), st)
    with pytest.raises(ValueError):
        tree_map(lambda p, q: p, a, dict(x=torch.zeros(2)))
    with pytest.raises(ValueError):
        tree_map(lambda p, q: p, dict(x=None), dict(x=torch.zeros(2)))
