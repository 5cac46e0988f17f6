"""The scripted solutions and the tasks this slice adds, through the PyTorch
port against the JAX package, on the CPU: PullCubeTool-v1 (the tables, the
reset obs and evaluate, one step under ``pd_ee_delta_pos``: state, obs,
dense reward, info), Empty-v1 (reset and one step under
``pd_ee_delta_pose``), the solutions' state readers on the same state, and
the first 10 control actions of ``solve_pick_cube`` and
``solve_pull_cube_tool`` run by both packages from the same start (B=2).

The JAX envs are ``torch_parity.jax_env``'s (one per task and mode in a
process, on the XLA engine, reset with seed 0); their reset states are
carried across with ``maniskill_tpu_torch.convert``. The solutions'
actions are taken through a recorder that stops each after 10 steps.
Whole solutions run on the port under the ``slow`` marker, as the JAX
package's own solution tests do.

Tolerances: the env step those of tests/test_megakernel.py:48-67 (qpos
2e-5, qvel 2e-4, free pose 2e-5, free vel 5e-4, impulses 5e-3), obs 2e-4,
reward 1e-4, the state readers 1e-5, the solutions' actions 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.envs.base_env import TaskContext as JTaskContext
from maniskill_tpu.examples.motionplanning import solutions as jsol

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.envs.base_env import TaskContext
from maniskill_tpu_torch.examples.motionplanning import solutions as tsol
from maniskill_tpu_torch.physics import megakernel
from torch_parity import fast_trace_metadata, jax_env, np_tree as _np

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)

B = 2
TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
           contact_lam=5e-3, contact_lam_t=5e-3)
# (task, control mode): (nq, F, G, P, obs dim)
TASKS = {("PullCubeTool-v1", "pd_ee_delta_pos"): (9, 2, 10, 412, 39),
         ("Empty-v1", "pd_ee_delta_pose"): (9, 0, 7, 40, 25)}


@pytest.fixture(scope="module", autouse=True)
def _fast_jax_tables():
    """The JAX package's static contact tables through one jitted program
    (tests/torch_parity.py)."""
    with fast_trace_metadata():
        yield


def _port(task, mode):
    return mtt.make(task, num_envs=B, reward_mode="dense", device="cpu", control_mode=mode)


@pytest.mark.parametrize("task,mode", list(TASKS))
@pytest.mark.parametrize("check", ["reset", "step"])
def test_task_matches_jax(task, mode, check):
    """``reset``: the model's sizes, the kernel's gate, and the port's obs
    and evaluate at the JAX reset state. ``step``: one env step with
    random actions from the JAX reset: the physics state, the drive
    targets, obs, dense reward and info."""
    jenv = jax_env(task, mode, B)
    tenv = _port(task, mode)
    st_t = convert.env_state_from_numpy(_np(jenv.reset_state))
    nq, F, G, P, obs_dim = TASKS[task, mode]
    if check == "reset":
        for m in (tenv.model, jenv.model):
            assert (m.nq, m.n_free, len(m.geoms), m.n_points) == (nq, F, G, P)
        assert megakernel.supports(tenv.model)
        obs_j, info_j = jenv.reset_out
        ctx = TaskContext(tenv, st_t)
        info = tenv.evaluate(st_t, ctx)
        obs = tenv._get_obs(st_t, ctx, info)
        assert obs.shape == np.shape(obs_j) == (B, obs_dim)
        np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=2e-4)
        assert sorted(info) == sorted(info_j)
        for key in info_j:
            np.testing.assert_allclose(info[key].numpy(), np.asarray(info_j[key]), atol=1e-5)
        return
    action = np.random.default_rng(5).uniform(-1.2, 1.2, (B, tenv.action_dim)).astype(
        np.float32)
    st_j2, obs_j, rew_j, _, info_j = jenv._jit_step(jenv.reset_state, jnp.asarray(action))
    st_t2, obs_t, rew_t, _, info_t = tenv._step(st_t, torch.as_tensor(action))
    got = convert.to_numpy(st_t2.sim)
    for name, tol in TOL.items():
        np.testing.assert_allclose(got[name], np.asarray(getattr(st_j2.sim, name)), atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(st_t2.cmd.target_qpos.numpy(), np.asarray(st_j2.cmd.target_qpos),
                               atol=1e-5)
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=2e-4)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-4)
    for key in info_j:
        np.testing.assert_allclose(info_t[key].numpy(), np.asarray(info_j[key]), atol=1e-5)


def test_state_readers_match_jax():
    """The solutions' readers (TCP pose, a free body's pose and velocity,
    the TCP with an actor, a kinematic body's position) on one stepped
    PullCubeTool-v1 state, and the one host copy a state they share."""
    jenv = jax_env("PullCubeTool-v1", "pd_ee_delta_pos", B)
    tenv = _port("PullCubeTool-v1", "pd_ee_delta_pos")
    action = np.tile(np.float32([0.5, -0.3, -0.4, 1.0]), (B, 1))
    jenv._state = jenv._jit_step(jenv.reset_state, jnp.asarray(action))[0]
    tenv._state = convert.env_state_from_numpy(_np(jenv._state))
    pairs = [(tsol._tcp_pose(tenv), jsol._tcp_pose(jenv))]
    for actor in ("cube", "l_shape_tool"):
        pairs += [(tsol._actor_pose(tenv, actor), jsol._actor_pose(jenv, actor)),
                  (tsol._tcp_and_actor(tenv, actor), jsol._tcp_and_actor(jenv, actor)),
                  ((tsol._actor_vel(tenv, actor),), (jsol._actor_vel(jenv, actor),))]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
    kin = tenv.model.kin_index
    for name in kin:
        np.testing.assert_allclose(tsol._kin_position(tenv, name),
                                   np.asarray(jenv._state.sim.kin_pose[:, kin[name], :3]))
    host = tenv._solution_host
    assert host[0] is tenv._state and tsol._host(tenv) is host[1]


class _Stop(Exception):
    pass


class _Recorder:
    """Steps the env and keeps the actions; stops the solution after ``n``."""

    def __init__(self, env, n):
        self.env, self.n, self.actions = env, n, []

    def step(self, action):
        if len(self.actions) == self.n:
            raise _Stop
        self.actions.append(np.array(action))
        return self.env.step(action)


def _jitted_tcp_readers(monkeypatch, env):
    """The JAX solutions' TCP readers (``_tcp_pose``, ``_tcp_and_actor``)
    with their FK as one jitted program: the same function as the module's
    own, which vmaps it eagerly (about 0.6 s a read on the CPU)."""
    def one(st):
        pose = JTaskContext(env, st).tcp_pose
        return pose.p, pose.q

    tcp = jax.jit(jax.vmap(one))

    def tcp_pose(e):
        p, q = tcp(e._state)
        return np.asarray(p), np.asarray(q)

    def tcp_and_actor(e, actor):
        pos = np.asarray(e._state.sim.free_pose[:, e.model.free_index[actor], :3])
        return tcp_pose(e)[0], pos

    monkeypatch.setattr(jsol, "_tcp_pose", tcp_pose)
    monkeypatch.setattr(jsol, "_tcp_and_actor", tcp_and_actor)


@pytest.mark.parametrize("task", ["PickCube-v1", "PullCubeTool-v1"])
def test_solution_first_actions_match_jax(task, monkeypatch):
    """The first 10 control actions of the task's solution, each package
    stepping its own env from the JAX reset state: the servo reads the
    state each step, so the actions agree only as far as both envs' states
    do. (The JAX readers themselves are held against the port's in
    ``test_state_readers_match_jax``.)"""
    jenv = jax_env(task, "pd_ee_delta_pos", B)
    _jitted_tcp_readers(monkeypatch, jenv)
    tenv = _port(task, "pd_ee_delta_pos")
    tenv._state = convert.env_state_from_numpy(_np(jenv.reset_state))
    jenv._state = jenv.reset_state
    recs = []
    for sol, env in ((jsol.SOLUTIONS[task], jenv), (tsol.SOLUTIONS[task], tenv)):
        rec = _Recorder(env, 10)
        with pytest.raises(_Stop):
            sol(env, recorder=rec)
        recs.append(np.stack(rec.actions))
    assert recs[0].shape == (10, B, 4)
    np.testing.assert_allclose(recs[1], recs[0], atol=1e-4)
    assert np.abs(recs[0][:, :, :3]).max() > 0.1  # the servo moved the TCP


def test_run_refuses_traj_dir():
    from maniskill_tpu_torch.examples.motionplanning import run

    with pytest.raises(NotImplementedError, match="trajectory"):
        run.main(["-e", "PickCube-v1", "--traj-dir", "demos", "--device", "cpu"])


@pytest.mark.slow
@pytest.mark.parametrize("task", ["PickCube-v1", "PushCube-v1", "FoldSuitcase-v1"])
def test_solution_succeeds(task):
    """The whole solution on the port, B=2, from the port's own reset: the
    tasks whose solutions succeed in every env (the JAX package's own slow
    tests hold PickCube and PushCube so; PullCubeTool's succeeds in about
    60 % of the envs, against a bar of 0.6 in the JAX package's
    tests/test_solutions.py)."""
    env = mtt.make(task, num_envs=B, device="cpu", robot_init_qpos_noise=0.0,
                   control_mode=tsol.CONTROL_MODES.get(task, "pd_ee_delta_pos"))
    env.reset(seed=0)
    assert tsol.SOLUTIONS[task](env).all()
