"""The control suite through the PyTorch port against the JAX package, on
the CPU: the MJCF loader (hopper, ant, humanoid), the passive and torque
controllers, the contact-free plain step (Cartpole: no geoms, P=0), the
nine ids (MS-CartpoleBalance-v1, MS-CartpoleSwingUp-v1, MS-HopperStand-v1,
MS-HopperHop-v1, MS-AntWalk-v1, MS-AntRun-v1, MS-HumanoidStand-v1,
MS-HumanoidWalk-v1, MS-HumanoidRun-v1) and one MPPI solve on
MS-HumanoidStand-v1 (nq 27).

The same inputs go through both: JAX reset states carried across with
``maniskill_tpu_torch.convert``, states on the floor made by the port
(its plain step settles the JAX reset state) and carried back, random
actions from a numpy seed, the JAX MPPI noise. The JAX side runs its XLA
engine (``sim_backend="xla"``), the plain reference of its Pallas kernel.
The ids of one robot share one model and one physics step, so the JAX
side compiles its controller and physics step (``_jax_advance``) once a
robot, and each id's evaluate, obs and dense reward on the advanced state
(``_jax_post``); on the port's side each id runs its env step.

Tolerances: those of tests/test_megakernel.py:48-67 for the env step
(qpos 2e-5, qvel 2e-4, impulses 5e-3), obs 2e-4 (it holds qvel), reward
1e-5, MPPI 1e-4; the MJCF specs, collision geoms, actuators, gains and
command targets exactly, the torques to float32 rounding. Stiff floor
contacts (gears up to 150 on light links, 8 substeps a control step) can
take the JAX float32 step itself beyond the tolerances of a float64 step
in an env: an env where the port and JAX differ beyond a tolerance is
refereed by the port's plain step run in float64 (``torch_parity.refereed``): in such
an env neither float32 step may be more than three times further from the
float64 step than the other, field by field, but one env of a step may
reach ten.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.envs.base_env import TaskContext as JTaskContext
from maniskill_tpu.kinematics.mjcf import load_mjcf as jload_mjcf
from maniskill_tpu.physics import engine as jeng
from maniskill_tpu.planners.mppi import MPPI as JMPPI, MPPIConfig as JMPPIConfig
from maniskill_tpu.utils.assets import ASSET_DIR

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.envs.base_env import TaskContext
from maniskill_tpu_torch.kinematics.mjcf import load_mjcf
from maniskill_tpu_torch.physics import engine as teng
from maniskill_tpu_torch.physics import megakernel
from maniskill_tpu_torch.planners.mppi import MPPI, MPPIConfig
from torch_parity import (fast_trace_metadata, shared_jit, make_jax_env, plain64, refereed,
                         np_tree as _np, to_jax as _to_jax)

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
    for fn in (_jax_env, _jax_advance, _jax_post, _port):
        fn.cache_clear()


K = 8
TOL = dict(qpos=2e-5, qvel=2e-4, contact_lam=5e-3, contact_lam_t=5e-3)
# (robot, nq, G, P, pair functions) of each id's model; the first id of a
# robot compiles the JAX physics step its robot's ids share
TASKS = {
    "MS-CartpoleBalance-v1": ("cart_pole", 2, 0, 0, []),
    "MS-CartpoleSwingUp-v1": ("cart_pole", 2, 0, 0, []),
    "MS-HopperStand-v1": ("hopper", 7, 8, 14, ["plane_capsule"]),
    "MS-HopperHop-v1": ("hopper", 7, 8, 14, ["plane_capsule"]),
    "MS-AntWalk-v1": ("ant", 14, 14, 25, ["plane_capsule", "plane_sphere"]),
    "MS-AntRun-v1": ("ant", 14, 14, 25, ["plane_capsule", "plane_sphere"]),
    "MS-HumanoidStand-v1": ("humanoid", 27, 20, 35, ["plane_capsule", "plane_sphere"]),
    "MS-HumanoidWalk-v1": ("humanoid", 27, 20, 35, ["plane_capsule", "plane_sphere"]),
    "MS-HumanoidRun-v1": ("humanoid", 27, 20, 35, ["plane_capsule", "plane_sphere"]),
}
# control steps from the JAX reset state, with zero torque, to a state on
# the floor at first touch (points loaded in most envs; the robots then
# bounce, and a robot lying on the floor is stiffer still)
SETTLE = {"hopper": 10, "ant": 5, "humanoid": 10}
# how many times further from the float64 step one float32 step (the port's
# or JAX's) may be than the other in a refereed env (``refereed``); one env
# of a step may reach the cap
REFEREE_FACTOR, REFEREE_CAP = 3.0, 10.0
MJCF = {"hopper": "control/hopper.xml", "ant": "control/ant.xml",
        "humanoid": "robots/humanoid/humanoid.xml"}


@functools.lru_cache(maxsize=None)
def _jax_env(task):
    """The task's JAX env reset with seed 0."""
    env = make_jax_env(task, num_envs=K, reward_mode="dense", sim_backend="xla")
    env.reset(seed=0)
    return env


@functools.lru_cache(maxsize=None)
def _jax_advance(robot):
    """The JAX controller and physics step of one control step (the first
    half of ``BaseEnv._step_one``), vmapped and jitted once a robot."""
    env = _jax_env(next(t for t, v in TASKS.items() if v[0] == robot))

    def advance(state, action):
        cmd = env.agent.controller.set_action(state.cmd, state.sim.qpos, action)
        sim = env._physics_step(state.sim, cmd, env.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd, elapsed_steps=state.elapsed_steps + 1)

    return shared_jit(jax.vmap(advance))


@functools.lru_cache(maxsize=None)
def _jax_post(task):
    """The rest of the task's JAX ``_step_one`` on an advanced state:
    ``(obs, reward, info)``."""
    env = _jax_env(task)

    def post(state, action):
        ctx = JTaskContext(env, state)
        state = env._update_extras(state, ctx)
        info = env.evaluate(state, ctx)
        return env._get_obs(state, ctx, info), env._get_reward(state, action, info, ctx), info

    return shared_jit(jax.vmap(post))


@functools.lru_cache(maxsize=None)
def _port(task):
    return mtt.make(task, num_envs=K, reward_mode="dense", device="cpu")


# ---- the MJCF loader and the controllers -----------------------------------


def _same(a, b, name):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), name
        for k in a:
            _same(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{name}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    else:
        assert a == b, name


@pytest.mark.parametrize("robot", list(MJCF))
def test_mjcf_matches_jax(robot):
    """``load_mjcf`` on the robot's XML: every ``RobotSpec`` field (frames,
    link indices, armature), the collision geoms, the world geoms and the
    ``<motor>`` actuators, equal to the JAX loader's; the ``<freejoint>``
    of the ant and the humanoid expands to 3 slides and 3 hinges."""
    path = str(ASSET_DIR / MJCF[robot])
    mt, mj = load_mjcf(path), jload_mjcf(path)
    for f in dataclasses.fields(mj.spec):
        _same(getattr(mt.spec, f.name), getattr(mj.spec, f.name), f.name)
    for name in ("collision_geoms", "world_geoms", "actuators", "free_root_dofs"):
        _same(getattr(mt, name), getattr(mj, name), name)
    nq = {"hopper": 7, "ant": 14, "humanoid": 27}[robot]
    assert mt.spec.nb == nq and len(mt.actuators) == {"hopper": 4, "ant": 8, "humanoid": 21}[robot]
    if robot != "hopper":
        assert mt.spec.joint_type[:6].tolist() == [1, 1, 1, 0, 0, 0]


@pytest.mark.parametrize("task", ["MS-CartpoleBalance-v1", "MS-HumanoidStand-v1"])
def test_controllers_match_jax(task):
    """Cartpole's PD slider and passive hinge, and the humanoid's 21 torque
    actuators: action bounds, drive gains, and the command of random
    actions (beyond the ctrlrange too) from random states, equal to the JAX
    controller's: the targets, and the torques ``gear * clip(a,
    ctrlrange)`` on the actuated dofs, zero on the root's six."""
    jc, tc = _jax_env(task).agent.controller, _port(task).agent.controller
    assert tc.action_dim == jc.action_dim == {"MS-CartpoleBalance-v1": 1}.get(task, 21)
    for name in ("action_low", "action_high", "kp", "kd", "force_limit"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name), err_msg=name)
    rng = np.random.default_rng(3)
    nq = _port(task).model.nq
    qpos = rng.normal(0, 0.3, (K, nq)).astype(np.float32)
    action = rng.uniform(-1.5, 1.5, (K, tc.action_dim)).astype(np.float32)
    jcmd = jax.vmap(lambda q, a: jc.set_action(jc.reset(q), q, a))(jnp.asarray(qpos),
                                                                   jnp.asarray(action))
    q_t = torch.as_tensor(qpos)
    tcmd = tc.set_action(tc.reset(q_t), q_t, torch.as_tensor(action))
    for name in ("target_qpos", "target_qvel", "kp", "kd", "force_limit"):
        np.testing.assert_array_equal(getattr(tcmd, name).numpy(),
                                      np.asarray(getattr(jcmd, name)), err_msg=name)
    np.testing.assert_allclose(tcmd.qf.numpy(), np.asarray(jcmd.qf), rtol=1e-6, atol=0)
    if task == "MS-CartpoleBalance-v1":
        assert not tcmd.qf.any() and tcmd.kp[0].tolist() == [2000.0, 0.0]
    else:
        assert not tcmd.qf[:, :6].any() and tcmd.qf[:, 6:].abs().min() > 0
        assert (tcmd.qf.abs().amax(0) <= 120).all() and not tcmd.kp.any()


def test_cartpole_plain_step_matches_jax():
    """The contact-free plain step (no geoms, no points: the JAX
    ``point_forces`` returns empty terms) on random Cartpole states and
    commands, five sim steps: qpos and qvel as the JAX engine's, the
    warm-start fields (K, 0); the kernel wrapper takes it on CPU tensors
    and ``supports`` the model."""
    tm, jm = _port("MS-CartpoleBalance-v1").model, _jax_env("MS-CartpoleBalance-v1").model
    assert (tm.n_points, len(tm.geoms), jm.n_points) == (0, 0, 0)
    rng = np.random.default_rng(5)
    sim = _np(_jax_env("MS-CartpoleBalance-v1")._state.sim)
    sim["qpos"] = rng.uniform(-1.0, 1.0, (K, 2)).astype(np.float32)
    sim["qvel"] = rng.normal(0, 1.0, (K, 2)).astype(np.float32)
    cmd = _np(_jax_env("MS-CartpoleBalance-v1")._state.cmd)
    cmd["target_qpos"] = rng.uniform(-1.0, 1.0, (K, 2)).astype(np.float32)
    cmd["qf"] = rng.normal(0, 2.0, (K, 2)).astype(np.float32)
    st_t, cmd_t = convert.sim_state_from_numpy(sim), convert.drive_cmd_from_numpy(cmd)
    got = teng.make_step_fn(tm)(st_t, cmd_t, 5)
    jstep = jeng.make_step_fn(jm)
    jsim = _to_jax(_jax_env("MS-CartpoleBalance-v1")._state.sim, st_t)
    jcmd = _to_jax(_jax_env("MS-CartpoleBalance-v1")._state.cmd, cmd_t)
    ref = jax.jit(jax.vmap(lambda s, c: jstep(s, c, 5)))(jsim, jcmd)
    np.testing.assert_allclose(got.qpos.numpy(), np.asarray(ref.qpos), atol=2e-5)
    np.testing.assert_allclose(got.qvel.numpy(), np.asarray(ref.qvel), atol=2e-4)
    assert got.contact_lam.shape == (K, 0) and got.contact_lam_t.shape == (K, 0, 3)
    assert np.abs(got.qpos.numpy() - sim["qpos"]).max() > 1e-3
    kern = megakernel.MegaKernel(tm)
    np.testing.assert_array_equal(kern(st_t, cmd_t, 5)[0].qpos, got.qpos)
    assert kern.launches == 0


# ---- the nine ids ----------------------------------------------------------


def _check_tables(task):
    """nq, F=0, G, P and the pair functions; the pair groups, geom table,
    gravity flags (the robot's links fall), drive gains and the static
    contact tables equal to the JAX model's; ``supports``."""
    jm, tm = _jax_env(task).model, _port(task).model
    _, nq, G, P, fns = TASKS[task]
    for m in (tm, jm):
        assert (m.nq, m.n_free, len(m.geoms), m.n_points) == (nq, 0, G, P)
        assert [g[0].__name__ for g in m.pair_groups] == fns
    for gt, gj in zip(tm.pair_groups, jm.pair_groups):
        assert gt[1] == gj[1]
        for a, b in zip(gt[2:], gj[2:]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tm.geoms, jm.geoms):
        assert (a.kind, a.body, int(a.gtype), a.name, a.friction) == (
            b.kind, b.body, int(b.gtype), b.name, b.friction)
        for f in ("size", "offset_p", "offset_q"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for name in ("gravity_mask", "ancestor_mask", "init_qpos", "drive_kp", "drive_kd",
                 "drive_force_limit", "robot_qlim", "robot_inertia_com"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    assert tm.gravity_mask.all() and tm.params == tm.params.__class__(
        **{f.name: getattr(jm.params, f.name) for f in dataclasses.fields(tm.params)})
    for a, b in zip(teng._assignment_tables(tm), jeng._assignment_tables(jm)):
        np.testing.assert_array_equal(a, b)
    assert megakernel.supports(tm)
    env = _port(task)
    assert isinstance(env.kernel, megakernel.MegaKernel)
    assert env.sim_steps_per_control * tm.params.substeps == (8 if G else 5)


def _check_reset(task):
    """At the JAX reset state carried across: evaluate, the state obs and
    the dense reward (zero action) of the port equal JAX's."""
    jenv, tenv = _jax_env(task), _port(task)
    st = convert.env_state_from_numpy(_np(jenv._state))
    ctx = TaskContext(tenv, st)
    info = tenv.evaluate(st, ctx)
    obs = tenv._get_obs(st, ctx, info)
    obs_j, rew_j, info_j = _jax_post(task)(jenv._state, jnp.zeros((K, tenv.action_dim)))
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=2e-4)
    rew = tenv.compute_dense_reward(st, torch.zeros(K, tenv.action_dim), info, ctx)
    np.testing.assert_allclose(rew.numpy(), np.asarray(rew_j), atol=1e-5)
    assert info.keys() == info_j.keys()
    for key in info_j:
        np.testing.assert_array_equal(info[key].numpy(), np.asarray(info_j[key]), err_msg=key)


def _compare_step(task, st_j, action, label):
    """One env step of the port from the JAX state ``st_j`` against the
    JAX advance: the physics state (envs beyond a tolerance refereed,
    ``torch_parity.refereed``) and the torques; then the port's obs, dense
    reward and info flags against the JAX ``post`` on the port's own new
    state.
    Only envs in contact (a point loaded before or after the step) may be
    refereed. Returns the JAX state after the step."""
    tenv = _port(task)
    st_t = convert.env_state_from_numpy(_np(st_j))
    st_j2 = _jax_advance(TASKS[task][0])(st_j, jnp.asarray(action))
    st_t2, obs_t, rew_t, term_t, info_t = tenv._step(st_t, torch.as_tensor(action))
    got, ref = convert.to_numpy(st_t2.sim), _np(st_j2.sim)
    np.testing.assert_array_equal(st_t2.cmd.qf.numpy(), np.asarray(st_j2.cmd.qf))
    cmd = tenv.agent.controller.set_action(st_t.cmd, st_t.sim.qpos, torch.as_tensor(action))
    f64 = plain64(tenv.kernel, st_t.sim, cmd, tenv.sim_steps_per_control)
    bad = refereed(got, ref, f64, TOL, REFEREE_FACTOR, REFEREE_CAP)
    touch = ((st_t.sim.contact_lam > 0).any(1).numpy() | (got["contact_lam"] > 0).any(1)
             | (ref["contact_lam"] > 0).any(1))
    assert not (bad & ~touch).any(), (label, bad, touch)
    obs_j, rew_j, info_j = _jax_post(task)(_to_jax(st_j2, st_t2), jnp.asarray(action))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=2e-4, err_msg=label)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-5, err_msg=label)
    assert info_t.keys() == info_j.keys()
    for key in info_j:
        np.testing.assert_array_equal(info_t[key].numpy(), np.asarray(info_j[key]),
                                      err_msg=f"{label} {key}")
    return st_j2


def _check_steps(task):
    """Three env steps from the JAX reset state with random actions in
    [-0.3, 0.3] (each step from the JAX state of the one before), then,
    for a robot on the floor, one from a state the port settled onto it
    (``SETTLE`` zero-torque steps) and carried back, with points loaded in
    at least three quarters of the envs: the physics state, the torques,
    obs, dense reward and every info flag. Envs in contact may be refereed
    (up to six of the eight of the humanoid's floor step); every other env
    agrees."""
    jenv, tenv = _jax_env(task), _port(task)
    rng = np.random.default_rng(sum(map(ord, task)))
    st_j = jenv._state
    for i in range(3):
        action = rng.uniform(-0.3, 0.3, (K, tenv.action_dim)).astype(np.float32)
        st_j = _compare_step(task, st_j, action, f"step {i}")
    n = SETTLE.get(TASKS[task][0])
    if n is None:
        return
    st_t = convert.env_state_from_numpy(_np(jenv._state))
    for _ in range(n):
        st_t = tenv._step(st_t, torch.zeros(K, tenv.action_dim))[0]
    assert (st_t.sim.contact_lam > 0).any(1).float().mean() >= 0.75
    action = rng.uniform(-0.3, 0.3, (K, tenv.action_dim)).astype(np.float32)
    _compare_step(task, _to_jax(jenv._state, st_t), action, "floor")


TASK_CHECKS = [(task, c) for task in TASKS for c in ("tables", "reset", "steps")]


@pytest.mark.parametrize("task, check", TASK_CHECKS, ids=[f"{t}-{c}" for t, c in TASK_CHECKS])
def test_task_matches_jax(task, check):
    """One check of an id against the JAX package (``_check_*``): the model
    tables; evaluate, obs and reward at the JAX reset state; env steps from
    it and from a state on the floor."""
    {"tables": _check_tables, "reset": _check_reset, "steps": _check_steps}[check](task)


def test_humanoid_mppi_matches_jax():
    """One MPPI solve on MS-HumanoidStand-v1 at K=8, H=3 (the bench
    sigma and temperature) from the JAX reset state with the JAX noise
    injected: the nominal and the rollout returns match."""
    task = "MS-HumanoidStand-v1"
    jenv, tenv = _jax_env(task), _port(task)
    H = 3
    cfg = dict(horizon=H, num_samples=K, sigma=0.6, temperature=0.3)
    jp = JMPPI(jenv, JMPPIConfig(**cfg))
    ps_j = jp.init(seed=0)
    ps_j2, info_j = jp.solve(ps_j, jax.tree.map(lambda x: x[0], jenv._state))
    white = np.asarray(jax.random.normal(jax.random.split(ps_j.key)[1],
                                         (K, H, tenv.action_dim)))
    tp = MPPI(tenv, MPPIConfig(**cfg))
    st_t = convert.env_state_from_numpy(_np(jax.tree.map(lambda x: x[:1], jenv._state)))
    ps_t, info_t = tp.solve(tp.init(seed=0), st_t, noise=torch.tensor(white))
    for key in ("best_return", "mean_return"):
        np.testing.assert_allclose(float(info_t[key]), float(info_j[key]), atol=1e-4)
    np.testing.assert_allclose(ps_t.nominal.numpy(), np.asarray(ps_j2.nominal), atol=1e-4)


def test_root_chain_singularity_matches_jax():
    """The humanoid's ``<freejoint>`` root (slides, then hinges about z, y
    and x) is singular where the y hinge reaches a quarter turn: the outer
    two hinges align. Falling states there (y hinge 1e-4 to 1e-2 rad short
    of pi/2, 5 cm above the floor, random joint rates, the root's hinge
    rates up to ten times larger), one control step at zero torque
    through the JAX XLA step and the port's plain step: both turn an env
    non-finite, the same env; the same states half a radian from the
    singularity stay finite below 100 rad/s in both."""
    from maniskill_tpu_torch.physics.engine import compute_contacts, robot_fk

    task = "MS-HumanoidStand-v1"
    jenv, tenv = _jax_env(task), _port(task)
    spec = tenv.model.robot
    pitch = [i for i, n in enumerate(spec.joint_names)
             if n.startswith("root") and spec.joint_type[i] == 0][1]
    st = convert.env_state_from_numpy(_np(jenv._state))
    rng = np.random.default_rng(0)
    qvel = rng.normal(0, 0.5, st.sim.qvel.shape).astype(np.float32)
    qvel[4:, 3:6] *= 6
    zero = torch.zeros(K, tenv.action_dim)
    short = np.array([1e-4, 1e-3, 3e-3, 1e-2] * 2, np.float32)
    finite = []
    for off in (0.0, 0.5):
        qpos = st.sim.qpos.clone()
        qpos[:, pitch] = torch.as_tensor(np.float32(np.pi / 2) - short - np.float32(off))
        sim = st.sim.replace(qpos=qpos, qvel=torch.as_tensor(qvel))
        qpos[:, 2] += compute_contacts(tenv.model, sim, *robot_fk(tenv.model, qpos)[:2])[2].amax(1)
        qpos[:, 2] += 0.05
        st_t = st.replace(sim=sim.replace(qpos=qpos))
        cmd = tenv.agent.controller.set_action(st_t.cmd, qpos, zero)
        got = tenv.kernel.plain(st_t.sim, cmd, tenv.sim_steps_per_control)[0].qvel.numpy()
        ref = np.asarray(_jax_advance("humanoid")(_to_jax(jenv._state, st_t),
                                                  jnp.zeros((K, tenv.action_dim))).sim.qvel)
        finite.append([np.isfinite(v).all(1) for v in (got, ref)])
        if off:
            assert all(f.all() for f in finite[-1])
            assert np.abs(got).max() < 100 and np.abs(ref).max() < 100
    (f_t, f_j), _ = finite
    assert not f_j.all() and (~f_t & ~f_j).any(), (f_t, f_j)


def test_contact_state_loads_the_floor():
    """``contact_state`` (the kernel checks' floor states) on the humanoid,
    from the JAX reset state: finite; in the plain control step from it
    the feet's capsules carry force in the standing envs and the head's
    sphere in the upside-down ones; the command holds non-zero torques on
    the 21 actuated dofs and none on the root's six."""
    from maniskill_tpu_torch.physics.engine import make_step_fn

    env = _port("MS-HumanoidStand-v1")
    st = convert.env_state_from_numpy(_np(_jax_env("MS-HumanoidStand-v1")._state))
    cst = env.contact_state(st, torch.Generator().manual_seed(0))
    assert torch.isfinite(cst.sim.qpos).all() and torch.isfinite(cst.sim.qvel).all()
    assert not cst.cmd.qf[:, :6].any() and cst.cmd.qf[:, 6:].abs().min() > 0
    plan = megakernel._Plan(env.model)
    step = make_step_fn(env.model)
    sim, loaded = cst.sim, torch.zeros(K, plan.P, dtype=torch.bool)
    for _ in range(env.sim_steps_per_control):
        sim, aux = step(sim, cst.cmd, 1, return_aux=True)
        loaded |= (aux["f_pt"].abs().sum(-1) > 0) | (sim.contact_lam > 0)
    capsule = torch.as_tensor(plan.pfn == megakernel._FNS.index("plane_capsule"))
    sphere = torch.as_tensor(plan.pfn == megakernel._FNS.index("plane_sphere"))
    assert loaded[0::2][:, capsule].any(1).all()
    assert loaded[3::4][:, sphere].any(1).all()
