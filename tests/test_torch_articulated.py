"""Articulated objects through the PyTorch port against the JAX package, on
the CPU: ``ArticulationBuilder`` and ``merge_forest``, the six articulated
ids (FoldSuitcase-v1, FoldSuitcaseModels-v1, TurnFaucet-v1,
OpenCabinetDrawer-v1, OpenCabinetDoor-v1, OpenCabinetDrawerModels-v1:
robot-only scenes, F=0, with an object's tree merged into the robot's
kinematic forest), the Fetch's base controller, and MPPI's
``nominal_init``.

The same inputs go through both: JAX reset states carried across with
``maniskill_tpu_torch.convert``, states in contact built by the port
(``contact_state``: fingers pressing the lid or the drawer, points with a
robot link on each side carrying force) and carried back, the JAX MPPI
noise. The JAX side runs its XLA engine (``sim_backend="xla"``), the plain
reference of its Pallas kernel. Each task's JAX env and its jitted env
step are built once per process and shared by the cases that need them
(``_jax``); the cases run in task-major order.

Tolerances: those of tests/test_megakernel.py:48-67 for the env step
(qpos 2e-5, qvel 2e-4, impulses 5e-3); obs 2e-4, reward and MPPI 1e-4;
``ArticulationBuilder``'s and the forest's fields exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.agents.robots.panda import Panda as JPanda
from maniskill_tpu.kinematics import articulation as jart
from maniskill_tpu.physics import engine as jeng
from maniskill_tpu.physics.model import box_geom as jbox_geom
from maniskill_tpu.planners.mppi import MPPI as JMPPI, MPPIConfig as JMPPIConfig

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.agents.robots.panda import Panda
from maniskill_tpu_torch.envs.base_env import TaskContext
from maniskill_tpu_torch.kinematics import articulation as tart
from maniskill_tpu_torch.physics import engine as teng
from maniskill_tpu_torch.physics import megakernel
from maniskill_tpu_torch.physics.model import box_geom, tree_map
from maniskill_tpu_torch.planners.mppi import MPPI, MPPIConfig
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
    _jax.cache_clear()
    _port.cache_clear()


K = 8
TOL = dict(qpos=2e-5, qvel=2e-4, contact_lam=5e-3, contact_lam_t=5e-3)
# (nq, G, P, pair functions) of each id's model (the JAX package's)
TASKS = {
    "FoldSuitcase-v1": (10, 9, 168, ["box_box_corners", "box_box_onesided"]),
    "FoldSuitcaseModels-v1": (10, 9, 168, ["box_box_corners", "box_box_onesided"]),
    "TurnFaucet-v1": (10, 9, 168, ["box_box_corners", "box_box_onesided"]),
    "OpenCabinetDrawer-v1": (16, 12, 320, ["box_box_corners", "box_box_onesided", "plane_box"]),
    "OpenCabinetDoor-v1": (16, 12, 320, ["box_box_corners", "box_box_onesided", "plane_box"]),
    "OpenCabinetDrawerModels-v1": (17, 15, 480,
                                   ["box_box_corners", "box_box_onesided", "plane_box"]),
}


@functools.lru_cache(maxsize=None)
def _jax_env(task):
    """The task's JAX env, built but not reset (its model and tables)."""
    return make_jax_env(task, num_envs=K, reward_mode="dense", sim_backend="xla")


@functools.lru_cache(maxsize=None)
def _jax(task):
    """The task's JAX env reset with seed 0 (its reset outputs in
    ``reset_out``) and its env step, vmapped and jitted."""
    env = _jax_env(task)
    env.reset_out = env.reset(seed=0)
    return env, shared_jit(jax.vmap(env._step_one))


@functools.lru_cache(maxsize=None)
def _port(task):
    return mtt.make(task, num_envs=K, reward_mode="dense", device="cpu")


# ---- ArticulationBuilder and the forest ------------------------------------


def _suitcase(ab_cls, geom):
    ab = ab_cls("suitcase")
    lid = ab.add_revolute_link("lid", axis=(0.0, 1.0, 0.0), limits=(0.0, 2.2),
                               joint_pose=((0.03, 0.0, 0.03), (1, 0, 0, 0)), mass=0.4,
                               com=(-0.13, 0.0, 0.008), damping=0.3, friction=0.5)
    ab.add_prismatic_link("latch", parent=lid, axis=(1.0, 0.0, 0.0), limits=(0.0, 0.02),
                          joint_pose=((-0.2, 0.0, 0.01), (0.9238795, 0.0, 0.3826834, 0.0)),
                          mass=0.05, init_q=0.01)
    ab.add_geom(lid, geom([0.13, 0.09, 0.008], offset_p=(-0.13, 0.0, 0.008)))
    ab.add_base_geom(geom([0.13, 0.09, 0.015], offset_p=(-0.1, 0.0, 0.015)))
    return ab


def _same_spec(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert x.keys() == y.keys(), f.name
            for k in x:
                xv, yv = x[k], y[k]
                if isinstance(xv, tuple):
                    assert xv[0] == yv[0], (f.name, k)
                    for u, v in zip(xv[1:], yv[1:]):
                        np.testing.assert_array_equal(u, v, err_msg=f"{f.name} {k}")
                else:
                    assert xv == yv, (f.name, k)
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)
        else:
            assert x == y, f.name


def test_articulation_builder_and_forest_match_jax():
    """``ArticulationBuilder.build`` (a revolute lid with a prismatic child
    on a turned joint frame, its link and base geoms, init qpos) and
    ``merge_forest`` of the Panda and that object at a turned and shifted
    pose: every ``RobotSpec`` field (frames and link indices included),
    ``tree_id`` and the dof offsets, equal to the JAX package's."""
    pt = _suitcase(tart.ArticulationBuilder, box_geom).build()
    pj = _suitcase(jart.ArticulationBuilder, jbox_geom).build()
    _same_spec(pt[0], pj[0])
    for gt, gj in zip(pt[1] + sum(pt[2], []), pj[1] + sum(pj[2], [])):
        assert gt.keys() == gj.keys()
        for k in gt:
            np.testing.assert_array_equal(np.asarray(gt[k]), np.asarray(gj[k]), err_msg=k)
    np.testing.assert_array_equal(pt[3], pj[3])
    base = np.array([-0.615, 0.0, 0.0, 1, 0, 0, 0], np.float32)
    pose = np.array([0.1, -0.2, 0.05, 0.9659258, 0.0, 0.0, 0.258819], np.float32)
    ft = tart.merge_forest([(Panda().robot_spec, base), (pt[0], pose)], base)
    fj = jart.merge_forest([(JPanda().robot_spec, base), (pj[0], pose)], base)
    _same_spec(ft[0], fj[0])
    np.testing.assert_array_equal(ft[1], fj[1])
    np.testing.assert_array_equal(ft[2], fj[2])
    assert list(ft[1]) == [0] * 9 + [1, 1] and ft[0].parent.tolist()[9:] == [-1, 9]


# ---- the six ids ----------------------------------------------------------


def _check_tables(task):
    """nq, F=0, G, P and the pair functions of the Motivation's table; the
    pair groups (functions, point counts, sides, friction), the geom table,
    ``gravity_mask``, ``tree_id``, ``art_dof_index``, the assignment
    tables and the per-point side tables, equal to the JAX model's; points
    with a robot link on each side lie across trees; ``supports``."""
    jm, tm = _jax_env(task).model, _port(task).model
    nq, G, P, fns = TASKS[task]
    assert (tm.nq, tm.n_free, len(tm.geoms), tm.n_points) == (nq, 0, G, P)
    assert (jm.nq, jm.n_free, len(jm.geoms), jm.n_points) == (nq, 0, G, P)
    assert [g[0].__name__ for g in tm.pair_groups] == fns
    assert [g[0].__name__ for g in jm.pair_groups] == fns
    for gt, gj in zip(tm.pair_groups, jm.pair_groups):
        assert gt[1] == gj[1]
        for a, b in zip(gt[2:], gj[2:]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tm.geoms, jm.geoms):
        assert (a.kind, a.body, int(a.gtype), a.name, a.friction) == (
            b.kind, b.body, int(b.gtype), b.name, b.friction)
        for f in ("size", "offset_p", "offset_q"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for name in ("gravity_mask", "tree_id", "ancestor_mask", "init_qpos", "static_pose",
                 "drive_kp", "drive_kd", "drive_force_limit", "robot_base_pose",
                 "robot_qlim", "robot_inertia_com"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    assert tm.static_names == jm.static_names
    assert tm.art_dof_index.keys() == jm.art_dof_index.keys()
    for k in tm.art_dof_index:
        np.testing.assert_array_equal(tm.art_dof_index[k], jm.art_dof_index[k])
    # the object feels gravity, the robot (balanced) does not
    obj = np.concatenate(list(tm.art_dof_index.values()))
    assert tm.gravity_mask[obj].all() and not np.delete(tm.gravity_mask, obj).any()
    for a, b in zip(teng._assignment_tables(tm), jeng._assignment_tables(jm)):
        np.testing.assert_array_equal(a, b)
    mt, mj = teng._trace_metadata(tm), jeng._trace_metadata(jm)
    for i in range(3):  # the initial contacts: narrowphase outputs
        np.testing.assert_allclose(mt[i].numpy(), np.asarray(mj[i]), atol=1e-5)
    for i in (7, 8):
        assert [tuple(map(int, m)) for m in mt[i]] == [tuple(map(int, m)) for m in mj[i]]
    plan = megakernel._Plan(tm)
    both = (plan.pra >= 0) & (plan.prb >= 0)
    assert both.any() and (tm.tree_id[plan.pra[both]] != tm.tree_id[plan.prb[both]]).all()
    assert megakernel.supports(tm)


def _check_reset(task):
    """At the JAX reset state carried across: evaluate, the state obs and
    the dense reward of the port equal JAX's."""
    jenv, _ = _jax(task)
    tenv = _port(task)
    obs_j, info_j = jenv.reset_out
    st = convert.env_state_from_numpy(_np(jenv._state))
    ctx = TaskContext(tenv, st)
    info = tenv.evaluate(st, ctx)
    obs = tenv._get_obs(st, ctx, info)
    assert obs.shape == np.shape(obs_j)
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=2e-4)
    for key in info_j:
        np.testing.assert_allclose(info[key].numpy(), np.asarray(info_j[key]), atol=1e-5,
                                   err_msg=key)

    def reward(state):
        from maniskill_tpu.envs.base_env import TaskContext as JTaskContext

        c = JTaskContext(jenv, state)
        return jenv.compute_dense_reward(state, None, jenv.evaluate(state, c), c)

    rew_j = jax.jit(jax.vmap(reward))(jenv._state)
    rew_t = tenv.compute_dense_reward(st, None, info, ctx)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-4)


def _check_step(task, states):
    """One env step from the JAX reset state with random actions, or from
    ``contact_state`` states with the action that keeps their command,
    carried to the JAX env: the physics state, obs, dense reward and every
    info flag. In contact, the points with a robot link on each side carry
    force in at least half the pressing envs of the JAX step."""
    jenv, jstep = _jax(task)
    tenv = _port(task)
    A = tenv.action_dim
    if states == "reset":
        st_t, st_j = convert.env_state_from_numpy(_np(jenv._state)), jenv._state
        action = np.random.default_rng(1).uniform(-0.3, 0.3, (K, A)).astype(np.float32)
    else:
        st_t = tenv.contact_state(convert.env_state_from_numpy(_np(jenv._state)),
                                  torch.Generator().manual_seed(0))
        st_j = _to_jax(jenv._state, st_t)
        # the contact state's own command: the arm holds, the gripper shuts
        # (Panda: the delta arm at 0, the gripper at its low end; Fetch: the
        # gripper at 0, its base and body at rest)
        action = np.zeros((K, A), np.float32)
        action[:, 7] = -1.0 if task.startswith("OpenCabinet") else -0.6
        if task.startswith("OpenCabinet"):
            arm = [tenv.model.robot.joint_names.index(n) for n in
                   ("shoulder_pan_joint", "shoulder_lift_joint", "upperarm_roll_joint",
                    "elbow_flex_joint", "forearm_roll_joint", "wrist_flex_joint",
                    "wrist_roll_joint")]
            d = st_t.cmd.target_qpos[:, arm] - st_t.sim.qpos[:, arm]
            action[:, :7] = np.clip(d.numpy() / 0.1, -1, 1)
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
    if states == "contact":
        plan = megakernel._Plan(tenv.model)
        cross = (plan.pra >= 0) & (plan.prb >= 0)
        lam = np.asarray(st_j2.sim.contact_lam) > 0
        press = np.arange(K) % 4 != 3
        assert lam[press][:, cross].any(1).mean() >= 0.5


def _check_mppi(task):
    """One MPPI solve at K=8, H=3 (the JAX config's sigma and
    temperature) with the JAX noise injected: the nominal and the rollout
    returns match."""
    jenv, _ = _jax(task)
    tenv = _port(task)
    Ks, H = 8, 3
    cfg = dict(horizon=H, num_samples=Ks, sigma=0.5, temperature=0.2)
    jp = JMPPI(jenv, JMPPIConfig(**cfg))
    ps_j = jp.init(seed=0)
    ps_j2, info_j = jp.solve(ps_j, jax.tree.map(lambda x: x[0], jenv._state))
    white = np.asarray(jax.random.normal(jax.random.split(ps_j.key)[1],
                                         (Ks, H, tenv.action_dim)))
    tp = MPPI(tenv, MPPIConfig(**cfg))
    st_t = convert.env_state_from_numpy(_np(jax.tree.map(lambda x: x[:1], jenv._state)))
    ps_t, info_t = tp.solve(tp.init(seed=0), st_t, noise=torch.tensor(white))
    for key in ("best_return", "mean_return"):
        np.testing.assert_allclose(float(info_t[key]), float(info_j[key]), atol=1e-4)
    np.testing.assert_allclose(ps_t.nominal.numpy(), np.asarray(ps_j2.nominal), atol=1e-4)


TASK_CHECKS = ([(task, "tables") for task in TASKS]
               + [("FoldSuitcaseModels-v1", c) for c in ("reset", "step_reset", "step_contact")]
               + [("OpenCabinetDrawer-v1", c) for c in ("step_reset", "step_contact")]
               + [("TurnFaucet-v1", c) for c in ("reset", "mppi")])


@pytest.mark.parametrize("task, check", TASK_CHECKS,
                         ids=[t if c == "tables" else f"{t}-{c}" for t, c in TASK_CHECKS])
def test_task_matches_jax(task, check):
    """One check of a task against the JAX package (``_check_*``): the
    model tables of all six ids; evaluate, obs and reward at the JAX reset
    state; one env step from it and one from ``contact_state`` states; a
    TurnFaucet MPPI solve with the JAX noise."""
    if check == "tables":
        _check_tables(task)
    elif check == "reset":
        _check_reset(task)
    elif check == "mppi":
        _check_mppi(task)
    else:
        _check_step(task, check.split("_")[1])


# ---- the Fetch's controllers and MPPI's prior ------------------------------


def test_fetch_controllers_match_jax():
    """The Fetch under ``pd_joint_delta_pos`` (arm 7, gripper 1, body 3,
    base 2 = 13 actions): action bounds, drive gains, and the drive
    targets of random actions from random states, equal to the JAX
    controller's; the base's two actions become world-frame velocity
    targets of the root x, y and yaw joints (damping-only drives), whose
    position targets hold the current pose."""
    from maniskill_tpu.agents.robots.fetch import Fetch as JFetch
    from maniskill_tpu_torch.agents.robots.fetch import Fetch

    ja, ta = JFetch(), Fetch()
    jc, tc = ja.controller, ta.controller
    assert tc.action_dim == jc.action_dim == 13
    assert list(tc.controllers) == list(jc.controllers) == ["arm", "gripper", "body", "base"]
    for name in ("action_low", "action_high", "kp", "kd", "force_limit"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name), err_msg=name)
    np.testing.assert_array_equal(ta.keyframes["rest"].qpos, ja.keyframes["rest"].qpos)
    rng = np.random.default_rng(4)
    qpos = (ja.keyframes["rest"].qpos + rng.normal(0, 0.3, (K, 15))).astype(np.float32)
    action = rng.uniform(-1.5, 1.5, (K, 13)).astype(np.float32)
    jcmd = jax.vmap(lambda q, a: jc.set_action(jc.reset(q), q, a))(jnp.asarray(qpos),
                                                                   jnp.asarray(action))
    q_t = torch.as_tensor(qpos)
    tcmd = tc.set_action(tc.reset(q_t), q_t, torch.as_tensor(action))
    for name in ("target_qpos", "target_qvel", "kp", "kd", "force_limit"):
        np.testing.assert_allclose(getattr(tcmd, name).numpy(), np.asarray(getattr(jcmd, name)),
                                   atol=1e-6, err_msg=name)
    base = [ta.robot_spec.joint_names.index(n) for n in
            ("root_x_axis_joint", "root_y_axis_joint", "root_z_rotation_joint")]
    np.testing.assert_array_equal(tcmd.target_qpos[:, base].numpy(), qpos[:, base])
    assert (tcmd.kp[:, base] == 0).all() and (tcmd.kd[:, base] == 1e3).all()


def test_mppi_nominal_init():
    """``MPPIConfig.nominal_init`` is the first solve's nominal (the
    cabinet's approach prior); with zero noise the solve keeps it, and a
    prior of the wrong shape is refused."""
    env = _port("TurnFaucet-v1")
    H, A = 2, env.action_dim
    prior = np.zeros((H, A), np.float32)
    prior[:, 0], prior[:, 7] = 0.5, -0.25
    planner = MPPI(env, MPPIConfig(horizon=H, num_samples=3, nominal_init=prior))
    ps = planner.init(seed=0)
    np.testing.assert_array_equal(ps.nominal.numpy(), prior)
    env.reset(seed=0)
    st = tree_map(lambda x: x[:1], env._state)
    ps2, _ = planner.solve(ps, st, noise=torch.zeros(3, H, A))
    np.testing.assert_allclose(ps2.nominal.numpy(), prior, atol=1e-6)
    with pytest.raises(ValueError, match="nominal_init"):
        MPPI(env, MPPIConfig(horizon=3, nominal_init=prior)).init()
