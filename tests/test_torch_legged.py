"""The legged robots through the PyTorch port against the JAX package, on
the CPU: ``load_mjcf`` on the ANYmal C, Go2 and H1 XMLs, their agents, and
the four ids AnymalC-Reach-v1, AnymalC-Spin-v1, UnitreeGo2-Reach-v1 and
UnitreeH1Stand-v1.

The same inputs go through both. Each id's JAX env is reset with seed 0
(its XLA engine, ``sim_backend="xla"``: the plain reference of its Pallas
kernel); the port resets from JAX's draws (the Reach goal, H1's joint
noise, read off the JAX reset state and handed to the port's ``_draw``)
and must give JAX's reset state, obs and evaluate. AnymalC-Reach-v1 (the
quadrupeds' class) and UnitreeH1Stand-v1 then take three env steps from
the JAX reset state with random actions (the quadrupeds land on the
floor in the second) and one from the port's ``contact_state`` (standing,
on the side or upside down) carried back. The JAX side compiles the
controller and physics step (``_jax_advance``) and evaluate, obs and
reward on the port's own new state (``_jax_post``); the fall and
shank-contact terms read each package's own contact-force query.

Tolerances: the env step those of tests/test_megakernel.py:48-67 (qpos
2e-5, qvel 2e-4, impulses 5e-3); stiff floor contacts can take the JAX
float32 step itself beyond them, so an env beyond one is refereed by the
port's plain step in float64 (``torch_parity.refereed``: neither float32
step more than 3 times further from it than the other, one env of a step
up to 10; beyond that one env, an env where JAX's float32 step is the
further one passes only where JAX's own step in float64 agrees with the
port's), and only envs in contact may be; the reset state 1e-6; obs,
reward and evaluate on one state 1e-5 relative (1e-6 absolute for values
near 0; the contact forces behind the fall flags within the force query's
float32 rounding); the MJCF specs, geoms, masks and model tables exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.agents.robots.quadruped import AnymalC as JAnymalC
from maniskill_tpu.agents.robots.quadruped import UnitreeGo2 as JGo2
from maniskill_tpu.agents.robots.quadruped import UnitreeH1 as JH1
from maniskill_tpu.envs.base_env import TaskContext as JTaskContext
from maniskill_tpu.kinematics import chain as jchain
from maniskill_tpu.kinematics.mjcf import load_mjcf as jload_mjcf
from maniskill_tpu.physics import engine as jeng
from maniskill_tpu.physics import megakernel as jmk
from maniskill_tpu.utils.assets import ASSET_DIR

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.agents.robots.quadruped import AnymalC, UnitreeGo2, UnitreeH1
from maniskill_tpu_torch.kinematics import chain
from maniskill_tpu_torch.kinematics.mjcf import load_mjcf
from maniskill_tpu_torch.physics import engine as teng
from maniskill_tpu_torch.physics import megakernel
from torch_parity import (fast_trace_metadata, jax_step64, make_jax_env, np_tree, plain64,
                          refereed, shared_jit, to_jax)

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _fast_jax_tables():
    """The JAX package's static contact tables through one jitted program
    (tests/torch_parity.py); the module's envs and compiled programs are
    dropped at its end."""
    with fast_trace_metadata():
        yield
    for fn in (_jax, _jax_advance, _jax_post, _port):
        fn.cache_clear()


K = 8
TOL = dict(qpos=2e-5, qvel=2e-4, contact_lam=5e-3, contact_lam_t=5e-3)
REL, NEAR0 = 1e-5, 1e-6
_FNS = ["plane_box", "plane_capsule", "plane_sphere"]
# (robot, nq, G, P, kinematic bodies) of each id's model
TASKS = {
    "AnymalC-Reach-v1": ("anymal_c", 18, 18, 32, 1),
    "AnymalC-Spin-v1": ("anymal_c", 18, 18, 32, 1),
    "UnitreeGo2-Reach-v1": ("unitree_go2", 18, 18, 32, 1),
    "UnitreeH1Stand-v1": ("unitree_h1", 25, 24, 55, 0),
}
STEPPED = ("AnymalC-Reach-v1", "UnitreeH1Stand-v1")
ROBOTS = {"anymal_c": (AnymalC, JAnymalC, "anymal_c.xml", 18, 17, 12),
          "unitree_go2": (UnitreeGo2, JGo2, "go2.xml", 18, 17, 12),
          "unitree_h1": (UnitreeH1, JH1, "h1.xml", 25, 23, 19)}


def _close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=REL,
                               atol=NEAR0, err_msg=msg)


@functools.lru_cache(maxsize=None)
def _jax(task):
    """The task's JAX env (K envs, reset with seed 0; its reset outputs in
    ``reset_out``)."""
    env = make_jax_env(task, num_envs=K, reward_mode="dense", sim_backend="xla")
    env.reset_out = env.reset(seed=0)
    return env


@functools.lru_cache(maxsize=None)
def _jax_advance(task):
    """The JAX controller and physics step of one control step (the first
    half of ``BaseEnv._step_one``), vmapped and jitted."""
    env = _jax(task)

    def advance(state, action):
        cmd = env.agent.controller.set_action(state.cmd, state.sim.qpos, action)
        sim = env._physics_step(state.sim, cmd, env.sim_steps_per_control)
        return state.replace(sim=sim, cmd=cmd, elapsed_steps=state.elapsed_steps + 1)

    return shared_jit(jax.vmap(advance))


@functools.lru_cache(maxsize=None)
def _jax_post(task):
    """The rest of the JAX ``_step_one`` on an advanced state: ``(obs,
    reward, info, the contact forces' magnitudes (P,))``."""
    env = _jax(task)

    def post(state, action):
        ctx = JTaskContext(env, state)
        info = env.evaluate(state, ctx)
        return (env._get_obs(state, ctx, info), env._get_reward(state, action, info, ctx), info,
                jnp.linalg.norm(ctx.contact_forces(), axis=-1))

    return shared_jit(jax.vmap(post))


@functools.lru_cache(maxsize=None)
def _port(task):
    return mtt.make(task, num_envs=K, reward_mode="dense", device="cpu")


# ---- the MJCFs and the agents ---------------------------------------------------


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


@pytest.mark.parametrize("robot", list(ROBOTS))
def test_mjcf_matches_jax(robot):
    """``load_mjcf`` on the robot's XML: every ``RobotSpec`` field (joint
    names, axes, limits, link poses, masses, inertias), the collision geoms
    (types, sizes, offsets, frictions), the world geoms and the free
    root's dofs, equal to the JAX loader's; the ``<freejoint>`` expands to
    slides x, y, z and hinges z, y, x; box, capsule and sphere geoms."""
    _, _, xml, nq, n_geoms, _ = ROBOTS[robot]
    path = str(ASSET_DIR / "control" / xml)
    mt, mj = load_mjcf(path), jload_mjcf(path)
    for f in dataclasses.fields(mj.spec):
        _same(getattr(mt.spec, f.name), getattr(mj.spec, f.name), f.name)
    for name in ("collision_geoms", "world_geoms", "actuators", "free_root_dofs"):
        _same(getattr(mt, name), getattr(mj, name), name)
    assert mt.spec.nb == nq and len(mt.collision_geoms) == n_geoms
    assert list(mt.spec.joint_names[:6]) == ["root_slide_0", "root_slide_1", "root_slide_2",
                                             "root_hinge_2", "root_hinge_1", "root_hinge_0"]
    assert mt.spec.joint_type[:6].tolist() == [1, 1, 1, 0, 0, 0]
    assert {int(g["type"]) for g in mt.collision_geoms} == {1, 2, 3}


@pytest.mark.parametrize("robot", list(ROBOTS))
def test_agent_matches_jax(robot):
    """The agent: the standing and rest keyframes (the legs' standing
    angles, the root's z slide), its collision geoms, both control modes'
    bounds and gains over the leg joints (the root's six undriven), the
    base and shank links, and forward kinematics at the keyframe."""
    cls, jcls, _, nq, _, n_act = ROBOTS[robot]
    for mode in ("pd_joint_delta_pos", "pd_joint_pos"):
        ta, ja = cls(device="cpu", control_mode=mode), jcls(control_mode=mode)
        for kf in ("standing", "rest"):
            np.testing.assert_array_equal(ta.keyframes[kf].qpos, ja.keyframes[kf].qpos)
        _same(ta.collision_geoms(), ja.collision_geoms(), "collision_geoms")
        c_t, c_j = ta.controller, ja.controller
        assert c_t.action_dim == c_j.action_dim == n_act
        for name in ("action_low", "action_high", "kp", "kd", "force_limit"):
            np.testing.assert_array_equal(getattr(c_t, name), getattr(c_j, name), err_msg=name)
        assert not np.asarray(c_t.kp)[:6].any() and np.asarray(c_t.kp)[6:].all()
        assert (ta.base_link, ta.shank_links) == (ja.base_link, ja.shank_links)
    q = ta.keyframes["standing"].qpos
    base = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
    bp, bq = chain.fk(ta.robot_spec, torch.as_tensor(base), torch.as_tensor(q)[None])[:2]
    jp, jq = jchain.fk(ja.robot_spec, jnp.asarray(base), jnp.asarray(q))[:2]
    np.testing.assert_allclose(bp[0].numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(bq[0].numpy(), np.asarray(jq), atol=1e-6)


# ---- the four ids ------------------------------------------------------------


def _check_tables(task):
    """nq, F=0, G, P, the kinematic bodies and the pair functions; the pair
    groups, geom table, model constants (the robot's links under gravity;
    2 sim steps of 2 substeps a control step), assignment tables and static
    contact tables equal to the JAX model's; the quadrupeds' base and shank
    contact masks entry for entry; ``supports`` in both packages and the
    dispatch's choice of the kernel."""
    jenv, tenv = _jax(task), _port(task)
    jm, tm = jenv.model, tenv.model
    _, nq, G, P, kin = TASKS[task]
    for m in (tm, jm):
        assert (m.nq, m.n_free, len(m.geoms), m.n_points, len(m.kin_index)) == (nq, 0, G, P, kin)
        assert [g[0].__name__ for g in m.pair_groups] == _FNS
    for gt, gj in zip(tm.pair_groups, jm.pair_groups):
        assert gt[1] == gj[1]
        for a, b in zip(gt[2:], gj[2:]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tm.geoms, jm.geoms):
        assert (a.kind, a.body, int(a.gtype), a.name, a.friction) == (
            b.kind, b.body, int(b.gtype), b.name, b.friction)
        for f in ("size", "offset_p", "offset_q"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for name in ("ancestor_mask", "init_qpos", "static_pose", "drive_kp", "drive_kd",
                 "drive_force_limit", "robot_base_pose", "robot_qlim", "gravity_mask",
                 "robot_inertia_com"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    assert tm.gravity_mask.all()
    assert tm.params == tm.params.__class__(
        **{f.name: getattr(jm.params, f.name) for f in dataclasses.fields(tm.params)})
    assert tenv.sim_steps_per_control == jenv.sim_steps_per_control == 2
    assert tm.params.substeps == 2
    for a, b in zip(teng._assignment_tables(tm), jeng._assignment_tables(jm)):
        np.testing.assert_array_equal(a, b)
    mt, mj = teng._trace_metadata(tm), jeng._trace_metadata(jm)
    for i in range(3):
        np.testing.assert_allclose(mt[i].numpy(), np.asarray(mj[i]), atol=1e-5)
    for i in range(3, 7):
        np.testing.assert_array_equal(mt[i].numpy(), np.asarray(mj[i]))
    assert list(mt[7]) == list(mj[7]) and list(mt[8]) == list(mj[8])
    if "H1" not in task:
        np.testing.assert_array_equal(tenv._base_mask, np.asarray(jenv._base_mask))
        np.testing.assert_array_equal(tenv._shank_mask, np.asarray(jenv._shank_mask))
        np.testing.assert_array_equal(tenv._leg_idx, jenv._leg_idx)
        # the base box's eight corners; ANYmal's shanks a capsule (2
        # points) and a foot sphere each, Go2's a capsule each
        assert tenv._base_mask.sum() == 8
        assert tenv._shank_mask.sum() == (12 if "Anymal" in task else 8)
    assert megakernel.supports(tm) and jmk.supports(jm)
    assert isinstance(tenv.kernel, megakernel.MegaKernel)


def _reset_from(tenv, draws):
    """The port's whole reset of K envs, its draws replaced by ``draws``."""
    tenv._draw = lambda gen, k: draws
    try:
        return tenv._reset_all(torch.Generator().manual_seed(0))
    finally:
        del tenv._draw


def _check_reset(task):
    """The port's reset from JAX's draws (the Reach goal's x and y, H1's
    joint offsets): the whole state (sim, command) within 1e-6 of JAX's
    reset state, its obs and evaluate those of JAX's reset. No robot has
    fallen."""
    jenv, tenv = _jax(task), _port(task)
    st_j = np_tree(jenv._state)
    obs_j, info_j = jenv.reset_out
    if "Reach" in task:
        goal = st_j["sim"]["kin_pose"][:, tenv.goal_site]
        draws = dict(gx=torch.as_tensor(np.array(goal[:, 0])),
                     gy=torch.as_tensor(np.array(goal[:, 1])))
    elif "H1" in task:
        draws = dict(noise=torch.as_tensor(st_j["sim"]["qpos"] - tenv._default_qpos))
    else:
        draws = {}
    st, obs, info = _reset_from(tenv, draws) if draws else tenv._reset_all(torch.Generator())
    got = convert.to_numpy(st)
    for part in ("sim", "cmd"):
        for name, ref in st_j[part].items():
            if ref is not None and got[part].get(name) is not None:
                np.testing.assert_allclose(got[part][name], ref, atol=1e-6, err_msg=name)
    _close(obs.numpy(), obs_j, "obs")
    assert info.keys() == info_j.keys()
    for key in info_j:
        _close(info[key].numpy(), info_j[key], key)
    assert not info.get("fail", torch.zeros(1, dtype=torch.bool)).any()


def _compare_step(task, st_j, action, label):
    """One env step of the port from the JAX state ``st_j`` against the
    JAX advance: the physics state (envs beyond a tolerance refereed, JAX's
    own float64 step the second referee; only envs in contact may be) and
    the command; then the port's obs, dense
    reward and evaluate against JAX's on the port's own new state. Returns
    the JAX state after the step and the refereed envs."""
    from maniskill_tpu_torch.envs.base_env import TaskContext

    tenv = _port(task)
    st_t = convert.env_state_from_numpy(np_tree(st_j))
    st_j2 = _jax_advance(task)(st_j, jnp.asarray(action))
    st_t2, obs_t, rew_t, _, info_t = tenv._step(st_t, torch.as_tensor(action))
    got, ref = convert.to_numpy(st_t2.sim), np_tree(st_j2.sim)
    np.testing.assert_allclose(st_t2.cmd.target_qpos.numpy(), np.asarray(st_j2.cmd.target_qpos),
                               atol=1e-6)
    cmd = tenv.agent.controller.set_action(st_t.cmd, st_t.sim.qpos, torch.as_tensor(action))
    bad = refereed(got, ref, plain64(tenv.kernel, st_t.sim, cmd, tenv.sim_steps_per_control),
                   TOL, jax64=lambda: jax_step64(_jax(task), st_j.sim,
                                                 to_jax(st_j.cmd, cmd)))
    touch = ((st_t.sim.contact_lam > 0).any(1).numpy() | (got["contact_lam"] > 0).any(1)
             | (ref["contact_lam"] > 0).any(1))
    assert not (bad & ~touch).any(), (label, bad, touch)
    obs_j, rew_j, info_j, f_j = _jax_post(task)(to_jax(st_j2, st_t2), jnp.asarray(action))
    f_t = torch.linalg.norm(TaskContext(tenv, st_t2).contact_forces(), dim=-1).numpy()
    np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=1e-4, atol=1e-3, err_msg=label)
    # a fall or shank flag whose force sits within the query's rounding of
    # the 1 N threshold may flip; none does in these states
    _close(obs_t.numpy(), obs_j, f"{label} obs")
    _close(rew_t.numpy(), rew_j, f"{label} reward")
    assert info_t.keys() == info_j.keys()
    for key in info_j:
        _close(info_t[key].numpy(), info_j[key], f"{label} {key}")
    return st_j2, bad


def _check_steps(task):
    """Three env steps from the JAX reset state with random actions in
    [-0.3, 0.3] (as tests/test_torch_control.py's; each from the JAX state
    of the one before), then one from the port's ``contact_state``
    (carried back) under its own command: the physics state, obs, dense
    reward and evaluate. The keyframes start the quadrupeds 3-4 mm above
    the floor, and they land in the second step (their feet then hold a
    load in every env); H1 starts 7.6 cm up (both packages) and falls
    through all three. At most a quarter of the envs of a step are
    refereed."""
    jenv, tenv = _jax(task), _port(task)
    rng = np.random.default_rng(sum(map(ord, task)))
    st_j = jenv._state
    for i in range(3):
        action = rng.uniform(-0.3, 0.3, (K, tenv.action_dim)).astype(np.float32)
        st_j, bad = _compare_step(task, st_j, action, f"step {i}")
        assert bad.sum() <= K // 4, (i, bad)
        landed = (np.asarray(st_j.sim.contact_lam) > 0).any(1)
        assert landed.all() if ("H1" not in task and i > 0) else not landed.any(), (i, landed)
    st_t = tenv.contact_state(convert.env_state_from_numpy(np_tree(jenv._state)),
                              torch.Generator().manual_seed(0))
    zero = np.zeros((K, tenv.action_dim), np.float32)
    _, bad = _compare_step(task, to_jax(jenv._state, st_t), zero, "contact")
    assert bad.sum() <= K // 4, bad


TASK_CHECKS = [(task, c) for task in TASKS
               for c in ("tables", "reset") + (("steps",) if task in STEPPED else ())]


@pytest.mark.parametrize("task, check", TASK_CHECKS, ids=[f"{t}-{c}" for t, c in TASK_CHECKS])
def test_task_matches_jax(task, check):
    """One check of an id against the JAX package (``_check_*``): the model
    tables and contact masks; the reset from JAX's draws; env steps from
    the reset state and from a contact state."""
    {"tables": _check_tables, "reset": _check_reset, "steps": _check_steps}[check](task)


# ---- the port alone ------------------------------------------------------------


@pytest.mark.parametrize("task", list(TASKS))
def test_reset_draws_and_contact_states(task):
    """The port's own reset draws (its generator, 64 envs) fall in the JAX
    task's ranges (the goal 2-3 m ahead, within 1 m to the side, 0.2 m up;
    H1's body joints offset by normal(0, 0.02), the root's six not); and
    ``contact_state`` (the kernel checks' floor states) is finite, with the
    feet on the floor in the standing envs, the base (the quadrupeds' box)
    or the head (H1's sphere) in the upside-down ones, in the plain
    control step from it."""
    from maniskill_tpu_torch.physics.engine import make_step_fn

    env = mtt.make(task, num_envs=64, device="cpu")
    env.reset(seed=3)
    sim = env._state.sim
    dq = sim.qpos - torch.as_tensor(env._default_qpos)
    if "Reach" in task:
        goal = sim.kin_pose[:, env.goal_site]
        assert goal[:, 0].min() >= 2.0 and goal[:, 0].max() <= 3.0 and goal[:, 0].std() > 0.2
        assert goal[:, 1].abs().max() <= 1.0 and (goal[:, 2:] == torch.tensor(
            [0.2, 1.0, 0, 0, 0])).all()
    if "H1" in task:
        assert not dq[:, :6].any() and 0.015 < float(dq[:, 6:].std()) < 0.025
    else:
        assert not dq.any()
    cst = env.contact_state(env._state, torch.Generator().manual_seed(0))
    assert torch.isfinite(cst.sim.qpos).all() and torch.isfinite(cst.sim.qvel).all()
    plan = megakernel._Plan(env.model)
    s, aux = make_step_fn(env.model)(cst.sim, cst.cmd, env.sim_steps_per_control,
                                     return_aux=True)
    loaded = (aux["f_pt"].abs().sum(-1) > 0) | (s.contact_lam > 0)
    feet, top = env.FLOOR_CONTACT
    idx = torch.arange(64)
    for fn, envs in ((feet, idx % 2 == 0), (top, idx % 4 == 3)):
        pts = torch.as_tensor(plan.pfn == megakernel._FNS.index(fn))
        assert loaded[envs][:, pts].any(1).all(), fn
