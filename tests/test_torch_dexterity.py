"""The dexterity family through the PyTorch port against the JAX package, on
the CPU: ``random_quaternion``, the TriFingerPro and the D'Claw, and the
twelve ids TriFingerRotateCubeLevel0-4-v1, RotateCube-v1,
RotateValveDClaw-v1 and RotateValveLevel0-4-v1.

The same inputs go through both. Each id's JAX env is reset with seed 0
(its XLA engine, ``sim_backend="xla"``: the plain reference of its Pallas
kernel); the port resets from JAX's draws (the cube's place, the goal, the
tracked vector's angle, the valve's angle, direction, heads and lengths,
read off the JAX reset state and handed to the port's ``_draw``; the
claw's initial joint noise as JAX's initial state) and must give JAX's
reset state, obs and evaluate. One id of each env class (TriFinger
Level4, RotateCube, RotateValveLevel3) then takes three
env steps from the JAX reset state with random actions and one from the
port's ``contact_state`` (fingertips pressed onto the cube; the claw on
taller spokes) carried back. The JAX side compiles the controller and
physics step (``_jax_advance``, one program a scene: the five TriFinger
levels share theirs), RotateCube's bookkeeping on the port's new state
with the pre-step extras (``_jax_extras``), and evaluate, obs and reward
on the port's new state and extras (``_jax_post``).

Tolerances: the env step those of tests/test_megakernel.py:48-67 (qpos
2e-5, qvel 2e-4, free pose 2e-5, free vel 5e-4, impulses 5e-3); an env
beyond one is refereed by the port's plain step in float64
(``torch_parity.refereed``: neither float32 step more than 3 times
further from it than the other, one env of a step up to 10), and only
envs in contact may be; the reset state 1e-6; obs, reward, evaluate and
extras on one state 1e-5 relative (1e-6 absolute for values near 0), an
env's extras beyond it refereed by JAX's update written out in numpy
float64 (``_check_extras``: RotateCube's ``arccos`` near 1); the model tables
exactly, the static contact tables' positions 1e-5.
"""
import functools
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.agents.robots.trifinger import TriFingerPro as JTriFinger
from maniskill_tpu.agents.robots.xarm import DClaw as JDClaw
from maniskill_tpu.envs.base_env import TaskContext as JTaskContext
from maniskill_tpu.kinematics import chain as jchain
from maniskill_tpu.math.rotations import random_quaternion as j_random_quaternion
from maniskill_tpu.physics import engine as jeng
from maniskill_tpu.physics import megakernel as jmk

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.agents.robots.trifinger import TriFingerPro
from maniskill_tpu_torch.agents.robots.xarm import DClaw
from maniskill_tpu_torch.kinematics import chain
from maniskill_tpu_torch.math import rotations
from maniskill_tpu_torch.physics import engine as teng
from maniskill_tpu_torch.physics import megakernel
from torch_parity import (fast_trace_metadata, make_jax_env, np_tree, plain64, refereed,
                          shared_jit, to_jax)

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
    for fn in (_jax, _jax_advance, _jax_extras, _jax_post, _port):
        fn.cache_clear()


K = 8
TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
           contact_lam=5e-3, contact_lam_t=5e-3)
REL, NEAR0 = 1e-5, 1e-6
_CUBE = (9, 1, 5, 14, ["plane_box", "plane_sphere", "sphere_box"])
_VALVE = ["capsule_box", "plane_capsule"]
# (nq, F, G, P, pair functions, kinematic bodies) of each id's model
TASKS = {
    **{f"TriFingerRotateCubeLevel{i}-v1": _CUBE + (1,) for i in range(5)},
    "RotateCube-v1": _CUBE + (0,),
    "RotateValveDClaw-v1": (10, 0, 13, 99, _VALVE, 0),
    **{f"RotateValveLevel{i}-v1": (10, 0, 16, 180, _VALVE, 0) for i in range(5)},
}
# one id of each env class takes the steps (RotateValveDClaw-v1's valve is
# the levels' with three spoke slots: its tables and reset are checked)
STEPPED = ("TriFingerRotateCubeLevel4-v1", "RotateCube-v1", "RotateValveLevel3-v1")


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
def _jax_extras(task):
    """The JAX task's ``_update_extras`` on an advanced state: the new
    extras."""
    env = _jax(task)
    return shared_jit(jax.vmap(lambda state: env._update_extras(
        state, JTaskContext(env, state)).extras))


@functools.lru_cache(maxsize=None)
def _jax_post(task):
    """The rest of the JAX ``_step_one`` on an advanced state whose extras
    are updated: ``(obs, reward, info)``."""
    env = _jax(task)

    def post(state, action):
        ctx = JTaskContext(env, state)
        info = env.evaluate(state, ctx)
        return env._get_obs(state, ctx, info), env._get_reward(state, action, info, ctx), info

    return shared_jit(jax.vmap(post))


@functools.lru_cache(maxsize=None)
def _port(task):
    return mtt.make(task, num_envs=K, reward_mode="dense", device="cpu")


# ---- random_quaternion and the two robots ----------------------------------


@pytest.mark.parametrize("locks", [(), ("lock_x", "lock_y"), ("lock_x", "lock_y", "lock_z")],
                         ids=["shoemake", "yaw", "identity"])
def test_random_quaternion_matches_jax(locks):
    """``random_quaternion`` on JAX's uniforms (torch.rand handed the
    values ``jax.random.uniform`` draws from the same key): Shoemake's
    quaternion, the yaw-only one under lock_x and lock_y, the identity
    under all three; unit norm."""
    flags = {name: True for name in locks}
    key = jax.random.PRNGKey(7)
    ref = np.asarray(j_random_quaternion(key, (64,), **flags))
    shape = (64,) if len(locks) == 2 else (64, 3)
    u = torch.as_tensor(np.array(jax.random.uniform(key, shape)))
    with mock.patch.object(rotations.torch, "rand", lambda *a, **k: u.clone()):
        got = rotations.random_quaternion(torch.Generator(), (64,), **flags).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    if len(locks) == 2:
        assert not got[:, 1:3].any() and np.ptp(got[:, 0]) > 0.5


@pytest.mark.parametrize("mode", ["pd_joint_delta_pos", "pd_joint_pos"])
def test_trifinger_matches_jax(mode):
    """The TriFingerPro: its collision geoms (the three fingertip spheres,
    r 0.0155, friction 1.0), the rest keyframe, the tip links, the control
    mode's bounds and gains (kp 1e2, kd 1e1, force limit 20), and the
    fingertips' frames at the rest keyframe."""
    ta, ja = TriFingerPro(device="cpu", control_mode=mode), JTriFinger(control_mode=mode)
    got, ref = ta.collision_geoms(), ja.collision_geoms()
    assert len(got) == len(ref) and [int(g["type"]) for g in got][-3:] == [1, 1, 1]
    for g, r in zip(got, ref):
        assert g["link"] == r["link"] and g["friction"] == r["friction"]
        np.testing.assert_array_equal(g["size"], r["size"])
    assert ta.tip_link_names == ja.tip_link_names and ta.ee_link_name == ja.ee_link_name
    np.testing.assert_array_equal(ta.keyframes["rest"].qpos, ja.keyframes["rest"].qpos)
    c_t, c_j = ta.controller, ja.controller
    assert c_t.action_dim == c_j.action_dim == 9
    for name in ("action_low", "action_high", "kp", "kd", "force_limit"):
        np.testing.assert_array_equal(getattr(c_t, name), getattr(c_j, name), err_msg=name)
    q = ta.keyframes["rest"].qpos
    base = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
    bp, bq = chain.fk(ta.robot_spec, torch.as_tensor(base), torch.as_tensor(q)[None])[:2]
    jp, jq = jchain.fk(ja.robot_spec, jnp.asarray(base), jnp.asarray(q))[:2]
    for name in ta.tip_link_names:
        p, _ = chain.frame_pose(ta.robot_spec, torch.as_tensor(base), bp, bq, name)
        pj, _ = jchain.frame_pose(ja.robot_spec, jnp.asarray(base), jp, jq, name)
        np.testing.assert_allclose(p[0].numpy(), np.asarray(pj), atol=1e-6)


@pytest.mark.parametrize("mode", ["pd_joint_delta_pos", "pd_joint_pos"])
def test_dclaw_matches_jax(mode):
    """The D'Claw: ``auto_capsule_collisions`` (radius 0.018, tips 0.04,
    friction 1.0: nine capsules), the zero rest keyframe, the control
    mode's bounds and gains (kp 1e2, kd 5, force limit 20)."""
    ta, ja = DClaw(device="cpu", control_mode=mode), JDClaw(control_mode=mode)
    got, ref = ta.collision_geoms(), ja.collision_geoms()
    assert len(got) == len(ref) == 9
    for g, r in zip(got, ref):
        assert g["link"] == r["link"] and int(g["type"]) == int(r["type"]) == 3
        for k in ("size", "offset_p", "offset_q"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        assert g["friction"] == r["friction"] == 1.0
    np.testing.assert_array_equal(ta.keyframes["rest"].qpos, np.zeros(9, np.float32))
    np.testing.assert_array_equal(ta.keyframes["rest"].qpos, ja.keyframes["rest"].qpos)
    c_t, c_j = ta.controller, ja.controller
    assert c_t.action_dim == c_j.action_dim == 9
    for name in ("action_low", "action_high", "kp", "kd", "force_limit"):
        np.testing.assert_array_equal(getattr(c_t, name), getattr(c_j, name), err_msg=name)


# ---- the twelve ids ----------------------------------------------------------


def _check_tables(task):
    """nq, F, G, P, the kinematic bodies and the pair functions; the pair
    groups, geom table, model constants, assignment tables and static
    contact tables equal to the JAX model's; ``supports`` in both packages
    and the dispatch's choice of the kernel."""
    jm, tm = _jax(task).model, _port(task).model
    nq, F, G, P, fns, kin = TASKS[task]
    for m in (tm, jm):
        assert (m.nq, m.n_free, len(m.geoms), m.n_points, len(m.kin_index)) == (nq, F, G, P, kin)
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
    for name in ("ancestor_mask", "init_qpos", "static_pose", "free_mass", "free_inertia",
                 "drive_kp", "drive_kd", "drive_force_limit", "robot_base_pose", "robot_qlim",
                 "gravity_mask", "robot_inertia_com"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    for name in tm.art_dof_index:
        np.testing.assert_array_equal(tm.art_dof_index[name], jm.art_dof_index[name])
    for a, b in zip(teng._assignment_tables(tm), jeng._assignment_tables(jm)):
        np.testing.assert_array_equal(a, b)
    mt, mj = teng._trace_metadata(tm), jeng._trace_metadata(jm)
    for i in range(3):
        np.testing.assert_allclose(mt[i].numpy(), np.asarray(mj[i]), atol=1e-5)
    for i in range(3, 7):
        np.testing.assert_array_equal(mt[i].numpy(), np.asarray(mj[i]))
    assert list(mt[7]) == list(mj[7]) and list(mt[8]) == list(mj[8])
    assert megakernel.supports(tm) and jmk.supports(jm)
    assert isinstance(_port(task).kernel, megakernel.MegaKernel)
    if "Valve" in task:
        env = _port(task)
        assert env._hub == int(_jax(task)._hub) == 9
        np.testing.assert_array_equal(env._spoke_geoms, tm.geom_indices("valve:hub"))
        if "Level" in task:
            np.testing.assert_array_equal(env._spoke_geoms, _jax(task)._spoke_geoms)


def _draws(task, tenv, st):
    """The random draws of JAX's reset state ``st`` (numpy arrays by
    field) in the form of the port's ``_draw``."""
    sim, ex = st["sim"], st["extras"]

    def t(a):
        return torch.as_tensor(np.array(a))

    if task.startswith("TriFinger"):
        goal = sim["kin_pose"][:, tenv.obj_goal]
        return dict(xy=t(sim["free_pose"][:, tenv.obj, :2]), goal_p=t(goal[:, :3]),
                    goal_q=t(goal[:, 3:]))
    if task == "RotateCube-v1":
        v = ex["unit_vector"]
        return dict(xy=t(sim["free_pose"][:, tenv.obj, :2]),
                    angle=t(np.arctan2(v[:, 1], v[:, 0])))
    q0 = t(sim["qpos"][:, tenv._hub])
    if task == "RotateValveDClaw-v1":
        return dict(q0=q0)
    size = sim["geom_size"][:, tenv._spoke_geoms, 0]
    return dict(q0=q0, direction=t(ex["rotate_dir"]), active=t(size > 1e-3),
                scale=t(size / np.float32(tenv.spoke_len / 2)))


def _reset_from(tenv, st_j, draws):
    """The port's whole reset of K envs, its draws replaced by ``draws``
    and its initial joint noise by the JAX reset's joints."""
    qpos = torch.as_tensor(np.array(st_j["sim"]["qpos"]))
    tenv._draw = lambda gen, k: draws
    tenv._initial_sim_state = lambda k, gen: tenv.model.initial_state(k, "cpu").replace(
        qpos=qpos.clone())
    try:
        return tenv._reset_all(torch.Generator().manual_seed(0))
    finally:
        del tenv._draw, tenv._initial_sim_state


def _check_reset(task):
    """The port's reset from JAX's draws: the whole state (sim, command,
    extras) within 1e-6 of JAX's reset state, its obs and evaluate those
    of JAX's reset. The valve levels' heads: three at 0, 120 and 240
    degrees on Levels 0-1, 3-6 (several counts among the envs) on
    Levels 2-4; lengths scaled on Levels 3-4 only."""
    jenv, tenv = _jax(task), _port(task)
    st_j = np_tree(jenv._state)
    obs_j, info_j = jenv.reset_out
    draws = _draws(task, tenv, st_j)
    st, obs, info = _reset_from(tenv, st_j, draws)
    got = convert.to_numpy(st)
    for part in ("sim", "cmd"):
        for name, ref in st_j[part].items():
            if ref is not None and got[part].get(name) is not None:
                np.testing.assert_allclose(got[part][name], ref, atol=1e-6, err_msg=name)
    assert got["extras"].keys() == st_j["extras"].keys()
    for name, ref in st_j["extras"].items():
        np.testing.assert_allclose(got["extras"][name], ref, atol=1e-6, err_msg=name)
    _close(obs.numpy(), obs_j, "obs")
    assert info.keys() == info_j.keys()
    for key in info_j:
        _close(info[key].numpy(), info_j[key], key)
    if "Level" in task and "Valve" in task:
        heads = draws["active"].sum(1)
        if int(task[16]) >= 2:
            assert heads.min() >= 3 and heads.max() <= 6 and len(set(heads.tolist())) > 1
        else:
            assert draws["active"].tolist() == [[True, False] * 3] * K
        lengths = got["sim"]["geom_size"][:, tenv._spoke_geoms, 0][draws["active"].numpy()]
        assert (np.ptp(lengths) > 1e-3) == (int(task[16]) >= 3)


def _extras_f64(tenv, pre):
    """JAX's ``RotateCubeEnv._update_extras`` (maniskill_tpu
    envs/tasks/rotate_cube.py:89-107) written out in numpy float64 on the
    advanced state ``pre``: the tracked vector turned by the cube's
    orientation, projected off the rotation axis and normalised, the angle
    to the previous one ``arccos`` clipped to [0, 1 - 1e-7] at the bound
    JAX's float32 program holds (0.99999988), then to pi/20. The referee of
    the extras, independent of both packages' code."""
    ex = {k: v.double().numpy() for k, v in pre.extras.items()}
    q = pre.sim.free_pose[:, tenv.obj, 3:].double().numpy()
    u, w, v = q[:, 1:], q[:, :1], ex["unit_vector"]
    uv = np.cross(u, v)
    new = v + 2.0 * (w * uv + np.cross(u, uv))
    axis = ex["rot_dir"]
    new = new - np.sum(new * axis, -1, keepdims=True) * axis
    new = new / np.sqrt(np.sum(new * new, -1, keepdims=True) + 1e-12)
    dot = np.sum(new * ex["prev_unit_vector"], -1)
    angle = np.clip(np.arccos(np.clip(dot, 0.0, np.float64(np.float32(1 - 1e-7)))),
                    -np.pi / 20, np.pi / 20)
    return dict(ex, prev_unit_vector=new, rotation_angle=angle,
                cum_rotation_angle=ex["cum_rotation_angle"] + angle)


def _check_extras(tenv, pre, got, ref, label):
    """The port's updated extras ``got`` against JAX's ``ref``, both from
    the advanced state ``pre``. RotateCube's step angle is ``arccos`` of a
    dot product near 1, where an ulp of the dot moves the angle by
    6e-8 / sin(angle) (1.5e-5 at a 0.004 rad step): an env beyond 1e-5
    relative is refereed by JAX's formula in float64 (``_extras_f64``)
    under ``torch_parity.refereed``'s rule (neither package more than 3
    times further from it than the other, one env up to 10), and at most a
    quarter of the envs may be; distances are taken in units of each
    entry's tolerance. The valves' extras must agree."""
    ref = {k: np.asarray(v, np.float64) for k, v in ref.items()}
    tol = {k: REL * np.abs(ref[k]) + NEAR0 for k in ref}

    def scaled(d):
        return {k: np.asarray(d[k], np.float64) / tol[k] for k in ref}

    got = scaled({k: v.double().numpy() for k, v in got.items()})
    off = [k for k in ref if (np.abs(got[k] - ref[k] / tol[k]) > 1.0).any()]
    if not off:
        return
    assert "rotation_angle" in ref, (label, off)
    bad = refereed(got, scaled(ref), scaled(_extras_f64(tenv, pre)), dict.fromkeys(ref, 1.0))
    assert bad.sum() <= K // 4, (label, bad)


def _compare_step(task, st_j, action, label):
    """One env step of the port from the JAX state ``st_j`` against the
    JAX advance: the physics state (envs beyond a tolerance refereed; only
    envs in contact may be) and the command; then the port's extras
    against JAX's update on the port's own new state (``_check_extras``),
    and its obs, dense reward and evaluate against JAX's on the port's new
    state and extras. Returns the JAX state after the step and the
    refereed envs."""
    tenv = _port(task)
    st_t = convert.env_state_from_numpy(np_tree(st_j))
    st_j2 = _jax_advance(task)(st_j, jnp.asarray(action))
    st_t2, obs_t, rew_t, _, info_t = tenv._step(st_t, torch.as_tensor(action))
    got, ref = convert.to_numpy(st_t2.sim), np_tree(st_j2.sim)
    np.testing.assert_allclose(st_t2.cmd.target_qpos.numpy(), np.asarray(st_j2.cmd.target_qpos),
                               atol=1e-6)
    cmd = tenv.agent.controller.set_action(st_t.cmd, st_t.sim.qpos, torch.as_tensor(action))
    bad = refereed(got, ref, plain64(tenv.kernel, st_t.sim, cmd, tenv.sim_steps_per_control),
                   TOL)
    touch = ((st_t.sim.contact_lam > 0).any(1).numpy() | (got["contact_lam"] > 0).any(1)
             | (ref["contact_lam"] > 0).any(1))
    assert not (bad & ~touch).any(), (label, bad, touch)
    if st_t.extras:
        pre = st_t2.replace(extras=st_t.extras)
        _check_extras(tenv, pre, st_t2.extras, _jax_extras(task)(to_jax(st_j2, pre)), label)
    obs_j, rew_j, info_j = _jax_post(task)(to_jax(st_j2, st_t2), jnp.asarray(action))
    _close(obs_t.numpy(), obs_j, f"{label} obs")
    _close(rew_t.numpy(), rew_j, f"{label} reward")
    assert info_t.keys() == info_j.keys()
    for key in info_j:
        _close(info_t[key].numpy(), info_j[key], f"{label} {key}")
    return st_j2, bad


def _check_steps(task):
    """Three env steps from the JAX reset state with random actions in
    [-1, 1] (each from the JAX state of the one before), then one from the
    port's ``contact_state`` (carried back) under its own command: the
    physics state, extras, obs, dense reward and evaluate. From reset
    nothing touches the fingers, and every env agrees; in contact at most
    a quarter of the envs are refereed."""
    jenv, tenv = _jax(task), _port(task)
    rng = np.random.default_rng(sum(map(ord, task)))
    st_j = jenv._state
    for i in range(3):
        action = rng.uniform(-1.0, 1.0, (K, tenv.action_dim)).astype(np.float32)
        st_j, bad = _compare_step(task, st_j, action, f"step {i}")
        assert not bad.any(), (i, bad)
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
    tables; the reset from JAX's draws; env steps from the reset state and
    from a contact state."""
    {"tables": _check_tables, "reset": _check_reset, "steps": _check_steps}[check](task)


# ---- the port alone ------------------------------------------------------------


@pytest.mark.parametrize("task", list(TASKS))
def test_reset_draws_follow_the_jax_ranges(task):
    """The port's own reset draws (its generator, 64 envs) fall in the JAX
    task's ranges: the cube within 2 cm of the centre, at rest on the
    floor; the goal on the table (Levels 0-1), at the fixed aerial point
    (Level 2), in the air within the arena (Levels 3-4); its orientation
    the identity (Levels 0, 2, 3), a yaw (Level 1) or any unit quaternion
    (Level 4); RotateCube's tracked vector horizontal and of unit length;
    the valve's start angle in [-pi, pi], the direction +1 on Level 0 and
    both signs on Levels 1-4, 3-6 heads on Levels 2-4, lengths in [0.8,
    1.2] of the spoke's on Levels 3-4, inactive spokes 1 mm."""
    env = mtt.make(task, num_envs=64, device="cpu")
    env.reset(seed=3)
    sim, ex = env._state.sim, env._state.extras
    if "Valve" not in task:
        cube = sim.free_pose[:, env.obj]
        assert cube[:, :2].abs().max() <= 0.02 and (cube[:, 2] == env.cube_half_size).all()
        if task == "RotateCube-v1":
            v = ex["unit_vector"]
            assert not v[:, 2].any() and torch.allclose(v.norm(dim=-1), torch.ones(64))
            return
        lvl = env.difficulty_level
        goal = sim.kin_pose[:, env.obj_goal]
        r = goal[:, :2].norm(dim=-1)
        z, q = goal[:, 2], goal[:, 3:]
        assert torch.allclose(q.norm(dim=-1), torch.ones(64), atol=1e-6)
        if lvl == 2:
            assert torch.allclose(goal[:, :3], torch.tensor([0.0, 0.0, 0.0825]))
        else:
            assert r.max() <= env.max_com_dist + 1e-6 and r.std() > 0.01
        if lvl in (0, 1):
            assert (z == env.cube_half_size).all()
        elif lvl == 3:
            assert z.min() >= env.min_height and z.max() <= env.max_height
        elif lvl == 4:
            assert z.min() >= env.radius_3d - 1e-6 and z.max() <= env.max_height
        if lvl == 1:
            assert not q[:, 1:3].any() and q[:, 3].abs().max() > 0.5
        elif lvl == 4:
            assert q[:, 1:3].abs().max() > 0.5
        else:
            assert (q == torch.tensor([1.0, 0, 0, 0])).all()
        return
    q0 = sim.qpos[:, env._hub]
    assert q0.abs().max() <= math.pi and q0.std() > 1.0
    if task == "RotateValveDClaw-v1":
        assert torch.allclose(ex["target_angle"] - ex["init_angle"], torch.tensor(math.pi / 2))
        return
    d = ex["rotate_dir"]
    assert set(d.tolist()) == ({1.0} if "Level0" in task else {-1.0, 1.0})
    size = sim.geom_size[:, env._spoke_geoms]
    active = size[..., 0] > 1e-3
    assert (size[~active] == 1e-3).all()
    heads = active.sum(1)
    if int(task[16]) >= 2:
        assert set(heads.tolist()) == {3, 4, 5, 6}
    else:
        assert (heads == 3).all()
    scale = size[..., 0][active] / 0.045
    if int(task[16]) >= 3:
        assert scale.min() >= 0.8 and scale.max() <= 1.2 and scale.std() > 0.05
    else:
        assert torch.allclose(scale, torch.ones(()))


@pytest.mark.parametrize("task", ["TriFingerRotateCubeLevel4-v1", "RotateValveLevel2-v1"])
def test_contact_state_loads_the_fingers(task):
    """``contact_state`` (the kernel checks' contact states) from the
    port's reset, 16 envs: finite; in the plain control step from it the
    fingertip spheres press the cube (sphere_box points carry force, with
    friction) or the claw's capsules press an active spoke (capsule_box
    points on a spoke of full size) in at least three quarters of the
    envs."""
    from maniskill_tpu_torch.physics.engine import make_step_fn

    env = mtt.make(task, num_envs=16, device="cpu")
    env.reset(seed=0)
    cst = env.contact_state(env._state, torch.Generator().manual_seed(0))
    assert torch.isfinite(cst.sim.qpos).all() and torch.isfinite(cst.sim.qvel).all()
    plan = megakernel._Plan(env.model)
    sim, aux = make_step_fn(env.model)(cst.sim, cst.cmd, env.sim_steps_per_control,
                                       return_aux=True)
    loaded = (aux["f_pt"].abs().sum(-1) > 0) | (sim.contact_lam > 0)
    if "Valve" in task:
        spoke = torch.as_tensor(np.isin(plan.pga, env._spoke_geoms)
                                | np.isin(plan.pgb, env._spoke_geoms))
        geom = torch.as_tensor(np.where(np.isin(plan.pga, env._spoke_geoms), plan.pga, plan.pgb))
        on_active = (cst.sim.geom_size[:, geom, 0] > 1e-3) & spoke
        held = (loaded & on_active).any(1)
        assert not (loaded & spoke & ~on_active).any()
    else:
        fingers = torch.as_tensor(plan.pfn == megakernel._FNS.index("sphere_box"))
        held = loaded[:, fingers].any(1)
        assert (sim.contact_lam_t.abs().sum(-1) > 0)[:, fingers].any(1).float().mean() >= 0.75
    assert held.float().mean() >= 0.75, held
