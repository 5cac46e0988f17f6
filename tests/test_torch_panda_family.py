"""The rest of the Panda family through the PyTorch port against the JAX
package, on the CPU: PickSingleObject-v1, AssemblingKits-v1,
FMBAssembly1Easy-v1, FrankaPickCubeBenchmark-v1, FrankaMoveBenchmark-v1,
CustomEnv-v1, and the Panda stick's PushT-v1, TableTopFreeDraw-v1,
DrawTriangle-v1 and DrawSVG-v1; the env's reset surface (a second reset
from the previous state, a partial reset, the sparse and none rewards).

The same inputs go through both: JAX reset states carried across with
``maniskill_tpu_torch.convert``, states in contact built by the port
(``contact_state``) and carried back, random actions from a numpy seed.
The JAX side runs its XLA engine (``sim_backend="xla"``), the plain
reference of its Pallas kernel. Each task's JAX env is
``torch_parity.jax_env``'s, built once per process; the cases are
task-major, and only the four new scenes (PushT, AssemblingKits,
FMBAssembly1Easy, DrawTriangle) compile a JAX env step, one for the reset
and the contact step together.

Tolerances: the env step those of tests/test_megakernel.py:48-67 (qpos
2e-5, qvel 2e-4, free pose 2e-5, free vel 5e-4, impulses 5e-3; the
kinematic poses, the dots, 2e-5); obs 2e-4, info 1e-5, rewards 1e-4;
extras exactly (integers, booleans) or within 1e-6 (the outline).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.envs.base_env import TaskContext as JTaskContext
from maniskill_tpu.physics import engine as jeng

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.envs.base_env import TaskContext
from maniskill_tpu_torch.physics import engine as teng
from maniskill_tpu_torch.physics import megakernel
from maniskill_tpu_torch.physics.shapes import GeomType
from torch_parity import (fast_trace_metadata, jax_env, shared_jit, np_tree as _np,
                         to_jax as _to_jax)

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)

K = 8
TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4, kin_pose=2e-5,
           contact_lam=5e-3, contact_lam_t=5e-3)
# (nq, F, G, P, n_kin, action dim, obs dim, pair functions) of each id
TASKS = {
    "PickSingleObject-v1": (9, 1, 8, 136, 1, 8, 46,
                            ["box_box_corners", "box_box_onesided", "plane_box"]),
    "AssemblingKits-v1": (9, 1, 12, 328, 1, 8, 45,
                          ["box_box_corners", "box_box_onesided", "plane_box"]),
    "FMBAssembly1Easy-v1": (9, 1, 11, 280, 1, 8, 35,
                            ["box_box_corners", "box_box_onesided", "plane_box"]),
    "FrankaPickCubeBenchmark-v1": (9, 1, 8, 136, 1, 8, 42,
                                   ["box_box_corners", "box_box_onesided", "plane_box"]),
    "FrankaMoveBenchmark-v1": (9, 0, 6, 40, 0, 8, 18, ["plane_box"]),
    "CustomEnv-v1": (9, 1, 8, 136, 1, 8, 35, ["box_box_corners", "box_box_onesided", "plane_box"]),
    "PushT-v1": (7, 1, 5, 69, 1, 7, 31, ["box_box", "box_box_onesided", "capsule_box", "plane_box"]),
    "TableTopFreeDraw-v1": (7, 0, 3, 3, 300, 7, 21, ["capsule_box"]),
    "DrawTriangle-v1": (7, 0, 3, 3, 300, 7, 57, ["capsule_box"]),
    "DrawSVG-v1": (7, 0, 3, 3, 500, 7, 57, ["capsule_box"]),
}
STEP_TASKS = ("PushT-v1", "AssemblingKits-v1", "FMBAssembly1Easy-v1", "DrawTriangle-v1")


@pytest.fixture(scope="module", autouse=True)
def _fast_jax_tables():
    """The JAX package's static contact tables through one jitted program
    (tests/torch_parity.py)."""
    with fast_trace_metadata():
        yield


def _jax(task):
    return jax_env(task, "pd_joint_delta_pos", K)


_PORT = {}


def _port(task, **kw):
    key = (task, tuple(sorted(kw.items())))
    if key not in _PORT:  # the JAX envs' reward mode (the Franka benchmarks': none)
        _PORT[key] = mtt.make(task, num_envs=K, device="cpu", reward_mode="dense", **kw)
    return _PORT[key]


def _from_jax(state):
    return convert.env_state_from_numpy(_np(state))


def _check_tables(task):
    """nq, F, G, P, the kinematic bodies, the action dim, the pair groups
    letter for letter, the per-point side tables, the geoms and the model
    constants; the kernel takes the model."""
    jenv, tenv = _jax(task), _port(task)
    jm, tm = jenv.model, tenv.model
    nq, F, G, P, nk, adim, _, fns = TASKS[task]
    assert (tm.nq, tm.n_free, len(tm.geoms), tm.n_points, tm.n_kin) == (nq, F, G, P, nk)
    assert (jm.nq, jm.n_free, len(jm.geoms), jm.n_points, jm.n_kin) == (nq, F, G, P, nk)
    assert tenv.action_dim == jenv.action_dim == adim
    assert tenv.sim_steps_per_control == jenv.sim_steps_per_control
    assert [g[0].__name__ for g in tm.pair_groups] == [g[0].__name__ for g in jm.pair_groups]
    assert sorted({g[0].__name__ for g in tm.pair_groups}) == fns
    for gt, gj in zip(tm.pair_groups, jm.pair_groups):
        assert gt[1] == gj[1]
        for a, b in zip(gt[2:], gj[2:]):
            np.testing.assert_array_equal(a, b)
    mt, mj = teng._trace_metadata(tm), jeng._trace_metadata(jm)
    for i in range(3):
        np.testing.assert_allclose(mt[i].numpy(), np.asarray(mj[i]), atol=1e-5)
    for i in range(3, 7):
        np.testing.assert_array_equal(mt[i].numpy(), np.asarray(mj[i]))
    for name in ("ancestor_mask", "init_qpos", "static_pose", "free_mass", "free_inertia",
                 "drive_kp", "drive_kd", "robot_base_pose"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    for a, b in zip(tm.geoms, jm.geoms):
        assert (a.kind, a.body, int(a.gtype), a.name) == (b.kind, b.body, int(b.gtype), b.name)
        for f in ("size", "offset_p", "offset_q", "friction"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(tenv.agent.controller.action_low,
                                  np.asarray(jenv.agent.controller.action_low))
    assert megakernel.supports(tm)


def _jax_rewards(jenv):
    """(dense, normalized dense, sparse) of the JAX env at its reset state,
    whatever its reward mode (one jitted program)."""
    def one(s):
        ctx = JTaskContext(jenv, s)
        info = jenv.evaluate(s, ctx)
        a = jnp.zeros(jenv.action_dim)
        return (jenv.compute_dense_reward(s, a, info, ctx),
                jenv.compute_normalized_dense_reward(s, a, info, ctx),
                jenv.compute_sparse_reward(s, a, info, ctx))

    return jax.jit(jax.vmap(one))(jenv.reset_state)


def _check_reset(task):
    """At the JAX reset state: the port's evaluate and state obs against
    the JAX reset's, its dense, normalized dense and sparse rewards against
    JAX's, and the none reward (the Franka benchmarks' mode) zeros."""
    jenv, tenv = _jax(task), _port(task)
    obs_j, info_j = jenv.reset_out
    st = _from_jax(jenv.reset_state)
    ctx = TaskContext(tenv, st)
    info = tenv.evaluate(st, ctx)
    obs = tenv._get_obs(st, ctx, info)
    assert obs.shape == np.shape(obs_j) == (K, TASKS[task][6])
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=2e-4)
    assert sorted(info) == sorted(info_j)
    for key in info_j:
        np.testing.assert_allclose(info[key].numpy(), np.asarray(info_j[key]), atol=1e-5,
                                   err_msg=key)
    action = torch.zeros(K, tenv.action_dim)
    dense_j, norm_j, sparse_j = _jax_rewards(jenv)
    for fn, want in ((tenv.compute_dense_reward, dense_j),
                     (tenv.compute_normalized_dense_reward, norm_j),
                     (tenv.compute_sparse_reward, sparse_j)):
        np.testing.assert_allclose(fn(st, action, info, ctx).numpy(), np.asarray(want),
                                   atol=1e-4, err_msg=fn.__name__)
    reward = tenv._get_reward(st, action, info, ctx)
    want = dict(none=np.zeros(K, np.float32), dense=dense_j)[tenv.reward_mode]
    np.testing.assert_allclose(reward.numpy(), np.asarray(want), atol=1e-4)
    for key in st.extras:
        np.testing.assert_array_equal(st.extras[key].numpy(),
                                      np.asarray(jenv.reset_state.extras[key]))


@functools.lru_cache(maxsize=None)
def _jstep(task):
    """The task's JAX env step, vmapped, compiled once among the workers."""
    return shared_jit(jax.vmap(_jax(task)._step_one))


def _check_step(task):
    """One env step from the JAX reset state with random actions, and one
    from the port's ``contact_state`` carried to the JAX env with the
    action zero (the arm holds): the physics state (the kinematic poses,
    the dots, included), obs, dense reward, every info entry and the
    extras. In contact the contact state's pair functions carry force in
    the JAX step: the stick against the T or the tabletop (capsule_box),
    the fingers on the piece or the beam (box_box_corners)."""
    jenv, tenv, jstep = _jax(task), _port(task), _jstep(task)
    plan = megakernel._Plan(tenv.model)
    pfn = np.asarray(megakernel._FNS)[plan.pfn]
    for states in ("reset", "contact"):
        st_t = _from_jax(jenv.reset_state)
        rng = np.random.default_rng(1)
        if states == "reset":
            st_j = jenv.reset_state
            action = rng.uniform(-0.3, 0.3, (K, tenv.action_dim)).astype(np.float32)
        else:
            st_t = tenv.contact_state(st_t, torch.Generator().manual_seed(0))
            st_j = _to_jax(jenv.reset_state, st_t)
            action = np.zeros((K, tenv.action_dim), np.float32)
            if tenv.action_dim == 8:
                action[:, 7] = -0.6  # the gripper shuts
        st_j2, obs_j, rew_j, _, info_j = jstep(st_j, jnp.asarray(action))
        st_t2, obs_t, rew_t, _, info_t = tenv._step(st_t, torch.as_tensor(action))
        got = convert.to_numpy(st_t2.sim)
        for name, tol in TOL.items():
            np.testing.assert_allclose(got[name], np.asarray(getattr(st_j2.sim, name)),
                                       atol=tol, err_msg=f"{states} {name}")
        np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=2e-4)
        np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-4)
        for key in info_j:
            np.testing.assert_allclose(info_t[key].numpy(), np.asarray(info_j[key]), atol=1e-5,
                                       err_msg=key)
        assert sorted(st_t2.extras) == sorted(st_j2.extras)
        for key in st_j2.extras:
            np.testing.assert_allclose(st_t2.extras[key].numpy(), np.asarray(st_j2.extras[key]),
                                       atol=1e-6, err_msg=key)
        if states == "contact":
            lam = np.asarray(st_j2.sim.contact_lam) > 0
            if task in ("PushT-v1", "DrawTriangle-v1"):
                assert lam[:, pfn == "capsule_box"].any(1).mean() >= 0.5
            else:
                assert lam[:, pfn == "box_box_corners"].any(1).mean() >= 0.5
            if task == "DrawTriangle-v1":  # the stick touched the canvas: dot 0 placed
                assert bool(st_t2.extras["drew_any"].all())
                d0 = tenv.dot_ids[0]
                np.testing.assert_allclose(got["kin_pose"][:, d0, 2], tenv.DOT_THICKNESS / 2)


def _check_prev(task):
    """The reconfiguration_freq branch at frequency 2 against the JAX
    ``_init_with_prev``: from the reset state (episode 1) the object is kept
    (the size, mass, inertia of the previous episode; PickSingleHull: its
    library row and hull tables), from that (episode 2) a new one is drawn;
    the port is fed JAX's draws (read from JAX's result: half sizes and
    densities, or library rows) and must give the same geom_size,
    free_mass, free_inertia and episode_count."""
    jenv, tenv = _jax(task), _port(task, reconfiguration_freq=2)
    jenv.reconfiguration_freq = 2
    try:
        init = jax.jit(jax.vmap(jenv._init_with_prev))
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(jnp.arange(K))
        prev_j = jenv.reset_state
        prev_t = _from_jax(prev_j)
        gidx = tenv.model.geom_indices("cube")[0]
        for episode in (1, 2):
            new_j = init(jenv.reset_state, keys, prev_j)
            sim = new_j.sim
            if task == "PickSingleObject-v1":
                half = torch.as_tensor(np.asarray(sim.geom_size[:, gidx]))
                m = torch.as_tensor(np.asarray(sim.free_mass[:, tenv.cube]))
                density = m / (8.0 * half.prod(-1))
                tenv._draw_object = lambda gen, k: (half, density)
            else:
                mid = torch.as_tensor(np.asarray(new_j.extras["model_id"])).long()
                tenv._draw_model = lambda gen, k: mid
            new_t = tenv._init_with_prev(_from_jax(jenv.reset_state), torch.Generator(), prev_t)
            kept = episode == 1
            for name in ("geom_size", "free_mass", "free_inertia"):
                got, want = getattr(new_t.sim, name).numpy(), np.asarray(getattr(sim, name))
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9, err_msg=name)
                if kept:
                    np.testing.assert_allclose(got, getattr(prev_t.sim, name).numpy(),
                                               rtol=1e-6, atol=1e-9, err_msg=name)
            assert (new_t.extras["episode_count"].numpy() == episode + 1).all()
            for key in new_j.extras:
                np.testing.assert_array_equal(new_t.extras[key].numpy(),
                                              np.asarray(new_j.extras[key]), err_msg=key)
            prev_j, prev_t = new_j, new_t
    finally:
        jenv.reconfiguration_freq = 1
        tenv.__dict__.pop("_draw_object", None)
        tenv.__dict__.pop("_draw_model", None)


TASK_CHECKS = ([(t, c) for t in TASKS
                for c in ("tables", "reset") + (("step",) if t in STEP_TASKS else ())
                + (("prev",) if t == "PickSingleObject-v1" else ())]
               + [("PickSingleHull-v1", "prev")])


@pytest.mark.parametrize("task, check", TASK_CHECKS, ids=[f"{t}-{c}" for t, c in TASK_CHECKS])
def test_task_matches_jax(task, check):
    """One check of a task against the JAX package, on the process's one
    JAX env of that task."""
    {"tables": _check_tables, "reset": _check_reset, "step": _check_step,
     "prev": _check_prev}[check](task)


def test_pusht_intersection_is_one_at_the_goal():
    """The T placed on the goal T covers all 512 sample points (success);
    moved 2 cm sideways or turned a quarter turn, less than the threshold."""
    env = _port("PushT-v1")
    env.reset(seed=0)
    st = env._state
    goal = st.sim.kin_pose[:, env.goal_tee]
    fp = st.sim.free_pose.clone()
    fp[:, env.tee] = goal
    fp[1, env.tee, 0] += 0.02
    fp[2, env.tee, 3:] = torch.tensor([math.cos(math.pi / 4), 0, 0, math.sin(math.pi / 4)])
    st = st.replace(sim=st.sim.replace(free_pose=fp))
    info = env.evaluate(st, TaskContext(env, st))
    inter = info["intersection"].numpy()
    assert inter[0] == 1.0 and bool(info["success"][0])
    assert 0.0 < inter[1] < 0.9 and 0.0 < inter[2] < 0.9
    assert not bool(info["success"][1:3].any())


def test_dots_follow_the_tip():
    """TableTopFreeDraw's ``_update_extras``: where the tip touches the
    canvas, the dot of index ``elapsed_steps - 1`` (clipped to the budget)
    sits under it at half the dot's thickness; elsewhere that dot is
    parked; every other dot is untouched."""
    env = _port("TableTopFreeDraw-v1")
    env.reset(seed=0)
    st = env.contact_state(env._state, torch.Generator().manual_seed(0))
    up = env._state  # the reset pose: the tip far above the canvas
    qpos = torch.where((torch.arange(K) % 2 == 0)[:, None], st.sim.qpos, up.sim.qpos)
    steps = torch.tensor([1, 2, 5, 5, 300, 300, 1000, 7], dtype=torch.int32)
    st = st.replace(sim=st.sim.replace(qpos=qpos), elapsed_steps=steps)
    ctx = TaskContext(env, st)
    tip = ctx.tcp_pose.p
    out = env._update_extras(st, ctx).sim.kin_pose
    d0 = env.dot_ids[0]
    idx = d0 + torch.clamp(steps.long() - 1, 0, env.MAX_DOTS - 1)
    for k in range(K):
        touching = bool(tip[k, 2] < env.DOT_THICKNESS + 0.005)
        assert touching == (k % 2 == 0)
        want = (torch.cat([tip[k, :2], torch.tensor([env.DOT_THICKNESS / 2, 1, 0, 0, 0])])
                if touching else torch.tensor([0, 0, -env.DOT_THICKNESS, 1, 0, 0, 0]))
        torch.testing.assert_close(out[k, idx[k]], want.to(torch.float32))
        others = torch.ones(out.shape[1], dtype=torch.bool)
        others[idx[k]] = False
        assert torch.equal(out[k, others], st.sim.kin_pose[k, others])


def test_draw_triangle_success_logic():
    """As the JAX package's tests/test_draw_targets.py:28: no success after
    a step with the stick up; with a completed drawing fabricated in the
    extras, a step that draws nothing keeps full coverage and succeeds;
    one touch far from the outline clears ``dots_ok``."""
    env = _port("DrawTriangle-v1")
    env.reset(seed=0)
    zero = torch.zeros(K, env.action_dim)
    *_, info = env.step(zero)
    assert not bool(info["success"].any())
    ex = env._state.extras
    env._state = env._state.replace(extras=dict(
        ex, ref_hit=torch.ones_like(ex["ref_hit"]), dots_ok=torch.ones_like(ex["dots_ok"]),
        drew_any=torch.ones_like(ex["drew_any"])))
    *_, info = env.step(zero)
    assert (info["outline_coverage"].numpy() == 1.0).all() and bool(info["success"].all())
    st = env.contact_state(env._state, torch.Generator().manual_seed(0))
    outline = st.extras["outline"]
    tip = TaskContext(env, st).tcp_pose.p
    far = (torch.linalg.norm(outline - tip[:, None, :2], dim=-1) >= env.THRESHOLD).all(-1)
    st2 = env._update_extras(st, TaskContext(env, st))
    assert torch.equal(st2.extras["dots_ok"], ~far)
    assert far.any()


def test_partial_reset_keeps_the_other_envs():
    """``reset(options={"env_idx": ...})`` after some steps: the envs not
    named keep every state field bit for bit; the named ones start an
    episode (elapsed 0, the object count of a reset from their previous
    state); a plain second reset passes each env's previous state (the
    episode count goes on), and the first reset starts at 1."""
    env = mtt.make("PickSingleObject-v1", num_envs=K, device="cpu", reconfiguration_freq=2)
    env.reset(seed=0)
    assert (env._state.extras["episode_count"].numpy() == 1).all()
    rng = np.random.default_rng(0)
    for _ in range(2):
        env.step(rng.uniform(-1, 1, (K, 8)).astype(np.float32))
    before = env._state
    idx = [1, 4, 6]
    env.reset(seed=5, options={"env_idx": idx})
    after = env._state
    named = torch.zeros(K, dtype=torch.bool)
    named[idx] = True
    flat_b, flat_a = convert.to_numpy(before), convert.to_numpy(after)

    def leaves(d, path=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{path}{k}.")
            elif v is not None:
                yield f"{path}{k}", v

    moved = dict(leaves(flat_a))
    for name, b in leaves(flat_b):
        np.testing.assert_array_equal(moved[name][~named.numpy()], b[~named.numpy()],
                                      err_msg=name)
    assert (after.elapsed_steps[named] == 0).all() and (before.elapsed_steps[named] == 2).all()
    assert (after.extras["episode_count"][named] == 2).all()
    assert (after.extras["episode_count"][~named] == 1).all()
    # freq 2: episode 1 keeps its object into episode 2
    torch.testing.assert_close(after.sim.geom_size[named], before.sim.geom_size[named],
                               rtol=0, atol=0)
    env.reset()
    assert (env._state.extras["episode_count"] == after.extras["episode_count"] + 1).all()


@pytest.mark.parametrize("task", ["PushT-v1", "FrankaMoveBenchmark-v1"])
def test_reward_modes(task):
    """Sparse is success minus fail and none is zeros, through ``step``; the
    Franka benchmarks accept only none."""
    modes = ("none",) if task.startswith("Franka") else ("sparse", "none", "dense")
    for mode in modes:
        env = mtt.make(task, num_envs=2, device="cpu", reward_mode=mode)
        env.reset(seed=0)
        _, reward, _, _, info = env.step(np.zeros(env.action_dim, np.float32))
        if mode == "sparse":
            torch.testing.assert_close(reward, info["success"].to(torch.float32))
        elif mode == "none":
            assert torch.equal(reward, torch.zeros(2))
    if task.startswith("Franka"):
        assert mtt.make(task, num_envs=1, device="cpu", reward_mode="dense").reward_mode == "none"
    else:
        with pytest.raises(ValueError):
            mtt.make(task, num_envs=1, device="cpu", reward_mode="sparse_dense")


def test_panda_stick_matches_jax():
    """The Panda stick: 7 dofs, the rest keyframe, the stick a capsule of
    r = 0.008 on the hand, the four control modes and their action boxes as
    the JAX agent's."""
    from maniskill_tpu.agents.robots.panda_stick import PandaStick as JStick

    from maniskill_tpu_torch.agents.robots.panda_stick import PandaStick

    for mode in PandaStick(device="cpu").supported_control_modes:
        t, j = PandaStick(device="cpu", control_mode=mode), JStick(control_mode=mode)
        assert t.nq == 7 and t.controller.action_dim == j.controller.action_dim
        np.testing.assert_array_equal(t.controller.action_low, np.asarray(j.controller.action_low))
        np.testing.assert_array_equal(t.controller.action_high,
                                      np.asarray(j.controller.action_high))
    assert list(PandaStick(device="cpu").supported_control_modes) == list(
        JStick()._controller_configs())
    np.testing.assert_array_equal(PandaStick.keyframes["rest"].qpos, JStick.keyframes["rest"].qpos)
    caps = [g for g in PandaStick(device="cpu").collision_geoms() if g["type"] == GeomType.CAPSULE]
    jcaps = [g for g in JStick().collision_geoms() if int(g["type"]) == int(GeomType.CAPSULE)]
    assert len(caps) == len(jcaps) == 1 and caps[0]["link"] == jcaps[0]["link"]
    for f in ("size", "offset_p", "offset_q"):
        np.testing.assert_allclose(caps[0][f], jcaps[0][f], err_msg=f)
    np.testing.assert_allclose(caps[0]["size"][0], 0.008)
