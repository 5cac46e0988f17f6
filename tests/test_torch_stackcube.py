"""StackCube-v1 through the PyTorch port against the JAX package, on the CPU.

The same inputs go through both: JAX reset states carried across with
``maniskill_tpu_torch.convert``, states in contact built by the port and
carried back, poses and actions drawn with numpy. The JAX side runs its XLA
engine (``sim_backend="xla"``), the plain reference of its Pallas kernel.

Tolerances as tests/test_torch_pickcube.py (from
tests/test_megakernel.py:48-67): qpos 2e-5, qvel 2e-4, free pose 2e-5,
free vel 5e-4, impulses 5e-3 (newtons under a stiff implicit law), obs
2e-4, reward 1e-4; both sides are float32 and differ in the order of sums.
Narrowphase outputs are a few float32 operations deep: 1e-5.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maniskill_tpu as mst
from maniskill_tpu.physics import engine as jeng
from maniskill_tpu.physics import shapes as jshapes

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.envs.base_env import TaskContext
from maniskill_tpu_torch.physics import engine as teng
from maniskill_tpu_torch.physics import megakernel, shapes

K = 4
TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
           contact_lam=5e-3, contact_lam_t=5e-3)
BOX_BOX = 3  # index of box_box in the kernel's pair-function table


def _np(obj):
    """JAX dataclass/dict nest -> dict of numpy arrays (PRNG key dropped)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _np(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.name != "rng"}
    if isinstance(obj, dict):
        return {k: _np(v) for k, v in obj.items()}
    return None if obj is None else np.asarray(obj)


def _to_jax(like, port):
    """A port state moved into the JAX state ``like``; fields the port does
    not model (the PRNG key, hull tables) keep ``like``'s values."""
    if isinstance(like, dict):
        return {k: _to_jax(like[k], port[k]) for k in like}
    if not dataclasses.is_dataclass(like):
        return jnp.asarray(convert.to_numpy(port)).astype(like.dtype)
    return like.replace(**{f.name: _to_jax(getattr(like, f.name), getattr(port, f.name))
                           for f in dataclasses.fields(like)
                           if getattr(like, f.name) is not None
                           and getattr(port, f.name, None) is not None})


@pytest.fixture(scope="module")
def jenv():
    env = mst.make("StackCube-v1", num_envs=K, reward_mode="dense", sim_backend="xla")
    env.reset_out = env.reset(seed=0)
    return env


@pytest.fixture(scope="module")
def tenv():
    return mtt.make("StackCube-v1", num_envs=K, reward_mode="dense", device="cpu")


@pytest.fixture(scope="module")
def jstep(jenv):
    """The JAX env step (physics, evaluate, obs, reward), vmapped and
    jitted once for the module."""
    return jax.jit(jax.vmap(jenv._step_one))


def _random_box_poses(rng, n):
    """Pairs of 2 cm boxes: B above A at yaw and tilt, within 5 mm of
    touching, so corners and face centres land inside and outside."""
    half = np.full((n, 3), 0.02, np.float32)
    half[:, 2] = rng.uniform(0.01, 0.03, n)

    def quat(tilt):
        ax = rng.normal(size=(n, 3))
        ax /= np.linalg.norm(ax, axis=1, keepdims=True)
        ang = rng.uniform(-tilt, tilt, n)
        return np.concatenate([np.cos(ang / 2)[:, None], ax * np.sin(ang / 2)[:, None]], 1)

    pa = rng.uniform(-0.05, 0.05, (n, 3))
    pb = pa + np.stack([rng.uniform(-0.03, 0.03, n), rng.uniform(-0.03, 0.03, n),
                        half[:, 2] + 0.02 + rng.uniform(-0.005, 0.005, n)], 1)
    return [a.astype(np.float32) for a in (pa, quat(0.3), half, pb, quat(math.pi), half)]


def test_box_box_matches_jax():
    """The 28-point narrowphase on random near-contact poses: the corner
    and face-centre order, B->A normals and depths of the JAX function."""
    args = _random_box_poses(np.random.default_rng(0), 256)
    cj = jax.vmap(jshapes.box_box)(*map(jnp.asarray, args))
    ct = shapes.box_box(*map(torch.as_tensor, args))
    assert ct.pos.shape == (256, 28, 3) and ct.depth.shape == (256, 28)
    for got, ref in zip(ct, cj):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    depth = ct.depth.numpy()
    assert (depth > 0).sum() > 100 and (depth < 0).sum() > 1000  # both sides of contact
    # face centres of A carry contacts too, not only the corners
    assert (depth[:, 8:14] > 0).any() and (depth[:, 22:28] > 0).any()


def test_static_model_tables_match(jenv, tenv):
    """The pair table (cubeA-cubeB free-free -> box_box, cube-table ->
    box_box_onesided, finger-cube -> box_box_corners, cube-floor ->
    plane_box), the point order and sides, and one solve group holding
    the robot and both cubes."""
    jm, tm = jenv.model, tenv.model
    assert (tm.nq, tm.n_free, len(tm.geoms), tm.n_points) == (9, 2, 9, 260)
    assert [(g[0].__name__, g[1], len(g[2])) for g in tm.pair_groups] == [
        ("box_box", 28, 1), ("box_box_corners", 16, 10), ("box_box_onesided", 8, 7),
        ("plane_box", 8, 2)]
    for gt, gj in zip(tm.pair_groups, jm.pair_groups):
        assert gt[0].__name__ == gj[0].__name__ and gt[1] == gj[1]
        for a, b in zip(gt[2:], gj[2:]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(teng._assignment_tables(tm), jeng._assignment_tables(jm)):
        np.testing.assert_array_equal(a, b)
    mt, mj = teng._trace_metadata(tm), jeng._trace_metadata(jm)
    for i in range(3):
        np.testing.assert_allclose(mt[i].numpy(), np.asarray(mj[i]), atol=1e-6)
    for i in (7, 8):
        assert [tuple(map(int, m)) for m in mt[i]] == [tuple(map(int, m)) for m in mj[i]]
    # one monolithic solve: the robot touches both cubes and they touch
    # each other (the JAX step builds the same union-find groups inline)
    assert [g.tolist() for g in teng._solve_groups(tm)] == [list(range(21))]
    plan = megakernel._Plan(tm)
    assert (plan.R_in, plan.R_out, plan.n_all) == (1242, 1954, 21)
    assert plan.pfn[:28].tolist() == [BOX_BOX] * 28 and plan.pcorner[:28].tolist() == list(range(28))
    assert plan.pfa[:28].tolist() == [0] * 28 and plan.pfb[:28].tolist() == [1] * 28
    assert megakernel.supports(tm)


def test_reset_draws_follow_the_placement_rule(tenv):
    """The port draws with its own generator: cubes on the table at
    z = 2 cm, yaw-only, at least sqrt(2) half + 1 mm apart in xy unless
    the clip of cubeB's offset to [-0.1, 0.2] (the JAX rule's too) pulled
    it closer."""
    env = mtt.make("StackCube-v1", num_envs=256, device="cpu")
    env.reset(seed=3)
    fp = env._state.sim.free_pose
    np.testing.assert_allclose(fp[..., 2].numpy(), 0.02)
    np.testing.assert_allclose(fp[..., 4:6].numpy(), 0.0, atol=1e-7)
    gap = torch.linalg.norm(fp[:, 0, :2] - fp[:, 1, :2], dim=-1)
    assert float((gap >= math.sqrt(2) * 0.02 + 0.001 - 1e-6).float().mean()) >= 0.9
    assert float(fp[..., :2].min()) >= -0.2 - 1e-6 and float(fp[..., :2].max()) <= 0.3 + 1e-6


def test_reset_state_evaluate_and_obs_match(jenv, tenv):
    """The JAX reset state carried across: evaluate, obs (48-dim state obs)
    and the dense reward of the port agree with the JAX reset."""
    obs_j, info_j = jenv.reset_out
    st = convert.env_state_from_numpy(_np(jenv._state))
    assert st.sim.free_pose.shape == (K, 2, 7)
    ctx = TaskContext(tenv, st)
    info = tenv.evaluate(st, ctx)
    obs = tenv._get_obs(st, ctx, info)
    assert obs.shape == (K, 48)
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=2e-4)
    for key in info_j:
        np.testing.assert_array_equal(info[key].numpy(), np.asarray(info_j[key]), key)
    assert not info["success"].any() and info["is_cubeA_static"].all()


def _contact_states(jenv, tenv):
    st = tenv.contact_state(convert.env_state_from_numpy(_np(jenv._state)),
                            torch.Generator().manual_seed(0))
    return st, _to_jax(jenv._state, st)


def test_env_step_matches_from_reset_states(jenv, tenv, jstep):
    """One env step from the JAX reset state with random actions: physics
    state, obs, dense reward and every info flag."""
    action = np.random.default_rng(0).uniform(-1, 1, (K, 8)).astype(np.float32)
    st_j, obs_j, rew_j, _, info_j = jstep(jenv._state, jnp.asarray(action))
    st_t = convert.env_state_from_numpy(_np(jenv._state))
    st_t, obs_t, rew_t, _, info_t = tenv._step(st_t, torch.as_tensor(action))
    got = convert.to_numpy(st_t.sim)
    for name, tol in TOL.items():
        np.testing.assert_allclose(got[name], np.asarray(getattr(st_j.sim, name)), atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=2e-4)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-4)
    for key in info_j:
        np.testing.assert_array_equal(info_t[key].numpy(), np.asarray(info_j[key]), key)


def test_env_step_matches_from_contact_states(jenv, tenv, jstep):
    """One env step from states in contact (``StackCubeEnv.contact_state``:
    cubeA stacked on cubeB, or grasped with cubeB on the floor in every
    fourth env; warm impulses loaded): the cubeA-cubeB box_box points carry
    force, and state, obs, reward and flags (is_cubeA_on_cubeB,
    is_cubeA_grasped) agree with JAX."""
    st_t, st_j = _contact_states(jenv, tenv)
    action = np.random.default_rng(1).uniform(-0.3, 0.3, (K, 8)).astype(np.float32)
    st_j2, obs_j, rew_j, _, info_j = jstep(st_j, jnp.asarray(action))
    st_t2, obs_t, rew_t, _, info_t = tenv._step(st_t, torch.as_tensor(action))
    got = convert.to_numpy(st_t2.sim)
    for name, tol in TOL.items():
        np.testing.assert_allclose(got[name], np.asarray(getattr(st_j2.sim, name)), atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=2e-4)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-4)
    for key in info_j:
        np.testing.assert_array_equal(info_t[key].numpy(), np.asarray(info_j[key]), key)
    lam = np.asarray(st_j2.sim.contact_lam)
    stacked = np.arange(K) % 2 == 0
    assert (lam[stacked][:, :28] > 0).sum(1).min() >= 1  # box_box loaded in each stack
    assert np.asarray(info_j["is_cubeA_on_cubeB"])[stacked].all()
    assert np.asarray(info_j["is_cubeA_grasped"])[~stacked].any()


def test_normalized_reward_and_update_extras(tenv):
    """``_update_extras`` runs in every step after physics and before
    evaluate (JAX base_env.py:541, 571), and the normalized dense reward is
    the dense one over 8."""
    env = mtt.make("StackCube-v1", num_envs=2, device="cpu")
    seen = []

    def update(state, ctx):
        seen.append(int(state.elapsed_steps[0]))
        assert ctx.state.sim is state.sim
        return state.replace(extras=dict(state.extras, steps=state.elapsed_steps.clone()))

    env._update_extras = update
    env.reset(seed=0)
    _, rew, *_ = env.step(torch.zeros(8))
    st, rew2, _ = env._rollout_step(env._state, torch.zeros(2, 8))
    assert seen == [1, 2] and st.extras["steps"].tolist() == [2, 2]
    dense_env = mtt.make("StackCube-v1", num_envs=2, device="cpu", reward_mode="dense")
    dense_env.reset(seed=0)
    _, rew_d, *_ = dense_env.step(torch.zeros(8))
    torch.testing.assert_close(rew * 8.0, rew_d)


def test_actor_vel(tenv):
    """``TaskContext.actor_vel``: a free actor's (linear, angular)
    velocity; zeros for a kinematic one (PickCube's goal site)."""
    tenv.reset(seed=0)
    st = tenv.contact_state(tenv._state, torch.Generator().manual_seed(2))
    ctx = TaskContext(tenv, st)
    torch.testing.assert_close(ctx.actor_vel("cubeB"), st.sim.free_vel[:, 1])
    assert ctx.actor_vel("cubeA").abs().sum() > 0
    pick = mtt.make("PickCube-v1", num_envs=3, device="cpu")
    pick.reset(seed=0)
    zero = TaskContext(pick, pick._state).actor_vel("goal_site")
    assert zero.shape == (3, 6) and not zero.any()
