"""Spheres and capsules through the PyTorch port against the JAX package, on
the CPU: the eight pair functions, PlugCharger-v1 (a charger of a box and two
capsule prongs, 20 substeps a control step) and RollBall-v1 (a free ball, a
kinematic goal region, the ``reached`` latch).

The same inputs go through both: poses drawn with numpy (random near-contact
poses and degenerate ones: parallel and crossing capsules, a sphere centre on
a box's face, edge, corner or centre, a capsule end on the plane), JAX reset
states carried across with ``maniskill_tpu_torch.convert``, states in contact
built by the port and carried back, and the JAX MPPI noise. The JAX side
runs its XLA engine (``sim_backend="xla"``), the plain reference of its
Pallas kernel. Each task's JAX env and its jitted env step are built once
per process and shared by the tests that need them.

Tolerances: narrowphase outputs 1e-5 (a few float32 operations); the env
step those of tests/test_megakernel.py:48-67 (qpos 2e-5, qvel 2e-4, free
pose 2e-5, free vel 5e-4, impulses 5e-3), for PlugCharger (20 substeps a
control step) those the JAX package holds its own kernel to on that scene
(tests/test_megakernel_big.py:46-67: qpos 3e-5, free pose 3e-5, free vel
1e-3); obs 2e-4, reward and MPPI 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.physics import engine as jeng
from maniskill_tpu.physics import shapes as jshapes
from maniskill_tpu.planners.mppi import MPPI as JMPPI, MPPIConfig as JMPPIConfig

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.envs.base_env import TaskContext
from maniskill_tpu_torch.physics import engine as teng
from maniskill_tpu_torch.physics import megakernel, shapes
from maniskill_tpu_torch.planners.mppi import MPPI, MPPIConfig
from torch_parity import (fast_trace_metadata, shared_jit, make_jax_env, np_tree as _np,
                         to_jax as _to_jax)

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _fast_jax_tables():
    """The JAX package's static contact tables through one jitted program
    (tests/torch_parity.py): its env builds take seconds, not tens."""
    with fast_trace_metadata():
        yield

K = 8
TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
           contact_lam=5e-3, contact_lam_t=5e-3)
# PlugCharger steps 20 substeps a control step (4 x the cube scenes'), and
# float32 rounding grows with them: the JAX package holds its own kernel to
# its XLA engine on this scene at these (tests/test_megakernel_big.py:46-67)
PLUG_TOL = dict(qpos=3e-5, qvel=5e-4, free_pose=3e-5, free_vel=1e-3,
                contact_lam=5e-3, contact_lam_t=5e-3)
TASKS = ("PlugCharger-v1", "RollBall-v1")
ROUND_FNS = ("plane_sphere", "sphere_box", "box_sphere", "sphere_sphere", "plane_capsule",
             "sphere_capsule", "capsule_box", "capsule_capsule")


@functools.lru_cache(maxsize=None)
def _jax(task):
    """The task's JAX env (K envs, reset with seed 0, its reset outputs in
    ``reset_out``) and its env step, vmapped and jitted: one of each per
    process, shared by every test that needs them."""
    env = make_jax_env(task, num_envs=K, reward_mode="dense", sim_backend="xla")
    env.reset_out = env.reset(seed=0)
    return env, shared_jit(jax.vmap(env._step_one))


@functools.lru_cache(maxsize=None)
def _port(task):
    return mtt.make(task, num_envs=K, reward_mode="dense", device="cpu")


# ---- the pair functions -------------------------------------------------------


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _pair_inputs(name, rng):
    """(pa, qa, sa, pb, qb, sb) of 256 random near-contact pairs and a few
    degenerate ones, float32."""
    n = 256
    r_a, r_b = rng.uniform(0.01, 0.04, n), rng.uniform(0.01, 0.04, n)
    hl_a, hl_b = rng.uniform(0.0, 0.05, n), rng.uniform(0.0, 0.05, n)
    half = rng.uniform(0.01, 0.05, (n, 3))
    qa, qb = _quats(rng, n), _quats(rng, n)
    pa = rng.uniform(-0.05, 0.05, (n, 3))
    zero3 = np.zeros((n, 3))
    sphere = lambda r: np.stack([r, 0 * r, 0 * r], 1)  # noqa: E731
    capsule = lambda r, hl: np.stack([r, hl, 0 * r], 1)  # noqa: E731
    ident = np.tile([1.0, 0, 0, 0], (n, 1))
    near = lambda scale: pa + rng.normal(size=(n, 3)) * scale  # noqa: E731
    if name in ("plane_sphere", "plane_capsule"):
        # B's centre within a few cm of the plane A through pa
        sb = sphere(r_b) if name == "plane_sphere" else capsule(r_b, hl_b)
        nrm = np.stack([2 * (qa[:, 1] * qa[:, 3] + qa[:, 0] * qa[:, 2]),
                        2 * (qa[:, 2] * qa[:, 3] - qa[:, 0] * qa[:, 1]),
                        1 - 2 * (qa[:, 1] ** 2 + qa[:, 2] ** 2)], 1)
        pb = near(0.05) + nrm * (r_b + rng.uniform(-0.02, 0.02, n))[:, None]
        # degenerate: axis-aligned plane and capsule, the end sphere exactly
        # on the plane (depth 0) or the end point in it
        qa[:8], pa[:8] = ident[:8], 0.0
        qb[:8] = ident[:8]
        pb[:4] = np.stack([zero3[:4, 0], zero3[:4, 0], sb[:4, 0] + sb[:4, 1]], 1)
        pb[4:8] = np.stack([zero3[4:8, 0], zero3[4:8, 0], sb[4:8, 1]], 1)
        return pa, qa, zero3, pb, qb, sb
    if name in ("sphere_box", "box_sphere"):
        # the sphere around the box's surface; degenerate: centre on a face,
        # an edge, a corner, at the box's centre
        pb = pa + rng.normal(size=(n, 3)) * (half.max(1) + r_a)[:, None] * 0.8
        qb[:16] = ident[:16]
        for i, sgn in enumerate(([1, 0, 0], [0, -1, 0], [1, 1, 0], [1, -1, 1], [0, 0, 0])):
            pb[3 * i:3 * i + 3] = pa[3 * i:3 * i + 3] + np.asarray(sgn) * half[3 * i:3 * i + 3]
        if name == "sphere_box":  # the box at pa turned by qb, the sphere at pb
            return pb, qa, sphere(r_a), pa, qb, half
        return pa, qb, half, pb, qa, sphere(r_a)
    if name == "sphere_sphere":
        pb = near(0.04)
        pb[:4] = pa[:4]  # coincident centres
        return pa, qa, sphere(r_a), pb, qb, sphere(r_b)
    if name == "sphere_capsule":
        pb = near(0.05)
        # degenerate: the sphere's centre on the capsule's axis (a zero
        # normal), and beyond its end (the clip)
        qb[:12] = ident[:12]
        pb[:8] = pa[:8] - np.stack([zero3[:8, 0], zero3[:8, 0],
                                    np.r_[0.3 * hl_b[:4], hl_b[4:8] + 0.01]], 1)
        # and level with its end, off the axis: the clip at a tie
        pa[8:12] = 0.0
        pb[8:12] = np.stack([rng.uniform(-0.02, 0.02, 4), rng.uniform(-0.02, 0.02, 4),
                             -hl_b[8:12]], 1)
        return pa, qa, sphere(r_a), pb, qb, capsule(r_b, hl_b)
    if name == "capsule_box":
        pb = pa + rng.normal(size=(n, 3)) * (half.max(1) + r_a)[:, None] * 0.8
        # degenerate: axis-aligned capsule through the box's face centre
        qa[:8], qb[:8] = ident[:8], ident[:8]
        pb[:8] = pa[:8] - np.stack([zero3[:8, 0], zero3[:8, 0],
                                    half[:8, 2] + r_a[:8] * rng.uniform(0.5, 1.5, 8)], 1)
        return pa, qa, capsule(r_a, hl_a), pb, qb, half
    if name == "capsule_capsule":
        pb = near(0.04)
        # degenerate: parallel (identity) and anti-parallel (a half turn
        # about x) capsules, exact unit axes; crossing at right angles
        qa[:16] = ident[:16]
        qb[:4] = ident[:4]
        qb[4:8] = np.tile([0.0, 1.0, 0, 0], (4, 1))
        qb[8:16] = np.tile([np.sqrt(0.5), np.sqrt(0.5), 0, 0], (8, 1))
        # crossing with B level with A's end: A's clip at a tie
        pa[12:16] = 0.0
        pb[12:16] = np.stack([rng.uniform(-0.02, 0.02, 4), rng.uniform(-0.02, 0.02, 4),
                              hl_a[12:16]], 1)
        return pa, qa, capsule(r_a, hl_a), pb, qb, capsule(r_b, hl_b)
    raise KeyError(name)


@pytest.mark.parametrize("name", ROUND_FNS)
def test_round_shapes_match_jax(name):
    """Each sphere and capsule pair function on random near-contact and
    degenerate poses: points, B->A normals and depths of the JAX function,
    and contacts on both sides of zero depth."""
    args = [a.astype(np.float32) for a in _pair_inputs(name, np.random.default_rng(7))]
    cj = jax.jit(jax.vmap(getattr(jshapes, name)))(*map(jnp.asarray, args))
    ct = getattr(shapes, name)(*map(torch.as_tensor, args))
    n_pts = {"plane_capsule": 2, "capsule_box": 3}.get(name, 1)
    assert ct.pos.shape == (256, n_pts, 3) and ct.depth.shape == (256, n_pts)
    for got, ref, what in zip(ct, cj, ("pos", "normal", "depth")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, err_msg=what)
    depth = ct.depth.numpy()
    assert (depth > 0).sum() >= 16 and (depth < 0).sum() >= 16
    # the contact_fn table resolves the canonical pair to this function
    types = {"plane": 0, "sphere": 1, "box": 2, "capsule": 3}
    a, b = name.split("_")
    fn, k, swapped = shapes.contact_fn(types[a], types[b])
    assert (fn.__name__, k, swapped) == (name, n_pts, False)


@pytest.mark.parametrize("name", ROUND_FNS)
def test_round_shapes_jvp_match_jax(name):
    """The forward-mode derivative of each sphere and capsule pair function
    along random tangents of both poses, on the inputs of
    ``test_round_shapes_match_jax`` (its degenerate ties included: parallel
    capsules, a sphere centre on a box's face, edge or corner, a capsule
    end on the plane), against ``jax.jvp`` of the JAX function: the port's
    clamps take JAX's derivative at a tie. Tolerance: 1e-3 of each pair's
    largest tangent (at least 1); near a box edge a normal's tangent grows
    as one over the distance and amplifies float32 rounding."""
    args = [a.astype(np.float32) for a in _pair_inputs(name, np.random.default_rng(7))]
    rng = np.random.default_rng(11)
    tans = [rng.normal(size=a.shape).astype(np.float32) if i in (0, 1, 3, 4)
            else np.zeros_like(a) for i, a in enumerate(args)]  # sizes held
    fj = getattr(jshapes, name)
    jv = jax.jit(jax.vmap(lambda *xt: jax.jvp(lambda *x: tuple(fj(*x)), xt[:6], xt[6:])[1]))
    ref = jv(*map(jnp.asarray, args + tans))
    _, got = torch.func.jvp(lambda *x: tuple(getattr(shapes, name)(*x)),
                            tuple(map(torch.as_tensor, args)), tuple(map(torch.as_tensor, tans)))
    for g, r, what in zip(got, ref, ("pos", "normal", "depth")):
        g, r = g.numpy().reshape(256, -1), np.asarray(r).reshape(256, -1)
        assert np.isfinite(r).all() and np.isfinite(g).all(), what
        scale = np.maximum(np.abs(r).max(1), 1.0)
        assert (np.abs(g - r).max(1) <= 1e-3 * scale).all(), what


@pytest.mark.parametrize("gtype, size", [(1, [0.03, 0, 0]), (3, [0.0025, 0.0055, 0]),
                                         (2, [0.1, 0.2, 0.3]), (5, [0.01, 0.02, 0.03])],
                         ids=["sphere", "capsule", "box", "hull"])
def test_geom_local_half_extents_match_jax(gtype, size):
    """Local AABB half extents of a sphere, a capsule, a box and a hull."""
    np.testing.assert_array_equal(shapes.geom_local_half_extents(gtype, size),
                                  jshapes.geom_local_half_extents(gtype, size))


# ---- the two tasks ----------------------------------------------------------------


def _check_tables(task):
    """Pair groups (functions, point counts, sides, friction) letter for
    letter, the per-point side tables and the initial contacts, and the
    model constants; PlugCharger keeps the JAX table's pairs of the
    charger with itself (the two prongs, capsule_capsule; each prong and
    the base, capsule_box)."""
    jm, tm = _jax(task)[0].model, _port(task).model
    P, G, subs = dict(zip(TASKS, ((453, 15, 4), (47, 8, 1))))[task]
    assert (tm.n_points, len(tm.geoms), tm.params.substeps) == (P, G, subs)
    assert (tm.n_points, len(tm.geoms), tm.params.substeps) == (
        jm.n_points, len(jm.geoms), jm.params.substeps)
    assert [g[0].__name__ for g in tm.pair_groups] == [g[0].__name__ for g in jm.pair_groups]
    for gt, gj in zip(tm.pair_groups, jm.pair_groups):
        assert gt[1] == gj[1]
        for a, b in zip(gt[2:], gj[2:]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(teng._assignment_tables(tm), jeng._assignment_tables(jm)):
        np.testing.assert_array_equal(a, b)
    mt, mj = teng._trace_metadata(tm), jeng._trace_metadata(jm)
    for i in range(3):  # initial contacts: narrowphase outputs
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
        for f in ("size", "offset_p", "offset_q"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    plan = megakernel._Plan(tm)
    self_pairs = sorted({(int(a), int(b)) for a, b, fa, fb in
                         zip(plan.pga, plan.pgb, plan.pfa, plan.pfb) if fa >= 0 and fa == fb})
    names = [(tm.geoms[a].gtype.name, tm.geoms[b].gtype.name) for a, b in self_pairs]
    assert names == ([("CAPSULE", "BOX"), ("CAPSULE", "CAPSULE"), ("CAPSULE", "BOX")]
                     if task == "PlugCharger-v1" else [])
    assert megakernel.supports(tm)


def _check_reset(task):
    """The JAX reset state carried across: evaluate and the state obs of
    the port agree with the JAX reset's."""
    jenv, _ = _jax(task)
    tenv = _port(task)
    obs_j, info_j = jenv.reset_out
    st = convert.env_state_from_numpy(_np(jenv._state))
    ctx = TaskContext(tenv, st)
    info = tenv.evaluate(st, ctx)
    obs = tenv._get_obs(st, ctx, info)
    assert obs.shape == np.shape(obs_j) == (K, {"PlugCharger-v1": 39, "RollBall-v1": 44}[task])
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=2e-4)
    for key in info_j:
        np.testing.assert_allclose(info[key].numpy(), np.asarray(info_j[key]), atol=1e-5,
                                   err_msg=key)


def _success_state(jenv):
    """The JAX reset state with the task solved, as the JAX package's own
    tests pose it (tests/test_plug_charger.py:33-47,
    tests/test_task_tail.py:89-102): the charger at rest at its goal pose,
    its prongs in the receptacle's slots; the ball at rest on the table
    at the goal region's centre."""
    st = jenv._state
    sim = st.sim
    if hasattr(jenv, "charger"):
        sim = sim.replace(free_pose=sim.free_pose.at[:, jenv.charger].set(
                              jnp.asarray(jenv._goal_pose)),
                          free_vel=sim.free_vel * 0.0, contact_lam=sim.contact_lam * 0.0,
                          contact_lam_t=sim.contact_lam_t * 0.0)
    else:
        goal = sim.kin_pose[:, jenv.goal_region, :2]
        rest = jnp.broadcast_to(jnp.asarray([jenv.ball_radius, 1.0, 0, 0, 0], jnp.float32),
                                (K, 5))
        sim = sim.replace(free_pose=sim.free_pose.at[:, jenv.ball].set(
                              jnp.concatenate([goal, rest], 1)),
                          free_vel=sim.free_vel.at[:, jenv.ball].set(0.0))
    return st.replace(sim=sim)


def _branches(task, plan, lam):
    """What must carry force in the task's contact states (per env group of
    its ``contact_state``)."""
    pfn = np.asarray(megakernel._FNS)[plan.pfn]
    robot = (plan.pra >= 0) | (plan.prb >= 0)
    idx = np.arange(K)
    if task == "PlugCharger-v1":
        wall = (pfn == "capsule_box") & ~robot & (plan.pfa != plan.pfb) & (plan.pgb >= 10)
        return {
            "prong-receptacle capsule_box": lam[idx % 4 == 0][:, wall].any(1),
            "prong-finger capsule_box": lam[idx % 4 == 1][:, (pfn == "capsule_box") & robot].any(1),
            "base box_box_corners": lam[idx % 4 != 3][:, pfn == "box_box_corners"].any(1),
            "plane_capsule": lam[idx % 8 == 3][:, pfn == "plane_capsule"].any(1),
            "plane_box": lam[idx % 8 == 7][:, pfn == "plane_box"].any(1),
        }
    finger, floor = idx % 8 == 0, idx % 4 == 3
    return {
        "ball-finger sphere_box": lam[finger][:, (pfn == "sphere_box") & robot].any(1),
        "ball-table sphere_box": lam[~finger & ~floor][:, (pfn == "sphere_box") & ~robot].any(1),
        "plane_sphere": lam[floor][:, pfn == "plane_sphere"].any(1),
    }


def _check_step(task, states):
    """One env step from the JAX reset state with random actions, or from
    ``contact_state`` states, carried to the JAX env, with the action that
    keeps their command (arm held, gripper shut: moved targets in these
    grasps leave float32 rounding amplified beyond the tolerances, in the
    plain step against a float64 one too; see chip_smoke.py), or from the
    solved state of ``_success_state`` with the zero action: the physics
    state, obs, dense reward and every info flag (RollBall's ``reached``
    latch too; from the solved state JAX's ``success`` holds in every env).
    In contact, every branch its ``contact_state`` names carries force in
    the JAX step's warm-start impulses."""
    jenv, jstep = _jax(task)
    tenv = _port(task)
    if states == "reset":
        st_t, st_j = convert.env_state_from_numpy(_np(jenv._state)), jenv._state
        action = np.random.default_rng(1).uniform(-0.3, 0.3, (K, 8)).astype(np.float32)
    elif states == "success":
        st_j = _success_state(jenv)
        st_t = convert.env_state_from_numpy(_np(st_j))
        action = np.zeros((K, 8), np.float32)
    else:
        st_t = tenv.contact_state(convert.env_state_from_numpy(_np(jenv._state)),
                                  torch.Generator().manual_seed(0))
        st_j = _to_jax(jenv._state, st_t)
        # the contact state's own command: the arm holds, the gripper shuts
        action = np.tile(np.float32([0.0] * 7 + [-0.6]), (K, 1))
    st_j2, obs_j, rew_j, _, info_j = jstep(st_j, jnp.asarray(action))
    st_t2, obs_t, rew_t, _, info_t = tenv._step(st_t, torch.as_tensor(action))
    if states == "success":
        assert np.asarray(info_j["success"]).all()
    got = convert.to_numpy(st_t2.sim)
    for name, tol in (PLUG_TOL if task == "PlugCharger-v1" else TOL).items():
        np.testing.assert_allclose(got[name], np.asarray(getattr(st_j2.sim, name)), atol=tol,
                                   err_msg=f"{states} {name}")
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=2e-4)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-4)
    for key in info_j:
        np.testing.assert_allclose(info_t[key].numpy(), np.asarray(info_j[key]), atol=1e-5,
                                   err_msg=key)
    for key in st_j2.extras:
        np.testing.assert_array_equal(st_t2.extras[key].numpy(), np.asarray(st_j2.extras[key]))
    if states == "contact":
        lam = np.asarray(st_j2.sim.contact_lam) > 0
        for label, holds in _branches(task, megakernel._Plan(tenv.model), lam).items():
            assert holds.mean() >= 0.5, label


def _check_mppi_rollball():
    """One RollBall MPPI solve at K=8, H=2 (sigma 0.6, temperature 0.3) with
    the JAX noise injected: the nominal and the rollout returns match."""
    jenv, _ = _jax("RollBall-v1")
    tenv = _port("RollBall-v1")
    Ks, H = 8, 2
    cfg = dict(horizon=H, num_samples=Ks, sigma=0.6, temperature=0.3)
    jp = JMPPI(jenv, JMPPIConfig(**cfg))
    ps_j = jp.init(seed=0)
    ps_j2, info_j = jp.solve(ps_j, jax.tree.map(lambda x: x[0], jenv._state))
    white = np.asarray(jax.random.normal(jax.random.split(ps_j.key)[1], (Ks, H, 8)))
    tp = MPPI(tenv, MPPIConfig(**cfg))
    st_t = convert.env_state_from_numpy(_np(jax.tree.map(lambda x: x[:1], jenv._state)))
    ps_t, info_t = tp.solve(tp.init(seed=0), st_t, noise=torch.tensor(white))
    for key in ("best_return", "mean_return"):
        np.testing.assert_allclose(float(info_t[key]), float(info_j[key]), atol=1e-4)
    np.testing.assert_allclose(ps_t.nominal.numpy(), np.asarray(ps_j2.nominal), atol=1e-4)


# task-major, so that the consecutive cases of one task tend to land on one
# worker, which then builds that task's JAX env and compiles its step once;
# the tables case of a task goes by the task's name alone
TASK_CHECKS = [(task, check) for task in TASKS
               for check in ("tables", "reset", "step_reset", "step_contact", "step_success")
               + (("mppi",) if task == "RollBall-v1" else ())]


@pytest.mark.parametrize("task, check", TASK_CHECKS,
                         ids=[t if c == "tables" else f"{t}-{c}" for t, c in TASK_CHECKS])
def test_task_matches_jax(task, check):
    """One check of a task against the JAX package, on the process's one
    JAX env and one compiled JAX env step of that task (``_jax``): the
    static pair tables, evaluate and obs at the JAX reset state, one env
    step from that state, one from ``contact_state`` states; for RollBall
    also an MPPI solve with the JAX noise (``_check_*``)."""
    if check == "tables":
        _check_tables(task)
    elif check == "reset":
        _check_reset(task)
    elif check == "mppi":
        _check_mppi_rollball()
    else:
        _check_step(task, check.split("_")[1])


@pytest.mark.parametrize("task", TASKS)
def test_reset_draws_follow_the_jax_ranges(task):
    """The port's own reset draws (its generator, not JAX's) within the JAX
    task's ranges: the charger's xy and yaw on the table; the ball's and
    the goal region's xy, and the ``reached`` latch cleared."""
    env = mtt.make(task, num_envs=256, device="cpu")
    env.reset(seed=3)
    fp = env._state.sim.free_pose[:, 0]
    if task == "PlugCharger-v1":
        assert float(fp[:, 0].min()) >= -0.12 and float(fp[:, 0].max()) <= -0.03
        yaw = 2 * torch.atan2(fp[:, 6], fp[:, 3])
        assert float(yaw.abs().max()) <= np.pi / 6 + 1e-6
        np.testing.assert_allclose(fp[:, 2].numpy(), 0.012)
    else:
        gp = env._state.sim.kin_pose[:, 0]
        assert float(fp[:, 0].min()) >= 0.0 and float(fp[:, 0].max()) <= 0.15
        assert float(gp[:, 0].min()) >= -0.65 and float(gp[:, 0].max()) <= -0.35
        assert not env._state.extras["reached"].any()


@pytest.mark.parametrize("task, top", list(zip(TASKS, (6.0, 30.0))), ids=TASKS)
def test_normalized_reward_and_reached_latch(task, top):
    """The normalized dense rewards are the dense ones over 6 (PlugCharger)
    and 30 (RollBall); RollBall's ``reached`` latch holds once set."""
    dense = mtt.make(task, num_envs=2, device="cpu", reward_mode="dense")
    norm = mtt.make(task, num_envs=2, device="cpu")
    for e in (dense, norm):
        e.reset(seed=0)
    _, rew_d, *_ = dense.step(torch.zeros(8))
    _, rew_n, *_ = norm.step(torch.zeros(8))
    torch.testing.assert_close(rew_n * top, rew_d)
    if task != "RollBall-v1":
        return
    st = dense._state
    st = st.replace(extras=dict(st.extras, reached=torch.tensor([1.0, 0.0])))
    st2 = dense._update_extras(st, TaskContext(dense, st))
    assert st2.extras["reached"][0] == 1.0
