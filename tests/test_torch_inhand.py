"""Hulls against spheres, capsules and hulls, and the Allegro in-hand tasks,
through the PyTorch port against the JAX package, on the CPU.

Covered: the pair functions ``sphere_hull``, ``capsule_hull`` and
``hull_hull`` (values and forward-mode derivatives, on random and degenerate
poses); ``auto_capsule_collisions`` on the Allegro hand and its forward
kinematics at the cradle keyframe; the five in-hand ids
(RotateCubeInHandAllegro-v1, RotateSingleObjectInHandLevel0-v1 to
Level3-v1): pair tables, reset evaluate and obs, an env step from reset and
one from a settled contact state (one case, one compiled JAX env step per
task and process), Level2 MPPI with the JAX noise, the port's own reset
draws and each task's normalized reward; the
hull stack (``physics/hull_stack.py``: sphere_hull and hull_hull loaded)
through the port's plain step and the JAX engine; ``convert`` with two
hull slots.

The same inputs go through both: poses drawn with numpy, JAX reset states
carried across with ``maniskill_tpu_torch.convert``, states in contact
built by the port and carried back, the JAX MPPI noise. The JAX side runs
its XLA engine (``sim_backend="xla"``), the plain reference of its Pallas
kernel. Each task's JAX env and its jitted env step are built once per
process and shared by the cases that need them (``_jax``); the cases run
in task-major order.

Tolerances: narrowphase outputs 1e-5 (a few float32 operations; the JAX
hull SDF takes its face distances by a matmul, the port in the kernel's
fixed order); derivatives 1e-3 of each pair's largest tangent (at least
1); the env step those of tests/test_megakernel.py:48-67 (qpos 2e-5, qvel
2e-4, free pose 2e-5, free vel 5e-4, impulses 5e-3), obs 2e-4, reward and
MPPI 1e-4, the cumulative angle 4e-5 (twice a quaternion's angle). A
light object dropped on 16 capsules is stiff: in such an env the JAX
float32 step itself can leave the tolerances of a float64 step (free vel
1.3e-3 from it in one of eight reset envs). An env where the port and JAX
differ beyond a tolerance is refereed by the port's plain step run in
float64: JAX must be beyond that tolerance of the float64 step there, and
the port may leave it in at most one env more than JAX does.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.agents.base_agent import auto_capsule_collisions as j_auto_capsules
from maniskill_tpu.agents.robots.panda import Panda as JPanda
from maniskill_tpu.agents.robots.xarm import AllegroHandRight as JAllegro
from maniskill_tpu.kinematics import chain as jchain
from maniskill_tpu.physics import engine as jeng
from maniskill_tpu.physics import hulls as jhulls
from maniskill_tpu.physics import megakernel as jmk
from maniskill_tpu.physics import model as jmodel
from maniskill_tpu.physics import shapes as jshapes
from maniskill_tpu.planners.mppi import MPPI as JMPPI, MPPIConfig as JMPPIConfig

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.agents.base_agent import auto_capsule_collisions
from maniskill_tpu_torch.agents.robots.xarm import AllegroHandRight
from maniskill_tpu_torch.envs.base_env import TaskContext
from maniskill_tpu_torch.kinematics import chain
from maniskill_tpu_torch.math.rotations import quat_mul
from maniskill_tpu_torch.physics import engine as teng
from maniskill_tpu_torch.physics import hull_stack, hulls, megakernel, shapes
from maniskill_tpu_torch.planners.mppi import MPPI, MPPIConfig
from torch_parity import (fast_trace_metadata, shared_jit, make_jax_env, plain64, np_tree as _np,
                         to_jax as _to_jax)

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _fast_jax_tables():
    """The JAX package's static contact tables through one jitted program
    (tests/torch_parity.py): its env builds take seconds, not tens. The
    module's envs and compiled steps are dropped at its end, so that the
    worker does not carry them into the tests that follow."""
    with fast_trace_metadata():
        yield
    _jax.cache_clear()
    _port.cache_clear()


K = 8
TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
           contact_lam=5e-3, contact_lam_t=5e-3)
TASKS = ("RotateCubeInHandAllegro-v1", "RotateSingleObjectInHandLevel0-v1",
         "RotateSingleObjectInHandLevel1-v1", "RotateSingleObjectInHandLevel2-v1",
         "RotateSingleObjectInHandLevel3-v1")
HULL_FNS = ("sphere_hull", "capsule_hull", "hull_hull")


def _refereed(got, ref, f64, tols):
    """Envs where the port's state ``got`` leaves the JAX state ``ref``
    beyond a tolerance. There the JAX float32 step itself must leave that
    tolerance of the float64 step ``f64`` (the env is ill-conditioned), and
    over all envs the port may leave it in at most one env more than JAX
    does. Dicts of numpy arrays by field."""
    out = np.zeros(K, bool)
    for name, tol in tols.items():
        err = np.abs(got[name] - ref[name]).reshape(K, -1).max(1)
        err64 = np.abs(got[name] - f64[name]).reshape(K, -1).max(1)
        jerr64 = np.abs(ref[name] - f64[name]).reshape(K, -1).max(1)
        bad = err > tol
        assert (jerr64[bad] > tol).all(), (name, err[bad], err64[bad], jerr64[bad])
        assert (err64 > tol).sum() <= (jerr64 > tol).sum() + 1, (name, err64, jerr64)
        out |= bad
    return out


# ---- the pair functions -------------------------------------------------------


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _box_faces(half):
    """An axis-aligned box's face planes with exact normals, padded to
    HULL_F as make_hull pads."""
    f = [[s * (i == 0), s * (i == 1), s * (i == 2), half[i]] for i in range(3) for s in (1, -1)]
    f += [[0.0, 0.0, 1.0, 1e6]] * (hulls.HULL_F - 6)
    return np.asarray(f, np.float32)


def _box_cloud(half):
    """A box hull's contact cloud: corners, face centres and edge midpoints
    (26 points), padded with the centre."""
    pts = [[sx * half[0], sy * half[1], sz * half[2]] for sx in (-1, 0, 1)
           for sy in (-1, 0, 1) for sz in (-1, 0, 1) if (sx, sy, sz) != (0, 0, 0)]
    pts += [[0.0, 0.0, 0.0]] * (hulls.HULL_P - len(pts))
    return np.asarray(pts, np.float32)


def _hull_pair_inputs(name, rng):
    """Arguments of a hull pair function for 128 random near-contact pairs
    (library hulls at random orientations) and a few degenerate ones at
    exact ties: an axis-aligned box hull with exact face normals, and
    sphere_hull: the centre level with two faces (an edge: the normal is
    their mean), on a face at zero depth, at the centre of a cube hull
    (six faces tie: a zero normal); capsule_hull: the axis parallel to a
    face, its samples on or beside it; hull_hull: two box hulls stacked
    exactly (zero depth), A's corners within B's top face."""
    n = 128
    cpts, faces = hulls.pad_library(hulls.standard_object_library())[:2]
    pick_a, pick_b = rng.integers(0, 8, n), rng.integers(0, 8, n)
    pa = rng.uniform(-0.03, 0.03, (n, 3))
    pb = pa + rng.normal(size=(n, 3)) * 0.03
    qa, qb = _quats(rng, n), _quats(rng, n)
    r = rng.uniform(0.01, 0.03, n)
    hl = rng.uniform(0.0, 0.04, n)
    sa = np.stack([r, hl, 0 * r], 1)
    sb = np.zeros((n, 3))
    va, fa, vb, fb = cpts[pick_a], faces[pick_a], cpts[pick_b], faces[pick_b]
    ident = np.array([1.0, 0, 0, 0])
    # binary fractions: sums and differences of these are exact in float32,
    # so the ties below are exact
    half = np.float32([2 ** -5, 2 ** -6, 3 * 2 ** -7])
    cube = np.float32([2 ** -6] * 3)
    exact = np.float32([2 ** -8, 2 ** -7, 3 * 2 ** -8, 2 ** -6])
    d = 16  # degenerate cases at the front
    qb[:d] = ident
    pb[:d] = 0.0
    fb[:d], vb[:d] = _box_faces(half), _box_cloud(half)
    if name == "sphere_hull":
        sa[0:8, 0] = np.tile(exact, 2)
        pa[0:4] = np.stack([half[0] + exact, half[1] + exact, 0 * exact], 1)  # an edge
        pa[4:8] = np.stack([0 * exact, 0 * exact, half[2] + exact], 1)  # zero depth
        pa[8:12] = 0.0
        fb[8:12] = _box_faces(cube)
        pa[12:16] = np.stack([np.full(4, half[0] - 0.004), rng.uniform(-0.01, 0.01, 4),
                              rng.uniform(-0.01, 0.01, 4)], 1)  # inside, near +x
        return pa, qa, sa, pb, qb, sb, vb, fb
    if name == "capsule_hull":
        qa[:d] = ident  # the axis along z: parallel to the x and y faces
        hl[:d] = np.minimum(hl[:d], 0.02)
        sa[:, 1] = hl
        pa[0:4] = np.stack([half[0] + r[0:4], rng.uniform(-0.01, 0.01, 4), 0 * r[0:4]], 1)
        pa[4:8] = np.stack([half[0] + 0.5 * r[4:8], half[1] + 0.5 * r[4:8], 0 * r[4:8]], 1)
        pa[8:16] = np.stack([half[0] + rng.uniform(-0.5, 1.5, 8) * r[8:16],
                             rng.uniform(-0.01, 0.01, 8), rng.uniform(-0.01, 0.01, 8)], 1)
        return pa, qa, sa, pb, qb, sb, vb, fb
    if name == "hull_hull":
        small = np.float32([2 ** -7, 5 * 2 ** -9, 3 * 2 ** -8])
        qa[:d] = ident
        fa[:d], va[:d] = _box_faces(small), _box_cloud(small)
        pa[:d] = np.stack([rng.uniform(-0.01, 0.01, d), rng.uniform(-0.005, 0.005, d),
                           np.full(d, half[2] + small[2])], 1)  # on B's top face
        pa[8:d, 2] -= rng.uniform(0.0, 0.005, d - 8)  # and a little into it
        return pa, qa, sa * 0, pb, qb, sb, va, fa, vb, fb
    raise KeyError(name)


@pytest.mark.parametrize("name", HULL_FNS)
def test_hull_pair_shapes_match_jax(name):
    """Each hull pair function on random near-contact and degenerate poses:
    points, B->A normals and depths of the JAX function, contacts on both
    sides of zero depth, exact normals at the degenerate ties; the
    ``contact_fn`` table resolves the canonical pair to it, with its point
    count and ``hull_args``."""
    args = [a.astype(np.float32) for a in _hull_pair_inputs(name, np.random.default_rng(5))]
    cj = jax.jit(jax.vmap(getattr(jshapes, name)))(*map(jnp.asarray, args))
    ct = getattr(shapes, name)(*map(torch.as_tensor, args))
    n_pts = {"sphere_hull": 1, "capsule_hull": 3, "hull_hull": 2 * hulls.HULL_P}[name]
    assert ct.pos.shape == (128, n_pts, 3) and ct.depth.shape == (128, n_pts)
    for got, ref, what in zip(ct, cj, ("pos", "normal", "depth")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, err_msg=what)
    depth = ct.depth.numpy()
    assert (depth > 0).sum() >= 8 and (depth < 0).sum() >= 8
    nrm = ct.normal.numpy()
    if name == "sphere_hull":
        np.testing.assert_allclose(nrm[0:4, 0], [[math.sqrt(0.5), math.sqrt(0.5), 0]] * 4,
                                   atol=1e-6)  # an edge: two faces' mean
        np.testing.assert_array_equal(depth[4:8, 0], 0.0)
        np.testing.assert_array_equal(nrm[8:12, 0], 0.0)  # six faces tie
    elif name == "capsule_hull":
        np.testing.assert_allclose(depth[0:4], 0.0, atol=1e-8)  # parallel, touching
        np.testing.assert_allclose(nrm[0:4], [[[1.0, 0, 0]] * 3] * 4, atol=1e-6)
    else:
        np.testing.assert_array_equal(depth[0:8, [0, 6, 17, 23]], 0.0)  # A's bottom corners
        assert (depth[8:16, :hulls.HULL_P] > 0).any(1).all()
    types = {"sphere": 1, "capsule": 3, "hull": 5}
    a, b = name.split("_")
    fn, k, swapped = shapes.contact_fn(types[a], types[b])
    assert (fn.__name__, k, swapped) == (name, n_pts, False)
    assert fn.hull_args == getattr(jshapes, name).hull_args


@pytest.mark.parametrize("name", HULL_FNS)
def test_hull_pair_shapes_jvp_match_jax(name):
    """The forward-mode derivative of each hull pair function along random
    tangents of both poses (sizes and hull tables held), on the inputs of
    ``test_hull_pair_shapes_match_jax`` with its exact ties, against
    ``jax.jvp`` of the JAX function; where JAX's tangent is not finite
    (a zero normal's norm), the port's is not either. Tolerance: 1e-3 of
    each pair's largest tangent (at least 1)."""
    args = [a.astype(np.float32) for a in _hull_pair_inputs(name, np.random.default_rng(5))]
    rng = np.random.default_rng(11)
    tans = [rng.normal(size=a.shape).astype(np.float32) if i in (0, 1, 3, 4)
            else np.zeros_like(a) for i, a in enumerate(args)]
    n = len(args)
    fj = getattr(jshapes, name)
    jv = jax.jit(jax.vmap(lambda *xt: jax.jvp(lambda *x: tuple(fj(*x)), xt[:n], xt[n:])[1]))
    ref = jv(*map(jnp.asarray, args + tans))
    _, got = torch.func.jvp(lambda *x: tuple(getattr(shapes, name)(*x)),
                            tuple(map(torch.as_tensor, args)), tuple(map(torch.as_tensor, tans)))
    for g, r, what in zip(got, ref, ("pos", "normal", "depth")):
        g, r = g.numpy().reshape(128, -1), np.asarray(r).reshape(128, -1)
        fin = np.isfinite(r).all(1)
        # at a cube hull's centre (sphere_hull rows 8-11) the six faces'
        # mean normal is zero and its norm's derivative is not finite: in
        # both packages, in the same rows
        assert fin.sum() >= (124 if name == "sphere_hull" else 128), what
        np.testing.assert_array_equal(np.isfinite(g).all(1), fin, err_msg=what)
        scale = np.maximum(np.abs(r[fin]).max(1), 1.0)
        assert (np.abs(g[fin] - r[fin]).max(1) <= 1e-3 * scale).all(), what


# ---- the Allegro hand ---------------------------------------------------------


def test_allegro_capsules_match_jax():
    """``auto_capsule_collisions`` on the Allegro spec (radius 0.014, tips
    0.035, friction 1.0: 16 capsules, one per link, a tip capsule on each
    of the four leaf links) equals the JAX package's."""
    got, ref = AllegroHandRight(device="cpu").collision_geoms(), JAllegro().collision_geoms()
    assert len(got) == len(ref) == 16
    for g, r in zip(got, ref):
        assert g["link"] == r["link"] and int(g["type"]) == int(r["type"]) == 3
        for k in ("size", "offset_p", "offset_q"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        assert g["friction"] == r["friction"] == 1.0


def test_auto_capsules_skip_massless_links_and_make_spheres():
    """``auto_capsule_collisions`` on the Allegro spec with a massless link
    (skipped) and a child joint at its parent's origin (a zero-length
    segment: a sphere) equals the JAX package's."""
    spec_t, spec_j = AllegroHandRight(device="cpu").robot_spec, JAllegro().robot_spec
    for spec in (spec_t, spec_j):
        spec.mass = spec.mass.copy()
        spec.mass[5] = 0.0
        spec.joint_pos = spec.joint_pos.copy()
        spec.joint_pos[2] = 0.0
    got = auto_capsule_collisions(spec_t, default_radius=0.02, tip_length=0.05)
    ref = j_auto_capsules(spec_j, default_radius=0.02, tip_length=0.05)
    assert [int(g["type"]) for g in got] == [int(r["type"]) for r in ref]
    assert 1 in [int(g["type"]) for g in got] and len(got) == 15
    for g, r in zip(got, ref):
        for k in ("size", "offset_p", "offset_q"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("mode", ["pd_joint_delta_pos", "pd_joint_pos"])
def test_allegro_control_modes_match_jax(mode):
    """The cradle keyframe and each control mode (no mimic joint: 16
    actions; ``pd_joint_pos`` takes raw, unnormalized targets within the
    joint limits) equal the JAX agent's: action bounds and gains."""
    ta, ja = AllegroHandRight(device="cpu", control_mode=mode), JAllegro(control_mode=mode)
    np.testing.assert_array_equal(ta.keyframes["rest"].qpos, ja.keyframes["rest"].qpos)
    c_t, c_j = ta.controller, ja.controller
    assert c_t.action_dim == c_j.action_dim == 16
    np.testing.assert_array_equal(c_t.action_low, c_j.action_low)
    np.testing.assert_array_equal(c_t.action_high, c_j.action_high)
    for name in ("kp", "kd", "force_limit"):
        np.testing.assert_array_equal(getattr(c_t, name), getattr(c_j, name), err_msg=name)


def test_allegro_fk_at_the_cradle_keyframe_matches_jax():
    """Forward kinematics of the upturned hand (base quaternion with
    negative w) at the cradle keyframe: body positions and orientations."""
    q = AllegroHandRight(device="cpu").keyframes["rest"].qpos
    assert q[13] == np.float32(0.35) and q.shape == (16,)
    spec = AllegroHandRight(device="cpu").robot_spec
    pose = np.array([0.0, 0.0, 0.18, -0.7071068, 0.0, 0.7071068, 0.0], np.float32)
    bp, bq = chain.fk(spec, torch.as_tensor(pose), torch.as_tensor(q)[None])[:2]
    jp, jq = jchain.fk(JAllegro().robot_spec, jnp.asarray(pose), jnp.asarray(q))[:2]
    np.testing.assert_allclose(bp[0].numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(bq[0].numpy(), np.asarray(jq), atol=1e-6)


# ---- the five tasks -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax(task):
    """The task's JAX env (K envs, reset with seed 0, its reset outputs in
    ``reset_out``) and its env step, vmapped and jitted: one of each per
    process, shared by every case that needs them."""
    env = make_jax_env(task, num_envs=K, reward_mode="dense", sim_backend="xla")
    env.reset_out = env.reset(seed=0)
    return env, shared_jit(jax.vmap(env._step_one))


@functools.lru_cache(maxsize=None)
def _port(task):
    return mtt.make(task, num_envs=K, reward_mode="dense", device="cpu")


def _check_tables(task):
    """Pair groups letter for letter (capsule_hull 16 x 3 for the hull
    levels, capsule_box 16 x 3 for the cubes; plane_capsule 16 x 2; P=80),
    the per-point side tables, the initial contacts, the model constants
    (nq 16, n_all 22) and the kernel's support, in both packages."""
    jm, tm = _jax(task)[0].model, _port(task).model
    hull = "Level2" in task or "Level3" in task
    assert [(g[0].__name__, g[1], len(g[2])) for g in tm.pair_groups] == [
        ("capsule_hull" if hull else "capsule_box", 3, 16), ("plane_capsule", 2, 16)]
    assert (tm.n_points, tm.nq, tm.n_free, len(tm.geoms), tm.n_hull) == (80, 16, 1, 18, int(hull))
    for gt, gj in zip(tm.pair_groups, jm.pair_groups):
        assert gt[0].__name__ == gj[0].__name__ and gt[1] == gj[1]
        for a, b in zip(gt[2:], gj[2:]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(teng._assignment_tables(tm), jeng._assignment_tables(jm)):
        np.testing.assert_array_equal(a, b)
    mt, mj = teng._trace_metadata(tm), jeng._trace_metadata(jm)
    for i in range(3):
        np.testing.assert_allclose(mt[i].numpy(), np.asarray(mj[i]), atol=1e-5)
    for i in range(3, 7):
        np.testing.assert_array_equal(mt[i].numpy(), np.asarray(mj[i]))
    for name in ("ancestor_mask", "init_qpos", "static_pose", "free_mass", "free_inertia",
                 "drive_kp", "drive_kd", "drive_force_limit", "robot_base_pose",
                 "geom_hull_slot"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    for a, b in zip(tm.geoms, jm.geoms):
        assert (a.kind, a.body, int(a.gtype), a.name) == (b.kind, b.body, int(b.gtype), b.name)
        for f in ("size", "offset_p", "offset_q"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert tm.robot_base_pose[3] < 0  # the upturned hand: a quaternion with negative w
    plan = megakernel._Plan(tm)
    assert plan.n_all == 22 and megakernel.supports(tm) and jmk.supports(jm)


def _check_reset(task):
    """The JAX reset state carried across: evaluate and the 40-dim state
    obs agree; Level1's per-env cube sizes, masses and inertias and the
    hull levels' per-env tables come across with it."""
    jenv, _ = _jax(task)
    tenv = _port(task)
    obs_j, info_j = jenv.reset_out
    st = convert.env_state_from_numpy(_np(jenv._state))
    if "Level1" in task:
        assert len(set(st.sim.geom_size[:, tenv._geom, 0].tolist())) == K
    if "Level2" in task or "Level3" in task:
        assert st.sim.hull_verts.shape == (K, 1, hulls.HULL_P, 3)
        assert len(set(st.sim.free_mass[:, 0].tolist())) >= 3
    ctx = TaskContext(tenv, st)
    info = tenv.evaluate(st, ctx)
    obs = tenv._get_obs(st, ctx, info)
    assert obs.shape == np.shape(obs_j) == (K, 40)
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=2e-4)
    for key in info_j:
        np.testing.assert_allclose(info[key].numpy(), np.asarray(info_j[key]), atol=1e-5,
                                   err_msg=key)


def _check_step(task):
    """One env step from the JAX reset state with random actions, and one
    from ``contact_state`` states (the object settled on the fingers) with
    the zero action (the fingers hold), through the process's one compiled
    JAX env step of the task: the physics state, obs, dense reward, every
    info flag and the extras (the cumulative angle and the previous
    quaternion). An env beyond a tolerance is refereed (module docstring);
    at most a quarter of the envs are. In contact, the object's points
    against the capsules carry force in most envs."""
    jenv, jstep = _jax(task)
    tenv = _port(task)
    for states in ("reset", "contact"):
        st_t = convert.env_state_from_numpy(_np(jenv._state))
        if states == "reset":
            st_j = jenv._state
            action = np.random.default_rng(1).uniform(-0.3, 0.3, (K, 16)).astype(np.float32)
        else:
            st_t = tenv.contact_state(st_t, torch.Generator().manual_seed(0))
            st_j = _to_jax(jenv._state, st_t)
            action = np.zeros((K, 16), np.float32)
        st_j2, obs_j, rew_j, _, info_j = jstep(st_j, jnp.asarray(action))
        st_t2, obs_t, rew_t, _, info_t = tenv._step(st_t, torch.as_tensor(action))
        got, ref = convert.to_numpy(st_t2.sim), _np(st_j2.sim)
        cmd = tenv.agent.controller.set_action(st_t.cmd, st_t.sim.qpos, torch.as_tensor(action))
        f64 = plain64(tenv.kernel, st_t.sim, cmd, tenv.sim_steps_per_control)
        refereed = _refereed(got, ref, f64, TOL)
        assert refereed.sum() <= K // 4, (states, refereed)
        ok = ~refereed
        np.testing.assert_allclose(obs_t.numpy()[ok], np.asarray(obs_j)[ok], atol=2e-4)
        np.testing.assert_allclose(rew_t.numpy()[ok], np.asarray(rew_j)[ok], atol=1e-4)
        # the cumulative angle is twice a quaternion's, whose tolerance is
        # the free pose's 2e-5: 4e-5
        for key in info_j:
            np.testing.assert_allclose(info_t[key].numpy()[ok], np.asarray(info_j[key])[ok],
                                       atol=4e-5 if key == "cum_angle" else 0,
                                       err_msg=f"{states} {key}")
        for key in st_j2.extras:
            np.testing.assert_allclose(st_t2.extras[key].numpy()[ok],
                                       np.asarray(st_j2.extras[key])[ok],
                                       atol=4e-5 if key == "cum_angle" else 2e-5,
                                       err_msg=f"{states} {key}")
    plan = megakernel._Plan(tenv.model)
    lam = ref["contact_lam"] > 0
    obj = (plan.pfn != megakernel._FNS.index("plane_capsule"))
    assert lam[:, obj].any(1).mean() >= 0.5


def _check_mppi():
    """One Level2 MPPI solve at K=8, H=2 (sigma 0.6, temperature 0.3) with
    the JAX noise injected: the nominal and the rollout returns match."""
    task = "RotateSingleObjectInHandLevel2-v1"
    jenv, _ = _jax(task)
    tenv = _port(task)
    Ks, H = 8, 2
    cfg = dict(horizon=H, num_samples=Ks, sigma=0.6, temperature=0.3)
    jp = JMPPI(jenv, JMPPIConfig(**cfg))
    ps_j = jp.init(seed=0)
    ps_j2, info_j = jp.solve(ps_j, jax.tree.map(lambda x: x[0], jenv._state))
    white = np.asarray(jax.random.normal(jax.random.split(ps_j.key)[1], (Ks, H, 16)))
    tp = MPPI(tenv, MPPIConfig(**cfg))
    st_t = convert.env_state_from_numpy(_np(jax.tree.map(lambda x: x[:1], jenv._state)))
    ps_t, info_t = tp.solve(tp.init(seed=0), st_t, noise=torch.tensor(white))
    for key in ("best_return", "mean_return"):
        np.testing.assert_allclose(float(info_t[key]), float(info_j[key]), atol=1e-4)
    np.testing.assert_allclose(ps_t.nominal.numpy(), np.asarray(ps_j2.nominal), atol=1e-4)


# task-major, so that the consecutive cases of one task tend to land on one
# worker, which then builds that task's JAX env once; one case per task
# compiles the task's JAX env step (a worker compiles it in 15-25 s cold)
TASK_CHECKS = [(task, check) for task in TASKS
               for check in ("tables", "reset", "step")
               + (("mppi",) if "Level2" in task else ())]


@pytest.mark.parametrize("task, check", TASK_CHECKS,
                         ids=[t if c == "tables" else f"{t}-{c}" for t, c in TASK_CHECKS])
def test_task_matches_jax(task, check):
    """One check of a task against the JAX package, on the process's one
    JAX env and one compiled JAX env step of that task (``_jax``): the
    static pair tables, evaluate and obs at the JAX reset state, one env
    step from that state and one from ``contact_state`` states; for Level2
    also an MPPI solve with the JAX noise (``_check_*``)."""
    if check == "tables":
        _check_tables(task)
    elif check == "reset":
        _check_reset(task)
    elif check == "mppi":
        _check_mppi()
    else:
        _check_step(task)


@pytest.mark.parametrize("task", TASKS, ids=["Cube", "Level0", "Level1", "Level2", "Level3"])
def test_reset_draws_follow_the_jax_ranges(task):
    """The port's own reset draws (its generator, not JAX's) within the JAX
    task's ranges: the object's xy around (-0.02, 0.01) within 1 cm at
    z 0.26, at rest, the cumulative angle cleared; the cube tasks' fixed
    half size (0.035, Level0 0.04) with mass 400 (2 half)^3 in every env;
    Level1's half sizes in [0.025, 0.055]; the hull levels' library rows
    per env (contact cloud, faces, AABB, mass and inertia), at density 400
    on Level2 and in [200, 1200] on Level3."""
    env = mtt.make(task, num_envs=64, device="cpu")
    env.reset(seed=3)
    s = env._state
    fp = s.sim.free_pose[:, 0]
    assert float((fp[:, 0] + 0.02).abs().max()) <= 0.01 + 1e-6
    assert float((fp[:, 1] - 0.01).abs().max()) <= 0.01 + 1e-6
    torch.testing.assert_close(fp[:, 2], torch.full((64,), 0.26))
    assert not s.extras["cum_angle"].any() and not s.sim.free_vel.any()
    half = s.sim.geom_size[:, env._geom]
    if not ("Level2" in task or "Level3" in task):
        if "Level1" in task:
            assert float(half.min()) >= 0.025 and float(half.max()) <= 0.055
            assert len(set(half[:, 0].tolist())) > 32
        else:
            torch.testing.assert_close(half, torch.full((64, 3), env.cube_half))
        torch.testing.assert_close(s.sim.free_mass[:, 0], 400.0 * (2 * half[:, 0]) ** 3)
        return
    verts, faces, vol, inert, aabb = (torch.as_tensor(t) for t in hulls.pad_library(env._lib))
    mid = torch.cdist(s.sim.hull_verts[:, 0].reshape(64, -1), verts.reshape(8, -1)).argmin(1)
    assert len(set(mid.tolist())) == 8
    torch.testing.assert_close(s.sim.hull_faces[:, 0], faces[mid], rtol=0, atol=0)
    torch.testing.assert_close(half, aabb[mid], rtol=0, atol=0)
    dens = s.sim.free_mass[:, 0] / vol[mid]
    torch.testing.assert_close(s.sim.free_inertia[:, 0], inert[mid] * dens[:, None, None])
    if "Level2" in task:
        torch.testing.assert_close(dens, torch.full((64,), 400.0))
    else:
        assert float(dens.min()) >= 200.0 - 1e-3 and float(dens.max()) <= 1200.0 + 1e-3
        assert float(dens.std()) > 100.0


@pytest.mark.parametrize("task", TASKS, ids=["Cube", "Level0", "Level1", "Level2", "Level3"])
def test_normalized_reward_is_dense_over_3(task):
    """Each task's normalized dense reward is its dense reward over 3, after
    one env step from the same reset."""
    dense = mtt.make(task, num_envs=2, device="cpu", reward_mode="dense")
    norm = mtt.make(task, num_envs=2, device="cpu")
    for e in (dense, norm):
        e.reset(seed=0)
    _, rew_d, *_ = dense.step(torch.zeros(16))
    _, rew_n, *_ = norm.step(torch.zeros(16))
    torch.testing.assert_close(rew_n * 3.0, rew_d)


def test_rewards_and_cumulative_angle():
    """A quarter turn about +z in one env (its quaternion stepped by 0.8 rad
    twice) adds up to the JAX rule's angle, succeeds with reward 3, and a
    drop below 0.10 fails with reward 0; ``pd_joint_pos`` takes absolute
    targets."""
    task = "RotateSingleObjectInHandLevel0-v1"
    dense = mtt.make(task, num_envs=2, device="cpu", reward_mode="dense")
    dense.reset(seed=0)
    st = dense._state
    before = st.extras["cum_angle"].clone()
    dq = torch.tensor([math.cos(0.4), 0.0, 0.0, math.sin(0.4)])
    for _ in range(2):
        fp = st.sim.free_pose.clone()
        fp[0, 0, 3:7] = quat_mul(dq, fp[0, 0, 3:7])
        fp[1, 0, 2] = 0.05
        st = st.replace(sim=st.sim.replace(free_pose=fp))
        st = dense._update_extras(st, TaskContext(dense, st))
    torch.testing.assert_close(st.extras["cum_angle"][0] - before[0], torch.tensor(1.6),
                               atol=1e-5, rtol=0)
    info = dense.evaluate(st, TaskContext(dense, st))
    assert info["success"].tolist() == [True, False] and info["fail"].tolist() == [False, True]
    rew = dense.compute_dense_reward(st, None, info, None)
    torch.testing.assert_close(rew, torch.tensor([3.0, 0.0]))
    absolute = mtt.make(task, num_envs=1, device="cpu", control_mode="pd_joint_pos")
    absolute.reset(seed=0)
    tgt = torch.linspace(-0.2, 0.2, 16)
    cmd = absolute.agent.controller.set_action(absolute._state.cmd, absolute._state.sim.qpos,
                                               tgt[None])
    qlim = torch.as_tensor(absolute.model.robot.qlim, dtype=torch.float32)
    torch.testing.assert_close(cmd.target_qpos[0], tgt.clamp(qlim[:, 0], qlim[:, 1]))


# ---- the hull stack: sphere_hull and hull_hull in a scene --------------------


def test_hull_stack_matches_jax():
    """The hull stack built by ``build_hull_stack`` from both packages: the
    same pair table (box hulls' clouds and planes from both copies of
    ``make_hull``), the JAX kernel's ``supports`` holds for it, and from
    the settled stack one control step of the port's plain step equals
    five sim steps of the JAX engine (``engine.make_step_fn``) within the
    tolerances, with sphere_hull and both halves of hull_hull (the block's
    cloud against the slab's planes and the slab's against the block's)
    carrying force in every env."""
    model, sim, cmd = hull_stack.hull_stack(K, "cpu", settle_steps=10)
    b = jmodel.SceneSpecBuilder()
    hull_stack.build_hull_stack(b, JPanda(), jhulls.make_hull, jmodel.sphere_geom,
                                jmodel.plane_geom)
    jm = b.build()
    assert jmk.supports(jm) and jmk._hull_cost(jm) == 82
    assert [(g[0].__name__, g[1], len(g[2])) for g in model.pair_groups] == [
        (g[0].__name__, g[1], len(g[2])) for g in jm.pair_groups]
    assert {g[0].__name__ for g in model.pair_groups} >= {"sphere_hull", "hull_hull"}
    np.testing.assert_allclose(model.hull_verts0, jm.hull_verts0, atol=1e-6)
    np.testing.assert_allclose(model.hull_faces0, jm.hull_faces0, atol=1e-6)
    new, aux = teng.make_step_fn(model)(sim, cmd, 5, return_aux=True)
    jstate = jax.tree.map(lambda x: jnp.broadcast_to(x, (K,) + x.shape), jm.initial_state())
    jstate = _to_jax(jstate, sim)
    jcmd = _to_jax(jax.tree.map(lambda x: jnp.broadcast_to(x, (K,) + x.shape),
                                jmodel.DriveCmd(target_qpos=jnp.zeros(9), target_qvel=jnp.zeros(9),
                                                qf=jnp.zeros(9))), cmd)
    # one compiled sim step called five times: XLA compiles a loop of sim
    # steps about three times longer than one on the CPU
    one = jax.jit(jax.vmap(jeng.make_step_fn(jm)))
    jnew = jstate
    for _ in range(5):
        jnew = one(jnew, jcmd)
    got, ref = convert.to_numpy(new), _np(jnew)
    for name, tol in TOL.items():
        np.testing.assert_allclose(got[name], ref[name], atol=tol, err_msg=name)
    plan = megakernel._Plan(model)
    loaded = (aux["f_pt"].abs().sum(-1) > 0).numpy()
    hh = plan.pfn == megakernel._FNS.index("hull_hull")
    for mask in (plan.pfn == megakernel._FNS.index("sphere_hull"), hh & (plan.pcorner < 40),
                 hh & (plan.pcorner >= 40)):
        assert loaded[:, mask].any(1).all()
        assert (ref["contact_lam"][:, mask] > 0).any(1).all()


def test_convert_carries_two_hull_slots():
    """A two-slot JAX ``SimState`` (the hull stack's, each env's slot
    tables made different) comes across to the port and back unchanged."""
    b = jmodel.SceneSpecBuilder()
    hull_stack.build_hull_stack(b, JPanda(), jhulls.make_hull, jmodel.sphere_geom,
                                jmodel.plane_geom)
    jm = b.build()
    js = jax.tree.map(lambda x: jnp.broadcast_to(x, (3,) + x.shape), jm.initial_state())
    js = js.replace(hull_verts=js.hull_verts * jnp.arange(1.0, 4.0)[:, None, None, None])
    st = convert.sim_state_from_numpy(_np(js))
    assert st.hull_verts.shape == (3, 2, hulls.HULL_P, 3)
    assert st.hull_faces.shape == (3, 2, hulls.HULL_F, 4)
    back = convert.to_numpy(st)
    for name, arr in _np(js).items():
        if arr is not None:
            np.testing.assert_array_equal(back[name], arr, err_msg=name)
