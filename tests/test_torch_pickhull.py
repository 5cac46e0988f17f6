"""PickSingleHull-v1 / PickSingleYCB-v1 through the PyTorch port against the
JAX package, on the CPU.

The same inputs go through both: the hull library built by both copies of
``physics/hulls.py``, random poses drawn with numpy, a JAX reset state
(each env holding its own object) carried across with
``maniskill_tpu_torch.convert``, states in contact built by the port and
carried back, and the JAX MPPI noise. The JAX side runs its XLA engine
(``sim_backend="xla"``), the plain reference of its Pallas kernel.

Tolerances: the library tables are equal (both build them in float64 with
scipy and cast to float32); narrowphase outputs 1e-5 (a few float32
operations; the JAX hull SDF takes its face distances by a matmul, the
port in the kernel's fixed order); the env step takes the cube tolerances
of tests/test_megakernel.py:48-67 from reset states (qpos 2e-5, qvel
2e-4, free pose 2e-5, free vel 5e-4, impulses 5e-3) and, from states in
contact, where the fingers press on hull points, the looser ones of the
JAX hull kernel test (:137-165: qpos 5e-5, qvel 5e-4, free pose 5e-5, free
vel 1e-3, impulses 1e-2). A stiff contact state amplifies float32 rounding:
in one env of the eight the JAX float32 step lands 3.6e-3 (free vel) and
0.16 (impulses) from the JAX step run in float64 (``jax_enable_x64``),
where the port's float32 step stays within 1.3e-5 and 5.5e-5 of it (and
the port's own float64 step within 1.2e-5 of JAX's); such an env is
refereed by the JAX float64 step, as chip_smoke.py referees the kernel by
a float64 plain step. Obs 2e-4, reward and MPPI 1e-4.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.physics import engine as jeng
from maniskill_tpu.physics import hulls as jhulls
from maniskill_tpu.physics import shapes as jshapes
from maniskill_tpu.planners.mppi import MPPI as JMPPI, MPPIConfig as JMPPIConfig
from maniskill_tpu.utils import building as jbuilding

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.envs.base_env import TaskContext
from maniskill_tpu_torch.physics import engine as teng
from maniskill_tpu_torch.physics import hulls, megakernel, shapes
from maniskill_tpu_torch.planners.mppi import MPPI, MPPIConfig
from maniskill_tpu_torch.utils import building
from torch_parity import (fast_trace_metadata, jax_step64, shared_jit, make_jax_env,
                         np_tree as _np, to_jax as _to_jax)

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
HULL_TOL = dict(qpos=5e-5, qvel=5e-4, free_pose=5e-5, free_vel=1e-3,
                contact_lam=1e-2, contact_lam_t=1e-2)
PLANE_HULL, BOX_HULL = megakernel._FNS.index("plane_hull"), megakernel._FNS.index("box_hull")


@pytest.fixture(scope="module")
def jenv():
    env = make_jax_env("PickSingleHull-v1", num_envs=K, reward_mode="dense", sim_backend="xla")
    env.reset_out = env.reset(seed=0)
    return env


@pytest.fixture(scope="module")
def tenv():
    return mtt.make("PickSingleHull-v1", num_envs=K, reward_mode="dense", device="cpu")


def _tables(lib):
    return [np.stack([getattr(a, n) for a in lib]) for n in ("verts", "faces", "cpts")] + [
        np.asarray([a.volume for a in lib]), np.stack([a.com for a in lib]),
        np.stack([a.inertia_com for a in lib]), np.stack([a.aabb_half for a in lib])]


@pytest.mark.parametrize("library", ["procedural", "ycb_fallback"])
def test_hull_library_tables_match(library):
    """The procedural 8-hull library and its padded tables (``pad_library``)
    equal the JAX package's; without the YCB mesh pack the YCB loader falls
    back to the same objects, position by position, in both."""
    if library == "procedural":
        lib_t, lib_j = hulls.standard_object_library(), jhulls.standard_object_library()
    else:
        assert building._find_mesh(building.DEFAULT_YCB_IDS[0]) is None
        with pytest.raises(FileNotFoundError):
            building.load_ycb_hull(building.DEFAULT_YCB_IDS[0])
        lib_t = building.ycb_or_procedural_library()
        lib_j = jbuilding.ycb_or_procedural_library()
        assert [a.name for a in lib_t] == [a.name for a in hulls.standard_object_library()]
    assert [a.name for a in lib_t] == [a.name for a in lib_j] and len(lib_t) == 8
    for a, b in zip(_tables(lib_t) + list(hulls.pad_library(lib_t)),
                    _tables(lib_j) + list(jhulls.pad_library(lib_j))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    cpts, faces = hulls.pad_library(lib_t)[:2]
    assert cpts.shape == (8, hulls.HULL_P, 3) and faces.shape == (8, hulls.HULL_F, 4)
    assert (faces[..., 3] == 1e6).any(1).all()  # every hull has padding planes


def _quat(rng, n, tilt):
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    ang = rng.uniform(-tilt, tilt, n)
    return np.concatenate([np.cos(ang / 2)[:, None], ax * np.sin(ang / 2)[:, None]], 1)


def _hull_args(rng, n):
    """Random pairs for plane_hull/box_hull: a box (or plane) A and a
    library hull B within a few cm of touching, at random orientations."""
    cpts, faces = hulls.pad_library(hulls.standard_object_library())[:2]
    pick = rng.integers(0, 8, n)
    pa = rng.uniform(-0.05, 0.05, (n, 3))
    sa = rng.uniform(0.01, 0.04, (n, 3))
    pb = pa + rng.uniform(-0.05, 0.05, (n, 3))
    return [x.astype(np.float32) for x in
            (pa, _quat(rng, n, math.pi), sa, pb, _quat(rng, n, math.pi), np.zeros((n, 3)),
             cpts[pick], faces[pick])]


def _box_faces(half):
    """An axis-aligned box's face planes, padded to HULL_F as make_hull pads."""
    f = [[s * (i == 0), s * (i == 1), s * (i == 2), half[i]] for i in range(3) for s in (1, -1)]
    f += [[0.0, 0.0, 1.0, 1e6]] * (hulls.HULL_F - 6)
    return np.asarray(f, np.float32)


@pytest.mark.parametrize("fn", ["_hull_sdf", "plane_hull", "box_hull"])
def test_hull_shapes_match_jax(fn):
    """The hull narrowphase against the JAX functions on random poses (point
    order, B->A normals, depths), both sides of contact present. The face
    SDF also on points placed exactly on a box's faces, edges and corners,
    where several faces tie for the max and the normal is their mean: the
    one-hot averaging itself (exact normals)."""
    rng = np.random.default_rng(0)
    if fn == "_hull_sdf":
        half = np.float32([0.03, 0.02, 0.01])
        faces = _box_faces(half)
        signs = np.array([[sx, sy, sz] for sx in (-1, 0, 1) for sy in (-1, 0, 1)
                          for sz in (-1, 0, 1) if (sx, sy, sz) != (0, 0, 0)], np.float32)
        p = np.concatenate([signs * half, rng.uniform(-0.05, 0.05, (64, 3)).astype(np.float32)])
        sdf_t, n_t = shapes._hull_sdf(torch.as_tensor(p), torch.as_tensor(faces))
        sdf_j, n_j = jshapes._hull_sdf(jnp.asarray(p), jnp.asarray(faces))
        np.testing.assert_allclose(sdf_t.numpy(), np.asarray(sdf_j), atol=1e-5)
        np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-5)
        exact = signs / np.linalg.norm(signs, axis=1, keepdims=True)
        np.testing.assert_allclose(n_t[:len(signs)].numpy(), exact, atol=1e-6)
        np.testing.assert_array_equal(sdf_t[:len(signs)].numpy(), 0.0)
        return
    args = _hull_args(rng, 128)
    cj = jax.vmap(getattr(jshapes, fn))(*map(jnp.asarray, args))
    ct = getattr(shapes, fn)(*map(torch.as_tensor, args))
    n_pts = hulls.HULL_P + (8 if fn == "box_hull" else 0)
    assert ct.pos.shape == (128, n_pts, 3) and ct.depth.shape == (128, n_pts)
    for got, ref in zip(ct, cj):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    depth = ct.depth.numpy()
    assert (depth > 0).sum() > 100 and (depth < 0).sum() > 1000
    if fn == "box_hull":  # box corners inside hulls, and hull points inside boxes
        assert (depth[:, :8] > 0).any() and (depth[:, 8:] > 0).any()


def test_static_pair_tables_match(jenv, tenv):
    """The pair table (finger and hand boxes against the table ->
    box_box_onesided, fingers, hand and table against the hull ->
    box_hull, the floor -> plane_hull; P = 368), the hull slot of each
    geom, the per-point static tables, and the kernel's row plan with the
    hull rows after the drive gains."""
    jm, tm = jenv.model, tenv.model
    assert (tm.nq, tm.n_free, len(tm.geoms), tm.n_points, tm.n_hull) == (9, 1, 8, 368, 1)
    assert [(g[0].__name__, g[1], len(g[2])) for g in tm.pair_groups] == [
        ("box_box_onesided", 8, 5), ("box_hull", 48, 6), ("plane_hull", 40, 1)]
    for gt, gj in zip(tm.pair_groups, jm.pair_groups):
        assert gt[0].__name__ == gj[0].__name__ and gt[1] == gj[1]
        for a, b in zip(gt[2:], gj[2:]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.geom_hull_slot, jm.geom_hull_slot)
    np.testing.assert_array_equal(tm.hull_verts0, jm.hull_verts0)
    np.testing.assert_array_equal(tm.hull_faces0, jm.hull_faces0)
    for a, b in zip(teng._assignment_tables(tm), jeng._assignment_tables(jm)):
        np.testing.assert_array_equal(a, b)
    mt, mj = teng._trace_metadata(tm), jeng._trace_metadata(jm)
    for i in range(3):
        np.testing.assert_allclose(mt[i].numpy(), np.asarray(mj[i]), atol=1e-5)
    for i in range(3, 7):
        np.testing.assert_array_equal(mt[i].numpy(), np.asarray(mj[i]))
    for i in (7, 8):
        assert [tuple(map(int, m)) for m in mt[i]] == [tuple(map(int, m)) for m in mj[i]]
    plan = megakernel._Plan(tm)
    assert plan.i_hverts == (plan.i_flim[1], plan.i_flim[1] + 3 * hulls.HULL_P)
    assert plan.i_hfaces == (plan.i_hverts[1], plan.i_hverts[1] + 4 * hulls.HULL_F)
    assert plan.R_in == plan.i_hfaces[1] and megakernel.supports(tm)
    assert (plan.pfn == BOX_HULL).sum() == 288 and (plan.pfn == PLANE_HULL).sum() == 40


def test_reset_state_evaluate_obs_and_extras(jenv, tenv):
    """The JAX reset state carried across: evaluate and the 46-dim state obs
    (with the object's AABB half extents and mass) agree (the reward is
    compared through the env step). The port's own reset gives each env the library row of its
    drawn object: contact cloud, faces, mass, inertia, rest height and
    size, and ``model_id``/``episode_count``; the normalized reward is the
    dense one over 6."""
    obs_j, info_j = jenv.reset_out
    mids = np.asarray(jenv._state.extras["model_id"])
    assert len(set(mids.tolist())) >= 4  # the envs hold different objects
    st = convert.env_state_from_numpy(_np(jenv._state))
    ctx = TaskContext(tenv, st)
    info = tenv.evaluate(st, ctx)
    obs = tenv._get_obs(st, ctx, info)
    assert obs.shape == (K, 46)
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), atol=2e-4)
    for key in info_j:
        np.testing.assert_array_equal(info[key].numpy(), np.asarray(info_j[key]), key)
    env = mtt.make("PickSingleHull-v1", num_envs=16, device="cpu")
    env.reset(seed=1)
    s = env._state
    mid = s.extras["model_id"].long()
    assert len(set(mid.tolist())) >= 5 and (s.extras["episode_count"] == 1).all()
    verts, faces, vol, inert, aabb = (torch.as_tensor(t)[mid] for t in hulls.pad_library(env._lib))
    torch.testing.assert_close(s.sim.hull_verts[:, 0], verts, rtol=0, atol=0)
    torch.testing.assert_close(s.sim.hull_faces[:, 0], faces, rtol=0, atol=0)
    torch.testing.assert_close(s.sim.free_mass[:, 0], vol * 1000.0)
    torch.testing.assert_close(s.sim.free_inertia[:, 0], inert * 1000.0)
    torch.testing.assert_close(s.sim.free_pose[:, 0, 2], aabb[:, 2], rtol=0, atol=0)
    torch.testing.assert_close(s.sim.geom_size[:, env._geom], aabb, rtol=0, atol=0)
    dense = mtt.make("PickSingleHull-v1", num_envs=16, device="cpu", reward_mode="dense")
    dense.reset(seed=1)
    _, rew, *_ = env.step(torch.zeros(8))
    _, rew_d, *_ = dense.step(torch.zeros(8))
    torch.testing.assert_close(rew * 6.0, rew_d)


@pytest.fixture(scope="module")
def jstep(jenv):
    """The JAX env step (physics, evaluate, obs, reward), vmapped and
    jitted once for the module."""
    return shared_jit(jax.vmap(jenv._step_one))


@pytest.mark.parametrize("states", ["reset", "contact"])
def test_env_step_matches(jenv, tenv, jstep, states):
    """One env step with random actions from the JAX reset state (a
    different object per env) or from ``contact_state`` states (the object
    grasped, sized by each env's own AABB; on the floor in every fourth
    env): the physics state, obs, dense reward and every info flag (in
    contact, an env beyond the tolerances is refereed by the JAX step run
    in float64; see the module docstring). In contact, box_hull
    points of the fingers (box corners against the hull
    and hull points against the finger boxes) and plane_hull points carry
    force."""
    st_t = convert.env_state_from_numpy(_np(jenv._state))
    st_j = jenv._state
    if states == "contact":
        st_t = tenv.contact_state(st_t, torch.Generator().manual_seed(0))
        st_j = _to_jax(jenv._state, st_t)
    rng = np.random.default_rng(1)
    action = rng.uniform(-0.3, 0.3, (K, 8)).astype(np.float32)
    st_j2, obs_j, rew_j, _, info_j = jstep(st_j, jnp.asarray(action))
    st_t2, obs_t, rew_t, _, info_t = tenv._step(st_t, torch.as_tensor(action))
    got = convert.to_numpy(st_t2.sim)
    if states == "reset":
        for name, tol in TOL.items():
            np.testing.assert_allclose(got[name], np.asarray(getattr(st_j2.sim, name)),
                                       atol=tol, err_msg=name)
        np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=2e-4)
        np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-4)
    else:
        cmd = tenv.agent.controller.set_action(st_t.cmd, st_t.sim.qpos, torch.as_tensor(action))
        f64 = jax_step64(jenv, st_j.sim, _to_jax(jenv._state.cmd, cmd))
        refereed = np.zeros(K, bool)
        for name, tol in HULL_TOL.items():
            err = np.abs(got[name] - np.asarray(getattr(st_j2.sim, name))).reshape(K, -1).max(1)
            err64 = np.abs(got[name] - f64[name]).reshape(K, -1).max(1)
            jerr64 = np.abs(np.asarray(getattr(st_j2.sim, name))
                            - f64[name]).reshape(K, -1).max(1)
            # where the port's float32 step leaves the JAX float32 step, the
            # JAX float64 step sides with the port
            assert (err64[err > tol] <= tol).all(), (name, err, err64)
            assert (jerr64[err > tol] > tol).all(), (name, err, jerr64)
            refereed |= err > tol
        assert refereed.sum() <= K // 8, refereed
        ok = ~refereed
        np.testing.assert_allclose(obs_t.numpy()[ok], np.asarray(obs_j)[ok], atol=2e-4)
        np.testing.assert_allclose(rew_t.numpy()[ok], np.asarray(rew_j)[ok], atol=1e-4)
    for key in info_j:
        np.testing.assert_array_equal(info_t[key].numpy(), np.asarray(info_j[key]), key)
    if states == "contact":
        plan = megakernel._Plan(tenv.model)
        lam = np.asarray(st_j2.sim.contact_lam) > 0
        robot = plan.pra >= 0
        grasp = np.arange(K) % 4 != 3
        finger = (plan.pfn == BOX_HULL) & robot
        assert lam[grasp][:, finger & (plan.pcorner < 8)].any()  # finger corners in the hull
        assert (lam[grasp][:, finger & (plan.pcorner >= 8)].sum(1) >= 2).mean() >= 0.5
        assert lam[~grasp][:, plan.pfn == PLANE_HULL].any(1).all()  # objects on the floor
        assert np.asarray(info_j["is_grasped"])[grasp].any()


def test_mppi_per_dimension_sigma_matches_jax(jenv, tenv):
    """One MPPI solve at K=8, H=2 with BASELINE config #5's per-dimension
    sigma (0.4 per arm joint, 0.1 for the gripper) and temperature 0.1,
    the JAX noise injected: the sigma held as an (A,) tensor, the returns
    and the nominal match."""
    Ks, H = 8, 2
    cfg = dict(horizon=H, num_samples=Ks, sigma=[0.4] * 7 + [0.1], temperature=0.1)
    jp = JMPPI(jenv, JMPPIConfig(**cfg))
    ps_j = jp.init(seed=0)
    start = jax.tree.map(lambda x: x[0], jenv._state)
    ps_j2, info_j = jp.solve(ps_j, start)
    white = np.asarray(jax.random.normal(jax.random.split(ps_j.key)[1], (Ks, H, 8)))
    tp = MPPI(tenv, MPPIConfig(**cfg))
    np.testing.assert_array_equal(tp.sigma.numpy(), np.asarray(ps_j.sigma))
    assert MPPI(tenv, MPPIConfig(sigma=0.3)).sigma.shape == (8,)
    st_t = convert.env_state_from_numpy(_np(jax.tree.map(lambda x: x[:1], jenv._state)))
    ps_t, info_t = tp.solve(tp.init(seed=0), st_t, noise=torch.tensor(white))
    for key in ("best_return", "mean_return"):
        np.testing.assert_allclose(float(info_t[key]), float(info_j[key]), atol=1e-4)
    np.testing.assert_allclose(ps_t.nominal.numpy(), np.asarray(ps_j2.nominal), atol=1e-4)
    assert float(info_t["ess"]) < Ks  # the temperature does weight the samples
