"""The WidowX and the BridgeData v2 twins through the PyTorch port against the
JAX package, on the CPU: the WidowX250S (its controllers, its FK, its grasp
checker), the env's state surface (``get_state_dict``/``set_state_dict``,
``sample_action``, ``set_drive_properties``) and the four ids
PutCarrotOnPlateInScene-v1, PutSpoonOnTableClothInScene-v1,
StackGreenCubeOnYellowCubeBakedTexInScene-v1 and PutEggplantInBasketScene-v1.

Each id's JAX env (K envs on its XLA engine, ``sim_backend="xla"``: the
plain reference of its Pallas kernel) is reset with seed 0. The port resets
from JAX's draws (the grid cell and orientation pair of each env, read off
the JAX reset state and handed to the port's ``_draw``) and must give
JAX's reset state, obs and evaluate; then it takes two control steps (20
sim steps each) from the JAX states with random actions against JAX's env
step, compiled once a task (``torch_parity.shared_jit``).

Tolerances: the env step those of tests/test_megakernel.py:48-67 (qpos
2e-5, qvel 2e-4, free pose 2e-5, free vel 5e-4, impulses 5e-3), an env
beyond one refereed by the port's plain step in float64
(``torch_parity.refereed``; only envs in contact may be); the step's obs
2e-4, reward 1e-4, the extras and evaluate's flags exactly, in the envs
held; the reset state 1e-6 and its obs and evaluate 1e-5 relative; the
model tables exactly.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.agents.robots.widowx import WidowX250S as JWidowX
from maniskill_tpu.kinematics import chain as jchain
from maniskill_tpu.physics import megakernel as jmk

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.agents.robots.widowx import WidowX250S, WidowX250SBridge
from maniskill_tpu_torch.kinematics import chain
from maniskill_tpu_torch.physics import megakernel
from torch_parity import (check_reset_outputs, check_tables, compare_env_step,
                          fast_trace_metadata, make_jax_env, np_tree)

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)

K = 4
_FLAT = ["box_box_corners", "box_box_onesided", "box_hull", "capsule_box", "capsule_hull",
         "plane_box", "plane_capsule", "plane_hull"]
# (nq, F, G, P, pair functions, kinematic bodies) of each id's model
TASKS = {
    "PutCarrotOnPlateInScene-v1": (8, 2, 12, 546, sorted(
        ["plane_box", "box_box_onesided", "plane_capsule", "capsule_box", "plane_hull",
         "box_hull", "capsule_hull", "hull_hull"]), 0),
    "PutSpoonOnTableClothInScene-v1": (8, 2, 12, 378, _FLAT, 0),
    "StackGreenCubeOnYellowCubeBakedTexInScene-v1": (8, 2, 12, 222, sorted(
        ["plane_box", "box_box_onesided", "box_box_corners", "box_box", "plane_capsule",
         "capsule_box"]), 0),
    "PutEggplantInBasketScene-v1": (8, 1, 16, 592, sorted(
        ["plane_box", "box_box_onesided", "plane_capsule", "capsule_box", "plane_hull",
         "box_hull", "capsule_hull"]), 1),
}


@pytest.fixture(scope="module", autouse=True)
def _fast_jax_tables():
    """The JAX package's static contact tables through one jitted program
    (tests/torch_parity.py)."""
    with fast_trace_metadata():
        yield
    for fn in (_jax, _jax_env, _port):
        fn.cache_clear()


@functools.lru_cache(maxsize=None)
def _jax_env(task):
    """The task's JAX env of K envs on its XLA engine, not reset (the
    model's tables need no compiled program)."""
    return make_jax_env(task, num_envs=K, reward_mode="dense", sim_backend="xla")


@functools.lru_cache(maxsize=None)
def _jax(task):
    """``_jax_env`` reset with seed 0: its reset outputs in ``reset_out``,
    its reset state in ``reset_state``."""
    env = _jax_env(task)
    env.reset_out = env.reset(seed=0)
    env.reset_state = env._state
    return env


@functools.lru_cache(maxsize=None)
def _port(task):
    return mtt.make(task, num_envs=K, reward_mode="dense", device="cpu")


# ---- the WidowX ----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["pd_joint_delta_pos", "pd_joint_pos", "pd_ee_delta_pos",
                                  "pd_ee_delta_pose"])
def test_widowx_matches_jax(mode):
    """The WidowX250S in each of its four control modes: the collision
    geoms (six capsules, two finger boxes at friction 2), the rest
    keyframe, the mode's bounds and gains (the real2sim arm vector, the
    mimic gripper over [0.014, 0.038]); the bridge variant is the same
    robot. Under the EE modes, two successive ``set_action`` calls from
    random joint positions against the JAX controller, each on its own
    package's FK (the IK step's solve is K1's plain version here)."""
    ta, ja = WidowX250S(device="cpu", control_mode=mode), JWidowX(control_mode=mode)
    assert ta.supported_control_modes == tuple(ja._controller_configs())
    got, ref = ta.collision_geoms(), ja.collision_geoms()
    assert [int(g["type"]) for g in got] == [int(g["type"]) for g in ref] == [3] * 6 + [2, 2]
    for g, r in zip(got, ref):
        assert g["link"] == r["link"] and g["friction"] == r["friction"]
        for k in ("size", "offset_p", "offset_q"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    np.testing.assert_array_equal(ta.keyframes["rest"].qpos, ja.keyframes["rest"].qpos)
    c_t, c_j = ta.controller, ja.controller
    for name in ("action_low", "action_high", "kp", "kd", "force_limit"):
        np.testing.assert_allclose(getattr(c_t, name), np.asarray(getattr(c_j, name)),
                                   rtol=1e-7, err_msg=name)
    assert c_t.action_dim == c_j.action_dim
    assert WidowX250SBridge(device="cpu", control_mode=mode).controller.action_dim == c_t.action_dim
    if not c_t.needs_fk_aux:
        return
    from maniskill_tpu.physics.model import DriveCmd as JDriveCmd
    from maniskill_tpu_torch.physics.model import DriveCmd

    rng = np.random.default_rng(3)
    spec_t, spec_j = ta.robot_spec, ja.robot_spec
    base = np.array([0.147, 0.028, 0.0, 1, 0, 0, 0], np.float32)
    q0 = (ta.keyframes["rest"].qpos + rng.uniform(-0.3, 0.3, (K, 8))).astype(np.float32)
    q0[:, 6:] = 0.03
    acts = rng.uniform(-1, 1, (2, K, c_t.action_dim)).astype(np.float32)

    def jax_set(cmd, q, a):
        bp, bq, aw = jchain.fk(spec_j, jnp.asarray(base), q)
        return c_j.set_action(cmd, q, a, aux=(jnp.asarray(base), bp, bq, aw))

    jset = jax.jit(jax.vmap(jax_set))
    cmd_t = c_t.reset(torch.as_tensor(q0))
    cmd_j = JDriveCmd(target_qpos=jnp.asarray(q0), target_qvel=jnp.zeros((K, 8)),
                      qf=jnp.zeros((K, 8)))
    for a in acts:
        bp, bq, aw = chain.fk(spec_t, torch.as_tensor(base), torch.as_tensor(q0))
        cmd_t = c_t.set_action(cmd_t, torch.as_tensor(q0), torch.as_tensor(a),
                               aux=(torch.as_tensor(base), bp, bq, aw))
        cmd_j = jset(cmd_j, jnp.asarray(q0), jnp.asarray(a))
        np.testing.assert_allclose(cmd_t.target_qpos.numpy(), np.asarray(cmd_j.target_qpos),
                                   atol=2e-5)
    assert isinstance(cmd_t, DriveCmd)


def test_widowx_fk_and_grasp_checker_match_jax():
    """The WidowX's FK (every body and the TCP frame at random joint
    positions) against the JAX chain, and its grasp checker on the carrot
    of PutCarrotOnPlateInScene-v1 against the JAX one on random contact
    forces and finger orientations: each finger's force against its own
    ±y column (the Panda's test is another), at least 0.5 N within 85
    degrees; cases on both sides of both thresholds."""
    ta, ja = WidowX250S(device="cpu"), JWidowX()
    rng = np.random.default_rng(0)
    q = (ta.keyframes["rest"].qpos + rng.uniform(-0.5, 0.5, (16, 8))).astype(np.float32)
    base = np.array([0.147, 0.028, 0.0, 1, 0, 0, 0], np.float32)
    bp, bq, aw = chain.fk(ta.robot_spec, torch.as_tensor(base), torch.as_tensor(q))
    jbp, jbq, jaw = jax.jit(jax.vmap(lambda x: jchain.fk(ja.robot_spec, jnp.asarray(base), x)))(
        jnp.asarray(q))
    for a, b in ((bp, jbp), (bq, jbq), (aw, jaw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
    p, _ = chain.frame_pose(ta.robot_spec, torch.as_tensor(base), bp, bq, ta.ee_link_name)
    pj = jax.jit(jax.vmap(lambda x, y: jchain.frame_pose(ja.robot_spec, jnp.asarray(base), x, y,
                                                         ja.ee_link_name)[0]))(jbp, jbq)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=2e-6)

    task = "PutCarrotOnPlateInScene-v1"
    tm, jm = _port(task).model, _jax_env(task).model
    got_fn = ta.build_grasp_checker(tm, "carrot", "cpu")
    ref_fn = ja.build_grasp_checker(jm, "carrot")
    nb, P = tm.robot.nb, tm.n_points
    body_quat = rng.normal(size=(64, nb, 4)).astype(np.float32)
    body_quat /= np.linalg.norm(body_quat, axis=-1, keepdims=True)
    # forces on the finger-carrot points: along each finger's own column
    # in half the cases (a grasp), random in the rest, 0.1-2 N
    f_pt = np.zeros((64, P, 3), np.float32)
    from maniskill_tpu.physics.engine import pair_force_signs
    from maniskill_tpu.physics.model import BodyKind

    for link, sign in (("left_finger_link", 1.0), ("right_finger_link", -1.0)):
        li = jm.robot.link_index[link]
        s = np.asarray(pair_force_signs(jm, (BodyKind.ROBOT_LINK, li),
                                        (BodyKind.FREE, jm.free_index["carrot"])))
        pts = np.flatnonzero(s)
        assert len(pts) > 0
        from scipy.spatial.transform import Rotation

        col = Rotation.from_quat(body_quat[:, li][:, [1, 2, 3, 0]]).as_matrix()[:, :, 1] * sign
        mag = rng.uniform(0.1, 2.0, (64, 1)).astype(np.float32)
        aligned = rng.uniform(size=64) < 0.5
        d = np.where(aligned[:, None], col + 0.3 * rng.normal(size=(64, 3)),
                     rng.normal(size=(64, 3)))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        f_pt[:, pts[0]] = s[pts[0]] * mag * d
    got = got_fn(torch.as_tensor(body_quat), torch.as_tensor(f_pt)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(ref_fn))(jnp.asarray(body_quat), jnp.asarray(f_pt)))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < 64


# ---- the four ids ------------------------------------------------------------------


def _check_tables(task):
    """nq, F, G, P, the pair functions and the kinematic bodies; the model
    tables equal to the JAX model's (``torch_parity.check_tables``); the
    configuration grids; ``supports`` in both packages (the JAX kernel's
    TPU gates refuse PutCarrot's hull_hull) and the dispatch's choice of
    the kernel."""
    jenv, tenv = _jax_env(task), _port(task)
    jm, tm = jenv.model, tenv.model
    nq, F, G, P, fns, kin = TASKS[task]
    for m in (tm, jm):
        assert (m.nq, m.n_free, len(m.geoms), m.n_points, len(m.kin_index)) == (nq, F, G, P, kin)
        assert sorted({g[0].__name__ for g in m.pair_groups}) == fns
    check_tables(tm, jm)
    for name in ("xyz_configs", "quat_configs"):
        np.testing.assert_array_equal(getattr(tenv, name), getattr(jenv, name), err_msg=name)
    assert tenv.sim_steps_per_control == jenv.sim_steps_per_control == 20
    assert tenv.get_language_instruction() == jenv.get_language_instruction()
    np.testing.assert_array_equal(tenv.rgb_overlay_images["3rd_view_camera"],
                                  jenv.rgb_overlay_images["3rd_view_camera"])
    assert megakernel.supports(tm) and megakernel.refusal(tm) is None
    assert jmk.supports(jm) == (task != "PutCarrotOnPlateInScene-v1")
    assert isinstance(tenv.kernel, megakernel.MegaKernel) and tenv.kernel_refusal is None


def _check_draws(task):
    """The port's own reset (its generator, 64 envs) on the JAX task's
    grids: each env's source and target on two cells of one configuration
    and oriented as one of its orientation pairs, at their rest heights
    (the basket site on the basin's floor, z = -0.06), at rest; more than
    half the configurations drawn; the extras zero; the language instruction per
    env."""
    env = mtt.make(task, num_envs=64, device="cpu")
    env.reset(seed=3)
    sim, ex = env._state.sim, env._state.extras
    xyz = torch.as_tensor(env.xyz_configs, dtype=torch.float32)
    quat = torch.as_tensor(env.quat_configs, dtype=torch.float32)
    poses = []
    for name in (env.source_name, env.target_name):
        i = env.model.free_index.get(name)
        poses.append(sim.free_pose[:, i] if i is not None
                     else sim.kin_pose[:, env.model.kin_index[name]])
    xy = torch.stack([p[:, :2] for p in poses], 1)
    ci = (xy[:, None] - xyz[None, :, :, :2]).abs().sum((-1, -2)).argmin(1)
    assert torch.allclose(xyz[ci, :, :2], xy, atol=1e-6)
    assert len(set(ci.tolist())) > len(xyz) // 2
    q = torch.stack([p[:, 3:] for p in poses], 1)
    assert ((q[:, None] - quat[None]).abs().amax((-1, -2)) < 1e-6).any(1).all()
    src_z, tgt_z = env._src_tgt_rest_z()
    assert torch.allclose(poses[0][:, 2], torch.tensor(src_z)) and torch.allclose(
        poses[1][:, 2], torch.tensor(tgt_z))
    assert not sim.free_vel.any()
    assert not ex["consecutive_grasp"].any() and not ex["is_src_obj_grasped"].any()
    assert env.get_language_instruction() == [env.instruction] * 64


def _check_reset(task):
    """The port's reset from JAX's draws (each env's grid cell and
    orientation pair read off the JAX reset state; its initial joint noise
    the JAX reset's joints): the whole state (sim, command, extras) within
    1e-6 of JAX's reset state, and the port's obs and evaluate on JAX's
    reset state those of JAX's reset."""
    jenv, tenv = _jax(task), _port(task)
    st_j = np_tree(jenv.reset_state)
    src, tgt = tenv.source_name, tenv.target_name
    fp, kp = st_j["sim"]["free_pose"], st_j["sim"]["kin_pose"]
    tgt_xy = (fp[:, tenv.model.free_index[tgt], :2] if tgt in tenv.model.free_index
              else kp[:, tenv.model.kin_index[tgt], :2])
    xy = np.stack([fp[:, tenv.model.free_index[src], :2], tgt_xy], 1)
    ci = np.abs(tenv.xyz_configs[None, :, :, :2] - xy[:, None]).sum((-1, -2)).argmin(1)
    q_src = fp[:, tenv.model.free_index[src], 3:]
    qi = np.abs(tenv.quat_configs[None, :, 0] - q_src[:, None]).sum(-1).argmin(1)
    draws = dict(ci=torch.as_tensor(ci), qi=torch.as_tensor(qi))
    qpos = torch.as_tensor(np.array(st_j["sim"]["qpos"]))
    tenv._draw = lambda gen, k: draws
    tenv._initial_sim_state = lambda k, gen: tenv.model.initial_state(k, "cpu").replace(
        qpos=qpos.clone())
    try:
        st, _obs, _info = tenv._reset_all(torch.Generator().manual_seed(0))
    finally:
        del tenv._draw, tenv._initial_sim_state
    got = convert.to_numpy(st)
    for part in ("sim", "cmd"):
        for name, ref in st_j[part].items():
            if ref is not None and got[part].get(name) is not None:
                np.testing.assert_allclose(got[part][name], ref, atol=1e-6, err_msg=name)
    assert got["extras"].keys() == st_j["extras"].keys()
    for name, ref in st_j["extras"].items():
        np.testing.assert_array_equal(got["extras"][name], ref, err_msg=name)
    if tgt in tenv.model.kin_index:
        assert (got["sim"]["kin_pose"][:, tenv.model.kin_index[tgt], 2] == -0.06).all()
    check_reset_outputs(jenv, tenv, task)


def _check_steps(task):
    """The reset from JAX's draws (``_check_reset``), then two env steps
    from the JAX reset state with random actions in [-1, 1] (each from the
    JAX state of the one before): the physics state, the extras, obs,
    dense reward and evaluate (``torch_parity.compare_env_step``). One
    case compiles the task's JAX programs, so one test process does."""
    _check_reset(task)
    jenv, tenv = _jax(task), _port(task)
    rng = np.random.default_rng(sum(map(ord, task)))
    st_j = jenv.reset_state
    for i in range(2):
        action = rng.uniform(-1.0, 1.0, (K, tenv.action_dim)).astype(np.float32)
        st_j, bad = compare_env_step(jenv._jit_step, tenv, st_j, action, f"{task} step {i}")
        assert bad.sum() <= K // 4, (i, bad)


TASK_CHECKS = [(task, c) for task in TASKS for c in ("tables", "draws", "steps")]


@pytest.mark.parametrize("task, check", TASK_CHECKS, ids=[f"{t}-{c}" for t, c in TASK_CHECKS])
def test_task_matches_jax(task, check):
    """One check of an id (``_check_*``): the model tables against the JAX
    model's; the port's own reset draws on the JAX grids; the reset from
    JAX's draws and env steps from the JAX reset state."""
    {"tables": _check_tables, "draws": _check_draws, "steps": _check_steps}[check](task)


def test_state_dict_round_trip_and_sample_action_match_jax():
    """On PutCarrotOnPlateInScene-v1's JAX reset state: the port's
    ``get_state_dict`` against JAX's (keys in order, every array), a
    round trip through ``set_state_dict`` after a step (the next step then
    bit for bit that of the restored state), ``get_state``'s flat vector
    against JAX's leaves flattened env by env, a restore without ``contacts`` (zero warm start), and
    ``sample_action`` on the same numpy draw as JAX's ``RandomState``."""
    task = "PutCarrotOnPlateInScene-v1"
    jenv, tenv = _jax(task), _port(task)
    tenv._state = convert.env_state_from_numpy(np_tree(jenv.reset_state))
    jenv._state = jenv.reset_state
    sd_t, sd_j = tenv.get_state_dict(), jenv.get_state_dict()

    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            key = f"{prefix}/{k}"
            out.update(flat(v, key) if isinstance(v, dict) else {key: v})
        return out

    ft, fj = flat(sd_t), flat(sd_j)
    assert list(ft) == list(fj)
    for k in fj:
        np.testing.assert_allclose(ft[k].numpy(), np.asarray(fj[k]), atol=1e-7, err_msg=k)
    # the JAX get_state cannot concatenate the (K, P, 3) impulses (ROADMAP
    # Queue C): the port's flat vector is JAX's leaves, each flattened by env
    np.testing.assert_allclose(tenv.get_state().numpy(), np.concatenate(
        [np.asarray(v, np.float32).reshape(K, -1) for v in fj.values()], -1), atol=1e-7)
    saved = tenv.get_state_dict()
    saved = {k: {n: v.clone() for n, v in d.items()} for k, d in saved.items()}
    a = torch.full((K, tenv.action_dim), 0.3)
    out1 = tenv.step(a)[0]
    tenv.set_state_dict(saved)
    for k, v in flat(tenv.get_state_dict()).items():
        assert torch.equal(v, flat(saved)[k]), k
    assert torch.equal(tenv.step(a)[0], out1)
    tenv.set_state_dict({k: v for k, v in saved.items() if k != "contacts"})
    assert not tenv._state.sim.contact_lam.any() and not tenv._state.sim.contact_lam_t.any()
    rs = np.random.RandomState(5)
    ref = jenv.sample_action(rs)
    u = np.random.RandomState(5).uniform(0.0, 1.0, (K, tenv.action_dim))
    with mock.patch.object(torch, "rand", lambda *args, **kw: torch.as_tensor(u, dtype=torch.float32)):
        got = tenv.sample_action(torch.Generator())
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    lo, hi = tenv.single_action_space
    assert (got.numpy() >= lo).all() and (got.numpy() <= hi).all()


def test_drive_properties_and_extras_across_resets():
    """``set_drive_properties`` changes the named joints' gains in the
    named envs only, and a reset restores the controller's; the int32
    ``consecutive_grasp`` count and the latched ``is_src_obj_grasped`` flag
    survive a partial reset in the envs kept and start from zero in the
    envs reset, as after a second whole reset."""
    env = mtt.make("StackGreenCubeOnYellowCubeBakedTexInScene-v1", num_envs=K, device="cpu")
    env.reset(seed=0)
    kp0 = env._state.cmd.kp.clone()
    env.set_drive_properties(stiffness=7.0, damping=[1.0, 2.0], joint_names=["waist", "elbow"],
                             env_idx=[1, 3])
    cmd = env._state.cmd
    assert (cmd.kp[[1, 3]][:, [0, 2]] == 7.0).all() and (cmd.kd[[1, 3]][:, [0, 2]] == torch.tensor(
        [1.0, 2.0])).all()
    keep = torch.ones_like(cmd.kp, dtype=torch.bool)
    keep[1, 0] = keep[1, 2] = keep[3, 0] = keep[3, 2] = False
    assert torch.equal(cmd.kp[keep], kp0[keep])
    env.step(torch.zeros(K, env.action_dim))
    env._state = env._state.replace(extras=dict(
        consecutive_grasp=torch.tensor([3, 4, 5, 6], dtype=torch.int32),
        is_src_obj_grasped=torch.tensor([True, False, True, True])))
    env.reset(options={"env_idx": [0, 2]})
    ex = env._state.extras
    assert ex["consecutive_grasp"].dtype == torch.int32
    assert ex["consecutive_grasp"].tolist() == [0, 4, 0, 6]
    assert ex["is_src_obj_grasped"].tolist() == [False, False, False, True]
    assert torch.equal(env._state.cmd.kp[[0, 2]], kp0[[0, 2]])
    env.reset()
    assert not env._state.extras["consecutive_grasp"].any()
    assert not env._state.extras["is_src_obj_grasped"].any()
    assert torch.equal(env._state.cmd.kp, kp0)


def test_contact_state_loads_the_bridge_branches():
    """``contact_state`` (the kernel checks' contact states) from the
    port's reset, 4 envs: finite; in the plain control step from it the
    gripper's capsule presses the eggplant (``capsule_hull``) in half the
    envs or more, and the carrot sits on the plate (``hull_hull``) in
    three quarters."""
    from maniskill_tpu_torch.physics.engine import make_step_fn

    for task, fn in (("PutEggplantInBasketScene-v1", "capsule_hull"),
                     ("PutCarrotOnPlateInScene-v1", "hull_hull")):
        env = mtt.make(task, num_envs=4, device="cpu")
        env.reset(seed=0)
        cst = env.contact_state(env._state, torch.Generator().manual_seed(0))
        assert torch.isfinite(cst.sim.qpos).all() and torch.isfinite(cst.sim.free_pose).all()
        sim, aux = make_step_fn(env.model)(cst.sim, cst.cmd, env.sim_steps_per_control,
                                           return_aux=True)
        loaded = (aux["f_pt"].abs().sum(-1) > 0) | (sim.contact_lam > 0)
        pts = torch.as_tensor(megakernel._Plan(env.model).pfn == megakernel._FNS.index(fn))
        share = float(loaded[:, pts].any(1).float().mean())
        assert share >= (0.5 if fn == "capsule_hull" else 0.75), (task, share)

