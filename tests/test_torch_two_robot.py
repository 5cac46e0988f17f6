"""The two-robot family and the last tabletop ids through the PyTorch port
against the JAX package, on the CPU: ``MultiAgent`` (two Pandas merged into
one forest: ``split_action``, ``proprioception``, the per-agent TCP and
grasp checker, the refusal of task-space modes) and the seven ids
TwoRobotPushCube-v1, TwoRobotPickCube-v1, TwoRobotStackCube-v1,
TwoRobotFold-v1, TwoRobotPickCubeYCB-v1 (beyond the kernel's ``NALL_MAX``:
the plain step), PlaceSphere-v1 and PickCubeYCB-v1.

Each id's JAX env (K envs on its XLA engine, ``sim_backend="xla"``: the
plain reference of its Pallas kernel, which refuses all seven through its
TPU compile gates) is reset with seed 0; the port's obs and evaluate on
JAX's reset state must be JAX's, and the port takes two control steps from
the JAX states with random actions against JAX's env step, compiled once
a task (``torch_parity.shared_jit``). The port's own reset draws are held
to the JAX ranges.

Tolerances: the env step those of tests/test_megakernel.py:48-67 (qpos
2e-5, qvel 2e-4, free pose 2e-5, free vel 5e-4, impulses 5e-3), an env
beyond one refereed by the port's plain step in float64
(``torch_parity.refereed``; only envs in contact may be); the step's obs
2e-4, reward 1e-4, evaluate's flags exactly, in the envs held; the reset's
obs and evaluate 1e-5 relative; the model tables exactly.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.agents.multi_agent import MultiAgent as JMultiAgent
from maniskill_tpu.physics import megakernel as jmk

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch.agents.multi_agent import MultiAgent
from maniskill_tpu_torch.envs.base_env import TaskContext
from maniskill_tpu_torch.examples.motionplanning import solutions
from maniskill_tpu_torch.physics import megakernel
from torch_parity import (check_reset_outputs, check_tables, compare_env_step,
                          fast_trace_metadata, make_jax_env)

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)

K = 4
_BOXES = ["box_box_corners", "box_box_onesided", "plane_box"]
_YCB = ["box_box_corners", "box_box_onesided", "box_hull", "hull_hull", "plane_box", "plane_hull"]
# (nq, F, G, P, n_kin, action dim, obs dim, pair functions) of each id's model
TASKS = {
    "TwoRobotPushCube-v1": (18, 2, 14, 832, 1, 16, 67, _BOXES),
    "TwoRobotPickCube-v1": (18, 1, 13, 656, 1, 16, 66, _BOXES),
    "TwoRobotStackCube-v1": (18, 2, 14, 860, 1, 16, 67, ["box_box"] + _BOXES),
    "TwoRobotFold-v1": (19, 0, 14, 728, 0, 16, 51, _BOXES[:2]),
    "TwoRobotPickCubeYCB-v1": (18, 3, 15, 1968, 1, 16, 66, _YCB),
    "PlaceSphere-v1": (9, 2, 13, 812, 0, 8, 35, [
        "box_box", "box_box_corners", "box_box_onesided", "plane_box", "plane_sphere",
        "sphere_box"]),
    "PickCubeYCB-v1": (9, 3, 10, 968, 1, 8, 42, _YCB),
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


# ---- MultiAgent --------------------------------------------------------------------


def test_multi_agent_matches_jax():
    """Two Pandas: the flat action bounds, gains and action dims; the
    split of a flat action; ``proprioception`` by agent (``panda-0``,
    ``panda-1``); each agent's qpos slice; the controller's targets for two
    successive actions on random joint positions against the JAX
    composite-of-composites; a task-space mode refused in both packages
    with the same error."""
    ta = MultiAgent(("panda", "panda"), device="cpu", control_mode="pd_joint_delta_pos")
    ja = JMultiAgent(("panda", "panda"), control_mode="pd_joint_delta_pos")
    assert ta.action_dim == ja.action_dim == 16 and ta.nq == ja.nq == 18
    for name in ("action_low", "action_high"):
        np.testing.assert_array_equal(getattr(ta, name), np.asarray(getattr(ja, name)))
    for name in ("kp", "kd", "force_limit"):
        np.testing.assert_array_equal(getattr(ta.controller, name),
                                      np.asarray(getattr(ja.controller, name)))
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (K, 16)).astype(np.float32)
    for x, y in zip(ta.split_action(torch.as_tensor(a)), ja.split_action(jnp.asarray(a))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    q = rng.normal(size=(K, 18)).astype(np.float32)
    v = rng.normal(size=(K, 18)).astype(np.float32)
    pt = ta.proprioception(torch.as_tensor(q), torch.as_tensor(v))
    pj = ja.proprioception(jnp.asarray(q), jnp.asarray(v))
    assert list(pt) == list(pj) == ["panda-0", "panda-1"]
    for agent in pj:
        assert list(pt[agent]) == list(pj[agent])
        for k in pj[agent]:
            np.testing.assert_array_equal(pt[agent][k].numpy(), np.asarray(pj[agent][k]))
    assert [ta.qpos_slice_of(i) for i in (0, 1)] == [ja.qpos_slice_of(i) for i in (0, 1)]
    import jax

    cmd_t = ta.controller.reset(torch.as_tensor(q))
    cmd_j = jax.vmap(ja.controller.reset)(jnp.asarray(q))
    jset = jax.jit(jax.vmap(ja.controller.set_action))
    for _ in range(2):
        act = rng.uniform(-1, 1, (K, 16)).astype(np.float32)
        cmd_t = ta.controller.set_action(cmd_t, torch.as_tensor(q), torch.as_tensor(act))
        cmd_j = jset(cmd_j, jnp.asarray(q), jnp.asarray(act))
        np.testing.assert_allclose(cmd_t.target_qpos.numpy(), np.asarray(cmd_j.target_qpos),
                                   atol=1e-6)
    assert cmd_t.kp is None and cmd_j.kp is None  # the model's gains
    for mode in ("pd_ee_delta_pos", "pd_ee_delta_pose"):
        with pytest.raises(NotImplementedError, match="joint-space controllers only"):
            MultiAgent(("panda", "panda"), device="cpu", control_mode=mode)
        with pytest.raises(NotImplementedError, match="joint-space controllers only"):
            JMultiAgent(("panda", "panda"), control_mode=mode)


# ---- the seven ids ---------------------------------------------------------------


def _check_tables(task):
    """nq, F, G, P, the kinematic bodies, the action and obs dims, the pair
    functions; the model tables equal to the JAX model's (the two arms'
    links under their prefixes, robot-robot pairs across the two trees);
    the JAX kernel refuses every one of the seven, the port's takes all but
    TwoRobotPickCubeYCB-v1, whose n_all (18 + 6 x 3 = 36) is beyond
    ``NALL_MAX``: its env runs the plain step and says why."""
    jenv, tenv = _jax_env(task), _port(task)
    jm, tm = jenv.model, tenv.model
    nq, F, G, P, nk, adim, odim, fns = TASKS[task]
    for m in (tm, jm):
        assert (m.nq, m.n_free, len(m.geoms), m.n_points, m.n_kin) == (nq, F, G, P, nk)
        assert sorted({g[0].__name__ for g in m.pair_groups}) == sorted(fns)
    assert tenv.action_dim == jenv.action_dim == adim
    check_tables(tm, jm)
    np.testing.assert_array_equal(tm.tree_id, np.asarray(
        jm.tree_id if jm.tree_id is not None else np.zeros(nq, np.int32)))
    assert not jmk.supports(jm)
    if task == "TwoRobotPickCubeYCB-v1":
        assert megakernel.refusal(tm) == "n_all 36 > NALL_MAX 32"
        assert not megakernel.supports(tm)
        assert tenv.kernel is None and tenv.kernel_refusal == "n_all 36 > NALL_MAX 32"
    else:
        assert megakernel.supports(tm) and tenv.kernel_refusal is None
        assert isinstance(tenv.kernel, megakernel.MegaKernel)
    if tm.robot.nb >= 18:  # two arms: each one's TCP under its prefix, on its side
        ctx = TaskContext(tenv, tenv._reset_all(torch.Generator().manual_seed(0))[0])
        p0, p1 = (tenv.agent.tcp_pose_of(i, ctx).p for i in (0, 1))
        assert (p0[:, 1] < 0).all() and (p1[:, 1] > 0).all()


def _check_reset(task):
    """The port's obs and evaluate on JAX's reset state: those of JAX's
    reset (``torch_parity.check_reset_outputs``)."""
    jenv, tenv = _jax(task), _port(task)
    check_reset_outputs(jenv, tenv, task)
    assert np.asarray(jenv.reset_out[0]).shape == (K, TASKS[task][6])


def _check_steps(task):
    """The reset's obs and evaluate (``_check_reset``), then two env steps
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


def _check_draws(task):
    """The port's own reset draws (its generator, 64 envs) fall in the JAX
    tasks' ranges: cube A at y in [-0.35, -0.2] and B in [0.2, 0.35], the
    goal region fixed; the lid open 0.05-0.35 rad short of its limit; the
    handover cube in [-0.1, 0.1] x [-0.3, -0.15],
    its aerial goal at y in [0.15, 0.3], z in [0.15, 0.3]; the bin in [0,
    0.1] x [-0.1, 0.1], the sphere in [-0.12, -0.05] x [-0.1, 0.1]; the
    cube among PickCubeYCB's clutter in [-0.1, 0.1]^2, the distractors in [-0.12, 0.12] x [-0.25, 0.25], dropped from 5 and 8 cm."""
    env = mtt.make(task, num_envs=64, device="cpu")
    env.reset(seed=3)
    fp, kp = env._state.sim.free_pose, env._state.sim.kin_pose

    def within(x, lo, hi):
        return bool(((x >= torch.tensor(lo)) & (x <= torch.tensor(hi))).all()) and float(
            x.std(0).min()) > 0.01

    if task in ("TwoRobotStackCube-v1", "TwoRobotPushCube-v1"):
        assert within(fp[:, env.cube_a, :2], [-0.1, -0.35], [0.1, -0.2])
        assert within(fp[:, env.cube_b, :2], [-0.1, 0.2], [0.1, 0.35])
        assert torch.equal(kp[:, env.goal_region], torch.tensor(
            [0.05, 0.0, 1e-3, 1, 0, 0, 0]).expand(64, 7))
    elif task == "TwoRobotFold-v1":
        lid = env._state.sim.qpos[:, env._lid_body]
        assert within(lid[:, None], [env.lid_qmax - 0.35], [env.lid_qmax - 0.05])
    elif task == "PlaceSphere-v1":
        assert within(fp[:, env.bin, :2], [0.0, -0.1], [0.1, 0.1])
        assert within(fp[:, env.sphere, :2], [-0.12, -0.1], [-0.05, 0.1])
    else:
        if task in ("TwoRobotPickCubeYCB-v1", "TwoRobotPickCube-v1"):
            assert within(fp[:, env.cube, :2], [-0.1, -0.3], [0.1, -0.15])
            assert within(kp[:, env.goal_site, :3], [-0.1, 0.15, 0.15], [0.1, 0.3, 0.3])
        if task == "PickCubeYCB-v1":
            assert within(fp[:, env.cube, :2], [-0.1, -0.1], [0.1, 0.1])
        for i, d in enumerate(getattr(env, "distractors", ())):
            assert within(fp[:, d, :2], [-0.12, -0.25], [0.12, 0.25])
            assert (fp[:, d, 2] == 0.05 + 0.03 * i).all()


TASK_CHECKS = [(task, c) for task in TASKS for c in ("tables", "draws", "steps")]


@pytest.mark.parametrize("task, check", TASK_CHECKS, ids=[f"{t}-{c}" for t, c in TASK_CHECKS])
def test_task_matches_jax(task, check):
    """One check of an id (``_check_*``): the model tables against the JAX
    model's; the port's own reset draws in the JAX ranges; the reset's obs
    and evaluate and env steps from the JAX reset state."""
    {"tables": _check_tables, "draws": _check_draws, "steps": _check_steps}[check](task)


# ---- the port alone ----------------------------------------------------------------


@pytest.mark.parametrize("task", ["TwoRobotStackCube-v1", "TwoRobotFold-v1", "PickCubeYCB-v1",
                                  "PlaceSphere-v1"])
def test_contact_state_loads_the_scene(task):
    """``contact_state`` (the kernel checks' contact states) from the
    port's reset, 8 envs: finite; in the plain control step from it cube A
    on cube B (``box_box``), the left arm's fingers on the suitcase's lid
    (``box_box_corners`` across the trees), the stacked distractors
    (``hull_hull``) or the sphere held or in its bin (``sphere_box``) carry
    force in half the envs or more."""
    from maniskill_tpu_torch.physics.engine import make_step_fn

    fn = {"TwoRobotStackCube-v1": "box_box", "TwoRobotFold-v1": "box_box_corners",
          "PickCubeYCB-v1": "hull_hull", "PlaceSphere-v1": "sphere_box"}[task]
    env = mtt.make(task, num_envs=8, device="cpu")
    env.reset(seed=0)
    cst = env.contact_state(env._state, torch.Generator().manual_seed(0))
    assert torch.isfinite(cst.sim.qpos).all() and torch.isfinite(cst.sim.free_pose).all()
    sim, aux = make_step_fn(env.model)(cst.sim, cst.cmd, env.sim_steps_per_control,
                                       return_aux=True)
    loaded = (aux["f_pt"].abs().sum(-1) > 0) | (sim.contact_lam > 0)
    plan = megakernel._Plan(env.model)
    pts = plan.pfn == megakernel._FNS.index(fn)
    if task == "TwoRobotFold-v1":
        pts &= (plan.pra >= 0) & (plan.prb >= 0)
    share = float(loaded[:, torch.as_tensor(pts)].any(1).float().mean())
    assert share >= 0.5, share


def test_pickcube_ycb_solution_is_registered():
    """PickCubeYCB-v1's scripted solution is the generic pick-and-place
    (``solve_pick_object``) under ``pd_ee_delta_pos``, as in the JAX
    package; on the port's env its first control steps run and keep the
    state finite."""
    from maniskill_tpu.examples.motionplanning import solutions as jsol

    assert solutions.SOLUTIONS["PickCubeYCB-v1"] is solutions.solve_pick_object
    assert jsol.SOLUTIONS["PickCubeYCB-v1"].__name__ == "solve_pick_object"
    assert "PickCubeYCB-v1" not in solutions.CONTROL_MODES
    env = mtt.make("PickCubeYCB-v1", num_envs=2, device="cpu", control_mode="pd_ee_delta_pos")
    env.reset(seed=0)
    steps = []

    class Recorder:
        def step(self, action):
            steps.append(action)
            if len(steps) > 3:
                raise StopIteration
            return env.step(action)

    with pytest.raises(StopIteration):
        solutions.solve_pick_object(env, Recorder())
    assert torch.isfinite(env._state.sim.qpos).all() and len(steps) == 4
