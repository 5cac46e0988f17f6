"""PickCube-v1 through the PyTorch port against the JAX package, on the CPU.

The same inputs go through both: a JAX reset state carried across with
``maniskill_tpu_torch.convert``, actions and MPPI noise drawn in numpy or by
JAX and handed to both. The JAX side uses its XLA engine
(``sim_backend="xla"``), the plain reference of its Pallas kernel.

Tolerances start from tests/test_megakernel.py:48-67 (qpos 2e-5, qvel 2e-4,
free pose 2e-5, free vel 5e-4, impulses 5e-3): both sides are float32 and
differ only in the order of sums, and contact impulses are in newtons with
a stiff implicit law, so they take the widest bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.physics import engine as jeng
from maniskill_tpu.planners.mppi import MPPI as JMPPI, MPPIConfig as JMPPIConfig

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.math import clamps
from maniskill_tpu_torch.physics import engine as teng
from maniskill_tpu_torch.physics import megakernel
from maniskill_tpu_torch.planners.mppi import MPPI, MPPIConfig
from torch_parity import fast_trace_metadata, make_jax_env, np_tree as _np

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _fast_jax_tables():
    """The JAX package's static contact tables through one jitted program
    (tests/torch_parity.py): its env builds take seconds, not tens."""
    with fast_trace_metadata():
        yield

K = 4
TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
           contact_lam=5e-3, contact_lam_t=5e-3)


@pytest.fixture(scope="module")
def jenv():
    env = make_jax_env("PickCube-v1", num_envs=K, reward_mode="dense",
                   sim_backend="xla")
    env.reset(seed=0)
    return env


@pytest.fixture(scope="module")
def tenv():
    return mtt.make("PickCube-v1", num_envs=K, reward_mode="dense", device="cpu")


@pytest.fixture(scope="module")
def jstep(jenv):
    """The JAX XLA engine, one sim step with aux per call, vmapped and
    jitted once for the module: one sim step per call keeps the compile
    small, and with a constant command 5 calls are one control step."""
    step = jeng.make_step_fn(jenv.model)
    return jax.jit(jax.vmap(lambda s, c: step(s, c, 1, True)))


def _assert_sim_close(sim_t, sim_j):
    got = convert.to_numpy(sim_t)
    for name, tol in TOL.items():
        np.testing.assert_allclose(got[name], np.asarray(getattr(sim_j, name)),
                                   atol=tol, err_msg=name)


def test_static_model_tables_match(jenv, tenv):
    """Exact equality of the static tables the kernel's row plan rests on."""
    jm, tm = jenv.model, tenv.model
    assert tm.n_points == jm.n_points == 136
    assert (tm.nq, tm.n_free, len(tm.geoms)) == (jm.nq, jm.n_free, len(jm.geoms))
    assert len(tm.pair_groups) == len(jm.pair_groups)
    for gt, gj in zip(tm.pair_groups, jm.pair_groups):
        assert gt[0].__name__ == gj[0].__name__ and gt[1] == gj[1]
        for a, b in zip(gt[2:], gj[2:]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(teng._assignment_tables(tm), jeng._assignment_tables(jm)):
        np.testing.assert_array_equal(a, b)
    mt, mj = teng._trace_metadata(tm), jeng._trace_metadata(jm)
    for i in range(3):  # contact pos / normal / depth at the initial state
        np.testing.assert_allclose(mt[i].numpy(), np.asarray(mj[i]), atol=1e-6)
    for i in range(3, 7):  # mu, damping, k, m
        np.testing.assert_array_equal(mt[i].numpy(), np.asarray(mj[i]))
    assert [tuple(map(int, m)) for m in mt[7]] == [tuple(map(int, m)) for m in mj[7]]
    assert [tuple(map(int, m)) for m in mt[8]] == [tuple(map(int, m)) for m in mj[8]]
    for name in ("ancestor_mask", "robot_inertia_com", "robot_qlim", "drive_kp",
                 "drive_kd", "drive_force_limit", "init_qpos", "static_pose",
                 "free_mass", "free_inertia", "robot_base_pose"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)


def test_engine_step_and_force_query_match(jenv, tenv, jstep):
    """Three control steps (5 sim steps each) of the plain engine step from
    the JAX reset state with perturbed targets, then the contact-force
    query, against the JAX XLA engine."""
    st = jenv._state
    cmd_j = st.cmd.replace(target_qpos=st.cmd.target_qpos + 0.05)
    jf = jstep
    tstep = teng.make_step_fn(tenv.model)
    sim_j, sim_t = st.sim, convert.sim_state_from_numpy(_np(st.sim))
    cmd_t = convert.drive_cmd_from_numpy(_np(cmd_j))
    for _ in range(15):
        sim_j, aux_j = jf(sim_j, cmd_j)
    for _ in range(3):
        sim_t, aux_t = tstep(sim_t, cmd_t, 5, return_aux=True)
    _assert_sim_close(sim_t, sim_j)
    # cube resting on the table, in both
    assert np.all(np.abs(np.asarray(sim_j.free_pose[:, 0, 2]) - 0.02) < 5e-3)
    np.testing.assert_allclose(aux_t["f_pt"].numpy(), np.asarray(aux_j["f_pt"]), atol=5e-3)
    np.testing.assert_allclose(aux_t["body_pos"].numpy(), np.asarray(aux_j["body_pos"]),
                               atol=2e-5)
    jq = jax.jit(jax.vmap(lambda s: jeng.make_force_query(jenv.model)(s)[0]))
    f_j = np.asarray(jq(sim_j))
    sim_t = convert.sim_state_from_numpy(_np(sim_j))
    f_t = teng.make_force_query(tenv.model)(sim_t)[0].numpy()
    assert np.abs(f_j).max() > 0.1  # the cube's weight is carried
    np.testing.assert_allclose(f_t, f_j, atol=5e-3)


def test_engine_step_matches_from_contact_states(jenv, tenv, jstep):
    """One control step of the plain engine step against the JAX XLA engine
    from states in contact (``PickCubeEnv.contact_state``: cube held in the
    fingers with the fingertips at the table, or lying on the floor; warm
    impulses loaded; targets perturbed). The finger-cube
    (box_box_corners), finger- and cube-table (box_box_onesided) and
    cube-floor (plane_box) points, and friction, carry force in these
    states, and the test checks that they do."""
    st_t = tenv.contact_state(convert.env_state_from_numpy(_np(jenv._state)),
                              torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    cmd_t = st_t.cmd.replace(target_qpos=st_t.cmd.target_qpos + torch.as_tensor(
        rng.normal(0.0, 0.05, (K, tenv.model.nq)), dtype=torch.float32))

    def to_jax(like, port):
        return like.replace(**{k: jnp.asarray(v)
                               for k, v in convert.to_numpy(port).items() if v is not None})

    sim_j, cmd_j = to_jax(jenv._state.sim, st_t.sim), to_jax(jenv._state.cmd, cmd_t)
    for _ in range(tenv.sim_steps_per_control):
        sim_j, aux_j = jstep(sim_j, cmd_j)
    sim_t, aux_t = teng.make_step_fn(tenv.model)(
        st_t.sim, cmd_t, tenv.sim_steps_per_control, return_aux=True)
    _assert_sim_close(sim_t, sim_j)
    np.testing.assert_allclose(aux_t["f_pt"].numpy(), np.asarray(aux_j["f_pt"]), atol=5e-3)
    plan = megakernel._Plan(tenv.model)
    robot = (plan.pra >= 0) | (plan.prb >= 0)
    loaded = np.abs(np.asarray(aux_j["f_pt"])).sum(-1) > 0
    grasp = np.arange(K) % 4 != 3
    assert loaded[grasp][:, plan.pfn == 2].sum(1).min() >= 4  # finger-cube
    assert loaded[grasp][:, (plan.pfn == 1) & ~robot].sum(1).min() >= 2  # cube-table
    assert loaded[~grasp][:, plan.pfn == 0].sum(1).min() >= 2  # cube-floor
    lam_t = np.abs(np.asarray(sim_j.contact_lam_t)).sum(-1) > 0
    assert lam_t[grasp].sum(1).min() >= 6
    # fingertips within the contact margin of the table
    depth = teng.compute_contacts(tenv.model, st_t.sim,
                                  *teng.robot_fk(tenv.model, st_t.sim.qpos)[:2])[2]
    assert (depth[grasp][:, (plan.pfn == 1) & robot] > -0.01).sum(1).min() >= 4


def test_env_step_outputs_match(jenv, tenv):
    """One env step from the same state and action: obs (42-dim state
    obs), dense reward, success and the grasp flag."""
    rng = np.random.default_rng(0)
    action = rng.uniform(-1, 1, (K, jenv.action_dim)).astype(np.float32)
    st_j, obs_j, rew_j, _term, info_j = jax.jit(jax.vmap(jenv._step_one))(
        jenv._state, jnp.asarray(action))
    st_t = convert.env_state_from_numpy(_np(jenv._state))
    st_t, obs_t, rew_t, _term_t, info_t = tenv._step(st_t, torch.as_tensor(action))
    assert obs_t.shape == (K, 42)
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=2e-4)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-4)
    for key in ("success", "is_grasped", "is_obj_placed", "is_robot_static"):
        np.testing.assert_array_equal(info_t[key].numpy(), np.asarray(info_j[key]), key)
    _assert_sim_close(st_t.sim, st_j.sim)
    # the controller targets are the same function of the action
    np.testing.assert_allclose(st_t.cmd.target_qpos.numpy(),
                               np.asarray(st_j.cmd.target_qpos), atol=1e-6)


def test_mppi_solve_nominal_matches(jenv, tenv):
    """One MPPI solve at K=8, H=3 with the JAX noise injected: the nominal
    and the rollout returns match."""
    Ks, H = 8, 3
    cfg = dict(horizon=H, num_samples=Ks, sigma=0.6, temperature=0.3)
    jp = JMPPI(jenv, JMPPIConfig(**cfg))
    ps_j = jp.init(seed=0)
    start = jax.tree.map(lambda x: x[0], jenv._state)
    ps_j2, info_j = jp.solve(ps_j, start)
    k_noise = jax.random.split(ps_j.key)[1]
    white = np.asarray(jax.random.normal(k_noise, (Ks, H, jenv.action_dim)))
    tp = MPPI(tenv, MPPIConfig(**cfg))
    st_t = convert.env_state_from_numpy(_np(jax.tree.map(lambda x: x[:1], jenv._state)))
    ps_t, info_t = tp.solve(tp.init(seed=0), st_t, noise=torch.tensor(white))
    np.testing.assert_allclose(float(info_t["best_return"]),
                               float(info_j["best_return"]), atol=1e-4)
    np.testing.assert_allclose(float(info_t["mean_return"]),
                               float(info_j["mean_return"]), atol=1e-4)
    np.testing.assert_allclose(ps_t.nominal.numpy(), np.asarray(ps_j2.nominal), atol=1e-4)


def test_engine_jvp_at_reset_state_matches_jax(jenv, tenv, monkeypatch):
    """Forward-mode derivative of one sim step of the plain engine step at
    the JAX reset states, against ``jax.jvp`` of the JAX engine step, along
    two seeded directions per env in (qpos, qvel, free_pose, free_vel).
    The reset state sits on kinks: the cube rests at exactly zero depth
    (the box SDF's ``min(max q, 0)``) and the gripper joints at their upper
    limit (the joint-limit ``max(qpos - hi, 0)``), where JAX splits the
    derivative 0.5/0.5, as ``math.clamps`` does. Tolerance: 1e-5 of each
    output's largest tangent (float32 rounding of stiff contact terms).
    With ``math.clamps`` swapped for torch's convention (the whole
    derivative to ``x`` at a bound, as ``torch.clamp`` gives) the qvel and
    impulse tangents leave by more than half their scale."""
    names = ("qpos", "qvel", "free_pose", "free_vel")
    outs = names + ("contact_lam", "contact_lam_t")
    st = jenv._state
    step = jeng.make_step_fn(jenv.model)
    rng = np.random.default_rng(3)
    tans = [{n: rng.normal(size=np.shape(getattr(st.sim, n))).astype(np.float32) for n in names}
            for _ in range(2)]

    def f(sim, cmd, *x):
        new = step(sim.replace(**dict(zip(names, x))), cmd, 1)
        return tuple(getattr(new, n) for n in outs)

    def jvp_one(sim, cmd, *t):
        return jax.jvp(lambda *x: f(sim, cmd, *x), tuple(getattr(sim, n) for n in names), t)[1]

    jv = jax.jit(jax.vmap(jvp_one))
    refs = [[np.asarray(r) for r in jv(st.sim, st.cmd, *[jnp.asarray(t[n]) for n in names])]
            for t in tans]
    sim_t = convert.sim_state_from_numpy(_np(st.sim))
    cmd_t = convert.drive_cmd_from_numpy(_np(st.cmd))
    tstep = teng.make_step_fn(tenv.model)

    def rel_errors():
        """Largest |port - JAX| tangent of each output over its scale."""
        worst = dict.fromkeys(outs, 0.0)
        for t, ref in zip(tans, refs):
            _, got = torch.func.jvp(
                lambda *x: tuple(getattr(tstep(sim_t.replace(**dict(zip(names, x))), cmd_t, 1), n)
                                 for n in outs),
                tuple(getattr(sim_t, n) for n in names),
                tuple(torch.as_tensor(t[n]) for n in names))
            for name, a, b in zip(outs, got, ref):
                scale = max(np.abs(b).max(), 1e-3)
                worst[name] = max(worst[name], float(np.abs(a.numpy() - b).max()) / scale)
        return worst

    worst = rel_errors()
    assert max(worst.values()) <= 1e-5, worst

    def whole_to_x(a, b):  # torch's convention: the derivative goes to a at a tie
        b = b if isinstance(b, torch.Tensor) else torch.full_like(a, b)
        return torch.where(a >= b, a, b)

    def whole_to_x_min(a, b):
        b = b if isinstance(b, torch.Tensor) else torch.full_like(a, b)
        return torch.where(a <= b, a, b)

    monkeypatch.setattr(clamps, "maximum", whole_to_x)
    monkeypatch.setattr(clamps, "minimum", whole_to_x_min)
    monkeypatch.setattr(clamps, "clip", lambda x, lo, hi: whole_to_x_min(whole_to_x(x, lo), hi))
    torch_conv = rel_errors()
    assert torch_conv["qvel"] > 0.5 and torch_conv["contact_lam"] > 0.5, torch_conv
    # the reset state does sit on the kinks
    np.testing.assert_array_equal(np.asarray(st.sim.qpos[:, 7:]),
                                  np.broadcast_to(jenv.model.robot_qlim[7:, 1], (K, 2)))
    assert np.asarray(jnp.abs(st.sim.free_pose[:, 0, 2] - 0.02)).max() == 0.0
