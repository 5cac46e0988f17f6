"""The Panda's eight control modes through the PyTorch port against the JAX
package, on the CPU: the damped-least-squares IK step (``dls_ik_delta``, its
SPD solve through K1's plain version here), each mode's action space and
``set_action`` (joint position, delta, target delta, velocity, position and
velocity, and the task-space ``pd_ee_delta_pos``/``pd_ee_delta_pose``), and
one env step and one ``_rollout_step`` of PickCube-v1 under
``pd_ee_delta_pos`` from the JAX reset.

The same inputs go through both: joint positions and actions from a numpy
seed (actions beyond [-1, 1] included), JAX reset states carried across
with ``maniskill_tpu_torch.convert``. The JAX env runs its XLA engine
(``sim_backend="xla"``), the plain reference of its Pallas kernel; it is
built once per process (``torch_parity.jax_env``) and its jitted step is
reused.

Tolerances: ``dls_ik_delta`` rtol 1e-5, atol 1e-6 (float32; the JAX
package solves with LU, the port with a Cholesky factor); drive targets
1e-5; the env step those of tests/test_megakernel.py:48-67 (qpos 2e-5,
qvel 2e-4, free pose 2e-5, free vel 5e-4, impulses 5e-3), obs 2e-4, reward
1e-4. (One EE control step's K1 and K2 against their plain versions on a
card: ``test_ee_control_step_kernels_match_plain`` in
tests/test_torch_megakernel.py, which imports no JAX.)
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.agents.robots.panda import Panda as JPanda
from maniskill_tpu.agents.robots.panda import PandaWristCam as JPandaWristCam
from maniskill_tpu.kinematics import chain as jchain

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch import convert
from maniskill_tpu_torch.agents.robots.panda import Panda, PandaWristCam
from maniskill_tpu_torch.kinematics import chain
from torch_parity import fast_trace_metadata, jax_env, np_tree as _np

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)

MODES = ["pd_joint_delta_pos", "pd_joint_pos", "pd_ee_delta_pos", "pd_ee_delta_pose",
         "pd_joint_target_delta_pos", "pd_joint_vel", "pd_joint_pos_vel",
         "pd_joint_delta_pos_vel"]
K = 8
K_ENV = 2  # the PickCube env: test_torch_solutions.py builds the same one
TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
           contact_lam=5e-3, contact_lam_t=5e-3)
# a base yawed by 30 degrees, so that the root frame is not the world's
BASE = np.array([-0.615, 0.1, 0.0, np.cos(np.pi / 12), 0.0, 0.0, np.sin(np.pi / 12)],
                np.float32)


@pytest.fixture(scope="module", autouse=True)
def _fast_jax_tables():
    """The JAX package's static contact tables through one jitted program
    (tests/torch_parity.py). The JAX env is ``torch_parity.jax_env``'s,
    which test_torch_solutions.py shares."""
    with fast_trace_metadata():
        yield
    _jax_step.cache_clear()


@pytest.mark.parametrize("m", [3, 6])
def test_dls_ik_delta_matches_jax(m):
    """Δq = Jᵀ (J Jᵀ + λ²I)⁻¹ Δx on a batch of random Jacobians (m rows,
    7 joints) and task-space deltas."""
    rng = np.random.default_rng(m)
    J = (0.3 * rng.normal(size=(K, m, 7))).astype(np.float32)
    dx = rng.uniform(-0.1, 0.1, (K, m)).astype(np.float32)
    want = np.asarray(jax.vmap(jchain.dls_ik_delta)(jnp.asarray(J), jnp.asarray(dx)))
    got = chain.dls_ik_delta(torch.as_tensor(J), torch.as_tensor(dx))
    assert got.shape == (K, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_mode_tables_match_jax(mode):
    """Each mode's action space, drive gains and controller layout, for
    ``panda`` and ``panda_wristcam``; the first mode is the default."""
    for cls, jcls in ((Panda, JPanda), (PandaWristCam, JPandaWristCam)):
        agent, jagent = cls(device="cpu", control_mode=mode), jcls(control_mode=mode)
        assert agent.supported_control_modes == jagent.supported_control_modes == tuple(MODES)
        c, jc = agent.controller, jagent.controller
        assert c.action_dim == jc.action_dim
        assert list(c.controllers) == list(jc.controllers) == ["arm", "gripper"]
        for name in ("action_low", "action_high", "kp", "kd", "force_limit"):
            np.testing.assert_array_equal(getattr(c, name), getattr(jc, name), err_msg=name)
        assert c.needs_fk_aux == jc.needs_fk_aux == mode.startswith("pd_ee")
        for sub, jsub in zip(c.controllers.values(), jc.controllers.values()):
            assert sub.action_dim == jsub.action_dim
            np.testing.assert_array_equal(sub.raw_low, jsub.raw_low)
            np.testing.assert_array_equal(sub.raw_high, jsub.raw_high)
    assert Panda(device="cpu").control_mode == JPanda().control_mode == MODES[0]


def _jax_aux(spec, qpos):
    base = jnp.asarray(BASE)
    body_pos, body_quat, axis_w = jax.vmap(lambda q: jchain.fk(spec, base, q))(qpos)
    return base, body_pos, body_quat, axis_w


@pytest.mark.parametrize("mode", MODES)
def test_set_action_matches_jax(mode):
    """Drive targets of two successive actions from seeded random joint
    positions (within the joint limits), actions drawn from [-1.5, 1.5]:
    the clip to the action space, the scale, the joint-limit clip,
    ``use_target`` (the second delta adds to the first's target), and the
    EE modes' IK step on each package's own FK of those positions."""
    agent, jagent = Panda(device="cpu", control_mode=mode), JPanda(control_mode=mode)
    c, jc = agent.controller, jagent.controller
    rng = np.random.default_rng(7)
    qlim = agent.robot_spec.qlim.astype(np.float32)
    qpos = (qlim[:, 0] + (qlim[:, 1] - qlim[:, 0]) * rng.uniform(0.05, 0.95, (K, 9))).astype(
        np.float32)
    actions = rng.uniform(-1.5, 1.5, (2, K, c.action_dim)).astype(np.float32)
    q_t, q_j = torch.as_tensor(qpos), jnp.asarray(qpos)
    aux_t = aux_j = None
    if c.needs_fk_aux:
        base = torch.as_tensor(BASE)
        aux_t = (base,) + chain.fk(agent.robot_spec, base, q_t)
        aux_j = _jax_aux(jagent.robot_spec, q_j)

    @jax.jit
    def jset(cmd, a):
        if aux_j is None:
            return jax.vmap(lambda cm, q, aa: jc.set_action(cm, q, aa))(cmd, q_j, a)
        return jax.vmap(lambda cm, q, aa, b, bq, aw: jc.set_action(
            cm, q, aa, aux=(aux_j[0], b, bq, aw)))(cmd, q_j, a, *aux_j[1:])

    cmd_j = jax.vmap(jc.reset)(q_j)
    cmd_t = c.reset(q_t)
    for a in actions:
        cmd_j = jset(cmd_j, jnp.asarray(a))
        cmd_t = c.set_action(cmd_t, q_t, torch.as_tensor(a), aux=aux_t)
        for name in ("target_qpos", "target_qvel", "qf"):
            np.testing.assert_allclose(getattr(cmd_t, name).numpy(),
                                       np.asarray(getattr(cmd_j, name)), atol=1e-5,
                                       err_msg=name)
    if mode == "pd_joint_target_delta_pos":  # the deltas added up, not to qpos
        arm = np.clip(qpos[:, :7] + 0.1 * np.clip(actions[0, :, :7], -1, 1), qlim[:7, 0],
                      qlim[:7, 1])
        arm = np.clip(arm + 0.1 * np.clip(actions[1, :, :7], -1, 1), qlim[:7, 0], qlim[:7, 1])
        np.testing.assert_allclose(cmd_t.target_qpos[:, :7].numpy(), arm, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """PickCube-v1 under pd_ee_delta_pos: the JAX env's reset state, a
    seeded random action and the JAX env step from there."""
    jenv = jax_env("PickCube-v1", "pd_ee_delta_pos", K_ENV)
    action = np.random.default_rng(3).uniform(-1.2, 1.2, (K_ENV, 4)).astype(np.float32)
    return jenv.reset_state, action, jenv._jit_step(jenv.reset_state, jnp.asarray(action))


@pytest.mark.parametrize("step", ["step", "rollout"])
def test_pickcube_ee_step_matches_jax(step):
    """One env step (obs, reward, info) and one ``_rollout_step`` (reward,
    success) of PickCube-v1 under ``pd_ee_delta_pos`` from the JAX reset,
    with random actions: the drive targets of the IK step and the physics
    state after it. Both are held against the JAX env step (its
    ``_rollout_step`` computes the same state, reward and success, without
    the obs: one JAX program compiled, not two)."""
    st_j, action, (st_j2, obs_j, rew_j, _, info_j) = _jax_step()
    tenv = mtt.make("PickCube-v1", num_envs=K_ENV, reward_mode="dense", device="cpu",
                    control_mode="pd_ee_delta_pos")
    st_t = convert.env_state_from_numpy(_np(st_j))
    if step == "step":
        st_t2, obs_t, rew_t, _, info_t = tenv._step(st_t, torch.as_tensor(action))
        np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=2e-4)
        assert sorted(info_t) == sorted(info_j)
        for key in info_j:
            np.testing.assert_allclose(info_t[key].numpy(), np.asarray(info_j[key]),
                                       atol=1e-5, err_msg=key)
    else:
        st_t2, rew_t, succ_t = tenv._rollout_step(st_t, torch.as_tensor(action))
        np.testing.assert_array_equal(succ_t.numpy(), np.asarray(info_j["success"]))
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-4)
    for name in ("target_qpos", "target_qvel"):
        np.testing.assert_allclose(getattr(st_t2.cmd, name).numpy(),
                                   np.asarray(getattr(st_j2.cmd, name)), atol=1e-5,
                                   err_msg=name)
    got = convert.to_numpy(st_t2.sim)
    for name, tol in TOL.items():
        np.testing.assert_allclose(got[name], np.asarray(getattr(st_j2.sim, name)), atol=tol,
                                   err_msg=name)
    # the arm moved off its reset targets: the IK step acted
    assert np.abs(np.asarray(st_j2.cmd.target_qpos - st_j.cmd.target_qpos))[:, :7].max() > 1e-3
