"""Rotations, poses, forward kinematics, the SPD solves, the reward
shaping and the JAX-convention clamps of the PyTorch port against the JAX
package, on the same numpy-seeded inputs (float32; tolerance 2e-6 for
single rotations, 2e-5 for the 9-body FK chain and the 15x15 solves, 1e-7
for the clamps' derivatives, which are 0, 0.5 or 1 times a tangent)."""
import jax
import jax.numpy as jnp
import pytest
import numpy as np
import torch

from maniskill_tpu.kinematics import chain as jchain
from maniskill_tpu.envs import rewards as jrewards
from maniskill_tpu.kinematics.urdf import parse_urdf as jparse
from maniskill_tpu.math import pose as jpose, rotations as jrot
from maniskill_tpu.physics import linalg as jlinalg

from maniskill_tpu_torch.agents.robots.panda import PANDA_URDF
from maniskill_tpu_torch.envs import rewards as trewards
from maniskill_tpu_torch.physics import linalg as tlinalg
from maniskill_tpu_torch.kinematics import chain as tchain
from maniskill_tpu_torch.kinematics.urdf import parse_urdf
from maniskill_tpu_torch.math import clamps as tclamps, pose as tpose, rotations as trot

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    q, r = _quats(rng, 16), _quats(rng, 16)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    w = rng.normal(size=(16, 3)).astype(np.float32)
    w[0] = 0.0  # quat_exp at zero stays finite
    ang = rng.uniform(-3, 3, 16).astype(np.float32)
    T = torch.as_tensor
    pairs = [
        (trot.quat_mul(T(q), T(r)), jrot.quat_mul(q, r)),
        (trot.quat_apply(T(q), T(v)), jrot.quat_apply(q, v)),
        (trot.quat_conjugate(T(q)), jrot.quat_conjugate(q)),
        (trot.quat_to_matrix(T(q)), jrot.quat_to_matrix(q)),
        (trot.quat_normalize(T(3 * q)), jrot.quat_normalize(3 * q)),
        (trot.quat_exp(T(w)), jrot.quat_exp(w)),
        (trot.quat_from_axis_angle(T(v), T(ang)), jrot.quat_from_axis_angle(v, ang)),
        (trot.angle_between(T(v), T(w)), jrot.angle_between(v, w)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    a, b = tpose.Pose(T(v), T(q)), tpose.Pose(T(w), T(r))
    ja, jb = jpose.Pose(jnp.asarray(v), jnp.asarray(q)), jpose.Pose(jnp.asarray(w), jnp.asarray(r))
    np.testing.assert_allclose((a * b).raw.numpy(), np.asarray((ja * jb).raw), atol=2e-6)
    np.testing.assert_allclose(a.inv().raw.numpy(), np.asarray(ja.inv().raw), atol=2e-6)


def test_quat_from_euler_matches_jax():
    """Euler angles over several turns, and the quarter turns
    LiftPegUpright's reset takes, to quaternions (tolerance 2e-6)."""
    rng = np.random.default_rng(3)
    rpy = rng.uniform(-7, 7, (64, 3)).astype(np.float32)
    rpy[:4] = np.float32([[np.pi / 2, 0, 0], [0, np.pi / 2, 0], [0, 0, -np.pi / 2], [0, 0, 0]])
    np.testing.assert_allclose(trot.quat_from_euler(torch.as_tensor(rpy)).numpy(),
                               np.asarray(jrot.quat_from_euler(rpy)), atol=2e-6)


def test_urdf_copy_and_fk_match_jax():
    spec, jspec = parse_urdf(PANDA_URDF), jparse(PANDA_URDF)
    for name in ("parent", "joint_type", "joint_pos", "joint_quat", "axis", "mass",
                 "com", "inertia", "qlim", "joint_damping", "joint_friction"):
        np.testing.assert_array_equal(getattr(spec, name), getattr(jspec, name))
    assert spec.joint_names == jspec.joint_names and spec.frames.keys() == jspec.frames.keys()
    base = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
    # the anchor: panda_link8 at q=0 sits at [0.088, 0, 0.926]
    bp, bq, _ = tchain.fk(spec, torch.as_tensor(base), torch.zeros(1, spec.nb))
    p8, _ = tchain.frame_pose(spec, torch.as_tensor(base), bp, bq, "panda_link8")
    np.testing.assert_allclose(p8[0].numpy(), [0.088, 0.0, 0.926], atol=1e-3)
    rng = np.random.default_rng(1)
    qpos = rng.uniform(-1, 1, (4, spec.nb)).astype(np.float32)
    got = tchain.fk(spec, torch.as_tensor(base), torch.as_tensor(qpos))
    for i in range(4):
        want = jchain._fk_unrolled(jspec, jnp.asarray(base), jnp.asarray(qpos[i]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), atol=2e-5)
        p, qq = tchain.frame_pose(spec, torch.as_tensor(base), got[0][i], got[1][i],
                                  "panda_hand_tcp")
        jp, jq = jchain.frame_pose(jspec, jnp.asarray(base), want[0], want[1],
                                   "panda_hand_tcp")
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=2e-5)
        np.testing.assert_allclose(qq.numpy(), np.asarray(jq), atol=2e-5)
    anc = np.tril(np.ones((spec.nb, spec.nb), np.float32))
    jfk = jchain._fk_unrolled(jspec, jnp.asarray(base), jnp.asarray(qpos[0]))
    pt = np.asarray(jfk[0][7]) + 0.01
    J = tchain.point_jacobian(spec, got[0][0], got[2][0], torch.as_tensor(pt), 7,
                              np.arange(7), anc)
    jJ = jchain.point_jacobian(jspec, jfk[0], jfk[2], jnp.asarray(pt), 7,
                               np.arange(7), anc)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=2e-5)


def test_spd_solves_match_jax():
    rng = np.random.default_rng(2)
    M = rng.normal(size=(4, 15, 15)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(15, dtype=np.float32)
    b1, b2 = rng.normal(size=(2, 4, 15)).astype(np.float32)
    T = torch.as_tensor
    np.testing.assert_allclose(tlinalg.solve_psd(T(A), T(b1)).numpy(),
                               np.asarray(jax.jit(jlinalg.solve_psd)(A, b1)), atol=2e-5)
    for got, want in zip(tlinalg.solve_psd_pair(T(A), T(b1), T(b2)),
                         jax.jit(jlinalg.solve_psd_pair)(A, b1, b2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("sigmoid", ["gaussian", "hyperbolic", "quadratic",
                                     "linear", "long_tail", "cosine"])
def test_reward_tolerance_matches_jax(sigmoid):
    x = np.linspace(-2, 3, 41).astype(np.float32)
    got = trewards.tolerance(torch.as_tensor(x), 0.0, 1.0, margin=0.5, sigmoid=sigmoid)
    want = jrewards.tolerance(x, 0.0, 1.0, margin=0.5, sigmoid=sigmoid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


_KINKS = {
    "maximum": (lambda x, b: tclamps.maximum(x, b), lambda x, b: jnp.maximum(x, b)),
    "minimum": (lambda x, b: tclamps.minimum(x, b), lambda x, b: jnp.minimum(x, b)),
    "clip": (lambda x, b: tclamps.clip(x, b, b + 1.0), lambda x, b: jnp.clip(x, b, b + 1.0)),
    "clamp_min": (lambda x, b: tclamps.clamp_min(x, 0.25), lambda x, b: jnp.maximum(x, 0.25)),
    "clamp_max": (lambda x, b: tclamps.clamp_max(x, 0.25), lambda x, b: jnp.minimum(x, 0.25)),
    "abs": (lambda x, b: tclamps.abs(x - b), lambda x, b: jnp.abs(x - b)),
}


@pytest.mark.parametrize("name", sorted(_KINKS))
def test_clamps_take_jax_derivatives_at_ties(name):
    """``math.clamps`` against ``jnp.maximum``/``minimum``/``clip``/``abs``:
    the primal equals the torch op's bit for bit, and the forward-mode
    (``torch.func.jvp`` against ``jax.jvp``) and reverse-mode (autograd
    against ``jax.vjp``) derivatives with respect to both arguments equal
    JAX's at ties, at both clip bounds and off them (0.5/0.5 at a tie,
    +1 for |x| at 0; ``torch.clamp`` would pass 1 at a bound)."""
    tfn, jfn = _KINKS[name]
    b = np.array([0.25, 0.25, 0.25, 0.25, 0.25, 0.25], np.float32)
    x = np.array([0.25, 1.25, -0.5, 0.3, 2.0, 0.0], np.float32)  # ties and bounds first
    tx, tb = np.float32([1.0, -2.0, 0.5, 3.0, 1.5, -1.0]), np.float32([0.5, 1.0, -1.0, 2.0, 0.0, 1.0])
    T = torch.as_tensor
    ref = {"maximum": torch.maximum(T(x), T(b)), "minimum": torch.minimum(T(x), T(b)),
           "clip": torch.clamp(T(x), T(b), T(b) + 1.0), "clamp_min": torch.clamp_min(T(x), 0.25),
           "clamp_max": torch.clamp_max(T(x), 0.25), "abs": torch.abs(T(x) - T(b))}[name]
    assert torch.equal(tfn(T(x), T(b)), ref)
    y_j, dy_j = jax.jvp(jfn, (x, b), (tx, tb))
    y_t, dy_t = torch.func.jvp(tfn, (T(x), T(b)), (T(tx), T(tb)))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    np.testing.assert_allclose(dy_t.numpy(), np.asarray(dy_j), rtol=0, atol=1e-7)
    cot = np.float32([1.0, 2.0, -1.0, 0.5, 1.0, 3.0])
    gx_j, gb_j = jax.vjp(jfn, x, b)[1](cot)
    xs, bs = T(x).requires_grad_(), T(b).requires_grad_()
    tfn(xs, bs).backward(T(cot))
    np.testing.assert_allclose(xs.grad.numpy(), np.asarray(gx_j), rtol=0, atol=1e-7)
    gb_t = bs.grad if bs.grad is not None else torch.zeros_like(bs)  # a scalar bound
    np.testing.assert_allclose(gb_t.numpy(), np.asarray(gb_j), rtol=0, atol=1e-7)
    if name in ("maximum", "minimum", "clip", "clamp_min"):
        assert float(dy_j[0]) != float(tx[0])  # the tie does split the derivative
