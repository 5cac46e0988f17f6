"""The CUDA mega-kernel's wrapper in the PyTorch port: row plan, packing,
static tables, the model gate and the device dispatch, on the CPU.

The kernel itself runs only on a CUDA device: ``test_kernel_matches_plain``
is marked ``cuda`` and skips without one. On a GPU host run it with
``python -m pytest --noconftest tests/test_torch_megakernel.py -m cuda``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch.physics import megakernel
from maniskill_tpu_torch.physics.engine import make_step_fn

K = 3


@pytest.fixture(scope="module")
def env():
    e = mtt.make("PickCube-v1", num_envs=K, reward_mode="dense", device="cpu")
    e.reset(seed=1)
    return e


def _random_state(env, seed):
    g = torch.Generator().manual_seed(seed)
    st = env._state
    sim = st.sim.replace(**{
        name: torch.randn(getattr(st.sim, name).shape, generator=g)
        for name in ("qpos", "qvel", "free_pose", "free_vel", "contact_lam",
                     "contact_lam_t", "kin_pose")})
    cmd = st.cmd.replace(target_qpos=torch.randn(st.cmd.target_qpos.shape, generator=g))
    return sim, cmd


def test_row_plan_matches_pickcube(env):
    plan = megakernel._Plan(env.model)
    assert (plan.R_in, plan.R_out, plan.P, plan.n_all) == (723, 1073, 136, 15)
    # point tables follow the engine's pair-group order, pair-major
    assert plan.pfn.tolist() == [2] * 80 + [1] * 48 + [0] * 8
    assert plan.pcorner[:16].tolist() == list(range(16))
    # the cube is side A against the table, side B against fingers and floor
    assert (plan.pfa >= 0).sum() == 8 and (plan.pfb >= 0).sum() == 80 + 8


def test_pack_unpack_round_trip(env):
    plan = megakernel._Plan(env.model)
    sim, cmd = _random_state(env, 0)
    plane = megakernel.pack(plan, sim, cmd)
    assert plane.shape == (plan.R_in, K) and plane.is_contiguous()
    P = plan.P
    np.testing.assert_array_equal(plane[plan.i_qpos[0]:plan.i_qpos[1]].T, sim.qpos)
    lamt = plane[plan.i_lamt[0]:plan.i_lamt[1]].T.reshape(K, 3, P)
    np.testing.assert_array_equal(lamt.transpose(1, 2), sim.contact_lam_t)
    fi = plane[plan.i_finertia[0]:plan.i_finertia[1]].T
    np.testing.assert_array_equal(fi[:, [0, 3, 5]], sim.free_inertia[:, 0].diagonal(dim1=-2, dim2=-1))
    np.testing.assert_array_equal(plane[plan.i_kp[0]:plan.i_kp[1]].T, cmd.kp)
    # an output plane built from the state's own rows unpacks to that state
    out = torch.zeros(plan.R_out, K)
    for sl, x in ((plan.o_qpos, sim.qpos), (plan.o_qvel, sim.qvel),
                  (plan.o_free_pose, sim.free_pose.reshape(K, -1)),
                  (plan.o_free_vel, sim.free_vel.reshape(K, -1)),
                  (plan.o_lam, sim.contact_lam),
                  (plan.o_lamt, sim.contact_lam_t.transpose(1, 2).reshape(K, -1))):
        out[sl[0]:sl[1]] = x.T
    back, aux = megakernel.unpack(plan, out, sim)
    for name in ("qpos", "qvel", "free_pose", "free_vel", "contact_lam", "contact_lam_t"):
        np.testing.assert_array_equal(getattr(back, name), getattr(sim, name), name)
    assert aux["f_pt"].shape == (K, P, 3) and aux["body_quat"].shape == (K, 9, 4)


def test_static_tables_follow_kernel_header(env):
    plan = megakernel._Plan(env.model)
    mf, mi = plan.tables()
    names = [n for n in megakernel._enum("Header") if n != "H_COUNT"]
    head = dict(zip(names, mi[:len(names)].tolist()))
    assert head["H_NQ"] == 9 and head["H_P"] == 136 and head["R_LAMT"] == plan.i_lamt[0]
    assert head["S_FPT"] == plan.o_fpt[0]
    # every table offset lies inside its table, and tables do not overlap
    f_offs = sorted(v for n, v in head.items() if n.startswith("F_"))
    i_offs = sorted(v for n, v in head.items() if n.startswith("I_"))
    assert f_offs[0] == 0 and f_offs[-1] < mf.size and len(set(f_offs)) == len(f_offs)
    assert i_offs[0] == len(names) and i_offs[-1] < mi.size
    prm = mf[head["F_PARAMS"]:head["F_PARAMS"] + 11]
    assert prm[0] == np.float32(0.01) and prm[1] == np.float32(0.2)
    np.testing.assert_array_equal(mi[head["I_PFN"]:head["I_PFN"] + 136], plan.pfn)


def test_work_counts_this_runs_data(env):
    """The bound's operation count follows the data: at reset only the
    cube's four bottom corners are within the contact margin, and states
    in contact need more work than states at rest."""
    plan = megakernel._Plan(env.model)
    st = env._state
    nbytes, ops, counts = megakernel.work(plan, st.sim, st.cmd, 5)
    mf, mi = plan.tables()
    assert nbytes == 4 * (723 + 1073) * K + mf.nbytes + mi.nbytes
    assert counts["points"] == 136 * K * 5 and counts["active"] == 4 * K * 5
    assert 0 < counts["loaded"] <= counts["active"]
    cst = env.contact_state(st, torch.Generator().manual_seed(0))
    _, ops_c, counts_c = megakernel.work(plan, cst.sim, cst.cmd, 5)
    assert counts_c["active"] > 2 * counts["active"] and ops_c > ops
    # no active point: only the fixed terms and the narrowphase remain
    far = st.sim.replace(free_pose=st.sim.free_pose + torch.tensor([0, 0, 1.0, 0, 0, 0, 0]))
    _, ops_far, counts_far = megakernel.work(plan, far, st.cmd, 1)
    assert counts_far["active"] == 0
    assert ops_far < ops / 5


def test_plain_step_runs_in_float64(env):
    """The plain step as a float64 reference: float64 state and command
    under torch's float64 default give float64 results close to the
    float32 step from a reset state."""
    st = env._state

    def as64(x):
        return x.replace(**{f.name: v.double() for f in dataclasses.fields(x)
                            if isinstance(v := getattr(x, f.name), torch.Tensor)
                            and v.is_floating_point()})

    step = make_step_fn(env.model)
    ref = step(st.sim, st.cmd, 5)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        got = step(as64(st.sim), as64(st.cmd), 5)
    finally:
        torch.set_default_dtype(prev)
    assert got.qpos.dtype == torch.float64 and got.contact_lam.dtype == torch.float64
    torch.testing.assert_close(got.qpos.float(), ref.qpos, atol=2e-5, rtol=0)
    torch.testing.assert_close(got.free_pose.float(), ref.free_pose, atol=2e-5, rtol=0)
    torch.testing.assert_close(got.contact_lam.float(), ref.contact_lam, atol=5e-3, rtol=0)


def test_supports_pickcube(env):
    assert megakernel.supports(env.model)
    caps = megakernel._caps()
    assert caps["NALL_MAX"] >= env.model.nq + 6 * env.model.n_free


def test_cpu_tensors_take_plain_path(env):
    """On CPU tensors the wrapper runs the plain engine step and launches
    nothing; the env's dispatch goes through the wrapper."""
    sim, cmd = env._state.sim, env._state.cmd
    kern = megakernel.MegaKernel(env.model)
    got, aux = kern(sim, cmd, 5)
    ref = make_step_fn(env.model)(sim, cmd, 5)
    np.testing.assert_array_equal(got.qpos, ref.qpos)
    np.testing.assert_array_equal(got.contact_lam, ref.contact_lam)
    assert kern.launches == 0 and aux["f_pt"].shape == (K, 136, 3)
    assert isinstance(env.kernel, megakernel.MegaKernel)
    env.step(torch.zeros(env.action_dim))
    assert env.kernel.launches == 0
    with pytest.raises(ValueError):
        kern.launch(megakernel.pack(kern.plan, sim, cmd), 5)
    plain_env = mtt.make("PickCube-v1", num_envs=1, device="cpu", sim_backend="torch")
    assert plain_env.kernel is None


@pytest.mark.cuda
@pytest.mark.parametrize("states", ["reset", "contact"])
def test_kernel_matches_plain(states):
    """One control step (5 substeps) through the CUDA kernel against the
    plain PyTorch step on the card, from reset states or from states in
    contact (``PickCubeEnv.contact_state``), targets perturbed; tolerances
    as tests/test_torch_pickcube.py. From reset states every env agrees.
    In contact the finger-cube, cube-table and cube-floor points carry
    force, so every pair function and the friction cone are compared; stiff
    contacts amplify float32 rounding and thresholds of the force law flip
    in a few envs (the plain step departs from a float64 step there too:
    chip_smoke.py), so there at least 90 % of the envs must agree. K=37 is
    not a multiple of the block, so the masked ragged edge runs too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cenv = mtt.make("PickCube-v1", num_envs=37, reward_mode="dense", device="cuda")
    cenv.reset(seed=0)
    st = cenv._state
    if states == "contact":
        st = cenv.contact_state(st, torch.Generator(device="cuda").manual_seed(0))
    cmd = st.cmd.replace(target_qpos=st.cmd.target_qpos + 0.05)
    got, aux = cenv.kernel(st.sim, cmd, 5)
    ref, aux_ref = cenv.kernel.plain(st.sim, cmd, 5)
    torch.cuda.synchronize()
    assert cenv.kernel.launches == 1
    share = 1.0 if states == "reset" else 0.9
    pairs = [(getattr(got, n), getattr(ref, n), tol) for n, tol in dict(
        qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
        contact_lam=5e-3, contact_lam_t=5e-3).items()]
    pairs += [(aux[n], aux_ref[n], 2e-5) for n in ("body_pos", "body_quat", "axis_w")]
    pairs += [(aux["f_pt"], aux_ref["f_pt"], 5e-3)]
    for a, b, tol in pairs:
        assert torch.isfinite(a).all()
        env_err = (a - b).abs().reshape(37, -1).amax(1)
        assert float((env_err <= tol).float().mean()) >= share, (env_err.max(), tol)
    if states == "contact":
        plan = cenv.kernel.plan
        loaded = (aux_ref["f_pt"].abs().sum(-1) > 0).cpu().numpy()
        grasp = np.arange(37) % 4 != 3
        assert (loaded[grasp][:, plan.pfn == 2].sum(1) >= 4).mean() >= 0.75
        assert (loaded[~grasp][:, plan.pfn == 0].sum(1) >= 1).mean() >= 0.75
        assert (ref.contact_lam_t.abs().sum(-1) > 0).sum() >= 6 * grasp.sum()
