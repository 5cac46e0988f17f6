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
from maniskill_tpu_torch.physics import engine
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


def _as64(x):
    """A state or command with its float tensors in float64."""
    return x.replace(**{f.name: v.double() for f in dataclasses.fields(x)
                        if isinstance(v := getattr(x, f.name), torch.Tensor)
                        and v.is_floating_point()})


def _in_float64(fn, *args):
    """``fn(*args)`` under torch's float64 default dtype."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return fn(*args)
    finally:
        torch.set_default_dtype(prev)


def test_plain_step_runs_in_float64(env):
    """The plain step as a float64 reference: float64 state and command
    under torch's float64 default give float64 results close to the
    float32 step from a reset state."""
    st = env._state
    step = make_step_fn(env.model)
    ref = step(st.sim, st.cmd, 5)
    got = _in_float64(step, _as64(st.sim), _as64(st.cmd), 5)
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


def test_pair_functions_follow_kernel_enum():
    """The wrapper's pair-function table is the kernel's PairFn enum."""
    assert [f"FN_{n.upper()}" for n in megakernel._FNS] == list(megakernel._enum("PairFn"))


@pytest.fixture(scope="module")
def stack():
    e = mtt.make("StackCube-v1", num_envs=K, reward_mode="dense", device="cpu")
    e.reset(seed=0)
    return e


def test_work_counts_free_free_points(stack):
    """StackCube's cubeA-cubeB points move two free bodies: their loaded
    Jacobian work counts twelve free-body columns."""
    plan = megakernel._Plan(stack.model)
    assert plan.pfn[:28].tolist() == [3] * 28
    cst = stack.contact_state(stack._state, torch.Generator().manual_seed(0))
    nbytes, ops, counts = megakernel.work(plan, cst.sim, cst.cmd, 5)
    assert nbytes == 4 * (1242 + 1954) * K + sum(a.nbytes for a in plan.tables())
    assert 0 < counts["loaded"] <= counts["active"] < counts["points"]


def _flat(sim, cmd):
    names = megakernel._SIM_FIELDS + megakernel._CMD_FIELDS
    return [getattr(sim, n) if n in megakernel._SIM_FIELDS else getattr(cmd, n) for n in names]


def test_kernel_step_derivatives_come_from_the_plain_step(stack):
    """The seam (``KernelStep``, the JAX custom_jvp): its forward is the
    wrapper's step (on CPU tensors the plain step stands in for the
    kernel), its forward-mode tangents (``torch.func.jvp``) and its
    reverse-mode gradients equal those of the plain step itself, from
    states in contact (cubeA on cubeB, grasps), along seeded directions."""
    cst = stack.contact_state(stack._state, torch.Generator().manual_seed(1))
    kern = megakernel.MegaKernel(stack.model)
    flat = _flat(cst.sim, cst.cmd)
    g = torch.Generator().manual_seed(2)
    diff = {"qpos", "qvel", "free_pose", "free_vel", "target_qpos"}
    names = megakernel._SIM_FIELDS + megakernel._CMD_FIELDS
    tans = [torch.randn(t.shape, generator=g) if n in diff else torch.zeros_like(t)
            for n, t in zip(names, flat) if t is not None]
    present = [t for t in flat if t is not None]

    def via_seam(*xs):
        it = iter(xs)
        return megakernel.KernelStep.apply(kern, 1, *[next(it) if t is not None else None
                                                      for t in flat])

    def via_plain(*xs):
        it = iter(xs)
        state, cmd = megakernel._split([next(it) if t is not None else None for t in flat])
        new = kern.plain(state, cmd, 1)[0]
        return tuple(getattr(new, n) for n in megakernel.STEP_FIELDS)

    out_s, tan_s = torch.func.jvp(via_seam, tuple(present), tuple(tans))
    out_p, tan_p = torch.func.jvp(via_plain, tuple(present), tuple(tans))
    for a, b in zip(out_s + tan_s, out_p + tan_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert max(float(t.abs().max()) for t in tan_p) > 0
    cot = [torch.randn(o.shape, generator=g) for o in out_p]
    grads = []
    for fn in (via_seam, via_plain):
        xs = [t.clone().requires_grad_() for t in present]
        torch.autograd.backward(fn(*xs), cot)
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert float(grads[0][0].abs().max()) > 0  # qpos


def test_kernel_step_jvp_twice_on_a_fresh_model():
    """Forward mode through the seam nests one ``torch.func.jvp`` in
    another; the model constants the plain step caches on first use must
    not be made inside the inner one (they would be wrapped for a level
    that is gone at the next call). A fresh model whose plain step first
    runs inside the seam's ``jvp`` (the forward's primal comes from another
    model, as the CUDA kernel's would), two calls."""
    env = mtt.make("StackCube-v1", num_envs=2, device="cpu")
    env.reset(seed=0)
    st = env._state
    other = megakernel.MegaKernel(mtt.make("StackCube-v1", num_envs=2, device="cpu").model)

    class StandIn(megakernel.MegaKernel):
        def __call__(self, state, cmd, sim_steps):
            return other.plain(state, cmd, sim_steps)

    kern = StandIn(env.model)

    def f(qpos):
        return megakernel.KernelStep.apply(kern, 1, *_flat(st.sim.replace(qpos=qpos), st.cmd))[1]

    tans = [torch.func.jvp(f, (st.sim.qpos,), (torch.ones_like(st.sim.qpos),))[1]
            for _ in range(2)]
    torch.testing.assert_close(tans[0], tans[1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("states", ["reset", "contact"])
def test_stackcube_kernel_matches_plain(states):
    """StackCube-v1 (two free cubes: the free-free box_box pair) through
    the CUDA kernel against the plain step on the card, K=37, from reset
    states or ``StackCubeEnv.contact_state`` states (cubeA stacked on
    cubeB, or grasped); tolerances as ``test_kernel_matches_plain``.

    Every env must agree except the ill-conditioned ones: all contact
    states, and the reset states whose cubes start interpenetrating (the
    JAX placement rule allows it; chip_smoke.py). Those are refereed by a
    float64 plain step: at most 10 % of all envs may leave the tolerances,
    and the kernel may be no further from the float64 step than the
    float32 plain step is (1.5 x its count of envs beyond tol, plus 2). In
    contact the cubeA-cubeB points carry force in the stacked envs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cenv = mtt.make("StackCube-v1", num_envs=37, reward_mode="dense", device="cuda")
    cenv.reset(seed=0)
    st = cenv._state
    plan = cenv.kernel.plan
    if states == "contact":
        st = cenv.contact_state(st, torch.Generator(device="cuda").manual_seed(0))
        refereed = torch.ones(37, dtype=torch.bool, device="cuda")
    else:
        depth = engine.compute_contacts(
            cenv.model, st.sim, *engine.robot_fk(cenv.model, st.sim.qpos)[:2])[2]
        free_free = torch.as_tensor((plan.pfa >= 0) & (plan.pfb >= 0), device="cuda")
        refereed = (depth[:, free_free] > 0).any(1)
    cmd = st.cmd.replace(target_qpos=st.cmd.target_qpos + 0.05)
    got, aux = cenv.kernel(st.sim, cmd, 5)
    ref, aux_ref = cenv.kernel.plain(st.sim, cmd, 5)
    f64, aux64 = _in_float64(cenv.kernel.plain, _as64(st.sim), _as64(cmd), 5)
    torch.cuda.synchronize()
    names = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
                 contact_lam=5e-3, contact_lam_t=5e-3)
    triples = [(getattr(got, n), getattr(ref, n), getattr(f64, n), tol)
               for n, tol in names.items()]
    triples += [(aux["f_pt"], aux_ref["f_pt"], aux64["f_pt"], 5e-3)]

    def beyond(a, b, tol):
        return (a.double() - b.double()).abs().reshape(37, -1).amax(1) > tol

    for a, b, c, tol in triples:
        assert torch.isfinite(a).all()
        out = beyond(a, b, tol)
        assert not (out & ~refereed).any(), (out.nonzero().ravel(), tol)
        assert int(out.sum()) <= 0.1 * 37, (int(out.sum()), tol)
        k64 = int((beyond(a, c, tol) & refereed).sum())
        p64 = int((beyond(b, c, tol) & refereed).sum())
        assert k64 <= 1.5 * p64 + 2, (k64, p64, tol)
    if states == "contact":
        loaded = (aux_ref["f_pt"].abs().sum(-1) > 0).cpu().numpy()
        stacked = np.arange(37) % 2 == 0
        assert (loaded[stacked][:, :28].sum(1) >= 1).mean() >= 0.5
