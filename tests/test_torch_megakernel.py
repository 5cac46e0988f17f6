"""The CUDA mega-kernel's wrapper in the PyTorch port: row plan, packing,
static tables, the model gate and the device dispatch, on the CPU.

The kernel itself runs only on a CUDA device: ``test_kernel_matches_plain``
and the other ``cuda`` cases skip without one. On a GPU host run it with
``python -m pytest --noconftest tests/test_torch_megakernel.py -m cuda``.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import maniskill_tpu_torch as mtt
from maniskill_tpu_torch.physics import megakernel
from maniskill_tpu_torch.physics import engine, hulls
from maniskill_tpu_torch.physics.engine import make_step_fn

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)

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
    """The planes are env-major: env k's row is ``plane[k]``, the row plan's
    R_in floats padded with zeros to W_in, a multiple of 4 (16-byte rows)."""
    plan = megakernel._Plan(env.model)
    sim, cmd = _random_state(env, 0)
    plane = megakernel.pack(plan, sim, cmd)
    assert plane.shape == (K, plan.W_in) and plane.is_contiguous()
    assert (plan.W_in, plan.W_out) == (724, 1076)
    assert not plane[:, plan.R_in:].any()
    P = plan.P
    np.testing.assert_array_equal(plane[:, plan.i_qpos[0]:plan.i_qpos[1]], sim.qpos)
    lamt = plane[:, plan.i_lamt[0]:plan.i_lamt[1]].reshape(K, 3, P)
    np.testing.assert_array_equal(lamt.transpose(1, 2), sim.contact_lam_t)
    fi = plane[:, plan.i_finertia[0]:plan.i_finertia[1]]
    np.testing.assert_array_equal(fi[:, [0, 3, 5]], sim.free_inertia[:, 0].diagonal(dim1=-2, dim2=-1))
    np.testing.assert_array_equal(plane[:, plan.i_kp[0]:plan.i_kp[1]], cmd.kp)
    # an output plane built from the state's own rows unpacks to that state
    out = torch.zeros(K, plan.W_out)
    for sl, x in ((plan.o_qpos, sim.qpos), (plan.o_qvel, sim.qvel),
                  (plan.o_free_pose, sim.free_pose.reshape(K, -1)),
                  (plan.o_free_vel, sim.free_vel.reshape(K, -1)),
                  (plan.o_lam, sim.contact_lam),
                  (plan.o_lamt, sim.contact_lam_t.transpose(1, 2).reshape(K, -1))):
        out[:, sl[0]:sl[1]] = x
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


@pytest.fixture(scope="module")
def hull():
    e = mtt.make("PickSingleHull-v1", num_envs=K, reward_mode="dense", device="cpu")
    e.reset(seed=0)
    return e


def test_hull_pair_functions_and_table_sizes(hull):
    """The hull members of the kernel's PairFn enum come after the box ones,
    in the wrapper's order; ``supports`` takes both hull tasks and refuses a
    model whose padded hull tables differ from the kernel's HULL_P/HULL_F."""
    assert megakernel._FNS[4:6] == ("plane_hull", "box_hull")
    assert megakernel._enum("PairFn")[4:6] == ("FN_PLANE_HULL", "FN_BOX_HULL")
    caps = megakernel._caps()
    assert (caps["HULL_P"], caps["HULL_F"]) == (hulls.HULL_P, hulls.HULL_F) == (40, 32)
    assert megakernel.supports(hull.model)
    assert megakernel.supports(mtt.make("PickSingleYCB-v1", num_envs=1, device="cpu").model)
    for name, cut in (("hull_verts0", np.s_[:, :24]), ("hull_faces0", np.s_[:, :16])):
        m = copy.copy(hull.model)
        setattr(m, name, getattr(m, name)[cut])
        assert not megakernel.supports(m), name


def test_hull_rows_follow_the_drive_gains(hull):
    """Each env's contact cloud and face planes ride the input plane after
    the drive gains, slot-major and component-minor (the JAX ``_pack``);
    the kernel finds them through the header and each geom's hull slot."""
    plan = megakernel._Plan(hull.model)
    st = hull._state
    plane = megakernel.pack(plan, st.sim, st.cmd)
    assert plan.R_in == plan.i_flim[1] + 3 * 40 + 4 * 32
    assert plane.shape == (K, plan.W_in) and plan.W_in - plan.R_in in range(4)
    np.testing.assert_array_equal(plane[:, plan.i_hverts[0]:plan.i_hverts[1]],
                                  st.sim.hull_verts.reshape(K, -1))
    np.testing.assert_array_equal(plane[:, plan.i_hfaces[0]:plan.i_hfaces[1]],
                                  st.sim.hull_faces.reshape(K, -1))
    assert len(set(st.extras["model_id"].tolist())) > 1  # rows differ per env
    mf, mi = plan.tables()
    names = [n for n in megakernel._enum("Header") if n != "H_COUNT"]
    head = dict(zip(names, mi[:len(names)].tolist()))
    assert (head["R_HVERTS"], head["R_HFACES"]) == (plan.i_hverts[0], plan.i_hfaces[0])
    G = len(hull.model.geoms)
    np.testing.assert_array_equal(mi[head["I_GHULL"]:head["I_GHULL"] + G],
                                  hull.model.geom_hull_slot)


def test_work_counts_hull_points(hull):
    """The bound counts each hull point's narrowphase from the run's data:
    a box corner against the hull's 32 faces, a hull point against a box,
    a hull point against the plane. With nothing within the margin the
    count differs from PickCube's (same robot, geoms and free body) by
    exactly the narrowphase of their point sets; in contact it grows."""
    plan = megakernel._Plan(hull.model)
    st = hull._state
    far = st.sim.replace(free_pose=st.sim.free_pose + torch.tensor([0, 0, 1.0, 0, 0, 0, 0]))
    _, ops_far, counts_far = megakernel.work(plan, far, st.cmd, 1)
    pick = mtt.make("PickCube-v1", num_envs=K, device="cpu")
    pick.reset(seed=0)
    pst = pick._state
    pfar = pst.sim.replace(free_pose=pst.sim.free_pose + torch.tensor([0, 0, 1.0, 0, 0, 0, 0]))
    _, ops_pick, counts_pick = megakernel.work(megakernel._Plan(pick.model), pfar, pst.cmd, 1)
    assert counts_far["active"] == counts_pick["active"] == 0
    O = megakernel.OPS
    narrow_hull = (40 * O["box_box_onesided"] + 40 * O["plane_hull"]
                   + 6 * (8 * O["box_hull_corner"] + 40 * O["box_hull_vertex"]))
    narrow_pick = 80 * O["box_box_corners"] + 48 * O["box_box_onesided"] + 8 * O["plane_box"]
    assert ops_far - ops_pick == K * (narrow_hull - narrow_pick + (368 - 136) * O["point_inactive"])
    _, ops, counts = megakernel.work(plan, st.sim, st.cmd, 5)
    cst = hull.contact_state(st, torch.Generator().manual_seed(0))
    _, ops_c, counts_c = megakernel.work(plan, cst.sim, cst.cmd, 5)
    assert counts["points"] == counts_c["points"] == 368 * K * 5
    assert counts_c["loaded"] > counts["loaded"] > 0 and ops_c > ops > 5 * ops_far


@pytest.mark.cuda
@pytest.mark.parametrize("states", ["reset", "contact"])
def test_hull_kernel_matches_plain(states):
    """PickSingleHull-v1 (a convex hull per env, different objects) through
    the CUDA kernel against the plain step on the card, K=37, from reset
    states (every env within the tolerances of ``test_kernel_matches_plain``)
    or ``contact_state`` states, refereed by a float64 plain step as in
    ``test_stackcube_kernel_matches_plain``; in contact the fingers' box_hull
    points carry force."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cenv = mtt.make("PickSingleHull-v1", num_envs=37, reward_mode="dense", device="cuda")
    cenv.reset(seed=0)
    st = cenv._state
    assert len(set(st.extras["model_id"].tolist())) >= 6
    if states == "contact":
        st = cenv.contact_state(st, torch.Generator(device="cuda").manual_seed(0))
    cmd = st.cmd.replace(target_qpos=st.cmd.target_qpos + 0.05)
    got, aux = cenv.kernel(st.sim, cmd, 5)
    ref, aux_ref = cenv.kernel.plain(st.sim, cmd, 5)
    f64, aux64 = _in_float64(cenv.kernel.plain, _as64(st.sim), _as64(cmd), 5)
    torch.cuda.synchronize()
    assert cenv.kernel.launches == 1
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
        if states == "reset":
            assert not out.any(), (out.nonzero().ravel(), tol)
            continue
        assert int(out.sum()) <= 0.1 * 37, (int(out.sum()), tol)
        k64, p64 = int(beyond(a, c, tol).sum()), int(beyond(b, c, tol).sum())
        assert k64 <= 1.5 * p64 + 2, (k64, p64, tol)
    if states == "contact":
        plan = cenv.kernel.plan
        loaded = (aux_ref["f_pt"].abs().sum(-1) > 0).cpu().numpy()
        finger = (plan.pfn == megakernel._FNS.index("box_hull")) & (plan.pra >= 0)
        grasp = np.arange(37) % 4 != 3
        assert (loaded[grasp][:, finger].sum(1) >= 2).mean() >= 0.5


# ---- spheres and capsules: PlugCharger-v1, RollBall-v1 and a scene built for
# the three pair functions no task runs ------------------------------------

ROUND_FNS = ("plane_sphere", "sphere_box", "box_sphere", "sphere_sphere", "plane_capsule",
             "sphere_capsule", "capsule_box", "capsule_capsule")


def round_scene(K, device, seed=0):
    """The Panda at its rest pose on the table, and beyond its reach three
    free bodies resting exactly on fixed supports (zero depth; each rest
    moved by up to 1 cm in x and y per env), held there by gravity: sphere
    s1 on a static block (``box_sphere``), sphere s2 balanced on a
    kinematic sphere k1 (``sphere_sphere``), and a capsule c1 along x lying
    across a kinematic capsule c0 along y at its middle
    (``capsule_capsule``) with its +x end on a kinematic sphere k2
    (``sphere_capsule``). Three free bodies keep
    n_all = 27 within the kernel's cap. The builder lists every (sphere,
    box) pair sphere first, as the JAX builder does; the model here lists
    the block-s1 pair box first, so its table holds ``box_sphere``, which
    no task reaches. Returns the model, a state and a command holding the
    arm at rest."""
    from maniskill_tpu_torch.agents.robots.panda import Panda
    from maniskill_tpu_torch.envs.scene_builders import TableSceneBuilder
    from maniskill_tpu_torch.physics.model import (DriveCmd, SceneModel, SceneSpecBuilder,
                                                   box_geom, capsule_geom, sphere_geom)

    b = SceneSpecBuilder()
    table = TableSceneBuilder(None)
    pose, qpos = table.robot_pose_and_qpos("panda")
    Panda(device=device).install(b, pose, init_qpos=qpos)
    table.build(b)
    r, rc, hl = 0.02, 0.015, 0.03
    along_x = (np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0)
    along_y = (np.cos(np.pi / 4), -np.sin(np.pi / 4), 0.0, 0.0)
    ms = 1000.0 * 4 / 3 * np.pi * r ** 3
    mc = 1000.0 * np.pi * rc * rc * 2 * (hl + rc)
    s1 = b.add_free_body("s1", ms, 0.4 * ms * r * r * np.eye(3), [sphere_geom(r)])
    s2 = b.add_free_body("s2", ms, 0.4 * ms * r * r * np.eye(3), [sphere_geom(r)])
    c1 = b.add_free_body("c1", mc, mc * (hl + rc) ** 2 / 3 * np.eye(3),
                         [capsule_geom(rc, hl, offset_q=along_x)])
    k1 = b.add_kinematic_body("k1", [sphere_geom(r)])
    k2 = b.add_kinematic_body("k2", [sphere_geom(r)])
    c0 = b.add_kinematic_body("c0", [capsule_geom(rc, hl, offset_q=along_y)])
    z0 = 0.1  # the supports' height over the table
    b.add_static_body("block", np.array([0.3, 0.0, z0, 1, 0, 0, 0], np.float32),
                      [box_geom([r] * 3)])
    m0 = b.build()
    block, g1 = m0.geom_indices("block")[0], m0.geom_indices("s1")[0]
    pairs = [(block, g1) if {ga, gb} == {block, g1} else (ga, gb) for ga, gb in m0.pairs]
    assert pairs != m0.pairs
    model = SceneModel(
        robot=m0.robot, robot_base_pose=m0.robot_base_pose, free_names=m0.free_names,
        free_mass=m0.free_mass, free_inertia=m0.free_inertia, kin_names=m0.kin_names,
        static_names=m0.static_names, static_pose=m0.static_pose, geoms=m0.geoms,
        pairs=pairs, params=m0.params, drive_kp=m0.drive_kp, drive_kd=m0.drive_kd,
        drive_force_limit=m0.drive_force_limit, init_qpos=m0.init_qpos)
    g = torch.Generator(device=device).manual_seed(seed)
    sim = model.initial_state(K, device)
    free_pose = sim.free_pose.clone()
    kin_pose = sim.kin_pose.clone()

    def at(x, y, z, shift):  # (K, 3): a point moved by the env's shift
        return torch.tensor([x, y, z], device=device) + shift

    def shift():  # up to 1 cm in x and y, per env: rests stay exact
        return torch.cat([0.02 * torch.rand((K, 2), generator=g, device=device) - 0.01,
                          torch.zeros((K, 1), device=device)], 1)

    free_pose[:, s1, :3] = at(0.3, 0.0, z0 + 2 * r, shift())  # on the block's top face
    d = shift()
    kin_pose[:, k1, :3] = at(0.3, 0.15, z0, d)
    free_pose[:, s2, :3] = at(0.3, 0.15, z0 + 2 * r, d)
    # c1 across c0 at its middle, its +x segment end r + rc over k2
    d = shift()
    kin_pose[:, c0, :3] = at(0.3, -0.15, z0, d)
    free_pose[:, c1, :3] = at(0.3, -0.15, z0 + 2 * rc, d)
    kin_pose[:, k2, :3] = at(0.3 + hl, -0.15, z0 + 2 * rc - r - rc, d)
    sim = sim.replace(free_pose=free_pose, kin_pose=kin_pose)
    zeros = torch.zeros_like(sim.qpos)
    return model, sim, DriveCmd(target_qpos=sim.qpos, target_qvel=zeros, qf=zeros)


@pytest.mark.parametrize("name", ["box_sphere", "sphere_sphere", "sphere_capsule",
                                  "capsule_capsule"])
def test_round_scene_holds_the_untasked_pair_functions(name):
    """The scene of ``round_scene`` holds all eight sphere and capsule pair
    functions (box_sphere, sphere_sphere and sphere_capsule among them: no
    task runs those), the kernel supports it, and the contacts of each of
    these four carry force after two sim steps of the plain step (the
    bodies then part)."""
    model, sim, cmd = round_scene(4, "cpu")
    names = {fn.__name__ for fn, *_ in model.pair_groups}
    assert set(ROUND_FNS) <= names
    assert megakernel.supports(model)
    _, aux = make_step_fn(model)(sim, cmd, 2, return_aux=True)
    plan = megakernel._Plan(model)
    loaded = (aux["f_pt"].abs().sum(-1) > 0).numpy()
    assert loaded[:, plan.pfn == megakernel._FNS.index(name)].any(1).all(), name


@pytest.fixture(scope="module")
def plug():
    e = mtt.make("PlugCharger-v1", num_envs=K, reward_mode="dense", device="cpu")
    e.reset(seed=0)
    return e


@pytest.mark.parametrize("task, P, subs", [("PlugCharger-v1", 453, 4), ("RollBall-v1", 47, 1)])
def test_round_pair_functions_and_plan(plug, task, P, subs):
    """The sphere and capsule members of the kernel's PairFn enum follow
    the first two hull ones, in the wrapper's order; PlugCharger-v1 (P=453, 20
    substeps a control step) and RollBall-v1 (P=47) are supported, and
    PlugCharger's charger takes one free body's six columns (n_all = 15)."""
    assert megakernel._FNS[6:14] == ROUND_FNS
    assert megakernel._enum("PairFn")[6:14] == tuple(f"FN_{n.upper()}" for n in ROUND_FNS)
    e = plug if task == "PlugCharger-v1" else mtt.make(task, num_envs=1, device="cpu")
    assert megakernel.supports(e.model)
    assert (e.model.n_points, e.model.params.substeps) == (P, subs)
    assert isinstance(e.kernel, megakernel.MegaKernel)
    if task != "PlugCharger-v1":
        return
    plan = megakernel._Plan(plug.model)
    assert (plan.n_all, plan.G) == (15, 15)
    # the prong pairs of the charger with itself: both sides the same body
    same = (plan.pfa >= 0) & (plan.pfa == plan.pfb)
    assert set(np.asarray(megakernel._FNS)[plan.pfn[same]]) == {"capsule_box", "capsule_capsule"}


def test_work_counts_round_points(plug):
    """The bound prices each sphere and capsule point by its row of
    ``megakernel.OPS``: with the charger lifted far from everything, the
    narrowphase terms of the step are the sums over the point table."""
    plan = megakernel._Plan(plug.model)
    st = plug._state
    far = st.sim.replace(free_pose=st.sim.free_pose + torch.tensor([0, 0, 1.0, 0, 0, 0, 0]))
    _, ops1, c1 = megakernel.work(plan, far, st.cmd, 1)
    _, ops2, c2 = megakernel.work(plan, far, st.cmd, 2)
    names = np.asarray(megakernel._FNS)[plan.pfn]
    for n in ("plane_capsule", "capsule_box", "capsule_capsule"):
        assert (names == n).sum() > 0 and megakernel.OPS[n] > 0
    assert ops2 > ops1 > 0 and c2["points"] == 2 * c1["points"] == 2 * 453 * K


def _kernel_vs_plain(kern, sim, cmd, n, strict, K_, ill_rule=False, per_env=False):
    """One launch against the plain step and a float64 plain step. Envs
    where ``strict`` holds (a bool or a (K,) mask) must be within the
    tolerances. Of the others at most 10 % may leave them (with
    ``ill_rule``, 10 % of those where the float32 plain step itself stays
    within the tolerances of the float64 step: the in-hand scenes), and the
    kernel must be no further from the float64 step than the float32 plain
    step (1.5 x its count, plus 2). With ``per_env`` (the control suite's
    floor contacts, where both float32 steps leave the float64 step's
    tolerances in most envs) the others are held one by one instead, as
    chip_smoke.py's ``disagreement`` holds them: the envs where the kernel
    is more than three times further from the float64 step than the plain
    step (each distance floored at the tolerance) may number no more than
    twice the envs where the plain step is so far from it, plus 1 % of the
    envs (at least 2).
    Returns the plain step's loaded points (K, P)."""
    got, aux = kern(sim, cmd, n)
    ref, aux_ref = kern.plain(sim, cmd, n)
    f64, aux64 = _in_float64(kern.plain, _as64(sim), _as64(cmd), n)
    torch.cuda.synchronize()
    names = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
                 contact_lam=5e-3, contact_lam_t=5e-3)
    triples = [(getattr(got, k), getattr(ref, k), getattr(f64, k), tol)
               for k, tol in names.items() if getattr(ref, k)[0].numel()]
    if aux_ref["f_pt"][0].numel():  # a contact-free scene has no points
        triples += [(aux["f_pt"], aux_ref["f_pt"], aux64["f_pt"], 5e-3)]

    def beyond(a, b, tol):
        return (a.double() - b.double()).abs().reshape(K_, -1).amax(1) > tol

    strict = torch.as_tensor(strict, device=sim.qpos.device).expand(K_)
    held = ~strict
    if ill_rule:
        for _a, b, c, tol in triples:
            held &= ~beyond(b, c, tol)
    def dist(a, b):
        return (a.double() - b.double()).abs().reshape(K_, -1).amax(1)

    for a, b, c, tol in triples:
        assert torch.isfinite(a).all()
        out = beyond(a, b, tol)
        assert not (out & strict).any(), ((out & strict).nonzero().ravel(), tol)
        if strict.all():
            continue
        if per_env:
            d_k, d_p = dist(a, c)[~strict], dist(b, c)[~strict]
            n_k = int((d_k > 3 * d_p.clamp(min=tol)).sum())
            n_p = int((d_p > 3 * d_k.clamp(min=tol)).sum())
            assert n_k <= 2 * n_p + max(2, 0.01 * len(d_k)), (n_k, n_p, tol)
            continue
        assert int((out & held).sum()) <= 0.1 * K_, (int((out & held).sum()), tol)
        k64, p64 = int(beyond(a, c, tol).sum()), int(beyond(b, c, tol).sum())
        assert k64 <= 1.5 * p64 + 2, (k64, p64, tol)
    return (aux_ref["f_pt"].abs().sum(-1) > 0).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["PlugCharger-v1", "RollBall-v1"])
@pytest.mark.parametrize("states", ["reset", "contact"])
def test_round_kernel_matches_plain(task, states):
    """PlugCharger-v1 (capsule prongs on an offset-geom free body, 20
    substeps in one launch) and RollBall-v1 (a free sphere) through the
    CUDA kernel against the plain step on the card, K=37: from reset states
    with the targets moved (every env within the tolerances), or from
    ``contact_state`` states under their own command (the arm holds, the
    gripper shuts), refereed by a float64 plain step as in
    ``test_hull_kernel_matches_plain``; in contact the prongs or the ball
    carry force. (Moved targets in these grasps make the plain float32
    step itself leave the tolerances of a float64 step in 9-15 % of the
    envs: chip_smoke.py.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cenv = mtt.make(task, num_envs=37, reward_mode="dense", device="cuda")
    cenv.reset(seed=0)
    st = cenv._state
    cmd = st.cmd.replace(target_qpos=st.cmd.target_qpos + 0.05)
    if states == "contact":
        st = cenv.contact_state(st, torch.Generator(device="cuda").manual_seed(0))
        cmd = st.cmd
    loaded = _kernel_vs_plain(cenv.kernel, st.sim, cmd, 5, states == "reset", 37)
    assert cenv.kernel.launches == 1
    if states == "contact":
        pfn = np.asarray(megakernel._FNS)[cenv.kernel.plan.pfn]
        for name in (("capsule_box", "plane_capsule") if task.startswith("Plug")
                     else ("sphere_box", "plane_sphere")):
            assert loaded[:, pfn == name].any(1).sum() >= 5, name


@pytest.mark.cuda
@pytest.mark.parametrize("states", ["reset", "contact"])
def test_peg_kernel_matches_plain(states):
    """PegInsertionSide-v1 (a peg sized per env through ``geom_size``, a
    kinematic box of four wall geoms) through the CUDA kernel against the
    plain step on the card, K=64: from reset states with the targets moved
    (every env within the tolerances), or from ``contact_state`` states
    under their own command (the held peg's head in the hole), refereed by
    a float64 plain step as in ``test_round_kernel_matches_plain``; in
    contact the peg-wall points carry force in half the envs or more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cenv = mtt.make("PegInsertionSide-v1", num_envs=64, reward_mode="dense", device="cuda")
    cenv.reset(seed=0)
    st = cenv._state
    cmd = st.cmd.replace(target_qpos=st.cmd.target_qpos + 0.05)
    if states == "contact":
        st = cenv.contact_state(st, torch.Generator(device="cuda").manual_seed(0))
        cmd = st.cmd
    loaded = _kernel_vs_plain(cenv.kernel, st.sim, cmd, 5, states == "reset", 64)
    assert cenv.kernel.launches == 1
    if states == "contact":
        plan, walls = cenv.kernel.plan, cenv.model.geom_indices("box_with_hole")
        wall = np.isin(plan.pga, walls) | np.isin(plan.pgb, walls)
        assert loaded[:, wall].any(1).mean() >= 0.5


@pytest.mark.cuda
def test_pushcube_control_step_replays_as_a_cuda_graph():
    """PushCube-v1's control step (an MPPI solve, K=64, H=3, with its noise
    draw; the env step through K2; the freeze) captured as one CUDA graph
    and replayed 3 times by ``run_episode_device`` equals the eager host
    loop (``run_episode``) from the same seed within 1e-4. K2's wrapper
    counts the warm-up step and the capture, H + 1 calls each (the
    rollouts' and the env step's), and the graph holds H + 1 K2 kernel
    nodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from maniskill_tpu_torch.planners import MPPI, MPPIConfig, run_episode, run_episode_device

    cenv = mtt.make("PushCube-v1", num_envs=1, obs_mode="none", reward_mode="dense",
                    device="cuda")
    planner = MPPI(cenv, MPPIConfig(horizon=3, num_samples=64, sigma=0.6, temperature=0.3))
    stats = {}
    dev = run_episode_device(cenv, planner, seed=0, max_steps=3, stats=stats)
    assert cenv.kernel.launches == 2 * 4
    assert sum(c for name, c in stats["graph_kernels"].items() if "mk_kernel" in name) == 4
    host = run_episode(cenv, planner, seed=0, max_steps=3, stop_on_success=False)
    assert not dev["success"]
    np.testing.assert_allclose(dev["actions"], host["actions"], atol=1e-4)
    np.testing.assert_allclose(dev["rewards"], host["rewards"], atol=1e-4)


@pytest.mark.cuda
def test_round_scene_kernel_matches_plain():
    """The scene of ``round_scene`` (box_sphere, sphere_sphere,
    sphere_capsule and capsule_capsule in contact) through the CUDA kernel
    against the plain step on the card, two sim steps in one launch, K=37:
    every env within the tolerances, and each of those four functions
    carries force."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, sim, cmd = round_scene(37, "cuda")
    kern = megakernel.MegaKernel(model)
    loaded = _kernel_vs_plain(kern, sim, cmd, 2, True, 37)
    pfn = np.asarray(megakernel._FNS)[kern.plan.pfn]
    for name in ("box_sphere", "sphere_sphere", "sphere_capsule", "capsule_capsule"):
        assert loaded[:, pfn == name].any(1).mean() >= 0.9, name


# ---- hulls against spheres, capsules and hulls: the in-hand task and the
# hull stack built for sphere_hull and hull_hull --------------------------

HULL_FNS = ("sphere_hull", "capsule_hull", "hull_hull")


def touched_in_step(kern, sim, cmd, n):
    """(K,) envs in which some point carries force in any sim step of ``n``
    (the plain step, one sim step at a time: its ``f_pt`` is the last
    substep's only)."""
    hit = torch.zeros(sim.qpos.shape[0], dtype=torch.bool, device=sim.qpos.device)
    for _ in range(n):
        sim, aux = kern.plain(sim, cmd, 1)
        hit |= (aux["f_pt"].abs().sum(-1) > 0).any(1) | (sim.contact_lam > 0).any(1)
    return hit


def test_hull_pairs_follow_kernel_enum():
    """sphere_hull, capsule_hull and hull_hull close the kernel's PairFn
    enum in the wrapper's order, and the port's pair table holds all 17
    functions the kernel implements."""
    from maniskill_tpu_torch.physics import shapes

    assert megakernel._FNS[14:] == HULL_FNS
    assert megakernel._enum("PairFn")[14:] == tuple(f"FN_{n.upper()}" for n in HULL_FNS)
    table = {fn.__name__ for fn, _ in shapes.PAIR_FUNCS.values()}
    assert table == set(megakernel._FNS) - {"box_box_onesided", "box_box_corners"}
    assert len(megakernel._FNS) == 17


@pytest.mark.parametrize("task, n_hull", [
    ("RotateCubeInHandAllegro-v1", 0), ("RotateSingleObjectInHandLevel0-v1", 0),
    ("RotateSingleObjectInHandLevel1-v1", 0), ("RotateSingleObjectInHandLevel2-v1", 1),
    ("RotateSingleObjectInHandLevel3-v1", 1)])
def test_inhand_models_are_supported(task, n_hull):
    """Each in-hand model (the Allegro's 16 joints, n_all 22, P=80) is within
    the kernel's caps, the env dispatches to it, and the hull levels carry
    one hull slot of rows on the input plane (capsule_hull against it),
    the cube levels none (capsule_box)."""
    e = mtt.make(task, num_envs=1, device="cpu")
    assert megakernel.supports(e.model) and isinstance(e.kernel, megakernel.MegaKernel)
    plan = megakernel._Plan(e.model)
    assert (plan.nq, plan.n_all, plan.P, plan.n_hull) == (16, 22, 80, n_hull)
    assert plan.i_hfaces[1] - plan.i_hverts[0] == n_hull * (3 * 40 + 4 * 32)
    names = set(np.asarray(megakernel._FNS)[plan.pfn])
    assert names == {"capsule_hull" if n_hull else "capsule_box", "plane_capsule"}


def test_work_counts_capsule_hull_points():
    """The bound prices each capsule_hull sample by its row of ``OPS``:
    with the object lifted far from the hand, the narrowphase of Level2's
    step is 48 capsule_hull and 32 plane_capsule points."""
    e = mtt.make("RotateSingleObjectInHandLevel2-v1", num_envs=K, device="cpu")
    e.reset(seed=0)
    plan = megakernel._Plan(e.model)
    st = e._state
    far = st.sim.replace(free_pose=st.sim.free_pose + torch.tensor([0, 0, 1.0, 0, 0, 0, 0]))
    _, ops1, c1 = megakernel.work(plan, far, st.cmd, 1)
    _, ops2, c2 = megakernel.work(plan, far, st.cmd, 2)
    O = megakernel.OPS
    names = np.asarray(megakernel._FNS)[plan.pfn]
    assert sum(O[n] for n in names) == 48 * O["capsule_hull"] + 32 * O["plane_capsule"]
    assert ops2 > ops1 > 0 and c2["points"] == 2 * c1["points"] == 2 * 80 * K


@pytest.fixture(scope="module")
def stack_scene():
    from maniskill_tpu_torch.physics.hull_stack import hull_stack

    return hull_stack(K, "cpu")


def test_hull_stack_reads_both_hull_slots(stack_scene):
    """The hull stack has two hull slots: the plane carries both envs'
    tables slot-major, and the hull_hull pair's sides read slots 0 (the
    slab) and 1 (the block) through the geoms' hull slots; the kernel
    supports the scene."""
    model, sim, cmd = stack_scene
    assert model.n_hull == 2 and sim.hull_verts.shape == (K, 2, 40, 3)
    assert megakernel.supports(model)
    plan = megakernel._Plan(model)
    plane = megakernel.pack(plan, sim, cmd)
    assert plan.i_hfaces[1] - plan.i_hverts[0] == 2 * (3 * 40 + 4 * 32)
    np.testing.assert_array_equal(plane[:, plan.i_hverts[0]:plan.i_hverts[1]],
                                  sim.hull_verts.reshape(K, -1))
    hh = plan.pfn == megakernel._FNS.index("hull_hull")
    assert hh.sum() == 80 and plan.pcorner[hh].tolist() == list(range(80))
    ga, gb = int(plan.pga[hh][0]), int(plan.pgb[hh][0])
    assert (model.geom_hull_slot[ga], model.geom_hull_slot[gb]) == (0, 1)
    assert [model.geoms[g].name for g in (ga, gb)] == ["slab", "block"]


def test_work_counts_hull_hull_points(stack_scene):
    """The bound prices A's cloud against B's planes and B's against A's
    by their rows of ``OPS``; with the stack lifted apart, the narrowphase
    is the sum over the point table."""
    model, sim, cmd = stack_scene
    plan = megakernel._Plan(model)
    lift = torch.tensor([[0, 0, 0.0], [0, 0, 1.0], [0, 0, 2.0]])
    far = sim.replace(free_pose=sim.free_pose + torch.cat([lift, torch.zeros(3, 4)], 1))
    _, ops1, c1 = megakernel.work(plan, far, cmd, 1)
    assert c1["active"] < 80 * K  # only the slab's points on the ground
    O = megakernel.OPS
    names = np.asarray(megakernel._FNS)[plan.pfn]
    narrow = sum(O["hull_hull_a" if c < 40 else "hull_hull_b"] if n == "hull_hull"
                 else O[n] for n, c in zip(names, plan.pcorner))
    assert narrow == (40 * (O["hull_hull_a"] + O["hull_hull_b"]) + 2 * O["sphere_hull"]
                      + 80 * O["plane_hull"] + O["plane_sphere"] + 40 * O["plane_box"])
    _, ops, c = megakernel.work(plan, sim, cmd, 1)
    assert c["active"] > c1["active"] and ops > ops1


@pytest.mark.cuda
@pytest.mark.parametrize("states", ["dropped", "settled"])
def test_hull_stack_kernel_matches_plain(states):
    """The hull stack through the CUDA kernel against the plain step on the
    card, one control step, K=37: dropped (each body 1 mm over the one
    below) and settled (10 sim steps of the plain step), under the referee
    rule of ``_kernel_vs_plain`` with ``ill_rule`` (the landing amplifies float32 rounding:
    free vel 4.4e-4 from a float64 step in the worst of 512 envs, median
    8.5e-5; chip_smoke.py). In both, sphere_hull and both halves of
    hull_hull carry force by the step's end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from maniskill_tpu_torch.physics.hull_stack import hull_stack

    model, sim, cmd = hull_stack(37, "cuda", settle_steps=0 if states == "dropped" else 10)
    kern = megakernel.MegaKernel(model)
    loaded = _kernel_vs_plain(kern, sim, cmd, 5, False, 37, ill_rule=True)
    assert kern.launches == 1
    plan = kern.plan
    pfn = np.asarray(megakernel._FNS)[plan.pfn]
    for mask in (pfn == "sphere_hull", (pfn == "hull_hull") & (plan.pcorner < 40),
                 (pfn == "hull_hull") & (plan.pcorner >= 40)):
        assert loaded[:, mask].any(1).mean() >= 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("states", ["reset", "contact"])
def test_inhand_kernel_matches_plain(states):
    """RotateSingleObjectInHandLevel2-v1 (the Allegro hand, nq=16, n_all=22,
    a hull per env against 16 capsules) through the CUDA kernel against the
    plain step on the card, K=37: from reset states with the targets moved,
    every env whose object touches nothing in the step (``touched_in_step``)
    within the tolerances, the others by the referee rule of
    ``_kernel_vs_plain`` with ``ill_rule``; from ``contact_state`` states (the dropped object settled
    on the fingers) under their own command, by the referee rule of
    ``_kernel_vs_plain`` with ``ill_rule``, with capsule_hull points loaded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cenv = mtt.make("RotateSingleObjectInHandLevel2-v1", num_envs=37, reward_mode="dense",
                    device="cuda")
    cenv.reset(seed=0)
    st = cenv._state
    cmd = st.cmd.replace(target_qpos=st.cmd.target_qpos + 0.05)
    if states == "contact":
        st = cenv.contact_state(st, torch.Generator(device="cuda").manual_seed(0))
        cmd = st.cmd
    strict = (~touched_in_step(cenv.kernel, st.sim, cmd, 5) if states == "reset"
              else torch.zeros(37, dtype=torch.bool, device="cuda"))
    loaded = _kernel_vs_plain(cenv.kernel, st.sim, cmd, 5, strict, 37, ill_rule=True)
    assert cenv.kernel.launches == 1
    if states == "contact":
        pfn = np.asarray(megakernel._FNS)[cenv.kernel.plan.pfn]
        assert loaded[:, pfn == "capsule_hull"].any(1).mean() >= 0.5


# ---- the env-major planes and the kernel's shared-memory slice -----------

def test_output_plane_is_env_major(stack_scene):
    """Env k's outputs are row k of the (K, W_out) plane, in the row plan's
    order and component order: unpack reads each field of env k from
    ``out[k, row]``. The hull stack (three free bodies, two hull slots)
    pads its input row, and pack keeps each env's own hull tables in its
    row."""
    model, sim, cmd = stack_scene
    plan = megakernel._Plan(model)
    assert plan.W_in == 1532 and plan.W_out == 1568 and plan.R_in == 1530
    plane = megakernel.pack(plan, sim, cmd)
    assert plane.shape == (K, 1532) and not plane[:, plan.R_in:].any()
    for k in range(K):
        np.testing.assert_array_equal(plane[k, plan.i_hfaces[0]:plan.i_hfaces[1]],
                                      sim.hull_faces[k].reshape(-1))
    out = torch.arange(K * plan.W_out, dtype=torch.float32).reshape(K, plan.W_out)
    new, aux = megakernel.unpack(plan, out, sim)
    F, P, nb = plan.F, plan.P, plan.nb
    for k in range(K):
        assert new.qpos[k].tolist() == out[k, plan.o_qpos[0]:plan.o_qpos[1]].tolist()
        assert new.free_pose[k, 2, 3] == out[k, plan.o_free_pose[0] + 7 * 2 + 3]
        assert new.contact_lam_t[k, 5, 1] == out[k, plan.o_lamt[0] + P + 5]
        assert aux["f_pt"][k, 7, 2] == out[k, plan.o_fpt[0] + 2 * P + 7]
        assert aux["body_quat"][k, 3, 1] == out[k, plan.o_bquat[0] + nb + 3]
    assert new.free_pose.shape == (K, F, 7) and new.free_pose.is_contiguous()


@pytest.mark.parametrize("task, floats", [
    # W_in 724 + 41 x 9 bodies + 7 x 8 geoms + TRI(15) 120 + 3 x 15 dofs
    # + 8 loading points x (4 x 15 + 16) + 7 x 1 free body + 7 x 136
    # points = 2,881 -> 2,884
    ("PickCube-v1", 2884),
    # W_in 896 + 41 x 16 + 7 x 18 + TRI(22) 253 + 3 x 22 + 8 x (4 x 22 +
    # 16) + 7 + 7 x 80 = 3,396
    ("RotateSingleObjectInHandLevel2-v1", 3396),
    # a robot-only forest (F = 0): W_in 844 + 41 x 10 + 7 x 9 + TRI(10) 55
    # + 3 x 10 + 8 x (4 x 10 + 16) + 0 + 7 x 168 = 3,026 -> 3,028
    ("TurnFaucet-v1", 3028),
    # the Fetch and the drawer: W_in 1528 + 41 x 16 + 7 x 12 + TRI(16) 136
    # + 3 x 16 + 8 x (4 x 16 + 16) + 7 x 320 = 5,332
    ("OpenCabinetDrawer-v1", 5332),
    # contact-free (P = 0, G = 0): W_in 16 + 41 x 2 + TRI(2) 3 + 3 x 2 + 8
    # x (4 x 2 + 16) = 299 -> 300
    ("MS-CartpoleBalance-v1", 300),
    # the humanoid, nq 27: W_in 556 + 41 x 27 + 7 x 20 + TRI(27) 378 + 3 x
    # 27 + 8 x (4 x 27 + 16) + 7 x 35 = 3,499 -> 3,500
    ("MS-HumanoidStand-v1", 3500)])
def test_slice_follows_a_hand_count(task, floats):
    """The floats of one env's shared-memory slice against a count by hand
    of make_layout's sections."""
    e = mtt.make(task, num_envs=1, device="cpu")
    plan = megakernel._Plan(e.model)
    assert plan.slice_floats() == floats and floats % 4 == 0


_IDS = ["Empty-v1", "FoldSuitcase-v1", "FoldSuitcaseModels-v1", "LiftPegUpright-v1", "MS-AntRun-v1",
        "MS-AntWalk-v1", "MS-CartpoleBalance-v1", "MS-CartpoleSwingUp-v1", "MS-HopperHop-v1",
        "MS-HopperStand-v1", "MS-HumanoidRun-v1", "MS-HumanoidStand-v1",
        "MS-HumanoidWalk-v1", "OpenCabinetDoor-v1",
        "OpenCabinetDrawer-v1", "OpenCabinetDrawerModels-v1", "PegInsertionSide-v1",
        "PickCube-v1", "PickSingleHull-v1", "PickSingleYCB-v1", "PlugCharger-v1", "PokeCube-v1",
        "PullCube-v1", "PullCubeTool-v1", "PushCube-v1", "PushCubeKitchen-v1", "RollBall-v1",
        "RotateCubeInHandAllegro-v1", "RotateSingleObjectInHandLevel0-v1",
        "RotateSingleObjectInHandLevel1-v1", "RotateSingleObjectInHandLevel2-v1",
        "RotateSingleObjectInHandLevel3-v1", "StackCube-v1", "TurnFaucet-v1"]


@pytest.mark.parametrize("task", _IDS + ["hull stack"])
def test_every_ported_scene_fits_the_kernel(task):
    """Every registered id and the hull stack are within the kernel's caps
    (a body, dof and geom a lane), a block's slices (WARPS envs) fit its
    shared memory, and ``supports`` takes them, so the env dispatches to
    the kernel and never quietly to the plain step."""
    from maniskill_tpu_torch.envs.registration import REGISTERED_ENVS

    assert sorted(REGISTERED_ENVS) == _IDS
    if task == "hull stack":
        from maniskill_tpu_torch.physics.hull_stack import hull_stack

        model = hull_stack(1, "cpu")[0]
    else:
        e = mtt.make(task, num_envs=1, device="cpu")
        model = e.model
        assert isinstance(e.kernel, megakernel.MegaKernel)
    caps = megakernel._caps()
    plan = megakernel._Plan(model)
    assert megakernel.supports(model)
    assert max(plan.nq, plan.n_all, plan.G) <= 32 and plan.F <= caps["F_MAX"]
    assert 4 * caps["WARPS"] * plan.slice_floats() <= megakernel.SMEM_BLOCK_MAX


def test_supports_refuses_a_slice_beyond_shared_memory(env, monkeypatch):
    """A model whose block of slices cannot fit the card's shared memory is
    refused (and so never launched)."""
    assert megakernel.supports(env.model)
    block = 4 * megakernel._caps()["WARPS"] * megakernel._Plan(env.model).slice_floats()
    monkeypatch.setattr(megakernel, "SMEM_BLOCK_MAX", block - 4)
    assert not megakernel.supports(env.model)


def _reset_vs_plain(kern, sim, cmd, K_):
    """One control step through the kernel against the plain step, every
    env within the tolerances of ``test_kernel_matches_plain``."""
    got, aux = kern(sim, cmd, 5)
    ref, aux_ref = kern.plain(sim, cmd, 5)
    torch.cuda.synchronize()
    pairs = [(getattr(got, n), getattr(ref, n), tol) for n, tol in dict(
        qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
        contact_lam=5e-3, contact_lam_t=5e-3).items()]
    pairs += [(aux[n], aux_ref[n], 2e-5) for n in ("body_pos", "body_quat", "axis_w")]
    pairs += [(aux["f_pt"], aux_ref["f_pt"], 5e-3)]
    for a, b, tol in pairs:
        assert a.shape[0] == K_ and torch.isfinite(a).all()
        env_err = (a - b).abs().reshape(K_, -1).amax(1)
        assert bool((env_err <= tol).all()), (env_err.max(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("K_", [1, 33, 4097])
def test_ragged_k_matches_plain(K_):
    """PickCube reset states at K = 1 (iLQR's rollouts: one warp on the
    card), 33 and 4,097 (a warp past a whole number of blocks of four or
    of 32 threads) through the kernel against the plain step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cenv = mtt.make("PickCube-v1", num_envs=K_, reward_mode="dense", device="cuda")
    cenv.reset(seed=0)
    st = cenv._state
    _reset_vs_plain(cenv.kernel, st.sim, st.cmd.replace(target_qpos=st.cmd.target_qpos + 0.05), K_)
    assert cenv.kernel.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["PickCube-v1", "PlugCharger-v1"])
def test_repeat_launches_are_bit_identical(task):
    """Two launches on one plane give the same bits (no float atomics, no
    order that depends on scheduling), from states in contact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cenv = mtt.make(task, num_envs=37, reward_mode="dense", device="cuda")
    cenv.reset(seed=0)
    st = cenv.contact_state(cenv._state, torch.Generator(device="cuda").manual_seed(0))
    kern = cenv.kernel
    plane = megakernel.pack(kern.plan, st.sim, st.cmd)
    n_sub = 5 * cenv.model.params.substeps
    a, b = kern.launch(plane, n_sub), kern.launch(plane, n_sub)
    torch.cuda.synchronize()
    R = kern.plan.R_out
    assert torch.equal(a[:, :R].view(torch.int32), b[:, :R].view(torch.int32))
    assert kern.launches == 2


@pytest.mark.cuda
def test_launch_refused_for_shared_memory_raises():
    """A slice the card cannot give a block (a plan widened to 64,000
    floats a row) is refused at launch, and the wrapper raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cenv = mtt.make("PickCube-v1", num_envs=4, device="cuda")
    kern = cenv.kernel
    kern.plan = copy.copy(kern.plan)
    kern.plan.W_in = 64000
    with pytest.raises(RuntimeError, match="launch failed"):
        kern.launch(torch.zeros((4, 64000), device="cuda"), 5)
    assert kern.launches == 0


# ---- articulated objects: a kinematic forest, robot-only scenes (F=0) ------

ART_IDS = ["FoldSuitcaseModels-v1", "TurnFaucet-v1", "OpenCabinetDrawer-v1"]


@pytest.fixture(scope="module")
def faucet():
    e = mtt.make("TurnFaucet-v1", num_envs=K, reward_mode="dense", device="cpu")
    e.reset(seed=0)
    return e


def test_forest_plan_has_no_free_rows(faucet):
    """A robot-only forest (the Panda and the faucet's handle, F = 0): the
    free-body slices of both planes are empty, the packed plane round-trips
    with zero-width free-body fields, the handle's dof (9) is a root of its
    own tree, and the handle's points against the fingers have a robot
    body on each side, in different trees."""
    model = faucet.model
    plan = megakernel._Plan(model)
    assert (plan.F, plan.nq, plan.n_all, plan.G, plan.P) == (0, 10, 10, 9, 168)
    for sl in (plan.i_free_pose, plan.i_free_vel, plan.i_fmass, plan.i_finertia,
               plan.o_free_pose, plan.o_free_vel):
        assert sl[0] == sl[1]
    assert model.robot.parent[9] == -1 and model.tree_id.tolist() == [0] * 9 + [1]
    st = faucet._state
    plane = megakernel.pack(plan, st.sim, st.cmd)
    assert plane.shape == (K, plan.W_in) and not plane[:, plan.R_in:].any()
    out = torch.zeros(K, plan.W_out)
    out[:, plan.o_qpos[0]:plan.o_qpos[1]] = st.sim.qpos
    back, aux = megakernel.unpack(plan, out, st.sim)
    assert back.free_pose.shape == (K, 0, 7) and back.free_vel.shape == (K, 0, 6)
    np.testing.assert_array_equal(back.qpos, st.sim.qpos)
    assert aux["body_pos"].shape == (K, 10, 3)
    cross = (plan.pra >= 0) & (plan.prb >= 0)
    # the hand's box and the fingers' four against the handle, 16 corners each
    assert cross.sum() == 5 * 16
    assert (model.tree_id[plan.pra[cross]] != model.tree_id[plan.prb[cross]]).all()


def test_work_counts_cross_tree_points_on_both_sides(faucet):
    """A loaded point with a robot link on each side prices the Jacobian
    columns of both trees' dofs: the fingers' ancestors (9 dofs of the
    arm and gripper less the other finger) and the handle's dof."""
    plan = megakernel._Plan(faucet.model)
    anc = faucet.model.ancestor_mask
    cross = np.nonzero((plan.pra >= 0) & (plan.prb >= 0))[0]
    for p in cross[:4]:
        ra, rb = plan.pra[p], plan.prb[p]
        n = np.count_nonzero(anc[ra] - anc[rb])
        assert n == np.count_nonzero(anc[ra]) + np.count_nonzero(anc[rb])
    st = faucet.contact_state(faucet._state, torch.Generator().manual_seed(0))
    _, ops_c, counts_c = megakernel.work(plan, st.sim, st.cmd, 5)
    _, ops_r, counts_r = megakernel.work(plan, faucet._state.sim, faucet._state.cmd, 5)
    assert counts_c["loaded"] > counts_r["loaded"] and ops_c > ops_r


def test_forest_gravity_and_passive_dofs(faucet):
    """The static tables carry the forest's per-body gravity (the handle's
    link only) and the handle's passive drive (kp = kd = 0, limit 1e10),
    and the handle's joint limits and friction beside the robot's."""
    model = faucet.model
    plan = megakernel._Plan(model)
    mf, mi = plan.tables()
    names = [n for n in megakernel._enum("Header") if n != "H_COUNT"]
    head = dict(zip(names, mi[:len(names)].tolist()))
    np.testing.assert_array_equal(mf[head["F_GMASK"]:head["F_GMASK"] + 10], [0.0] * 9 + [1.0])
    np.testing.assert_array_equal(mf[head["F_QLIM"] + 18:head["F_QLIM"] + 20],
                                  np.float32([-2.4, 2.4]))
    assert mf[head["F_JFRIC"] + 9] == np.float32(0.25)
    cmd = faucet._state.cmd
    assert cmd.kp[:, 9].eq(0).all() and cmd.kd[:, 9].eq(0).all()
    assert cmd.force_limit[:, 9].eq(1e10).all()
    assert (cmd.kp[:, :7] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("task", ART_IDS)
@pytest.mark.parametrize("states", ["reset", "contact"])
def test_articulated_kernel_matches_plain(task, states):
    """The articulated scenes (a forest, F = 0) through the CUDA kernel
    against the plain step on the card, K=37: from reset states with the
    targets moved, every env where no point carries force in the step
    within the tolerances, the others refereed; from ``contact_state``
    states (fingers pressing the lid or the drawer, a lid or a drawer past
    its limit) under their own command, refereed by a float64 plain step;
    there the points with a robot link on each side carry force."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cenv = mtt.make(task, num_envs=37, reward_mode="dense", device="cuda")
    cenv.reset(seed=0)
    st = cenv._state
    cmd = st.cmd.replace(target_qpos=st.cmd.target_qpos + 0.05)
    if states == "contact":
        st = cenv.contact_state(st, torch.Generator(device="cuda").manual_seed(0))
        cmd = st.cmd
    # reset envs where a point carries force in the step (the laptop's lid
    # through the hand) take the contact states' rule
    strict = (~touched_in_step(cenv.kernel, st.sim, cmd, 5) if states == "reset"
              else torch.zeros(37, dtype=torch.bool, device="cuda"))
    loaded = _kernel_vs_plain(cenv.kernel, st.sim, cmd, 5, strict, 37)
    assert cenv.kernel.launches == 1
    if states == "contact":
        plan = cenv.kernel.plan
        cross = (plan.pra >= 0) & (plan.prb >= 0)
        assert loaded[:, cross].any(1).mean() >= 0.5


# ---- the control suite: contact-free scenes (P = 0) and nq 27 ---------------


@pytest.fixture(scope="module")
def cartpole():
    e = mtt.make("MS-CartpoleBalance-v1", num_envs=K, reward_mode="dense", device="cpu")
    e.reset(seed=0)
    return e


def test_contact_free_plan_and_packing(cartpole):
    """Cartpole (no geoms, no points): zero-width point rows on both
    planes, a pack/unpack round trip with (K, 0) warm starts and forces,
    header offsets of the empty tables at their tables' ends, and a bound
    of the fixed terms only."""
    model = cartpole.model
    plan = megakernel._Plan(model)
    assert (plan.nq, plan.F, plan.G, plan.P, plan.n_all) == (2, 0, 0, 0, 2)
    for sl in (plan.i_lam, plan.i_lamt, plan.i_gsize, plan.o_lam, plan.o_lamt, plan.o_fpt):
        assert sl[0] == sl[1]
    assert (plan.R_in, plan.R_out, plan.W_in, plan.W_out) == (16, 24, 16, 24)
    assert megakernel.supports(model) and isinstance(cartpole.kernel, megakernel.MegaKernel)
    st = cartpole._state
    plane = megakernel.pack(plan, st.sim, st.cmd)
    assert plane.shape == (K, 16)
    np.testing.assert_array_equal(plane[:, plan.i_kp[0]:plan.i_kp[1]], st.cmd.kp)
    out = torch.zeros(K, plan.W_out)
    out[:, plan.o_qpos[0]:plan.o_qpos[1]] = st.sim.qpos
    back, aux = megakernel.unpack(plan, out, st.sim)
    np.testing.assert_array_equal(back.qpos, st.sim.qpos)
    assert back.contact_lam.shape == (K, 0) and back.contact_lam_t.shape == (K, 0, 3)
    assert aux["f_pt"].shape == (K, 0, 3) and aux["body_pos"].shape == (K, 2, 3)
    mf, mi = plan.tables()
    names = [n for n in megakernel._enum("Header") if n != "H_COUNT"]
    head = dict(zip(names, mi[:len(names)].tolist()))
    assert head["H_P"] == 0 and head["H_G"] == 0 and head["F_DN0"] == mf.size
    assert head["I_GHULL"] == mi.size
    nbytes, ops, counts = megakernel.work(plan, st.sim, st.cmd, 8)
    assert counts == dict(points=0, active=0, loaded=0)
    assert nbytes == 4 * (16 + 24) * K + mf.nbytes + mi.nbytes
    _, ops1, _ = megakernel.work(plan, st.sim, st.cmd, 1)
    assert ops == 8 * ops1 > 0


def test_humanoid_plan_and_torques():
    """MS-HumanoidStand-v1 (nq 27: its root six dofs and 21 actuated
    hinges, n_all 27, 378 packed LHS entries, P 35 on the floor): within
    the kernel's caps, four envs a block fit the card's shared memory, the
    robot's links feel gravity, and the torque command reaches the input
    plane's qf rows."""
    e = mtt.make("MS-HumanoidStand-v1", num_envs=2, device="cpu")
    e.reset(seed=0)
    plan = megakernel._Plan(e.model)
    assert (plan.nq, plan.n_all, plan.G, plan.P, plan.F) == (27, 27, 20, 35, 0)
    assert plan.n_all * (plan.n_all + 1) // 2 == 378
    caps = megakernel._caps()
    assert 4 * caps["WARPS"] * plan.slice_floats() <= megakernel.SMEM_BLOCK_MAX
    assert e.model.gravity_mask.all()
    st = e.random_torques(e._state, torch.Generator().manual_seed(0))
    plane = megakernel.pack(plan, st.sim, st.cmd)
    qf = plane[:, plan.i_qf[0]:plan.i_qf[1]]
    np.testing.assert_array_equal(qf, st.cmd.qf)
    assert not qf[:, :6].any() and qf[:, 6:].abs().min() > 0
    assert not plane[:, plan.i_kp[0]:plan.i_kp[1]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("task, states", [
    ("MS-CartpoleBalance-v1", "reset"), ("MS-CartpoleBalance-v1", "settled"),
    ("MS-HumanoidStand-v1", "reset"), ("MS-HumanoidStand-v1", "contact")])
def test_control_kernel_matches_plain(task, states):
    """The control suite through the CUDA kernel against the plain step on
    the card, K=37, one control step (4 sim steps of 2 substeps) under
    random torques (``random_torques``) or, for Cartpole, a random slider
    action: Cartpole (P = 0, G = 0) from reset states and from states 10
    control steps on, every env within the tolerances; the humanoid (nq 27,
    non-zero qf) from reset states (in the air) and from ``contact_state``
    states on the floor (where the floor points carry force), every env
    refereed one by one by a float64 plain step (``per_env``): under the
    bench torques its qvel reaches 100 rad/s, and the two float32 steps
    differ beyond 2e-4 in a few envs in the air too (chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cenv = mtt.make(task, num_envs=37, reward_mode="dense", device="cuda")
    cenv.reset(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    st = cenv._state
    n = cenv.sim_steps_per_control
    if task.startswith("MS-Cartpole"):
        a = torch.rand((37, 1), generator=gen, device="cuda") * 2 - 1
        cmd = cenv.agent.controller.set_action(st.cmd, st.sim.qpos, a)
        sim = st.sim
        if states == "settled":
            for _ in range(10):
                sim = cenv.kernel(sim, cmd, n)[0]
        _kernel_vs_plain(cenv.kernel, sim, cmd, n, True, 37)
        assert cenv.kernel.launches == (11 if states == "settled" else 1)
        return
    st = cenv.contact_state(st, gen) if states == "contact" else cenv.random_torques(st, gen)
    assert st.cmd.qf[:, 6:].abs().min() > 0
    loaded = _kernel_vs_plain(cenv.kernel, st.sim, st.cmd, n, False, 37, per_env=True)
    assert cenv.kernel.launches == 1
    if states == "contact":
        assert loaded.any(1).mean() >= 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["friction", "plane_sphere"])
def test_control_referee_catches_planted_fault(fault):
    """``test_control_kernel_matches_plain``'s humanoid contact check on a
    kernel with a fault planted in its static tables fails: every point's
    friction coefficient 1 % high, or the plane_sphere points' normal
    impulse gain 1 % high (the head on the floor, in a quarter of the
    envs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cenv = mtt.make("MS-HumanoidStand-v1", num_envs=37, reward_mode="dense", device="cuda")
    cenv.reset(seed=0)
    st = cenv.contact_state(cenv._state, torch.Generator(device="cuda").manual_seed(0))
    bad = megakernel.MegaKernel(cenv.model)
    if fault == "friction":
        bad.plan.cmu = bad.plan.cmu * np.float32(1.01)
    else:
        sphere = bad.plan.pfn == megakernel._FNS.index("plane_sphere")
        bad.plan.dn0 = np.where(sphere, bad.plan.dn0 * np.float32(1.01), bad.plan.dn0)
    with pytest.raises(AssertionError):
        _kernel_vs_plain(bad, st.sim, st.cmd, cenv.sim_steps_per_control, False, 37,
                         per_env=True)
    assert bad.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pd_ee_delta_pos", "pd_ee_delta_pose"])
def test_ee_control_step_kernels_match_plain(mode, monkeypatch):
    """One task-space control step of PickCube-v1 on the card (K=64): the
    IK step launches K1 once and the physics step K2 once; the drive
    targets through K1 against those through its plain version within
    1e-4, and K2's step against the plain step within
    ``test_kernel_matches_plain``'s tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from maniskill_tpu_torch.envs.base_env import TaskContext
    from maniskill_tpu_torch.physics import linalg, solve_kernel

    Kc = 64
    cenv = mtt.make("PickCube-v1", num_envs=Kc, reward_mode="dense", device="cuda",
                    control_mode=mode)
    cenv.reset(seed=0)
    st = cenv._state
    gen = torch.Generator(device="cuda").manual_seed(0)
    action = 2 * torch.rand((Kc, cenv.action_dim), generator=gen, device="cuda") - 1
    solve_kernel.launches, cenv.kernel.launches = 0, 0
    st2, _, _ = cenv._advance(st, action)
    torch.cuda.synchronize()
    assert (solve_kernel.launches, cenv.kernel.launches) == (1, 1)
    ctx = TaskContext(cenv, st)
    aux = (torch.as_tensor(cenv.model.robot_base_pose, device="cuda"), ctx.body_pos,
           ctx.body_quat, ctx.axis_w)
    monkeypatch.setattr(solve_kernel, "solve_psd", linalg.solve_psd)
    ref_cmd = cenv.agent.controller.set_action(st.cmd, st.sim.qpos, action, aux=aux)
    err = float((st2.cmd.target_qpos - ref_cmd.target_qpos).abs().max())
    assert err <= 1e-4, err
    ref, _ = cenv.kernel.plain(st.sim, st2.cmd, 5)
    for name, tol in dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
                          contact_lam=5e-3, contact_lam_t=5e-3).items():
        e = (getattr(st2.sim, name) - getattr(ref, name)).abs().reshape(Kc, -1).amax(1)
        assert bool((e <= tol).all()), (name, float(e.max()))
