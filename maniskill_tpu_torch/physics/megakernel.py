"""Whole-step physics mega-kernel: wrapper, row plan, packing, build, load.

Port of the Pallas TPU kernel ``maniskill_tpu/physics/megakernel.py``
(``_build_kernel`` -> ``kernel``, ``:494``, launched by
``make_pallas_step_fn``, ``:1729``). The kernel itself is CUDA C++ in
``maniskill_tpu_torch/csrc/megakernel.cu`` (one env per thread; its header
note says what bounds it and why it is built as it is). This module keeps
the TPU kernel's env-last data layout: an input plane (R_in, K) and an
output plane (R_out, K), row r of env k at ``r*K + k``, with the same row
plan (``_Plan``) and component order as the JAX ``_pack``/``_unpack``.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use
(``maniskill_tpu_torch/_cuda.py``) and loaded with ``ctypes``. Its plain
version is the PyTorch engine step (``engine.make_step_fn``), which the
wrapper takes for CPU tensors only.

``KernelStep`` is the port of the JAX ``custom_jvp`` seam
(``maniskill_tpu/envs/base_env.py:495-513``): a ``torch.autograd.Function``
whose forward launches the kernel and whose derivatives, forward
(``jvp``) and reverse (``backward``), recompute the plain step on the saved
inputs and differentiate it. The kernel has no derivative of its own.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import re

import numpy as np
import torch

from .. import _cuda
from .._consts import const
from .engine import (_assignment_tables, _trace_metadata, _v_body, joint_columns,
                     make_step_fn, point_forces, robot_fk)
from .model import BodyKind, DriveCmd, SceneModel, SimState

SOURCE = _cuda.CSRC / "megakernel.cu"
BLOCK = 32  # threads per block: K=4096 envs -> 128 blocks over 132 SMs

# pair functions the kernel implements, in the order of its PairFn enum
_FNS = ("plane_box", "box_box_onesided", "box_box_corners", "box_box")


@functools.lru_cache(maxsize=None)
def _caps():
    """Compile-time caps of the kernel's thread-local arrays (#defines)."""
    src = SOURCE.read_text()
    return {n: int(re.search(rf"#define {n} (\d+)", src).group(1))
            for n in ("NB_MAX", "NALL_MAX", "G_MAX", "F_MAX")}


@functools.lru_cache(maxsize=None)
def _enum(name: str):
    """Member names of a C enum in the kernel source, in order."""
    src = SOURCE.read_text()
    body = re.search(rf"enum {name} \{{(.*?)\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return tuple(t.strip() for t in body.split(",") if t.strip())


def supports(model: SceneModel) -> bool:
    """Whether the CUDA kernel covers this model: velocity contact mode, one
    robot tree, pair functions among those the kernel implements, and sizes
    within its compile-time caps. (The port's ``SceneModel`` has no pair
    drives or hulls yet, so they need no test here.)"""
    caps = _caps()
    if model.params.contact_mode != "velocity" or model.robot is None:
        return False
    if model.n_points == 0:
        return False
    for (fn, *_rest) in model.pair_groups:
        if fn.__name__ not in _FNS:
            return False
    n_all = model.nq + 6 * model.n_free
    return (model.nq <= caps["NB_MAX"] and n_all <= caps["NALL_MAX"]
            and len(model.geoms) <= caps["G_MAX"] and model.n_free <= caps["F_MAX"])


class _Plan:
    """Static row layout of the two planes + per-point tables of one model."""

    def __init__(self, model: SceneModel):
        self.model = model
        self.nq = nq = model.nq
        self.F = F = model.n_free
        self.nb = model.robot.nb
        self.nk = nk = model.n_kin
        self.G = G = len(model.geoms)
        self.P = P = model.n_points
        self.n_all = nq + 6 * F
        off = 0

        def take(n):
            nonlocal off
            sl = (off, off + n)
            off += n
            return sl

        self.i_qpos = take(nq)
        self.i_qvel = take(nq)
        self.i_free_pose = take(7 * F)
        self.i_free_vel = take(6 * F)
        self.i_kin = take(7 * nk)
        self.i_gsize = take(3 * G)
        self.i_gpos = take(3 * G)
        self.i_gquat = take(4 * G)
        self.i_fmass = take(F)
        self.i_finertia = take(6 * F)  # unique symmetric comps, body frame
        self.i_lam = take(P)
        self.i_lamt = take(3 * P)
        self.i_tq = take(nq)
        self.i_tv = take(nq)
        self.i_qf = take(nq)
        self.i_kp = take(nq)
        self.i_kd = take(nq)
        self.i_flim = take(nq)
        self.R_in = off
        off = 0
        self.o_qpos = take(nq)
        self.o_qvel = take(nq)
        self.o_free_pose = take(7 * F)
        self.o_free_vel = take(6 * F)
        self.o_lam = take(P)
        self.o_lamt = take(3 * P)
        self.o_fpt = take(3 * P)
        self.o_bpos = take(3 * self.nb)
        self.o_bquat = take(4 * self.nb)
        self.o_axis = take(3 * self.nb)
        self.R_out = off

        # per-point tables in the engine's point order (_trace_metadata):
        # pair function, geoms of both sides, sample index within the pair
        pfn, pga, pgb, pcorner = [], [], [], []
        for (fn, npts, ia, ib, _mu) in model.pair_groups:
            for j in range(len(ia)):
                for c in range(npts):
                    pfn.append(_FNS.index(fn.__name__))
                    pga.append(int(ia[j]))
                    pgb.append(int(ib[j]))
                    pcorner.append(c)
        self.pfn, self.pga, self.pgb, self.pcorner = (
            np.asarray(x, np.int32) for x in (pfn, pga, pgb, pcorner))
        *_, meta_a, meta_b = _trace_metadata(model)

        def side(meta, kind):
            return np.asarray([b if (kd == kind and b >= 0) else -1
                               for (kd, b) in meta], np.int32)

        self.pra = side(meta_a, BodyKind.ROBOT_LINK)
        self.prb = side(meta_b, BodyKind.ROBOT_LINK)
        self.pfa = side(meta_a, BodyKind.FREE)
        self.pfb = side(meta_b, BodyKind.FREE)
        _, _, _, cmu, _, ck, *_ = _trace_metadata(model)
        params = model.params
        h = params.dt / params.substeps
        self.cmu = np.asarray(cmu, np.float32)
        # impulse gain d_n0 = k h / β, in float32 as the engine computes it
        self.dn0 = (np.asarray(ck, np.float32) * np.float32(h)
                    / np.float32(params.contact_beta)).astype(np.float32)

    def tables(self):
        """(mf float32, mi int32): the static model tables and the header
        that locates them (layout from the kernel's ``enum Header``)."""
        model = self.model
        spec = model.robot
        params = model.params
        from ..kinematics.chain import fk_tables

        Aq, Bq = fk_tables(spec)
        prm = dict(P_H=params.dt / params.substeps, P_BETA=params.contact_beta,
                   P_MARGIN=params.contact_margin,
                   P_BIAS_MAX=params.contact_bias_max,
                   P_RELAX=params.contact_relax, P_VREG=params.friction_vreg,
                   P_LIM_K=params.joint_limit_stiffness,
                   P_LIM_D=params.joint_limit_damping,
                   P_FVREG=params.joint_friction_vreg,
                   P_MAX_W=params.max_ang_vel, P_MAX_V=params.max_lin_vel)
        ftabs = dict(
            F_PARAMS=[prm[n] for n in _enum("Param") if n != "P_COUNT"],
            F_GRAVITY=params.gravity, F_BASE=model.robot_base_pose,
            F_JPOS=spec.joint_pos, F_AQ=Aq, F_BQ=Bq, F_JAXIS=spec.axis,
            F_MASS=spec.mass, F_COM=spec.com, F_ICOM=model.robot_inertia_com,
            F_JDAMP=spec.joint_damping, F_JFRIC=spec.joint_friction,
            F_QLIM=model.robot_qlim, F_GMASK=model.gravity_mask,
            F_STATIC=model.static_pose, F_CMU=self.cmu, F_DN0=self.dn0)
        itabs = dict(
            I_PARENT=spec.parent, I_JTYPE=spec.joint_type,
            I_ANC=model.ancestor_mask,
            I_GKIND=[int(g.kind) for g in model.geoms],
            I_GBODY=[int(g.body) for g in model.geoms],
            I_PFN=self.pfn, I_PGA=self.pga, I_PGB=self.pgb,
            I_PCORNER=self.pcorner, I_PRA=self.pra, I_PRB=self.prb,
            I_PFA=self.pfa, I_PFB=self.pfb)
        names = [n for n in _enum("Header") if n != "H_COUNT"]
        head = dict(H_NQ=self.nq, H_F=self.F, H_NK=self.nk, H_G=self.G, H_P=self.P)
        fparts, ioff = [], len(names)
        foff = 0
        for n, a in ftabs.items():
            a = np.asarray(a, np.float32).ravel()
            head[n] = foff
            fparts.append(a)
            foff += a.size
        iparts = []
        for n, a in itabs.items():
            a = np.asarray(a).astype(np.int32).ravel()
            head[n] = ioff
            iparts.append(a)
            ioff += a.size
        for n in names:
            if n.startswith(("R_", "S_")):
                sl = getattr(self, ("i_" if n[0] == "R" else "o_") + _ROW_NAMES[n[2:]])
                head[n] = sl[0]
        missing = [n for n in names if n not in head]
        if missing:
            raise KeyError(f"kernel header fields without a value: {missing}")
        mi = np.concatenate([np.asarray([head[n] for n in names], np.int32)] + iparts)
        return np.concatenate(fparts).astype(np.float32), mi


# Float operations of the physics step's function, per item of one
# substep: each add, multiply, divide, square root, comparison and
# transcendental counts one. They count what the step must compute, not how
# the kernel computes it (the kernel redoes the narrowphase in its second
# contact pass and builds Jacobian columns for every point; neither is
# counted). Derivation: PERF.md, "The bound of K2".
OPS = dict(
    fk_revolute=106,    # joint origin (quat_apply + add), cos/sin of q/2, m = c·A + s·B, quat_mul, axis
    fk_prismatic=97,    # joint origin, quat_mul, axis, origin + axis·q
    dof_motion=36,      # Plücker column at ref, body velocity before and after the solve
    geom_pose=61,       # quat_apply + add, quat_mul
    plane_box=52,       # box corner in the world, depth against the plane, normal
    box_box_onesided=140,  # corner in the world, into B's frame, box SDF and normal, back out
    box_box_corners=142,   # the same; half the points negate the normal
    box_box=142,        # the same: a face centre costs what a corner does
    point_inactive=1,   # the margin test: no force, and the warm start resets to 0
    point_active=134,   # context 22, force law 2×30, gate and gains 31, warm-start update 21
    vel_robot_side=12,  # v + ω × r of the side's robot body, per contact pass
    vel_free_side=18,   # v + ω × (p - c) of the side's free body, per contact pass
    vel_point=14,       # relative velocity, its normal and tangential parts, per pass
    jac_robot_dof=15,   # contact-Jacobian column (v + ω × r) with its sign
    jac_free_body=9,    # the six columns of a free body ([r]×, I)
    jac_dof=21,         # Jᵀn, the two right-hand sides Jᵀf, scaled columns
    jac_pair=8,         # one entry of h·Jᵀ(d_t I + (d_n - d_t) n nᵀ)J
    mass_body=132,      # CoM in the world, world inertia R I Rᵀ
    mass_dof=27,        # per (body, ancestor dof): CoM velocity column, I·ω column
    mass_pair=13,       # per (body, ancestor dof pair): m u·u + ω·Iω into M
    bias_body=204,      # velocity-product accelerations, I a + v ×* I v - gravity, subtree sums
    drive_dof=52,       # PD drive, joint limits, joint friction, diagonal terms
    free_body=275,      # world inertia, gyroscopic and gravity terms, clamped integration
    integrate_dof=4,    # q += h (q̇ + Δq̇_pos), q̇ += Δq̇
)


def _cholesky_ops(n: int) -> int:
    """Operations of the factor (max(s, 1e-12) and the reciprocal root per
    column) and of the forward and back solves of two right-hand sides."""
    factor = sum(2 * j + 3 + (n - 1 - j) * (2 * j + 1) for j in range(n))
    solves = sum(4 * i + 4 for i in range(n)) + sum(4 * (n - 1 - i) + 2 for i in range(n))
    return factor + solves


def work(plan: _Plan, state: SimState, cmd: DriveCmd, n_substeps: int):
    """``(bytes, operations, counts)`` of one launch on these inputs.

    Bytes: each plane read or written once, plus the static tables.
    Operations: ``OPS`` summed over what this run's data needs. The fixed
    terms (FK, geom poses, mass matrix, bias, drives, free bodies, Cholesky
    pair solve) and every point's narrowphase count once per substep; the
    contact context, velocities, force law and warm-start update count only
    at active points (depth within the margin); the contact-Jacobian
    columns and LHS updates only at points that load the solve (a positive
    normal force or a stored load). Which points those are is read from the
    plain step run substep by substep on the same inputs."""
    mf, mi = plan.tables()
    K = state.qpos.shape[0]
    nbytes = 4 * (plan.R_in + plan.R_out) * K + mf.nbytes + mi.nbytes
    model = plan.model
    spec, anc = model.robot, model.ancestor_mask
    n_anc = anc.sum(1)
    fixed = (sum(OPS["fk_revolute"] if t == 0 else OPS["fk_prismatic"]
                 for t in spec.joint_type)
             + plan.nq * (OPS["dof_motion"] + OPS["drive_dof"] + OPS["integrate_dof"])
             + plan.G * OPS["geom_pose"]
             + plan.nq * (OPS["mass_body"] + OPS["bias_body"])
             + int(n_anc.sum()) * OPS["mass_dof"]
             + int((n_anc * (n_anc + 1) // 2).sum()) * OPS["mass_pair"]
             + plan.F * OPS["free_body"] + _cholesky_ops(plan.n_all))
    narrow = sum(OPS[fn] for fn in np.asarray(_FNS)[plan.pfn])
    # per active point: both contact passes' velocities of its two sides
    vel = (OPS["vel_robot_side"] * ((plan.pra >= 0).astype(int) + (plan.prb >= 0))
           + OPS["vel_free_side"] * ((plan.pfa >= 0).astype(int) + (plan.pfb >= 0)))
    per_active = OPS["point_active"] + 2 * (vel + OPS["vel_point"])
    # per loading point: its Jacobian columns and LHS entries
    a_robot = np.asarray([np.count_nonzero((anc[ra] if ra >= 0 else 0)
                                           - (anc[rb] if rb >= 0 else 0))
                          for ra, rb in zip(plan.pra, plan.prb)])
    free = (plan.pfa >= 0).astype(int) + (plan.pfb >= 0)  # free bodies moving the point
    a = a_robot + 6 * free
    per_loaded = (OPS["jac_robot_dof"] * a_robot + OPS["jac_free_body"] * free
                  + OPS["jac_dof"] * a + OPS["jac_pair"] * (a * (a + 1) // 2))
    dev = state.qpos.device
    per_active_t = torch.as_tensor(per_active, device=dev, dtype=torch.float64)
    per_loaded_t = torch.as_tensor(per_loaded, device=dev, dtype=torch.float64)
    margin = model.params.contact_margin
    substep = make_step_fn(model).substep
    tables = _assignment_tables(model)
    ops, n_active, n_loaded = 0, 0, 0
    for _ in range(n_substeps):
        body_pos, body_quat, axis_w = robot_fk(model, state.qpos)
        ref = torch.as_tensor(model.robot_base_pose[:3], device=dev)
        cols = joint_columns(model, body_pos, axis_w, ref)
        _, f_pos, _, (_, _, cdep, d_n, _) = point_forces(
            model, state, body_pos, body_quat, _v_body(model, cols, state.qvel), tables)
        active = cdep > -margin
        loaded = active & ((d_n > 0) | (f_pos.abs().sum(-1) > 0))
        n_active += int(active.sum())
        n_loaded += int(loaded.sum())
        ops += (K * (fixed + narrow + OPS["point_inactive"] * plan.P)
                + int(torch.round((active * per_active_t).sum()))
                + int(torch.round((loaded * per_loaded_t).sum())))
        state, _ = substep(state, cmd)
    counts = dict(points=plan.P * K * n_substeps, active=n_active, loaded=n_loaded)
    return nbytes, ops, counts


# header row names -> _Plan slice names
_ROW_NAMES = dict(
    QPOS="qpos", QVEL="qvel", FPOSE="free_pose", FVEL="free_vel", KIN="kin",
    GSIZE="gsize", GPOS="gpos", GQUAT="gquat", FMASS="fmass",
    FINERTIA="finertia", LAM="lam", LAMT="lamt", TQ="tq", TV="tv", QF="qf",
    KP="kp", KD="kd", FLIM="flim", FPT="fpt", BPOS="bpos", BQUAT="bquat",
    AXIS="axis")


def pack(plan: _Plan, state: SimState, cmd: DriveCmd) -> torch.Tensor:
    """Batched (K-leading) state and command -> (R_in, K) float32 plane."""
    K = state.qpos.shape[0]
    model = plan.model

    def gains(x, arr):
        return x if x is not None else torch.as_tensor(
            arr, device=state.qpos.device).expand(K, -1)

    iu = ([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2])
    parts = [
        state.qpos, state.qvel,
        state.free_pose.reshape(K, -1), state.free_vel.reshape(K, -1),
        state.kin_pose.reshape(K, -1), state.geom_size.reshape(K, -1),
        state.geom_pos.reshape(K, -1), state.geom_quat.reshape(K, -1),
        state.free_mass.reshape(K, -1),
        state.free_inertia[..., iu[0], iu[1]].reshape(K, -1),
        state.contact_lam,
        state.contact_lam_t.transpose(1, 2).reshape(K, -1),
        cmd.target_qpos, cmd.target_qvel, cmd.qf,
        gains(cmd.kp, model.drive_kp), gains(cmd.kd, model.drive_kd),
        gains(cmd.force_limit, model.drive_force_limit),
    ]
    flat = torch.cat([p.to(torch.float32) for p in parts], dim=1)
    return flat.t().contiguous()


def unpack(plan: _Plan, out: torch.Tensor, state: SimState):
    """(R_out, K) plane -> (new SimState, aux dict)."""
    flat = out.t()
    K = flat.shape[0]
    F, P, nb = plan.F, plan.P, plan.nb

    def rows(sl):
        return flat[:, sl[0]:sl[1]]

    new_state = state.replace(
        qpos=rows(plan.o_qpos).contiguous(),
        qvel=rows(plan.o_qvel).contiguous(),
        free_pose=rows(plan.o_free_pose).reshape(K, F, 7),
        free_vel=rows(plan.o_free_vel).reshape(K, F, 6),
        contact_lam=rows(plan.o_lam).contiguous(),
        contact_lam_t=rows(plan.o_lamt).reshape(K, 3, P).transpose(1, 2),
    )
    aux = dict(
        f_pt=rows(plan.o_fpt).reshape(K, 3, P).transpose(1, 2),
        body_pos=rows(plan.o_bpos).reshape(K, 3, nb).transpose(1, 2),
        body_quat=rows(plan.o_bquat).reshape(K, 4, nb).transpose(1, 2),
        axis_w=rows(plan.o_axis).reshape(K, 3, nb).transpose(1, 2),
    )
    return new_state, aux


def load_library(path=None):
    """The kernel's library: this package's build, or the one at ``path``."""
    lib = ctypes.CDLL(str(path)) if path is not None else _cuda.load("megakernel")
    lib.mk_step.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mk_step.restype = ctypes.c_int
    lib.mk_error_string.argtypes = [ctypes.c_int]
    lib.mk_error_string.restype = ctypes.c_char_p
    return lib


# the SimState fields one step changes: KernelStep's outputs
STEP_FIELDS = ("qpos", "qvel", "free_pose", "free_vel", "contact_lam", "contact_lam_t")
_SIM_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))
_CMD_FIELDS = tuple(f.name for f in dataclasses.fields(DriveCmd))


def _split(flat):
    """The flat argument list of KernelStep -> (SimState, DriveCmd)."""
    n = len(_SIM_FIELDS)
    return (SimState(**dict(zip(_SIM_FIELDS, flat[:n]))),
            DriveCmd(**dict(zip(_CMD_FIELDS, flat[n:]))))


class KernelStep(torch.autograd.Function):
    """One physics step with the kernel as its primal and the plain step as
    its derivative (the JAX ``custom_jvp`` seam). Arguments: the
    ``MegaKernel``, the number of sim steps, then the ``SimState`` and
    ``DriveCmd`` fields in declaration order (``None`` for a gain the
    command leaves to the model); outputs: the ``STEP_FIELDS`` of the new
    state. ``jvp`` and ``backward`` rerun the plain step on the saved
    inputs, so a tangent or a gradient never goes through the kernel, and
    the primal and the derivative of one call come from two
    implementations that agree to float32 rounding, as in JAX.

    ``jvp`` uses ``torch.func.jvp``: forward mode through this step works
    under ``torch.func.jvp`` (which nests), not under
    ``torch.autograd.forward_ad``."""

    @staticmethod
    def forward(kernel, sim_steps, *flat):
        state, cmd = _split(flat)
        new, _ = kernel(state, cmd, sim_steps)
        return tuple(getattr(new, n) for n in STEP_FIELDS)

    @staticmethod
    def setup_context(ctx, inputs, output):
        kernel, sim_steps, *flat = inputs
        ctx.kernel, ctx.sim_steps = kernel, sim_steps
        ctx.present = [t is not None for t in flat]
        saved = [t for t in flat if t is not None]
        ctx.save_for_backward(*saved)
        ctx.save_for_forward(*saved)

    @staticmethod
    def _plain(ctx):
        """The plain step as a function of the present (non-None) inputs."""
        def fn(*present):
            it = iter(present)
            state, cmd = _split([next(it) if p else None for p in ctx.present])
            new, _ = ctx.kernel.plain(state, cmd, ctx.sim_steps)
            return tuple(getattr(new, n) for n in STEP_FIELDS)
        return fn

    @staticmethod
    def jvp(ctx, _kernel, _sim_steps, *tangents):
        saved = ctx.saved_tensors
        tans = [t for t, p in zip(tangents, ctx.present) if p]
        tans = tuple(torch.zeros_like(x) if t is None else t for x, t in zip(saved, tans))
        _, out = torch.func.jvp(KernelStep._plain(ctx), tuple(saved), tans)
        return out

    @staticmethod
    def backward(ctx, *grads):
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            out = KernelStep._plain(ctx)(*inputs)
            got = iter(torch.autograd.grad(out, inputs, grads, allow_unused=True))
        return (None, None, *[next(got) if p else None for p in ctx.present])


class MegaKernel:
    """The physics step of one model through the CUDA kernel.

    ``kernel(state, cmd, sim_steps) -> (state', aux)`` advances
    ``sim_steps`` sim steps (``params.substeps`` substeps each) in ONE
    launch for CUDA tensors, and runs the plain PyTorch step for CPU
    tensors. ``launches`` counts kernel launches."""

    def __init__(self, model: SceneModel):
        if not supports(model):
            raise NotImplementedError("the CUDA mega-kernel does not support this model")
        self.model = model
        self.plan = _Plan(model)
        self.launches = 0
        self._plain_step = None
        self._lib = None
        self._host_tables = None

    def __call__(self, state: SimState, cmd: DriveCmd, sim_steps: int):
        dev = state.qpos.device
        if dev.type == "cpu":
            return self.plain(state, cmd, sim_steps)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        plane = pack(self.plan, state, cmd)
        out = self.launch(plane, sim_steps * self.model.params.substeps)
        return unpack(self.plan, out, state)

    def step(self, state: SimState, cmd: DriveCmd, sim_steps: int) -> SimState:
        """The differentiable step the env dispatches to: ``KernelStep`` for
        CUDA tensors, the plain step itself for CPU tensors."""
        if state.qpos.device.type == "cpu":
            return self.plain(state, cmd, sim_steps)[0]
        flat = [getattr(state, n) for n in _SIM_FIELDS] + [getattr(cmd, n) for n in _CMD_FIELDS]
        out = KernelStep.apply(self, sim_steps, *flat)
        return state.replace(**dict(zip(STEP_FIELDS, out)))

    def plain(self, state: SimState, cmd: DriveCmd, sim_steps: int):
        """The kernel's plain PyTorch version (the engine step)."""
        if self._plain_step is None:
            self._plain_step = make_step_fn(self.model)
        return self._plain_step(state, cmd, sim_steps, return_aux=True)

    def launch(self, plane: torch.Tensor, n_substeps: int) -> torch.Tensor:
        """Run the kernel on an (R_in, K) plane; returns the (R_out, K) plane."""
        plan = self.plan
        if plane.device.type != "cuda":
            raise ValueError(f"the kernel needs a CUDA tensor, got {plane.device}")
        if plane.dtype != torch.float32 or plane.dim() != 2 or plane.shape[0] != plan.R_in:
            raise ValueError(f"expected a float32 ({plan.R_in}, K) plane, got "
                             f"{plane.dtype} {tuple(plane.shape)}")
        if not plane.is_contiguous():
            raise ValueError("the input plane must be contiguous")
        K = plane.shape[1]
        if n_substeps < 1 or K < 1:
            raise ValueError(f"need n_substeps >= 1 and K >= 1, got {n_substeps}, {K}")
        if self._lib is None:
            self._lib = load_library()
            self._host_tables = plan.tables()
        mf, mi = self._host_tables
        mf_t = const(self, "mf", mf, plane.device, torch.float32)
        mi_t = const(self, "mi", mi, plane.device, torch.int32)
        out = torch.empty((plan.R_out, K), dtype=torch.float32, device=plane.device)
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        err = self._lib.mk_step(plane.data_ptr(), out.data_ptr(), mf_t.data_ptr(),
                                mi_t.data_ptr(), K, n_substeps, BLOCK, stream)
        if err != 0:
            raise RuntimeError("mega-kernel launch failed: "
                               + self._lib.mk_error_string(err).decode())
        self.launches += 1
        return out
