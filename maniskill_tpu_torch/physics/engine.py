"""Batched articulated rigid-body dynamics engine (plain PyTorch).

Port of ``maniskill_tpu/physics/engine.py``: ``robot_fk``,
``joint_columns`` (with ``body_velocities``, the JAX force query's
``J q̇``), ``all_geom_poses``, ``compute_contacts``,
``_assignment_tables`` (``:291``), ``point_forces`` (``:304``),
``make_force_query`` (``:494``), ``pair_force_signs``, ``make_step_fn`` and
its ``substep`` (``:537-1125``) and ``_trace_metadata`` (``:1127``). The
robot may be a kinematic forest (the robot's tree and articulated objects'
trees, ``model.add_articulation``): FK, the prefix and suffix sums and the
ancestor masks start every root from the base pose, gravity is per body
(``gravity_mask``), joint limits, damping and friction act on every dof,
passive ones included, and a point with a robot link on each side takes
both sides' columns (``sm``). Robot-only scenes (no free body) have no
free-body blocks. A contact-free scene (P=0: Cartpole's, which has no
geoms at all) takes empty contact terms, as the JAX ``point_forces`` returns
them (``:349-352``): its step is the tree dynamics, drives, limits and the
solve. Not ported yet: actor-pair drives (``:919-1041``), the legacy spring
contact mode, and scenes without a robot.

Clamps and maxima on the differentiated path go through ``math.clamps``,
which gives JAX's derivative at a tie (0.5/0.5), so the step's tangents
equal the JAX step's also where a state sits exactly on a bound (a body
resting at zero depth, a gripper joint at its limit).

The JAX functions are single-env and vmapped; here every function takes the
batch dimension K leading. This step is the plain version of the CUDA
mega-kernel (``megakernel.py``): the kernel is held against it on the card,
and it is what runs for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .._consts import const
from ..math import clamps
from ..kinematics import chain
from ..kinematics.urdf import JOINT_REVOLUTE
from ..math.rotations import (_cross, quat_apply, quat_exp, quat_mul,
                              quat_normalize, quat_to_matrix)
from .linalg import solve_psd_pair
from .model import BodyKind, DriveCmd, SceneModel, SimState
from .spatial import force_cross, motion_cross, point_force_to_wrench


def robot_fk(model: SceneModel, qpos: torch.Tensor):
    """FK of the robot tree for a batch of ``qpos (K, nq)``."""
    base = const(model, "robot_base_pose", model.robot_base_pose, qpos.device)
    return chain.fk(model.robot, base, qpos)


def joint_columns(model: SceneModel, body_pos, axis_w, ref) -> torch.Tensor:
    """Per-dof Plücker motion columns s_j (K, nq, 6)."""
    anchors = body_pos - ref
    lin_rev = _cross(anchors, axis_w)
    is_rev = const(model, "is_rev",
                   (model.robot.joint_type == JOINT_REVOLUTE)[:, None],
                   body_pos.device)
    ang = is_rev * axis_w
    lin = is_rev * lin_rev + (1.0 - is_rev) * axis_w
    return torch.cat([ang, lin], dim=-1)


def body_velocities(model: SceneModel, body_pos, axis_w, qvel) -> torch.Tensor:
    """(K, nb, 6) spatial velocities [ω; v at the base origin] of every
    body: v_body = J q̇ with J[b] = anc[b] ∘ colsᵀ (the JAX force query's
    and ``_link_velocities``' form)."""
    dev = qvel.device
    ref = const(model, "robot_base_pose", model.robot_base_pose, dev)[:3]
    cols = joint_columns(model, body_pos, axis_w, ref)
    anc = const(model, "ancestor_mask", model.ancestor_mask, dev)
    return torch.einsum("bk,Kkc,Kk->Kbc", anc, cols, qvel)


def all_geom_poses(model: SceneModel, state: SimState, body_pos, body_quat):
    """World poses of every geom, (K, G, 3) and (K, G, 4)."""
    dev = state.qpos.device
    K = state.qpos.shape[0]
    if not model.geoms:
        return state.qpos.new_zeros(K, 0, 3), state.qpos.new_zeros(K, 0, 4)
    parts_p, parts_q = [], []
    for i, g in enumerate(model.geoms):
        if g.kind == BodyKind.ROBOT_LINK and g.body >= 0:
            pp, pq = body_pos[:, g.body], body_quat[:, g.body]
        elif g.kind == BodyKind.ROBOT_LINK:
            base = const(model, "robot_base_pose", model.robot_base_pose, dev)
            pp, pq = base[:3].expand(K, 3), base[3:7].expand(K, 4)
        elif g.kind == BodyKind.FREE:
            pp = state.free_pose[:, g.body, :3]
            pq = state.free_pose[:, g.body, 3:7]
        elif g.kind == BodyKind.KINEMATIC:
            pp = state.kin_pose[:, g.body, :3]
            pq = state.kin_pose[:, g.body, 3:7]
        else:
            sp = const(model, "static_pose", model.static_pose, dev)[g.body]
            pp, pq = sp[:3].expand(K, 3), sp[3:7].expand(K, 4)
        parts_p.append(pp + quat_apply(pq, state.geom_pos[:, i]))
        parts_q.append(quat_mul(pq, state.geom_quat[:, i]))
    return torch.stack(parts_p, dim=1), torch.stack(parts_q, dim=1)


def _dyn_mass_of(model, g) -> float:
    if g.kind == BodyKind.FREE:
        return float(model.free_mass[g.body])
    if g.kind == BodyKind.ROBOT_LINK:
        return float(model.robot.mass[g.body]) if g.body >= 0 else np.inf
    return np.inf


def _point_tables(model: SceneModel):
    """Static per-point coefficients and (kind, body) side tables."""
    cache = model.__dict__.get("_point_tables")
    if cache is not None:
        return cache
    params = model.params
    k = params.contact_stiffness
    mu_l, c_l, k_l, m_l, meta_a, meta_b = [], [], [], [], [], []
    for (fn, npts, ia_arr, ib_arr, mu_arr) in model.pair_groups:
        for j in range(len(ia_arr)):
            ga, gb = model.geoms[ia_arr[j]], model.geoms[ib_arr[j]]
            m_eff = min(_dyn_mass_of(model, ga), _dyn_mass_of(model, gb))
            if not np.isfinite(m_eff):
                m_eff = 1.0
            m_pt = m_eff / npts
            g_norm = float(np.linalg.norm(params.gravity))
            k_eff = max(k, m_eff * g_norm / params.contact_ref_penetration)
            k_pt = k_eff / npts
            damping = 2.0 * params.contact_damping_ratio * np.sqrt(k_pt * m_pt)
            mu_l += [mu_arr[j]] * npts
            c_l += [damping] * npts
            k_l += [k_pt] * npts
            m_l += [m_pt] * npts
            meta_a += [(ga.kind, ga.body)] * npts
            meta_b += [(gb.kind, gb.body)] * npts
    cache = tuple(np.asarray(x, np.float32) for x in (mu_l, c_l, k_l, m_l)) + (
        meta_a, meta_b)
    model._point_tables = cache
    return cache


def compute_contacts(model: SceneModel, state: SimState, body_pos, body_quat):
    """Evaluate every static candidate pair, grouped by contact function.

    Returns pos (K,P,3), normal (K,P,3) [B→A], depth (K,P), mu (P,),
    damping (P,), k (P,), m (P,), and the static per-point (kind, body)
    tables of both sides."""
    dev = state.qpos.device
    gpos, gquat = all_geom_poses(model, state, body_pos, body_quat)
    gsize = state.geom_size
    pos_l, nrm_l, dep_l = [], [], []
    for (fn, npts, ia_arr, ib_arr, _mu) in model.pair_groups:
        ia = const(model, f"ia:{fn.__name__}", ia_arr, dev, torch.long)
        ib = const(model, f"ib:{fn.__name__}", ib_arr, dev, torch.long)
        args = [gpos[:, ia], gquat[:, ia], gsize[:, ia], gpos[:, ib], gquat[:, ib], gsize[:, ib]]
        hargs = getattr(fn, "hull_args", None)
        if hargs is not None:
            # hull pairs also take each hull side's per-env contact cloud and
            # face planes, A's before B's: static slot gathers
            # (engine.py:216-229)
            for side, g_arr in (("a", ia_arr), ("b", ib_arr)):
                if side in hargs:
                    h = const(model, f"h{side}:{fn.__name__}", model.geom_hull_slot[g_arr],
                              dev, torch.long)
                    args += [state.hull_verts[:, h], state.hull_faces[:, h]]
        c = fn(*args)  # (K, n_pairs, npts, ...)
        K = c.pos.shape[0]
        pos_l.append(c.pos.reshape(K, -1, 3))
        nrm_l.append(c.normal.reshape(K, -1, 3))
        dep_l.append(c.depth.reshape(K, -1))
    mu, damp, kk, mm, meta_a, meta_b = _point_tables(model)
    if not pos_l:  # a contact-free scene
        K = state.qpos.shape[0]
        pos_l, nrm_l, dep_l = ([state.qpos.new_zeros(K, 0, 3)], [state.qpos.new_zeros(K, 0, 3)],
                               [state.qpos.new_zeros(K, 0)])
    return (
        torch.cat(pos_l, dim=1), torch.cat(nrm_l, dim=1), torch.cat(dep_l, dim=1),
        const(model, "cmu", mu, dev), const(model, "cdamp", damp, dev),
        const(model, "ck", kk, dev), const(model, "cm", mm, dev),
        meta_a, meta_b,
    )


def _point_assignment(meta, kind: BodyKind, n_bodies: int) -> np.ndarray:
    """Static one-hot (n_bodies, P) point→body assignment for one kind."""
    A = np.zeros((n_bodies, len(meta)), dtype=np.float32)
    for p, (kd, b) in enumerate(meta):
        if kd == kind and b >= 0:
            A[b, p] = 1.0
    return A


def _assignment_tables(model: SceneModel):
    """Static one-hot point→body assignment matrices for both pair sides."""
    *_, meta_a, meta_b = _trace_metadata(model)
    nq, n_free = model.nq, model.n_free
    return (
        _point_assignment(meta_a, BodyKind.ROBOT_LINK, max(nq, 1)),
        _point_assignment(meta_b, BodyKind.ROBOT_LINK, max(nq, 1)),
        _point_assignment(meta_a, BodyKind.FREE, max(n_free, 1)),
        _point_assignment(meta_b, BodyKind.FREE, max(n_free, 1)),
    )


def point_forces(model: SceneModel, state: SimState, body_pos, body_quat,
                 v_body, tables):
    """Velocity-level contact forces at every candidate point (force on
    side A, world frame), warm-started from ``state.contact_lam``.

    Returns ``(f_vel (K,P,3), f_pos (K,P,3), relam, (cpos, cnrm, cdep, d_n,
    d_t))``; ``relam(v_body_new, free_vel_new)`` gives the impulses the
    implicit solve delivered (see the JAX ``point_forces`` docstring)."""
    params = model.params
    if params.contact_mode != "velocity":
        raise NotImplementedError("only the velocity contact mode is ported")
    dev = state.qpos.device
    h = params.dt / params.substeps
    A_ra, A_rb, A_fa, A_fb = (const(model, f"assign{i}", t, dev)
                              for i, t in enumerate(tables))
    nq, n_free = model.nq, model.n_free
    ref = const(model, "robot_base_pose", model.robot_base_pose, dev)[:3]
    (cpos, cnrm, cdep, cmu, _cdamp, ck, _cm, _, _) = compute_contacts(
        model, state, body_pos, body_quat)
    if model.n_points == 0:  # no contact terms (the JAX :349-352)
        lam, lam_t = state.contact_lam, state.contact_lam_t
        return cpos, cpos, (lambda vb, fv: (lam, lam_t)), (cpos, cnrm, cdep, cdep, cdep)
    rel_a = cpos - ref

    def side_point_vel(A_robot, A_free, vbody, fvel):
        v = torch.zeros_like(cpos)
        if nq > 0:
            vb = A_robot.T @ vbody  # (K, P, 6)
            v = vb[..., 3:] + _cross(vb[..., :3], rel_a)
        if n_free > 0:
            fv = A_free.T @ fvel  # (K, P, 6) [lin, ang]
            fp = A_free.T @ state.free_pose[..., :3]
            v = v + (fv[..., :3] + _cross(fv[..., 3:], cpos - fp))
        return v

    def point_vels(vbody, fvel):
        v_rel = (side_point_vel(A_ra, A_fa, vbody, fvel)
                 - side_point_vel(A_rb, A_fb, vbody, fvel))
        v_n = torch.sum(v_rel * cnrm, dim=-1)
        return v_n, v_rel - v_n[..., None] * cnrm

    v_n, v_t = point_vels(v_body, state.free_vel)
    active = (cdep > -params.contact_margin).to(cdep.dtype)
    d_n0 = ck * h / params.contact_beta
    pen_bias = clamps.minimum(
        params.contact_beta * clamps.maximum(cdep, 0.0) / h,
        params.contact_bias_max)
    spec = clamps.minimum(cdep, 0.0) / h
    t_vel = spec
    t_pos = spec + pen_bias
    lam = state.contact_lam
    lam_t = state.contact_lam_t
    lam_t = lam_t - torch.sum(lam_t * cnrm, dim=-1, keepdim=True) * cnrm

    def forces_at(v_n_, v_t_):
        f_n_vel_ = clamps.maximum(lam + d_n0 * (t_vel - v_n_), 0.0) * active
        f_n_pos_ = clamps.maximum(lam + d_n0 * (t_pos - v_n_), 0.0) * active
        f_t_trial = lam_t - d_n0[:, None] * v_t_
        trial_norm = torch.sqrt(torch.sum(f_t_trial * f_t_trial, dim=-1) + 1e-18)
        cap = cmu * f_n_pos_
        f_t_ = f_t_trial * clamps.minimum(cap / trial_norm, 1.0)[..., None]
        return f_n_vel_, f_n_pos_, f_t_, trial_norm <= cap

    f_n_vel, f_n_pos, f_t, sticking = forces_at(v_n, v_t)
    # points with a positive force or a stored load stay in the implicit LHS
    loaded = (f_n_vel > 0) | ((lam > 0) & (active > 0))
    d_n = d_n0 * loaded
    vt_norm = torch.sqrt(torch.sum(v_t * v_t, dim=-1) + params.friction_vreg ** 2)
    d_t = torch.where(sticking, d_n0.expand_as(f_n_pos), cmu * f_n_pos / vt_norm) * loaded

    def relam(v_body_new, free_vel_new):
        v_n2, v_t2 = point_vels(v_body_new, free_vel_new)
        f_n_vel2, _, f_t2, _ = forces_at(v_n2, v_t2)
        a = params.contact_relax
        # memory only for touching points, ramped over 1 mm
        touch = clamps.clip(1.0 + cdep / 1e-3, 0.0, 1.0)
        lam2 = clamps.maximum((1 - a) * lam + a * f_n_vel2, 0.0) * touch
        lam_t2 = ((1 - a) * lam_t + a * f_t2) * touch[..., None]
        return lam2, lam_t2

    f_vel = f_n_vel[..., None] * cnrm + f_t
    f_pos = f_n_pos[..., None] * cnrm + f_t
    return f_vel, f_pos, relam, (cpos, cnrm, cdep, d_n, d_t)


def _v_body(model, cols, qvel):
    """Per-body spatial velocities: prefix sums of s_k q̇_k up the tree."""
    x = cols * qvel[..., None]
    acc = [None] * model.nq
    for b in range(model.nq):
        par = int(model.robot.parent[b])
        acc[b] = x[:, b] if par < 0 else acc[par] + x[:, b]
    return torch.stack(acc, dim=1)


def make_force_query(model: SceneModel):
    """Contact-force query ``query(state, fk=None) -> (f_pt (K,P,3), aux)``
    for evaluate-time pairwise force checks (``is_grasping``)."""
    tables = _assignment_tables(model)

    def query(state: SimState, fk=None):
        body_pos, body_quat, axis_w = fk if fk is not None else robot_fk(
            model, state.qpos)
        v_body = body_velocities(model, body_pos, axis_w, state.qvel)
        _, f_pos, _, aux = point_forces(model, state, body_pos, body_quat,
                                        v_body, tables)
        return f_pos, aux

    return query


def body_contact_mask(model: SceneModel, link_names) -> np.ndarray:
    """Static (P,) mask of the points with a geom of one of the named robot
    links (or articulated-object links of the forest) on either side: the
    point order of ``_trace_metadata`` (JAX ``envs/tasks/quadruped.py``
    ``_body_contact_mask``)."""
    idx = {model.robot.link_index[n] for n in link_names}
    *_, meta_a, meta_b = _trace_metadata(model)
    mask = np.zeros(len(meta_a), dtype=np.float32)
    for p, ((ka, ba), (kb, bb)) in enumerate(zip(meta_a, meta_b)):
        if (ka == BodyKind.ROBOT_LINK and ba in idx) or (kb == BodyKind.ROBOT_LINK and bb in idx):
            mask[p] = 1.0
    return mask


def pair_force_signs(model: SceneModel, sel_a, sel_b) -> np.ndarray:
    """Static (P,) signs: +1 where a point's pair is (sel_a, sel_b), -1 where
    it is (sel_b, sel_a), else 0. ``signs @ f_pt`` is the net contact force
    on sel_a from sel_b."""
    *_, meta_a, meta_b = _trace_metadata(model)
    signs = np.zeros(len(meta_a), dtype=np.float32)
    for p, (ma, mb) in enumerate(zip(meta_a, meta_b)):
        if ma == tuple(sel_a) and mb == tuple(sel_b):
            signs[p] = 1.0
        elif ma == tuple(sel_b) and mb == tuple(sel_a):
            signs[p] = -1.0
    return signs


def _solve_groups(model: SceneModel):
    """Static dof-index sets of the bodies that can exchange contact forces
    (union-find over the pair table; node 0 = robot, 1+j = free body j).
    Each set is one monolithic implicit solve."""
    nq, n_free = model.nq, model.n_free
    uf = list(range(1 + n_free))

    def find(i):
        while uf[i] != i:
            uf[i] = uf[uf[i]]
            i = uf[i]
        return i

    def node(g):
        if g.kind == BodyKind.ROBOT_LINK:
            return 0 if nq > 0 else None
        if g.kind == BodyKind.FREE:
            return 1 + g.body
        return None

    for (gi, gj) in model.pairs:
        na, nb = node(model.geoms[gi]), node(model.geoms[gj])
        if na is not None and nb is not None:
            ra, rb = find(na), find(nb)
            if ra != rb:
                uf[ra] = rb
    group_free = {}
    for j in range(n_free):
        group_free.setdefault(find(1 + j), []).append(j)
    robot_root = find(0) if nq > 0 else None
    roots = set(group_free) | ({robot_root} if nq > 0 else set())
    groups = []
    for r in sorted(roots):
        gc = list(range(nq)) if (nq > 0 and r == robot_root) else []
        for j in group_free.get(r, []):
            gc.extend(range(nq + 6 * j, nq + 6 * j + 6))
        groups.append(np.asarray(gc, dtype=np.int64))
    return groups


def make_step_fn(model: SceneModel):
    """Build the batched physics step ``step(state, cmd, sim_steps=1,
    return_aux=False)`` advancing ``sim_steps`` sim steps of
    ``params.substeps`` substeps each under a constant drive command.

    The step computes in float32. For a float64 reference run, pass float64
    state and command with torch's default dtype set to float64 (the model
    constants follow it)."""
    if model.robot is None:
        raise NotImplementedError("scenes without a robot are not ported")
    spec = model.robot
    params = model.params
    nq, n_free = model.nq, model.n_free
    n_all = nq + 6 * n_free
    h = params.dt / params.substeps
    tables = _assignment_tables(model)
    parent = [int(p) for p in spec.parent]
    group_cols = _solve_groups(model)
    A_ra, A_rb, A_fa, A_fb = tables
    sm_np = (model.ancestor_mask.T @ (A_ra - A_rb)).astype(np.float32)  # (nq, P)
    sgn_np = (A_fa - A_fb).astype(np.float32)  # (F, P)

    def c(name, arr, dev, dtype=None):
        return const(model, name, arr, dev, dtype)

    def suffix_sum(x):
        """Per-body (K, nb, D) -> per-dof subtree sums."""
        acc = [x[:, b] for b in range(nq)]
        for b in range(nq - 1, -1, -1):
            if parent[b] >= 0:
                acc[parent[b]] = acc[parent[b]] + acc[b]
        return torch.stack(acc, dim=1)

    def prefix_sum(x):
        acc = [None] * nq
        for b in range(nq):
            acc[b] = x[:, b] if parent[b] < 0 else acc[parent[b]] + x[:, b]
        return torch.stack(acc, dim=1)

    def substep(state: SimState, cmd: DriveCmd):
        dev = state.qpos.device
        K = state.qpos.shape[0]
        g_vec = c("gravity", np.asarray(params.gravity, np.float32), dev)
        ref = c("robot_base_pose", model.robot_base_pose, dev)[:3]
        # ---------------- robot kinematics ----------------
        body_pos, body_quat, axis_w = robot_fk(model, state.qpos)
        cols = joint_columns(model, body_pos, axis_w, ref)  # (K, nq, 6)
        v_body = prefix_sum(cols * state.qvel[..., None])

        # ---------------- contacts ----------------
        f_vel, f_pos, relam, (cpos, cnrm, cdep, d_n, d_t) = point_forces(
            model, state, body_pos, body_quat, v_body, tables)
        # contact jacobian in component-row form: (K, n_all, P) each
        rel_a = cpos - ref
        sm = c("sm", sm_np, dev)
        w_, v_ = cols[..., :3], cols[..., 3:]
        rx, ry, rz = (rel_a[..., i][:, None, :] for i in range(3))
        wx, wy, wz = (w_[..., i:i + 1] for i in range(3))
        vx, vy, vz = (v_[..., i:i + 1] for i in range(3))
        rows_x = [sm * (vx + wy * rz - wz * ry)]
        rows_y = [sm * (vy + wz * rx - wx * rz)]
        rows_z = [sm * (vz + wx * ry - wy * rx)]
        sgn = c("sgn_free", sgn_np, dev)
        zero = torch.zeros_like(cdep)
        for j in range(n_free):
            s = sgn[j]
            ax = cpos[..., 0] - state.free_pose[:, j, 0:1]
            ay = cpos[..., 1] - state.free_pose[:, j, 1:2]
            az = cpos[..., 2] - state.free_pose[:, j, 2:3]
            one = s.expand_as(zero)
            rows_x.append(torch.stack([zero, az * s, -ay * s, one, zero, zero], 1))
            rows_y.append(torch.stack([-az * s, zero, ax * s, zero, one, zero], 1))
            rows_z.append(torch.stack([ay * s, -ax * s, zero, zero, zero, one], 1))
        Cx = torch.cat(rows_x, dim=1)
        Cy = torch.cat(rows_y, dim=1)
        Cz = torch.cat(rows_z, dim=1)
        nx, ny, nz = (cnrm[..., i][:, None, :] for i in range(3))
        Gn = Cx * nx + Cy * ny + Cz * nz

        # ---------------- robot dynamics ----------------
        robot_com = c("robot_com", spec.com, dev)
        robot_mass = c("robot_mass", spec.mass, dev)
        Icom = c("robot_Icom", model.robot_inertia_com, dev)
        com_w = body_pos + quat_apply(body_quat, robot_com) - ref  # (K, nb, 3)
        Rm = quat_to_matrix(body_quat)  # (K, nb, 3, 3)
        Iw = Rm @ Icom @ Rm.transpose(-1, -2)
        am = c("ancestor_mask_T", model.ancestor_mask.T, dev)  # (nq, nb)
        cw = com_w[:, None]  # (K, 1, nb, 3)
        # masked point-velocity columns at CoMs U (K, nq, nb, 3) and angular
        # rows T; M[k,l] = Σ_b m_b U_kb·U_lb + T_kbᵀ I_w,b T_lb
        U = am[None, :, :, None] * (v_[:, :, None] + _cross(w_[:, :, None], cw))
        T = am[None, :, :, None] * w_[:, :, None].expand_as(U)
        V = torch.einsum("Kbcd,Kkbd->Kkbc", Iw, T)
        M = (torch.einsum("Kkbc,Klbc,b->Kkl", U, U, robot_mass)
             + torch.einsum("Kkbc,Klbc->Kkl", T, V))

        def I_apply(w6):
            w3, u3 = w6[..., :3], w6[..., 3:]
            z = u3 + _cross(w3, com_w)
            Iww = torch.einsum("Kbcd,Kbd->Kbc", Iw, w3)
            torque = Iww + robot_mass[:, None] * _cross(com_w, z)
            return torch.cat([torque, robot_mass[:, None] * z], dim=-1)

        sdot = motion_cross(v_body, cols)
        a_bias = prefix_sum(sdot * state.qvel[..., None])
        f_cori = I_apply(a_bias) + force_cross(v_body, I_apply(v_body))
        gmask = c("gravity_mask", model.gravity_mask, dev)[:, None]
        f_grav = point_force_to_wrench(
            com_w, (gmask * robot_mass[:, None] * g_vec).expand_as(com_w))
        tau_bias = torch.sum(cols * suffix_sum(f_cori - f_grav), dim=-1)

        kp_d = cmd.kp if cmd.kp is not None else c("drive_kp", model.drive_kp, dev)
        kd_d = cmd.kd if cmd.kd is not None else c("drive_kd", model.drive_kd, dev)
        flim_d = (cmd.force_limit if cmd.force_limit is not None
                  else c("drive_flim", model.drive_force_limit, dev))
        tau_drive = clamps.clip(
            kp_d * (cmd.target_qpos - state.qpos)
            + kd_d * (cmd.target_qvel - state.qvel), -flim_d, flim_d)
        qlim = c("robot_qlim", model.robot_qlim, dev)
        viol_low = clamps.maximum(qlim[:, 0] - state.qpos, 0.0)
        viol_high = clamps.maximum(state.qpos - qlim[:, 1], 0.0)
        in_viol = ((viol_low > 0) | (viol_high > 0)).to(state.qpos.dtype)
        tau_lim = (params.joint_limit_stiffness * (viol_low - viol_high)
                   - params.joint_limit_damping * in_viol * state.qvel)
        fr = c("joint_friction", spec.joint_friction, dev)
        fvreg = params.joint_friction_vreg
        sat = clamps.clip(state.qvel / fvreg, -1.0, 1.0)
        tau_fric = -fr * sat
        in_band = (torch.abs(state.qvel) < fvreg).to(state.qpos.dtype)
        diag = (h * (kp_d * h + kd_d)
                + h * c("joint_damping", spec.joint_damping, dev)
                + h * in_band * fr / fvreg
                + in_viol * h * (params.joint_limit_stiffness * h
                                 + params.joint_limit_damping))
        rhs_robot = tau_drive + cmd.qf + tau_lim + tau_fric - tau_bias

        # ---------------- free-body terms ----------------
        if n_free > 0:
            Rf = quat_to_matrix(state.free_pose[..., 3:7])
            I_wf = Rf @ state.free_inertia @ Rf.transpose(-1, -2)
            lin_v, ang_v = state.free_vel[..., :3], state.free_vel[..., 3:]
            u = torch.cat([ang_v, lin_v], dim=-1)  # (K, F, 6) [ω; v]
            gyro = _cross(ang_v, torch.einsum("Knij,Knj->Kni", I_wf, ang_v))
            grav = state.free_mass[..., None] * g_vec
            Wf = torch.cat([-gyro, grav], dim=-1)

        # ---------------- monolithic assembly + group solves ----------------
        h_dt = (h * d_t)[:, None, :]
        h_nn = (h * (d_n - d_t))[:, None, :]
        gf_vel = (Cx * f_vel[..., 0][:, None] + Cy * f_vel[..., 1][:, None]
                  + Cz * f_vel[..., 2][:, None]).sum(-1)
        gf_pos = (Cx * f_pos[..., 0][:, None] + Cy * f_pos[..., 1][:, None]
                  + Cz * f_pos[..., 2][:, None]).sum(-1)
        lhs = ((Cx * h_dt) @ Cx.transpose(-1, -2)
               + (Cy * h_dt) @ Cy.transpose(-1, -2)
               + (Cz * h_dt) @ Cz.transpose(-1, -2)
               + (Gn * h_nn) @ Gn.transpose(-1, -2))
        lhs[:, :nq, :nq] += M
        diag_parts = [diag + 1e-6]
        rhs_parts = [rhs_robot]
        if n_free > 0:
            diag_parts.append(torch.full((K, 6 * n_free), 1e-9, device=dev))
            rhs_parts.append(Wf.reshape(K, -1))
        lhs = lhs + torch.diag_embed(torch.cat(diag_parts, dim=-1))
        for j in range(n_free):
            o = nq + 6 * j
            lhs[:, o:o + 3, o:o + 3] += I_wf[:, j]
            lhs[:, o + 3:o + 6, o + 3:o + 6] += (
                state.free_mass[:, j, None, None] * torch.eye(3, device=dev))
        rhs_cat = torch.cat(rhs_parts, dim=-1)
        rhs_vel = gf_vel + rhs_cat
        rhs_pos = gf_pos + rhs_cat
        if len(group_cols) == 1 and len(group_cols[0]) == n_all:
            dv_vel, dv_pos = solve_psd_pair(lhs, h * rhs_vel, h * rhs_pos)
        else:
            dv_vel = torch.zeros(K, n_all, device=dev)
            dv_pos = torch.zeros(K, n_all, device=dev)
            for gc in group_cols:
                gi = c(f"group:{gc.tolist()}", gc, dev, torch.long)
                A = lhs[:, gi][:, :, gi]
                xv, xp = solve_psd_pair(A, h * rhs_vel[:, gi], h * rhs_pos[:, gi])
                dv_vel[:, gi] = xv
                dv_pos[:, gi] = xp

        # ---------------- integration ----------------
        qvel_new = state.qvel + dv_vel[:, :nq]
        # split impulse: velocities integrate the bias-free pass, positions
        # the bias-inclusive one
        qpos_new = state.qpos + h * (state.qvel + dv_pos[:, :nq])
        free_pose_new, free_vel_new = state.free_pose, state.free_vel
        if n_free > 0:
            u_new = u + dv_vel[:, nq:].reshape(K, n_free, 6)
            u_int = u + dv_pos[:, nq:].reshape(K, n_free, 6)

            def clamp_u(uu):
                wn = torch.sqrt(torch.sum(uu[..., :3] ** 2, -1, keepdim=True) + 1e-18)
                vn = torch.sqrt(torch.sum(uu[..., 3:] ** 2, -1, keepdim=True) + 1e-18)
                ws = clamps.minimum(params.max_ang_vel / wn, 1.0)
                vs = clamps.minimum(params.max_lin_vel / vn, 1.0)
                return torch.cat([uu[..., :3] * ws, uu[..., 3:] * vs], dim=-1)

            u_new = clamp_u(u_new)
            u_int = clamp_u(u_int)
            p_new = state.free_pose[..., :3] + h * u_int[..., 3:]
            q_new = quat_normalize(
                quat_mul(quat_exp(h * u_int[..., :3]), state.free_pose[..., 3:7]))
            free_pose_new = torch.cat([p_new, q_new], dim=-1)
            free_vel_new = torch.cat([u_new[..., 3:], u_new[..., :3]], dim=-1)

        # store the impulses the solve delivered (post-solve velocities)
        lam_new, lam_t_new = relam(prefix_sum(cols * qvel_new[..., None]),
                                   free_vel_new)
        new_state = state.replace(
            qpos=qpos_new, qvel=qvel_new, free_pose=free_pose_new,
            free_vel=free_vel_new, contact_lam=lam_new, contact_lam_t=lam_t_new)
        aux = dict(f_pt=f_pos, body_pos=body_pos, body_quat=body_quat,
                   axis_w=axis_w)
        return new_state, aux

    def step(state: SimState, cmd: DriveCmd, sim_steps: int = 1,
             return_aux: bool = False):
        """With ``return_aux`` also returns the last substep's contact forces
        and FK (taken before that substep's update)."""
        aux = None
        for _ in range(params.substeps * sim_steps):
            state, aux = substep(state, cmd)
        return (state, aux) if return_aux else state

    step.substep = substep  # one substep: (state, cmd) -> (state', aux)
    return step


def _trace_metadata(model: SceneModel):
    """Evaluate ``compute_contacts`` once on the initial state (CPU) to get
    the static per-point tables; cached on the model."""
    cache = model.__dict__.get("_trace_metadata")
    if cache is None:
        state = model.initial_state(1, "cpu")
        body_pos, body_quat, _ = robot_fk(model, state.qpos)
        out = compute_contacts(model, state, body_pos, body_quat)
        cache = tuple(x[0] if i < 3 else x for i, x in enumerate(out))
        model._trace_metadata = cache
    return cache
