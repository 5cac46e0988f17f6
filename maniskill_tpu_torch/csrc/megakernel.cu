// Whole-step physics mega-kernel for Hopper (sm_90a), one warp per env.
//
// Replaces the Pallas TPU kernel maniskill_tpu/physics/megakernel.py
// (_build_kernel -> kernel, launched by make_pallas_step_fn). One launch
// runs n_substeps physics substeps for every env: robot FK, geom world
// poses (a free body's geoms at their offsets), narrowphase (plane_box,
// box_box_onesided, box_box_corners, the free-free box_box, plane_hull and
// box_hull, sphere_hull, capsule_hull and hull_hull against convex hulls
// whose contact clouds and face planes are per-env rows of the input plane,
// and the eight sphere and capsule pairs: all 17 pair functions),
// warm-started velocity-level contact forces, the robot mass matrix and
// bias with implicit drives, free-body terms, the monolithic Cholesky
// pair solve (split impulse: velocity and position right-hand sides),
// integration with velocity clamps and the warm-start (lam, lam_t) update.
// It computes what maniskill_tpu_torch/physics/engine.py computes.
//
// Scene classes: a robot tree or a forest of trees (one body and dof a
// lane: up to 32, the humanoid's 27 included, whose 378 packed LHS entries
// are 12 a lane), with or without free bodies (F = 0: zero-width slices),
// and with or without contact points. A contact-free scene (P = 0, G = 0:
// Cartpole) runs every point loop zero times and reads no per-point or
// per-geom table (their offsets then sit at their tables' ends): its step
// is FK, the mass matrix, bias, drives with qf, damping, limits, the factor
// and the two solves.
//
// What bounds it on this card: latency and the number of warps in flight,
// not bytes. The state in and out is ~7 KB per env per launch (~29 MB at
// K=4096: microseconds of HBM time), and the step's function needs 3-5 x
// 10^4 float operations per env and substep (megakernel.work), most of them
// in the narrowphase, which runs point by point through short dependent
// chains (quaternion products, the 32 face planes of a hull). The TPU
// kernel's layout, one env per lane of a (8, 128) tile, carried over as one
// env per thread, gave K/32 warps: at K=4096 about one warp per SM out of
// the 64 an SM can hold, with nothing to hide a dependent instruction or a
// memory access, and every per-env array (the packed LHS, the body arrays)
// in local memory, one thread at a time.
//
// What the design does about it:
// - One warp per env, WARPS (4) envs a block. K=4096 gives 4,096 warps,
//   and the occupancy (registers, and the shared-memory slice below)
//   decides how many an SM holds; iLQR's K=1 rollouts get 32 lanes. Warps
//   past K exit whole; lanes meet only at __syncwarp, ballots and shuffles,
//   never at a block barrier.
// - Each env's state lives in shared memory, in a slice per warp sized per
//   model at launch (dynamic shared memory; make_layout): the env's input
//   row (state, per-env model data, hull tables, the warm start, which is
//   updated in place and written out once), the body arrays, the geom
//   poses, the packed LHS, both right-hand sides, dinv, a batch of loading
//   points' records and columns, and each point's contact. The input and
//   output planes are env-major, each
//   env's row padded to 4 floats, so a warp moves its row with coalesced
//   16-byte loads. The static tables (mf, mi) stay in global memory: every
//   warp reads the same addresses, which stay in L1, and PlugCharger's
//   17 KB of per-point tables staged per block would cost a resident env.
// - Points across lanes: lane l takes points l, l + 32, ... in both
//   contact passes, each point's narrowphase on one lane with the code of
//   the one-thread kernel (a pair's points are consecutive, so a warp
//   diverges over few pair functions). Pass 1 keeps each point's contact
//   (position, normal, depth) in the slice, and pass 2 reads it back
//   instead of redoing the narrowphase: the geom poses do not change
//   between the passes, and on the card this paid even where the larger
//   slice halved the resident envs (PERF.md, section 6). A
//   point beyond the contact margin carries no force and loads nothing,
//   so it skips the force law (in pass 1 except in the last substep, for
//   the bits of f_pt; in pass 2 once it is also 1 mm apart, where the
//   warm-start ramp zeroes its update).
// - Only loading points build Jacobian columns: a point whose load gate is
//   off and whose f_vel and f_pos are exactly zero adds only signed zeros,
//   which change no sum. A ballot picks the others; in point order,
//   LOAD_BATCH at a time, each writes a record to the slice, lane d builds
//   column d of every point of the batch (and owns the right-hand sides'
//   entry d), and each lane adds the batch to the packed LHS entries it
//   owns (e = lane + 32 t). No float atomics: every entry sums the loaded
//   points in point order, then the mass matrix over bodies, then the
//   drive diagonal, then the free-body blocks, each term written as the
//   one-thread kernel wrote it, so the sums are those of that kernel.
// - The tree passes (FK, velocities, the bias prefix and subtree sums) run
//   one tree level at a time, a lane per body; the mass matrix a lane per
//   entry (per-body terms a lane per body); the factor a lane per row
//   (chol_factor_warp); the two triangular solves on lanes 0 and 1 at
//   once; integration a lane per dof or free body.
// - Not used: tensor cores (the step holds float32 parity, and its
//   products are 3-vectors and rank updates of at most 32 x 32, far below a
//   wgmma tile) and asynchronous copies (a row of a few KB is read once a
//   launch; a coalesced warp load is enough).

#include <cuda_runtime.h>

#include "cholesky.cuh"

#define NB_MAX 32
#define NALL_MAX 32
#define G_MAX 32
#define F_MAX 4
// padded hull table sizes (physics/hulls.py HULL_P, HULL_F; the wrapper
// refuses a model whose tables differ)
#define HULL_P 40
#define HULL_F 32
// envs (warps) per block, and the blocks per SM that __launch_bounds__
// asks the register allocation to allow (ptxas then keeps 128 registers a
// lane). Four envs a block against one: 2-17 % faster on six of the eight
// scene and state pairs measured, 1-4 % slower on the other two (PERF.md,
// section 6)
#define WARPS 4
#define MIN_BLOCKS 4
// loading points added to the LHS together (the slice holds their columns)
#define LOAD_BATCH 8
#define FULL_MASK 0xffffffffu

// Layout of the int table `mi`: this header, then the int tables. The
// Python wrapper reads these names from this file to build the tables.
enum Header {
  H_NQ, H_F, H_NK, H_G, H_P,
  // float tables: offsets into mf
  F_PARAMS, F_GRAVITY, F_BASE, F_JPOS, F_AQ, F_BQ, F_JAXIS, F_MASS, F_COM,
  F_ICOM, F_JDAMP, F_JFRIC, F_QLIM, F_GMASK, F_STATIC, F_CMU, F_DN0,
  // int tables: offsets into mi
  I_PARENT, I_JTYPE, I_ANC, I_GKIND, I_GBODY, I_PFN, I_PGA, I_PGB,
  I_PCORNER, I_PRA, I_PRB, I_PFA, I_PFB, I_GHULL,
  // input plane rows
  R_QPOS, R_QVEL, R_FPOSE, R_FVEL, R_KIN, R_GSIZE, R_GPOS, R_GQUAT, R_FMASS,
  R_FINERTIA, R_LAM, R_LAMT, R_TQ, R_TV, R_QF, R_KP, R_KD, R_FLIM, R_HVERTS,
  R_HFACES,
  // output plane rows
  S_QPOS, S_QVEL, S_FPOSE, S_FVEL, S_LAM, S_LAMT, S_FPT, S_BPOS, S_BQUAT,
  S_AXIS,
  H_COUNT
};

enum Param {
  P_H, P_BETA, P_MARGIN, P_BIAS_MAX, P_RELAX, P_VREG, P_LIM_K, P_LIM_D,
  P_FVREG, P_MAX_W, P_MAX_V,
  P_COUNT
};

enum PairFn {
  FN_PLANE_BOX, FN_BOX_BOX_ONESIDED, FN_BOX_BOX_CORNERS, FN_BOX_BOX, FN_PLANE_HULL,
  FN_BOX_HULL, FN_PLANE_SPHERE, FN_SPHERE_BOX, FN_BOX_SPHERE, FN_SPHERE_SPHERE,
  FN_PLANE_CAPSULE, FN_SPHERE_CAPSULE, FN_CAPSULE_BOX, FN_CAPSULE_CAPSULE, FN_SPHERE_HULL,
  FN_CAPSULE_HULL, FN_HULL_HULL
};

enum Kind { KIND_STATIC, KIND_KINEMATIC, KIND_FREE, KIND_ROBOT_LINK };


struct V3 { float x, y, z; };
struct Q4 { float w, x, y, z; };

__device__ __forceinline__ V3 mk3(float x, float y, float z) { V3 r = {x, y, z}; return r; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return mk3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return mk3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scl(V3 a, float s) { return mk3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return mk3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  Q4 r;
  r.w = a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z;
  r.x = a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y;
  r.y = a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x;
  r.z = a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w;
  return r;
}

__device__ __forceinline__ Q4 qconj(Q4 q) { Q4 r = {q.w, -q.x, -q.y, -q.z}; return r; }

// v + 2 w (u x v) + 2 u x (u x v), u = q.xyz (rotations.quat_apply)
__device__ __forceinline__ V3 qapply(Q4 q, V3 v) {
  V3 u = mk3(q.x, q.y, q.z);
  V3 uv = cross(u, v);
  V3 uuv = cross(u, uv);
  return mk3(v.x + 2.0f * (q.w * uv.x + uuv.x), v.y + 2.0f * (q.w * uv.y + uuv.y),
             v.z + 2.0f * (q.w * uv.z + uuv.z));
}

__device__ __forceinline__ float sgnf(float x) { return (float)(x > 0.0f) - (float)(x < 0.0f); }

__device__ __forceinline__ V3 ld3(const float* p) { return mk3(p[0], p[1], p[2]); }
__device__ __forceinline__ Q4 ld4(const float* p) { Q4 q = {p[0], p[1], p[2], p[3]}; return q; }

// rotation matrix rows from a unit quaternion (rotations.quat_to_matrix)
__device__ __forceinline__ void quat_to_mat(Q4 q, float R[3][3]) {
  float tx = 2.0f * q.x, ty = 2.0f * q.y, tz = 2.0f * q.z;
  float twx = tx * q.w, twy = ty * q.w, twz = tz * q.w;
  float txx = tx * q.x, txy = ty * q.x, txz = tz * q.x;
  float tyy = ty * q.y, tyz = tz * q.y, tzz = tz * q.z;
  R[0][0] = 1.0f - (tyy + tzz); R[0][1] = txy - twz; R[0][2] = txz + twy;
  R[1][0] = txy + twz; R[1][1] = 1.0f - (txx + tzz); R[1][2] = tyz - twx;
  R[2][0] = txz - twy; R[2][1] = tyz + twx; R[2][2] = 1.0f - (txx + tyy);
}

// world inertia R I Rᵀ of a symmetric body-frame inertia; 6 unique entries
// [xx, xy, xz, yy, yz, zz]
__device__ __forceinline__ void rotate_inertia(Q4 q, float I[3][3], float out[6]) {
  float R[3][3], B[3][3];
  quat_to_mat(q, R);
  for (int c = 0; c < 3; ++c)
    for (int d = 0; d < 3; ++d)
      B[c][d] = R[c][0] * I[0][d] + R[c][1] * I[1][d] + R[c][2] * I[2][d];
  int o = 0;
  for (int c = 0; c < 3; ++c)
    for (int e = c; e < 3; ++e)
      out[o++] = B[c][0] * R[e][0] + B[c][1] * R[e][1] + B[c][2] * R[e][2];
}

__device__ __forceinline__ V3 sym_apply(const float I[6], V3 w) {
  return mk3(I[0] * w.x + I[1] * w.y + I[2] * w.z,
             I[1] * w.x + I[3] * w.y + I[4] * w.z,
             I[2] * w.x + I[4] * w.y + I[5] * w.z);
}

// point vs box SDF + outward local normal (shapes._point_box_sdf)
__device__ __forceinline__ void point_box_sdf(V3 pl, V3 half, float* sdf, V3* n) {
  float qx = fabsf(pl.x) - half.x, qy = fabsf(pl.y) - half.y, qz = fabsf(pl.z) - half.z;
  float ox = fmaxf(qx, 0.0f), oy = fmaxf(qy, 0.0f), oz = fmaxf(qz, 0.0f);
  float d_out = sqrtf(ox * ox + oy * oy + oz * oz + 1e-18f);
  float qmax = fmaxf(qx, fmaxf(qy, qz));
  *sdf = d_out + fminf(qmax, 0.0f);
  float sx = sgnf(pl.x), sy = sgnf(pl.y), sz = sgnf(pl.z);
  if (d_out > 1e-6f) {
    V3 no = mk3(ox * sx, oy * sy, oz * sz);
    float nn = sqrtf(dot(no, no) + 1e-18f);
    *n = mk3(no.x / nn, no.y / nn, no.z / nn);
  } else {
    // interior: axis of least penetration; ties split and re-normalized
    float hx = (float)(qx >= qmax), hy = (float)(qy >= qmax), hz = (float)(qz >= qmax);
    float hs = hx + hy + hz;
    V3 ni = mk3(hx / hs * sx, hy / hs * sy, hz / hs * sz);
    float nn = sqrtf(dot(ni, ni) + 1e-18f);
    *n = mk3(ni.x / nn, ni.y / nn, ni.z / nn);
  }
}

// box corner c (0..7) in the box frame: signs (-1,-1,-1), (-1,-1,1), ...
__device__ __forceinline__ V3 corner_local(V3 half, int c) {
  return mk3(half.x * ((c & 4) ? 1.0f : -1.0f), half.y * ((c & 2) ? 1.0f : -1.0f),
             half.z * ((c & 1) ? 1.0f : -1.0f));
}

// box face centre f (0..5) in the box frame: +x, -x, +y, -y, +z, -z
// (shapes._FACE_DIRS)
__device__ __forceinline__ V3 face_local(V3 half, int f) {
  const float s = (f & 1) ? -1.0f : 1.0f;
  const int ax = f >> 1;
  return mk3(ax == 0 ? s * half.x : 0.0f, ax == 1 ? s * half.y : 0.0f,
             ax == 2 ? s * half.z : 0.0f);
}

struct Contact { V3 pos, nrm; float dep; };

// One env's hull tables in its input row (shared memory): slot s's contact
// point p is row[R_HVERTS + 3 (s HULL_P + p) + c], its face f row[R_HFACES +
// 4 (s HULL_F + f) + c] (c: nx, ny, nz, d). The lanes of a warp that test
// points against one hull read one face at a time: a broadcast.
__device__ __forceinline__ V3 hull_point(const float* row, const int* mi, int slot, int p) {
  return ld3(row + mi[R_HVERTS] + 3 * (slot * HULL_P + p));
}

__device__ __forceinline__ const float* hull_faces(const float* row, const int* mi, int slot) {
  return row + mi[R_HFACES] + 4 * HULL_F * slot;
}

// x nx + y ny + z nz - d of face f (f[0..3]), rounded operation by
// operation (no FMA), as the plain version computes it: the max pass and
// the one-hot pass of hull_sdf then see the same value, and a tie breaks
// as it does there
__device__ __forceinline__ float face_dist(V3 p, const float* f) {
  return __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(p.x, f[0]), __fmul_rn(p.y, f[1])),
                             __fmul_rn(p.z, f[2])),
                   f[3]);
}

// point vs convex hull (shapes._hull_sdf): the largest face distance, and
// the normalised mean of the normals of every face that attains it (an
// edge point gets the two faces' mean). Padding faces sit at d = 1e6 and
// never attain it. Not inlined: it keeps the box-only scenes' registers.
__device__ __noinline__ void hull_sdf(V3 p, const float* faces, float* sdf, V3* n) {
  float best = face_dist(p, faces);
  for (int f = 1; f < HULL_F; ++f) best = fmaxf(best, face_dist(p, faces + 4 * f));
  float cnt = 0.0f;
  V3 acc = mk3(0.0f, 0.0f, 0.0f);
  for (int f = 0; f < HULL_F; ++f) {
    const float* fr = faces + 4 * f;
    if (face_dist(p, fr) >= best) {
      cnt += 1.0f;
      acc = add(acc, mk3(fr[0], fr[1], fr[2]));
    }
  }
  const V3 m = scl(acc, 1.0f / cnt);
  const float inv = 1.0f / fmaxf(sqrtf(dot(m, m)), 1e-9f);
  *sdf = best;
  *n = scl(m, inv);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// sphere and capsule pairs (shapes.plane_sphere, plane_capsule,
// sphere_sphere, sphere_box, box_sphere, sphere_capsule, capsule_box,
// capsule_capsule): geom a = (pa, qa, sa) and b = (pb, qb, sb), size x = the
// radius, y = a capsule's half length along its +z axis. The point's index
// `c` picks the sample: plane_capsule's ends c = 0, 1 at -hl, +hl; the
// sample spheres of capsule_box c = 0, 1, 2 at -hl, 0, +hl (the JAX kernel
// reads these signs from rows). Not inlined, as hull_sdf: the box scenes
// keep their registers.
__device__ __noinline__ void round_contact(int fn, int c, V3 pa, Q4 qa, V3 sa, V3 pb, Q4 qb,
                                           V3 sb, Contact* out) {
  const V3 ez = mk3(0.0f, 0.0f, 1.0f);
  Contact ct;
  if (fn == FN_PLANE_SPHERE || fn == FN_PLANE_CAPSULE) {
    // a sphere of radius sb.x (the sphere, or the capsule's end) below the plane
    const V3 n = qapply(qa, ez);
    const V3 ctr = fn == FN_PLANE_SPHERE
                       ? pb
                       : add(pb, scl(qapply(qb, ez), sb.y * (c == 0 ? -1.0f : 1.0f)));
    const float dist = dot(sub(ctr, pa), n) - sb.x;
    ct.pos = sub(ctr, scl(n, sb.x + 0.5f * dist));
    ct.nrm = scl(n, -1.0f);
    ct.dep = -dist;
  } else if (fn == FN_SPHERE_BOX || fn == FN_BOX_SPHERE || fn == FN_CAPSULE_BOX) {
    // a sphere (or a capsule's sample sphere) against the box SDF;
    // box_sphere is sphere_box with the sides swapped and the normal negated
    const bool swap = fn == FN_BOX_SPHERE;
    const V3 ps = swap ? pb : pa, ss = swap ? sb : sa;
    const V3 pbox = swap ? pa : pb, sbox = swap ? sa : sb;
    const Q4 qbox = swap ? qa : qb;
    const V3 ctr = fn == FN_CAPSULE_BOX ? add(pa, scl(qapply(qa, ez), sa.y * (float)(c - 1)))
                                        : ps;
    float sdf;
    V3 nl;
    point_box_sdf(qapply(qconj(qbox), sub(ctr, pbox)), sbox, &sdf, &nl);
    const V3 n = qapply(qbox, nl);  // outward from the box
    const float dep = ss.x - sdf;
    ct.pos = sub(ctr, scl(n, ss.x - 0.5f * dep));
    ct.nrm = swap ? scl(n, -1.0f) : n;
    ct.dep = dep;
  } else {
    // sphere_sphere, sphere_capsule, capsule_capsule: the closest points of
    // a's centre or segment and b's, then sphere against sphere
    V3 ca = pa, cb = pb;
    if (fn == FN_SPHERE_CAPSULE) {
      const V3 axis = qapply(qb, ez);
      cb = add(pb, scl(axis, clampf(dot(sub(pa, pb), axis), -sb.y, sb.y)));
    } else if (fn == FN_CAPSULE_CAPSULE) {
      const V3 ua = qapply(qa, ez), ub = qapply(qb, ez);
      const V3 d0 = sub(pa, pb);
      const float b = dot(ua, ub), cc = dot(ua, d0), f = dot(ub, d0);
      const float denom = fmaxf(1.0f - b * b, 1e-9f);
      float s = clampf((b * f - cc) / denom, -sa.y, sa.y);
      const float t = clampf(b * s + f, -sb.y, sb.y);
      s = clampf(b * t - cc, -sa.y, sa.y);
      ca = add(pa, scl(ua, s));
      cb = add(pb, scl(ub, t));
    }
    const V3 d = sub(ca, cb);
    const float dist = sqrtf(dot(d, d) + 1e-18f);
    const V3 n = mk3(d.x / dist, d.y / dist, d.z / dist);
    const float dep = sa.x + sb.x - dist;
    ct.pos = add(cb, scl(n, sb.x - 0.5f * dep));
    ct.nrm = n;
    ct.dep = dep;
  }
  *out = ct;
}

// a point against a hull's face-plane SDF (shapes.sphere_hull,
// capsule_hull, hull_hull): sphere_hull's one point is a's centre;
// capsule_hull's c = 0, 1, 2 are a's sample spheres at -hl, 0, +hl;
// hull_hull's points 0 .. HULL_P-1 are a's contact cloud against b's planes,
// HULL_P .. 2 HULL_P-1 b's cloud against a's with the normal negated. The
// point goes into the hull's frame, through hull_sdf, and its normal back
// out. A sphere's depth is its radius less the SDF, and its point sits
// on the normal midway into the overlap; a cloud point keeps its place,
// depth minus the SDF. Not inlined, as round_contact.
__device__ __noinline__ void hull_contact(int fn, int c, V3 pa, Q4 qa, V3 sa, V3 pb, Q4 qb,
                                          const float* row, const int* mi, int slot_a,
                                          int slot_b, Contact* out) {
  const bool flip = fn == FN_HULL_HULL && c >= HULL_P;
  V3 w;  // the point, in the world
  if (fn == FN_HULL_HULL)
    w = flip ? add(pb, qapply(qb, hull_point(row, mi, slot_b, c - HULL_P)))
             : add(pa, qapply(qa, hull_point(row, mi, slot_a, c)));
  else if (fn == FN_CAPSULE_HULL)
    w = add(pa, scl(qapply(qa, mk3(0.0f, 0.0f, 1.0f)), sa.y * (float)(c - 1)));
  else
    w = pa;
  const V3 ph = flip ? pa : pb;  // the hull the point is held against
  const Q4 qh = flip ? qa : qb;
  float sdf;
  V3 nl;
  hull_sdf(qapply(qconj(qh), sub(w, ph)), hull_faces(row, mi, flip ? slot_a : slot_b), &sdf,
           &nl);
  const V3 n = qapply(qh, nl);  // outward from the hull
  Contact ct;
  if (fn == FN_HULL_HULL) {
    ct.pos = w;
    ct.nrm = flip ? scl(n, -1.0f) : n;
    ct.dep = -sdf;
  } else {
    const float dep = sa.x - sdf;
    ct.pos = sub(w, scl(n, sa.x - 0.5f * dep));
    ct.nrm = n;
    ct.dep = dep;
  }
  *out = ct;
}

// candidate point `c` of one pair (shapes.plane_box / box_box_onesided /
// box_box_corners / box_box / plane_hull / box_hull); normal from B toward
// A, depth > 0 when penetrating. box_box: points 0-7 are A's corners and
// 8-13 A's face centres against B, 14-27 the same of B against A with the
// normal negated. box_hull: points 0-7 are the box's corners against the
// hull's faces, 8-47 the hull's contact cloud against the box with the
// normal negated. plane_hull: the hull's contact cloud against the plane.
// Spheres and capsules: round_contact; spheres, capsules and hulls against
// a hull: hull_contact. gp, gq: the geoms' world poses; gsz: their sizes
// (rows of the env's input row `row`).
__device__ __forceinline__ Contact contact_point(int fn, int ga, int gb, int c,
                                                 const V3* gp, const Q4* gq,
                                                 const V3* gsz, const int* ghull,
                                                 const float* row, const int* mi) {
  Contact ct;
  if (fn >= FN_SPHERE_HULL) {
    hull_contact(fn, c, gp[ga], gq[ga], gsz[ga], gp[gb], gq[gb], row, mi, ghull[ga], ghull[gb],
                 &ct);
    return ct;
  }
  if (fn >= FN_PLANE_SPHERE) {
    round_contact(fn, c, gp[ga], gq[ga], gsz[ga], gp[gb], gq[gb], gsz[gb], &ct);
    return ct;
  }
  if (fn == FN_PLANE_BOX || fn == FN_PLANE_HULL) {
    V3 n = qapply(gq[ga], mk3(0.0f, 0.0f, 1.0f));
    const V3 local = fn == FN_PLANE_BOX ? corner_local(gsz[gb], c)
                                        : hull_point(row, mi, ghull[gb], c);
    V3 w = add(gp[gb], qapply(gq[gb], local));
    ct.pos = w;
    ct.nrm = scl(n, -1.0f);
    ct.dep = -dot(sub(w, gp[ga]), n);
    return ct;
  }
  if (fn == FN_BOX_HULL) {
    const int slot = ghull[gb];
    float sdf;
    V3 nl;
    if (c < 8) {
      V3 corner = add(gp[ga], qapply(gq[ga], corner_local(gsz[ga], c)));
      V3 loc = qapply(qconj(gq[gb]), sub(corner, gp[gb]));
      hull_sdf(loc, hull_faces(row, mi, slot), &sdf, &nl);
      ct.pos = corner;
      ct.nrm = qapply(gq[gb], nl);
    } else {
      V3 w = add(gp[gb], qapply(gq[gb], hull_point(row, mi, slot, c - 8)));
      V3 loc = qapply(qconj(gq[ga]), sub(w, gp[ga]));
      point_box_sdf(loc, gsz[ga], &sdf, &nl);
      ct.pos = w;
      ct.nrm = scl(qapply(gq[ga], nl), -1.0f);
    }
    ct.dep = -sdf;
    return ct;
  }
  // a point of box a inside box b; the second half of box_box_corners and
  // of box_box swaps the sides
  bool flip;
  int cl;  // the point's index on its box: corners 0-7, face centres 8-13
  if (fn == FN_BOX_BOX) {
    flip = c >= 14;
    cl = flip ? c - 14 : c;
  } else {
    flip = (fn == FN_BOX_BOX_CORNERS) && (c >= 8);
    cl = c & 7;
  }
  const int a = flip ? gb : ga, b = flip ? ga : gb;
  const V3 local = cl < 8 ? corner_local(gsz[a], cl) : face_local(gsz[a], cl - 8);
  V3 corner = add(gp[a], qapply(gq[a], local));
  V3 loc = qapply(qconj(gq[b]), sub(corner, gp[b]));
  float sdf;
  V3 nl;
  point_box_sdf(loc, gsz[b], &sdf, &nl);
  V3 nw = qapply(gq[b], nl);
  ct.pos = corner;
  ct.nrm = flip ? scl(nw, -1.0f) : nw;
  ct.dep = -sdf;
  return ct;
}

// velocity of the contact point on one side (robot body r and/or free body
// f; fpose and fvel: 7 and 6 floats a free body)
__device__ __forceinline__ V3 side_vel(int r, int f, V3 pos, V3 rel, const V3* vbw,
                                       const V3* vbv, const float* fpose, const float* fvel) {
  V3 v = mk3(0.0f, 0.0f, 0.0f);
  if (r >= 0) v = add(vbv[r], cross(vbw[r], rel));
  if (f >= 0) {
    V3 arm = sub(pos, ld3(fpose + 7 * f));
    v = add(v, add(ld3(fvel + 6 * f), cross(ld3(fvel + 6 * f + 3), arm)));
  }
  return v;
}

// per-point contact context shared by both passes (engine.point_forces)
struct PointCtx {
  Contact ct;
  V3 rel, lt;
  float lam, active, t_vel, t_pos, dn0, mu;
};

struct Forces {
  float fn_vel, fn_pos;
  V3 ft;
  bool sticking;
};

// warm impulse + implicit correction, cone-clamped friction
__device__ __forceinline__ Forces forces_at(const PointCtx& x, float v_n, V3 v_t) {
  Forces f;
  f.fn_vel = fmaxf(x.lam + x.dn0 * (x.t_vel - v_n), 0.0f) * x.active;
  f.fn_pos = fmaxf(x.lam + x.dn0 * (x.t_pos - v_n), 0.0f) * x.active;
  V3 tr = sub(x.lt, scl(v_t, x.dn0));
  float tn = sqrtf(dot(tr, tr) + 1e-18f);
  float cap = x.mu * f.fn_pos;
  f.ft = scl(tr, fminf(1.0f, cap / tn));
  f.sticking = tn <= cap;
  return f;
}

// Offsets (in floats) of one warp's shared-memory slice: the env's input
// row first (w_in floats, 16-byte aligned), then the body arrays (nq each),
// the geom poses, the packed LHS, rv, rp, dinv, the columns of a batch of
// loading points (4 a point and dof: the column and its normal part), the
// batch's point records (position, normal, f_vel, f_pos, h d_t, h (d_n -
// d_t), the point's index and its dofs' mask), the integrated free poses
// and each point's contact (7 floats). The same on the host (the launch's
// size) and the device; physics/megakernel.py (_Plan.slice_floats) counts
// the same.
struct Layout {
  int bp, aw, cw, cv, vbw, vbv, comw, st, sf, bq, iw, jm, gp, gq, A, rv, rp, dinv, col, rec,
      fposen, cache, total;
};

__host__ __device__ __forceinline__ Layout make_layout(int nq, int F, int G, int P, int w_in) {
  const int n_all = nq + 6 * F;
  Layout L;
  int o = w_in;
  L.bp = o; o += 3 * nq;
  L.aw = o; o += 3 * nq;
  L.cw = o; o += 3 * nq;
  L.cv = o; o += 3 * nq;
  L.vbw = o; o += 3 * nq;
  L.vbv = o; o += 3 * nq;
  L.comw = o; o += 3 * nq;
  L.st = o; o += 3 * nq;
  L.sf = o; o += 3 * nq;
  L.bq = o; o += 4 * nq;
  L.iw = o; o += 6 * nq;
  L.jm = o; o += 4 * nq;
  L.gp = o; o += 3 * G;
  L.gq = o; o += 4 * G;
  L.A = o; o += TRI(n_all);
  L.rv = o; o += n_all;
  L.rp = o; o += n_all;
  L.dinv = o; o += n_all;
  L.col = o; o += LOAD_BATCH * 4 * n_all;
  L.rec = o; o += LOAD_BATCH * 16;
  L.fposen = o; o += 7 * F;
  L.cache = o; o += 7 * P;
  L.total = (o + 3) & ~3;
  return L;
}

// model sizes and plane widths of one launch (w_in, w_out: the padded rows)
struct Dims { int nq, F, G, P, w_in, w_out; };

// (32 WARPS, MIN_BLOCKS): ptxas keeps a thread within 65536 / (32 WARPS
// MIN_BLOCKS) registers, so that 16 envs fit an SM by registers; the slice
// may allow fewer (PERF.md, section 6).
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
    mk_kernel(const float* __restrict__ in, float* __restrict__ out,
              const float* __restrict__ mf, const int* __restrict__ mi, int K, int n_substeps,
              Dims dm) {
  extern __shared__ float4 mk_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * WARPS + warp;
  if (k >= K) return;  // ragged edge: the whole warp exits

  const int nq = dm.nq, F = dm.F, G = dm.G, P = dm.P;
  const int n_all = nq + 6 * F, ntri = TRI(n_all);
  const Layout L = make_layout(nq, F, G, P, dm.w_in);
  float* S = reinterpret_cast<float*>(mk_smem) + warp * L.total;
  float* row = S;  // the env's input row; state and warm start updated in place
  {
    const float4* src = reinterpret_cast<const float4*>(in + (size_t)k * dm.w_in);
    float4* dst = reinterpret_cast<float4*>(row);
    for (int i = lane; i < dm.w_in / 4; i += 32) dst[i] = src[i];
  }
  float* orow = out + (size_t)k * dm.w_out;

  const float* prm = mf + mi[F_PARAMS];
  const float h = prm[P_H], beta = prm[P_BETA], margin = prm[P_MARGIN];
  const float bias_max = prm[P_BIAS_MAX], relax = prm[P_RELAX], vreg = prm[P_VREG];
  const float lim_k = prm[P_LIM_K], lim_d = prm[P_LIM_D], fvreg = prm[P_FVREG];
  const float max_w = prm[P_MAX_W], max_v = prm[P_MAX_V];
  const V3 gvec = ld3(mf + mi[F_GRAVITY]);
  const V3 base_p = ld3(mf + mi[F_BASE]);
  const Q4 base_q = ld4(mf + mi[F_BASE] + 3);
  const V3 ref = base_p;
  const int* parent = mi + mi[I_PARENT];
  const int* jtype = mi + mi[I_JTYPE];
  const int* anc = mi + mi[I_ANC];  // anc[b * nq + j]: dof j moves body b
  const int* gkind = mi + mi[I_GKIND];
  const int* gbody = mi + mi[I_GBODY];
  const int* pfn = mi + mi[I_PFN];
  const int* pga = mi + mi[I_PGA];
  const int* pgb = mi + mi[I_PGB];
  const int* pcorner = mi + mi[I_PCORNER];
  const int* pra = mi + mi[I_PRA];
  const int* prb = mi + mi[I_PRB];
  const int* pfa = mi + mi[I_PFA];
  const int* pfb = mi + mi[I_PFB];
  const int* ghull = mi + mi[I_GHULL];
  const float* cmu = mf + mi[F_CMU];
  const float* dn0 = mf + mi[F_DN0];

  // the env's state and model data: rows of its input row
  float* qpos = row + mi[R_QPOS];
  float* qvel = row + mi[R_QVEL];
  float* fpose = row + mi[R_FPOSE];  // 7 a free body: position, quaternion
  float* fvel = row + mi[R_FVEL];    // 6 a free body: v, ω
  float* lam = row + mi[R_LAM];      // warm start, point-major
  float* lamt = row + mi[R_LAMT];    // component-major: lamt[c P + p]
  const V3* gsz = reinterpret_cast<const V3*>(row + mi[R_GSIZE]);
  V3* bp = reinterpret_cast<V3*>(S + L.bp);
  V3* aw = reinterpret_cast<V3*>(S + L.aw);
  V3* cw = reinterpret_cast<V3*>(S + L.cw);
  V3* cv = reinterpret_cast<V3*>(S + L.cv);
  V3* vbw = reinterpret_cast<V3*>(S + L.vbw);
  V3* vbv = reinterpret_cast<V3*>(S + L.vbv);
  V3* comw = reinterpret_cast<V3*>(S + L.comw);
  V3* St = reinterpret_cast<V3*>(S + L.st);
  V3* Sf = reinterpret_cast<V3*>(S + L.sf);
  Q4* bq = reinterpret_cast<Q4*>(S + L.bq);
  float* Iw = S + L.iw;  // 6 a body
  Q4* jm = reinterpret_cast<Q4*>(S + L.jm);
  V3* gp = reinterpret_cast<V3*>(S + L.gp);
  Q4* gq = reinterpret_cast<Q4*>(S + L.gq);
  float* A = S + L.A;  // lower-packed LHS, factored in place
  float* rv = S + L.rv;
  float* rp = S + L.rp;
  float* dinv = S + L.dinv;
  float* col = S + L.col;  // the batch's columns: 4 (C, C·n) a point and dof
  float* rec = S + L.rec;  // the batch's points: 16 floats each
  float* fposen = S + L.fposen;
  float* cache = S + L.cache;  // each point's contact from pass 1: 7 floats

  // this lane's joint (lane < nq): its depth in the tree (parents come
  // before their children)
  int depth = 0;
  if (lane < nq)
    for (int p = parent[lane]; p >= 0; p = parent[p]) ++depth;
  const int max_depth = __reduce_max_sync(FULL_MASK, depth);
  const bool body = lane < nq;
  __syncwarp();

  for (int s = 0; s < n_substeps; ++s) {
    const bool last = (s == n_substeps - 1);
    // ---------- FK (pre-composed joint quaternions), joint columns at ref
    // and body velocities, one tree level at a time ----------
    if (body && jtype[lane] == 0) {  // revolute: the joint's own rotation
      const int i = lane;
      float half = 0.5f * qpos[i];
      float c = cosf(half), sn = sinf(half);
      const float* Aq = mf + mi[F_AQ] + 4 * i;
      const float* Bq = mf + mi[F_BQ] + 4 * i;
      Q4 m = {c * Aq[0] + sn * Bq[0], c * Aq[1] + sn * Bq[1], c * Aq[2] + sn * Bq[2],
              c * Aq[3] + sn * Bq[3]};
      jm[i] = m;
    }
    __syncwarp();
    for (int lvl = 0; lvl <= max_depth; ++lvl) {
      if (body && depth == lvl) {
        const int i = lane, par = parent[i];
        V3 pp = par < 0 ? base_p : bp[par];
        Q4 pq = par < 0 ? base_q : bq[par];
        V3 fp = add(pp, qapply(pq, ld3(mf + mi[F_JPOS] + 3 * i)));
        V3 ax = ld3(mf + mi[F_JAXIS] + 3 * i);
        Q4 bqi;
        V3 bpi, awi, cwi, cvi;
        if (jtype[i] == 0) {  // revolute
          bqi = qmul(pq, jm[i]);
          bpi = fp;
          awi = qapply(bqi, ax);
          cwi = awi;
          cvi = cross(sub(bpi, ref), awi);
        } else {  // prismatic
          bqi = qmul(pq, ld4(mf + mi[F_AQ] + 4 * i));
          awi = qapply(bqi, ax);
          bpi = add(fp, scl(awi, qpos[i]));
          cwi = mk3(0.0f, 0.0f, 0.0f);
          cvi = awi;
        }
        bq[i] = bqi;
        bp[i] = bpi;
        aw[i] = awi;
        cw[i] = cwi;
        cv[i] = cvi;
        V3 vw = scl(cwi, qvel[i]), vv = scl(cvi, qvel[i]);
        if (par >= 0) {
          vw = add(vbw[par], vw);
          vv = add(vbv[par], vv);
        }
        vbw[i] = vw;
        vbv[i] = vv;
        if (last) {
          orow[mi[S_BPOS] + i] = bpi.x;
          orow[mi[S_BPOS] + nq + i] = bpi.y;
          orow[mi[S_BPOS] + 2 * nq + i] = bpi.z;
          orow[mi[S_AXIS] + i] = awi.x;
          orow[mi[S_AXIS] + nq + i] = awi.y;
          orow[mi[S_AXIS] + 2 * nq + i] = awi.z;
          orow[mi[S_BQUAT] + i] = bqi.w;
          orow[mi[S_BQUAT] + nq + i] = bqi.x;
          orow[mi[S_BQUAT] + 2 * nq + i] = bqi.y;
          orow[mi[S_BQUAT] + 3 * nq + i] = bqi.z;
        }
      }
      __syncwarp();
    }
    // ---------------- geom world poses, a lane per geom ----------------
    if (lane < G) {
      const int g = lane, kind = gkind[g], b = gbody[g];
      V3 pp;
      Q4 pq;
      if (kind == KIND_ROBOT_LINK) {
        pp = b >= 0 ? bp[b] : base_p;
        pq = b >= 0 ? bq[b] : base_q;
      } else if (kind == KIND_FREE) {
        pp = ld3(fpose + 7 * b);
        pq = ld4(fpose + 7 * b + 3);
      } else if (kind == KIND_KINEMATIC) {
        pp = ld3(row + mi[R_KIN] + 7 * b);
        pq = ld4(row + mi[R_KIN] + 7 * b + 3);
      } else {
        pp = ld3(mf + mi[F_STATIC] + 7 * b);
        pq = ld4(mf + mi[F_STATIC] + 7 * b + 3);
      }
      gp[g] = add(pp, qapply(pq, ld3(row + mi[R_GPOS] + 3 * g)));
      gq[g] = qmul(pq, ld4(row + mi[R_GQUAT] + 4 * g));
    }
    for (int i = lane; i < ntri; i += 32) A[i] = 0.0f;
    for (int i = lane; i < n_all; i += 32) rv[i] = rp[i] = 0.0f;
    __syncwarp();

    // ------- pass 1: forces at current velocities -> rhs + LHS coupling -------
    // lane l takes points l, l + 32, ...; the points that load the solve are
    // then added one at a time, in point order
    for (int base = 0; base < P; base += 32) {
      const int p = base + lane;
      bool loads = false;
      V3 pos = mk3(0.0f, 0.0f, 0.0f), nrm = pos, f_vel = pos, f_pos = pos;
      float h_dt = 0.0f, h_nn = 0.0f;
      if (p < P) {
        PointCtx x;
        x.ct = contact_point(pfn[p], pga[p], pgb[p], pcorner[p], gp, gq, gsz, ghull, row, mi);
        pos = x.ct.pos;
        nrm = x.ct.nrm;
        const float dep = x.ct.dep;
        float* c = cache + 7 * p;  // for pass 2
        c[0] = pos.x; c[1] = pos.y; c[2] = pos.z;
        c[3] = nrm.x; c[4] = nrm.y; c[5] = nrm.z;
        c[6] = dep;
        // beyond the margin a point carries no force and loads nothing: its
        // gate is off and f_vel, f_pos are signed zeros. Its force law runs
        // only in the last substep, for the bits of f_pt
        if (dep > -margin || last) {
          x.rel = sub(pos, ref);
          x.lam = lam[p];
          V3 lt = mk3(lamt[p], lamt[P + p], lamt[2 * P + p]);
          x.lt = sub(lt, scl(nrm, dot(lt, nrm)));  // project onto the tangent plane
          x.active = (float)(dep > -margin);
          const float spec = fminf(dep, 0.0f) / h;
          x.t_vel = spec;
          x.t_pos = spec + fminf(beta * fmaxf(dep, 0.0f) / h, bias_max);
          x.dn0 = dn0[p];
          x.mu = cmu[p];
          const int ra = pra[p], rb = prb[p], fa = pfa[p], fb = pfb[p];
          V3 vrel = sub(side_vel(ra, fa, pos, x.rel, vbw, vbv, fpose, fvel),
                        side_vel(rb, fb, pos, x.rel, vbw, vbv, fpose, fvel));
          const float v_n = dot(vrel, nrm);
          const V3 v_t = sub(vrel, scl(nrm, v_n));
          Forces f = forces_at(x, v_n, v_t);
          // stored-load points stay in the implicit LHS
          const float gate = (f.fn_vel > 0.0f || (x.lam > 0.0f && x.active > 0.0f)) ? 1.0f : 0.0f;
          const float d_n = x.dn0 * gate;
          const float vt_norm = sqrtf(dot(v_t, v_t) + vreg * vreg);
          const float d_t = (f.sticking ? x.dn0 : x.mu * f.fn_pos / vt_norm) * gate;
          f_vel = add(scl(nrm, f.fn_vel), f.ft);
          f_pos = add(scl(nrm, f.fn_pos), f.ft);
          if (last) {
            orow[mi[S_FPT] + p] = f_pos.x;
            orow[mi[S_FPT] + P + p] = f_pos.y;
            orow[mi[S_FPT] + 2 * P + p] = f_pos.z;
          }
          h_dt = h * d_t;
          h_nn = h * (d_n - d_t);
          // with the gate off (d_n = d_t = 0) and no force, every term this
          // point would add is a signed zero
          loads = gate != 0.0f || f_vel.x != 0.0f || f_vel.y != 0.0f || f_vel.z != 0.0f ||
                  f_pos.x != 0.0f || f_pos.y != 0.0f || f_pos.z != 0.0f;
        }
      }
      // the loading points of this chunk, LOAD_BATCH at a time in point
      // order: each writes its record, lane d builds column d of each, then
      // lanes add the batch to the entries they own
      const unsigned loaders = __ballot_sync(FULL_MASK, loads);
      const int rank = __popc(loaders & ((1u << lane) - 1u));
      for (int b0 = 0; b0 < __popc(loaders); b0 += LOAD_BATCH) {
        const int nb = min(LOAD_BATCH, __popc(loaders) - b0);
        if (loads && rank >= b0 && rank < b0 + nb) {
          float* r = rec + 16 * (rank - b0);
          r[0] = pos.x; r[1] = pos.y; r[2] = pos.z;
          r[3] = nrm.x; r[4] = nrm.y; r[5] = nrm.z;
          r[6] = f_vel.x; r[7] = f_vel.y; r[8] = f_vel.z;
          r[9] = f_pos.x; r[10] = f_pos.y; r[11] = f_pos.z;
          r[12] = h_dt;
          r[13] = h_nn;
          reinterpret_cast<int*>(r)[14] = p;
        }
        __syncwarp();
        for (int q = 0; q < nb; ++q) {
          float* r = rec + 16 * q;
          const V3 qpos_w = ld3(r);
          const int pq = reinterpret_cast<const int*>(r)[14];
          const V3 rel = sub(qpos_w, ref);
          const int ra = pra[pq], rb = prb[pq], fa = pfa[pq], fb = pfb[pq];
          // contact-jacobian column of dof `lane`, if it moves this point;
          // a pair of one body with itself (PlugCharger's prongs) has sm =
          // sg = 0 on every dof: its columns cancel, and the point loads
          // nothing
          bool act = false;
          if (lane < n_all) {
            V3 C;
            if (lane < nq) {
              const int sm = (ra >= 0 ? anc[ra * nq + lane] : 0) - (rb >= 0 ? anc[rb * nq + lane] : 0);
              act = sm != 0;
              C = scl(add(cv[lane], cross(cw[lane], rel)), (float)sm);
            } else {
              const int j = (lane - nq) / 6, c = lane - nq - 6 * j;
              const float sg = (float)((fa == j) - (fb == j));
              act = sg != 0.0f;
              const V3 arm = sub(qpos_w, ld3(fpose + 7 * j));
              if (c == 0) C = mk3(0.0f, -arm.z * sg, arm.y * sg);       // ω_x
              else if (c == 1) C = mk3(arm.z * sg, 0.0f, -arm.x * sg);  // ω_y
              else if (c == 2) C = mk3(-arm.y * sg, arm.x * sg, 0.0f);  // ω_z
              else if (c == 3) C = mk3(sg, 0.0f, 0.0f);                 // v_x
              else if (c == 4) C = mk3(0.0f, sg, 0.0f);                 // v_y
              else C = mk3(0.0f, 0.0f, sg);                             // v_z
            }
            if (act) {
              float* cl = col + 4 * (q * n_all + lane);
              cl[0] = C.x;
              cl[1] = C.y;
              cl[2] = C.z;
              cl[3] = dot(C, ld3(r + 3));
              rv[lane] += dot(C, ld3(r + 6));
              rp[lane] += dot(C, ld3(r + 9));
            }
          }
          const unsigned am = __ballot_sync(FULL_MASK, act);
          if (lane == 0) reinterpret_cast<unsigned*>(r)[15] = am;
        }
        __syncwarp();
        // h Jᵀ(d_t I + (d_n - d_t) n nᵀ)J: lane-owned packed entries (d1,
        // d2), the batch's points in order
        for (int e = lane, d1 = 0; e < ntri; e += 32) {
          while (TRI(d1 + 1) <= e) ++d1;
          const int d2 = e - TRI(d1);
          float a = A[e];
          for (int q = 0; q < nb; ++q) {
            const float* r = rec + 16 * q;
            const unsigned am = reinterpret_cast<const unsigned*>(r)[15];
            if ((am >> d1) & (am >> d2) & 1u) {
              const float* c1 = col + 4 * (q * n_all + d1);
              const float* c2 = col + 4 * (q * n_all + d2);
              const V3 cwi = scl(ld3(c1), r[12]);
              const float gni = c1[3] * r[13];
              a += dot(cwi, ld3(c2)) + gni * c2[3];
            }
          }
          A[e] = a;
        }
        __syncwarp();
      }
    }

    // ---------------- robot mass matrix + bias ----------------
    if (body) {
      const int b = lane;
      comw[b] = sub(add(bp[b], qapply(bq[b], ld3(mf + mi[F_COM] + 3 * b))), ref);
      float Ic[3][3];
      for (int c = 0; c < 9; ++c) Ic[c / 3][c % 3] = mf[mi[F_ICOM] + 9 * b + c];
      rotate_inertia(bq[b], Ic, Iw + 6 * b);
    }
    __syncwarp();
    // lane-owned entries (kk, l) of the robot block, bodies in order
    for (int e = lane, kk = 0; e < TRI(nq); e += 32) {
      while (TRI(kk + 1) <= e) ++kk;
      const int l = e - TRI(kk);
      float a = A[e];
      for (int b = 0; b < nq; ++b) {
        const int* ab = anc + b * nq;
        if (!ab[kk] || !ab[l]) continue;
        const float m = mf[mi[F_MASS] + b];
        const V3 uk = add(cv[kk], cross(cw[kk], comw[b]));
        const V3 Iwk = sym_apply(Iw + 6 * b, cw[kk]);
        const V3 ul = add(cv[l], cross(cw[l], comw[b]));
        a += m * dot(uk, ul) + dot(cw[l], Iwk);
      }
      A[e] = a;
    }
    // bias: ṡ = v ×̂ s; a_bias = prefix(ṡ q̇); f = I a + v ×* I v - gravity
    for (int lvl = 0; lvl <= max_depth; ++lvl) {
      if (body && depth == lvl) {
        const int b = lane;
        V3 sdw = cross(vbw[b], cw[b]);
        V3 sdv = add(cross(vbw[b], cv[b]), cross(vbv[b], cw[b]));
        V3 t = scl(sdw, qvel[b]);  // St/Sf hold a_bias until reused below
        V3 f = scl(sdv, qvel[b]);
        if (parent[b] >= 0) {
          t = add(St[parent[b]], t);
          f = add(Sf[parent[b]], f);
        }
        St[b] = t;
        Sf[b] = f;
      }
      __syncwarp();
    }
    if (body) {
      const int b = lane;
      const float m = mf[mi[F_MASS] + b];
      const float* Iwb = Iw + 6 * b;
      // I_apply(a_bias)
      V3 z1 = add(Sf[b], cross(St[b], comw[b]));
      V3 t1 = add(sym_apply(Iwb, St[b]), scl(cross(comw[b], z1), m));
      V3 f1 = scl(z1, m);
      // v ×* I v
      V3 zi = add(vbv[b], cross(vbw[b], comw[b]));
      V3 ti = add(sym_apply(Iwb, vbw[b]), scl(cross(comw[b], zi), m));
      V3 fi = scl(zi, m);
      V3 t2 = add(cross(vbw[b], ti), cross(vbv[b], fi));
      V3 f2 = cross(vbw[b], fi);
      V3 Fg = scl(gvec, mf[mi[F_GMASK] + b] * m);
      V3 tg = cross(comw[b], Fg);
      St[b] = sub(add(t1, t2), tg);
      Sf[b] = sub(add(f1, f2), Fg);
    }
    __syncwarp();
    // subtree sums, deepest level first; a parent adds its children in
    // descending order
    for (int lvl = max_depth; lvl >= 1; --lvl) {
      if (body && depth == lvl - 1) {
        const int p = lane;
        V3 t = St[p], f = Sf[p];
        for (int b = nq - 1; b > p; --b) {
          if (parent[b] == p) {
            t = add(t, St[b]);
            f = add(f, Sf[b]);
          }
        }
        St[p] = t;
        Sf[p] = f;
      }
      __syncwarp();
    }
    // drives, joint limits and friction: a lane per dof
    if (body) {
      const int j = lane;
      const float tau_bias = dot(cw[j], St[j]) + dot(cv[j], Sf[j]);
      const float kp = row[mi[R_KP] + j], kd = row[mi[R_KD] + j], fl = row[mi[R_FLIM] + j];
      const float td = fminf(fmaxf(kp * (row[mi[R_TQ] + j] - qpos[j])
                                   + kd * (row[mi[R_TV] + j] - qvel[j]), -fl), fl);
      const float lo = mf[mi[F_QLIM] + 2 * j], hi = mf[mi[F_QLIM] + 2 * j + 1];
      const float viol_lo = fmaxf(lo - qpos[j], 0.0f), viol_hi = fmaxf(qpos[j] - hi, 0.0f);
      const float in_viol = (viol_lo > 0.0f || viol_hi > 0.0f) ? 1.0f : 0.0f;
      const float t_lim = lim_k * (viol_lo - viol_hi) - lim_d * in_viol * qvel[j];
      const float jfric = mf[mi[F_JFRIC] + j];
      const float sat = fminf(fmaxf(qvel[j] / fvreg, -1.0f), 1.0f);
      const float in_band = fabsf(qvel[j]) < fvreg ? 1.0f : 0.0f;
      const float r = td + row[mi[R_QF] + j] + t_lim - jfric * sat - tau_bias;
      rv[j] += r;
      rp[j] += r;
      A[TRI(j) + j] += h * (kp * h + kd) + h * mf[mi[F_JDAMP] + j] + 1e-6f
                       + h * in_band * jfric / fvreg + in_viol * (h * (lim_k * h + lim_d));
    }
    // free-body diagonal blocks + rhs ([ω; v] order): a lane per body
    if (lane < F) {
      const int j = lane;
      const float* fi = row + mi[R_FINERTIA] + 6 * j;  // [xx, xy, xz, yy, yz, zz]
      float I[3][3];
      I[0][0] = fi[0];
      I[0][1] = I[1][0] = fi[1];
      I[0][2] = I[2][0] = fi[2];
      I[1][1] = fi[3];
      I[1][2] = I[2][1] = fi[4];
      I[2][2] = fi[5];
      const Q4 q = ld4(fpose + 7 * j + 3);
      float Iwj[6];
      rotate_inertia(q, I, Iwj);
      const float fm = row[mi[R_FMASS] + j];
      const int o = nq + 6 * j;
      int u = 0;
      for (int c = 0; c < 3; ++c)
        for (int e = c; e < 3; ++e) A[TRI(o + e) + o + c] += Iwj[u++];
      for (int c = 0; c < 3; ++c) {
        A[TRI(o + c) + o + c] += 1e-9f;
        A[TRI(o + 3 + c) + o + 3 + c] += fm + 1e-9f;
      }
      const V3 w = ld3(fvel + 6 * j + 3);
      const V3 gyro = cross(w, sym_apply(Iwj, w));
      rv[o] -= gyro.x; rv[o + 1] -= gyro.y; rv[o + 2] -= gyro.z;
      rp[o] -= gyro.x; rp[o + 1] -= gyro.y; rp[o + 2] -= gyro.z;
      rv[o + 3] += fm * gvec.x; rv[o + 4] += fm * gvec.y; rv[o + 5] += fm * gvec.z;
      rp[o + 3] += fm * gvec.x; rp[o + 4] += fm * gvec.y; rp[o + 5] += fm * gvec.z;
    }
    __syncwarp();

    // ---------------- Cholesky pair solve (in place, lower packed) ---------
    // the factor a lane per row, then the velocity and position right-hand
    // sides at once on lanes 0 and 1, each scaled by h (cholesky.cuh)
    chol_factor_warp(A, dinv, n_all, lane);
    if (lane == 0) chol_solve(A, dinv, rv, n_all, h);
    else if (lane == 1) chol_solve(A, dinv, rp, n_all, h);
    __syncwarp();

    // ---------------- integration ----------------
    if (body) {
      const int j = lane;
      qpos[j] += h * (qvel[j] + rp[j]);  // positions take the bias-inclusive pass
      qvel[j] += rv[j];
    }
    if (lane < F) {
      const int j = lane, o = nq + 6 * j;
      float* fv = fvel + 6 * j;
      const float* fp = fpose + 7 * j;
      float* fn = fposen + 7 * j;
      float wn[3], vn[3], wi[3], vi[3];
      for (int c = 0; c < 3; ++c) {
        wn[c] = fv[3 + c] + rv[o + c];
        vn[c] = fv[c] + rv[o + 3 + c];
        wi[c] = fv[3 + c] + rp[o + c];
        vi[c] = fv[c] + rp[o + 3 + c];
      }
      // velocity clamps: s = min(1, cap / |v|)
      const float swn = fminf(1.0f, max_w * rsqrtf(wn[0] * wn[0] + wn[1] * wn[1] + wn[2] * wn[2] + 1e-24f));
      const float svn = fminf(1.0f, max_v * rsqrtf(vn[0] * vn[0] + vn[1] * vn[1] + vn[2] * vn[2] + 1e-24f));
      const float swi = fminf(1.0f, max_w * rsqrtf(wi[0] * wi[0] + wi[1] * wi[1] + wi[2] * wi[2] + 1e-24f));
      const float svi = fminf(1.0f, max_v * rsqrtf(vi[0] * vi[0] + vi[1] * vi[1] + vi[2] * vi[2] + 1e-24f));
      for (int c = 0; c < 3; ++c) {
        fn[c] = fp[c] + h * (vi[c] * svi);
        fv[c] = vn[c] * svn;
        fv[3 + c] = wn[c] * swn;
      }
      // q' = normalize(exp(h ω) ∘ q)
      const V3 hw = mk3(h * wi[0] * swi, h * wi[1] * swi, h * wi[2] * swi);
      const float angle = sqrtf(dot(hw, hw) + 1e-18f);
      const float hf = 0.5f * angle;
      const float kq = sinf(hf) / angle;
      const Q4 e = {cosf(hf), hw.x * kq, hw.y * kq, hw.z * kq};
      Q4 qn = qmul(e, ld4(fp + 3));
      const float inv = 1.0f / fmaxf(sqrtf(qn.w * qn.w + qn.x * qn.x + qn.y * qn.y + qn.z * qn.z), 1e-12f);
      fn[3] = qn.w * inv;
      fn[4] = qn.x * inv;
      fn[5] = qn.y * inv;
      fn[6] = qn.z * inv;
    }
    __syncwarp();

    // ------- pass 2: forces at the new velocities -> warm-start update -------
    for (int lvl = 0; lvl <= max_depth; ++lvl) {
      if (body && depth == lvl) {
        const int i = lane;
        V3 vw = scl(cw[i], qvel[i]), vv = scl(cv[i], qvel[i]);
        if (parent[i] >= 0) {
          vw = add(vbw[parent[i]], vw);
          vv = add(vbv[parent[i]], vv);
        }
        vbw[i] = vw;
        vbv[i] = vv;
      }
      __syncwarp();
    }
    for (int p = lane; p < P; p += 32) {
      PointCtx x;
      const float* c = cache + 7 * p;  // pass 1's contact (the geoms have not moved)
      x.ct.pos = ld3(c);
      x.ct.nrm = ld3(c + 3);
      x.ct.dep = c[6];
      const V3 pos = x.ct.pos, nrm = x.ct.nrm;
      const float dep = x.ct.dep;
      // memory only for touching points, ramped over 1 mm
      const float touch = fminf(fmaxf(1.0f + dep / 1e-3f, 0.0f), 1.0f);
      if (!(dep > -margin) && touch == 0.0f) {
        // no force and no memory: the update would give zeros (lam_t's
        // signed by the tangent it drops)
        lam[p] = 0.0f;
        lamt[p] = lamt[P + p] = lamt[2 * P + p] = 0.0f;
        continue;
      }
      x.rel = sub(pos, ref);
      x.lam = lam[p];
      V3 lt = mk3(lamt[p], lamt[P + p], lamt[2 * P + p]);
      x.lt = sub(lt, scl(nrm, dot(lt, nrm)));
      x.active = (float)(dep > -margin);
      const float spec = fminf(dep, 0.0f) / h;
      x.t_vel = spec;
      x.t_pos = spec + fminf(beta * fmaxf(dep, 0.0f) / h, bias_max);
      x.dn0 = dn0[p];
      x.mu = cmu[p];
      // free-body arms use the pre-integration poses (fpose, not fposen)
      V3 vrel = sub(side_vel(pra[p], pfa[p], pos, x.rel, vbw, vbv, fpose, fvel),
                    side_vel(prb[p], pfb[p], pos, x.rel, vbw, vbv, fpose, fvel));
      const float v_n = dot(vrel, nrm);
      Forces f = forces_at(x, v_n, sub(vrel, scl(nrm, v_n)));
      lam[p] = fmaxf((1.0f - relax) * x.lam + relax * f.fn_vel, 0.0f) * touch;
      lamt[p] = ((1.0f - relax) * x.lt.x + relax * f.ft.x) * touch;
      lamt[P + p] = ((1.0f - relax) * x.lt.y + relax * f.ft.y) * touch;
      lamt[2 * P + p] = ((1.0f - relax) * x.lt.z + relax * f.ft.z) * touch;
    }
    __syncwarp();
    for (int i = lane; i < 7 * F; i += 32) fpose[i] = fposen[i];
    __syncwarp();
  }

  for (int i = lane; i < nq; i += 32) {
    orow[mi[S_QPOS] + i] = qpos[i];
    orow[mi[S_QVEL] + i] = qvel[i];
  }
  for (int i = lane; i < 7 * F; i += 32) orow[mi[S_FPOSE] + i] = fpose[i];
  for (int i = lane; i < 6 * F; i += 32) orow[mi[S_FVEL] + i] = fvel[i];
  for (int i = lane; i < P; i += 32) orow[mi[S_LAM] + i] = lam[i];
  for (int i = lane; i < 3 * P; i += 32) orow[mi[S_LAMT] + i] = lamt[i];
}

// ---------------- host side (plain C interface, bound with ctypes) ----------------

// Let the kernel take `bytes` of dynamic shared memory a block (above the
// default 48 KB only after cudaFuncSetAttribute).
static cudaError_t reserve_smem(size_t bytes) {
  static size_t granted = 48 * 1024;
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(mk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) granted = bytes;
  return e;
}

// Floats of one warp's slice (make_layout).
extern "C" int mk_slice_floats(int nq, int F, int G, int P, int w_in) {
  return make_layout(nq, F, G, P, w_in).total;
}

extern "C" int mk_warps_per_block(void) { return WARPS; }

// Blocks of the kernel one SM holds with this slice (registers and shared
// memory; 0 if a block's slices do not fit).
extern "C" int mk_blocks_per_sm(int slice_floats) {
  const size_t bytes = (size_t)WARPS * slice_floats * sizeof(float);
  int n = 0;
  if (reserve_smem(bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mk_kernel, 32 * WARPS, bytes) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// Launch on the caller's stream over env-major planes in (K, w_in) and out
// (K, w_out); returns the launch's cudaGetLastError() (or the error of
// granting its shared memory: a slice too large for the card is refused).
extern "C" int mk_step(const float* in, float* out, const float* mf, const int* mi, int K,
                       int n_substeps, int nq, int F, int G, int P, int w_in, int w_out,
                       void* stream) {
  const Dims dm = {nq, F, G, P, w_in, w_out};
  const size_t bytes = (size_t)WARPS * make_layout(nq, F, G, P, w_in).total * sizeof(float);
  const cudaError_t e = reserve_smem(bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const int grid = (K + WARPS - 1) / WARPS;
  mk_kernel<<<grid, 32 * WARPS, bytes, (cudaStream_t)stream>>>(in, out, mf, mi, K, n_substeps,
                                                               dm);
  return (int)cudaGetLastError();
}

extern "C" const char* mk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
