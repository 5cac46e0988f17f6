// Whole-step physics mega-kernel for Hopper (sm_90a), one env per thread.
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
// What bounds it on this card: arithmetic and latency, not bytes. The state
// in and out is ~7.2 KB per env per launch (~29 MB at K=4096, microseconds
// of HBM time). The step's function needs 3-5 x 10^4 operations per env
// and substep (megakernel.work), most of them in the narrowphase; this
// kernel does several times that, since it builds Jacobian columns and
// rank-1 LHS updates at every point, zero or not, and redoes the
// narrowphase in its second contact pass. One thread per env gives only
// K/32 warps (128 at K=4096), so the kernel is latency-bound: every SM
// holds about one warp and the per-thread arrays below live in local memory.
//
// What the design does about it: the TPU kernel is already "one env per
// lane", so each thread runs the whole step for its env with no
// synchronisation. Small blocks (32 threads) spread the K/32 warps over
// all SMs. Per-point quantities are recomputed from the geom poses in both
// contact passes instead of being stored, so only lam/lam_t persist across
// points; they live in the output plane in the env-last layout (row r of
// env k at r*K + k), so neighbouring threads touch neighbouring addresses.
// Static model tables (parents, axes, per-point pair tables) are uploaded
// once per model and read by all threads from the same address
// (broadcast). The Python-unrolled per-model code of the TPU kernel becomes
// run-time loops over those tables, with compile-time caps on the local
// arrays (the wrapper refuses models beyond them). Per-env model data
// (free-body mass and inertia, geom sizes, the hull tables) are rows of the
// input plane, never static tables. A box corner against a hull costs two
// passes over its 32 face planes (the max, then the mean normal of the
// faces that attain it), read in place from the plane; the face-plane SDF
// is a separate (not inlined) function, which keeps it from raising the
// register pressure of the box-only scenes. Making it fast (several
// threads per env, shared-memory staging) is later work.

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

// One env's hull tables in the input plane: `col` is this env's column
// (row r at col[r * Ks]). Slot s's contact point p is rows
// R_HVERTS + 3 (s HULL_P + p) + c, its face f rows R_HFACES + 4 (s HULL_F + f)
// + c (c: nx, ny, nz, d). They are read in place, face by face, where a
// hull point needs them: neighbouring threads read neighbouring addresses,
// nothing is copied into thread-local memory, and no register holds them
// across the point loop.
__device__ __forceinline__ V3 hull_point(const float* col, size_t Ks, const int* mi, int slot,
                                         int p) {
  const float* r = col + (size_t)(mi[R_HVERTS] + 3 * (slot * HULL_P + p)) * Ks;
  return mk3(r[0], r[Ks], r[2 * Ks]);
}

__device__ __forceinline__ const float* hull_faces(const float* col, size_t Ks, const int* mi,
                                                   int slot) {
  return col + (size_t)(mi[R_HFACES] + 4 * HULL_F * slot) * Ks;
}

// x nx + y ny + z nz - d of face row f (rows f, f + Ks, f + 2 Ks, f + 3 Ks),
// rounded operation by operation (no FMA), as the plain version computes
// it: the max pass and the one-hot pass of hull_sdf then see the same
// value, and a tie breaks as it does there
__device__ __forceinline__ float face_dist(V3 p, const float* f, size_t Ks) {
  return __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(p.x, f[0]), __fmul_rn(p.y, f[Ks])),
                             __fmul_rn(p.z, f[2 * Ks])),
                   f[3 * Ks]);
}

// point vs convex hull (shapes._hull_sdf): the largest face distance, and
// the normalised mean of the normals of every face that attains it (an
// edge point gets the two faces' mean). Padding faces sit at d = 1e6 and
// never attain it.
__device__ __noinline__ void hull_sdf(V3 p, const float* faces, size_t Ks, float* sdf,
                                         V3* n) {
  float best = face_dist(p, faces, Ks);
  for (int f = 1; f < HULL_F; ++f) best = fmaxf(best, face_dist(p, faces + (size_t)4 * f * Ks, Ks));
  float cnt = 0.0f;
  V3 acc = mk3(0.0f, 0.0f, 0.0f);
  for (int f = 0; f < HULL_F; ++f) {
    const float* fr = faces + (size_t)4 * f * Ks;
    if (face_dist(p, fr, Ks) >= best) {
      cnt += 1.0f;
      acc = add(acc, mk3(fr[0], fr[Ks], fr[2 * Ks]));
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
                                          const float* col, size_t Ks, const int* mi,
                                          int slot_a, int slot_b, Contact* out) {
  const bool flip = fn == FN_HULL_HULL && c >= HULL_P;
  V3 w;  // the point, in the world
  if (fn == FN_HULL_HULL)
    w = flip ? add(pb, qapply(qb, hull_point(col, Ks, mi, slot_b, c - HULL_P)))
             : add(pa, qapply(qa, hull_point(col, Ks, mi, slot_a, c)));
  else if (fn == FN_CAPSULE_HULL)
    w = add(pa, scl(qapply(qa, mk3(0.0f, 0.0f, 1.0f)), sa.y * (float)(c - 1)));
  else
    w = pa;
  const V3 ph = flip ? pa : pb;  // the hull the point is held against
  const Q4 qh = flip ? qa : qb;
  float sdf;
  V3 nl;
  hull_sdf(qapply(qconj(qh), sub(w, ph)), hull_faces(col, Ks, mi, flip ? slot_a : slot_b), Ks,
           &sdf, &nl);
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
// a hull: hull_contact.
__device__ __forceinline__ Contact contact_point(int fn, int ga, int gb, int c,
                                                 const V3* gp, const Q4* gq,
                                                 const V3* gsz, const int* ghull,
                                                 const float* col, size_t Ks,
                                                 const int* mi) {
  Contact ct;
  if (fn >= FN_SPHERE_HULL) {
    hull_contact(fn, c, gp[ga], gq[ga], gsz[ga], gp[gb], gq[gb], col, Ks, mi, ghull[ga],
                 ghull[gb], &ct);
    return ct;
  }
  if (fn >= FN_PLANE_SPHERE) {
    round_contact(fn, c, gp[ga], gq[ga], gsz[ga], gp[gb], gq[gb], gsz[gb], &ct);
    return ct;
  }
  if (fn == FN_PLANE_BOX || fn == FN_PLANE_HULL) {
    V3 n = qapply(gq[ga], mk3(0.0f, 0.0f, 1.0f));
    const V3 local = fn == FN_PLANE_BOX ? corner_local(gsz[gb], c)
                                        : hull_point(col, Ks, mi, ghull[gb], c);
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
      hull_sdf(loc, hull_faces(col, Ks, mi, slot), Ks, &sdf, &nl);
      ct.pos = corner;
      ct.nrm = qapply(gq[gb], nl);
    } else {
      V3 w = add(gp[gb], qapply(gq[gb], hull_point(col, Ks, mi, slot, c - 8)));
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

// velocity of the contact point on one side (robot body r and/or free body f)
__device__ __forceinline__ V3 side_vel(int r, int f, V3 pos, V3 rel, const V3* vbw,
                                       const V3* vbv, float (*fpose)[7],
                                       float (*fvel)[6]) {
  V3 v = mk3(0.0f, 0.0f, 0.0f);
  if (r >= 0) v = add(vbv[r], cross(vbw[r], rel));
  if (f >= 0) {
    V3 arm = sub(pos, ld3(fpose[f]));
    v = add(v, add(ld3(fvel[f]), cross(ld3(fvel[f] + 3), arm)));
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

// (64, 1): at most 64 threads a block, one block an SM is enough. With the
// not-inlined narrowphase helpers ptxas then keeps the per-thread state in
// registers (248, no spills); with (64) alone it chose 80 registers and
// spilled, 1-3 % slower on the box scenes (PERF.md, section 6).
__global__ void __launch_bounds__(64, 1) mk_kernel(const float* __restrict__ in,
                                                float* __restrict__ out,
                                                const float* __restrict__ mf,
                                                const int* __restrict__ mi, int K,
                                                int n_substeps) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;  // ragged edge: no padding, the tail threads exit
  const size_t Ks = (size_t)K;
#define IN(r) in[(size_t)(r) * Ks + k]
#define OUT(r) out[(size_t)(r) * Ks + k]

  const int nq = mi[H_NQ], F = mi[H_F], G = mi[H_G], P = mi[H_P];
  const int n_all = nq + 6 * F;
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

  // ---- state and per-env model data into thread-local arrays ----
  float qpos[NB_MAX], qvel[NB_MAX];
  float fpose[F_MAX][7], fvel[F_MAX][6], fmass[F_MAX], finert[F_MAX][3][3];
  V3 gsz[G_MAX], gop[G_MAX];
  Q4 goq[G_MAX];
  for (int i = 0; i < nq; ++i) {
    qpos[i] = IN(mi[R_QPOS] + i);
    qvel[i] = IN(mi[R_QVEL] + i);
  }
  for (int j = 0; j < F; ++j) {
    for (int c = 0; c < 7; ++c) fpose[j][c] = IN(mi[R_FPOSE] + 7 * j + c);
    for (int c = 0; c < 6; ++c) fvel[j][c] = IN(mi[R_FVEL] + 6 * j + c);
    fmass[j] = IN(mi[R_FMASS] + j);
    const int r = mi[R_FINERTIA] + 6 * j;  // [xx, xy, xz, yy, yz, zz]
    finert[j][0][0] = IN(r);
    finert[j][0][1] = finert[j][1][0] = IN(r + 1);
    finert[j][0][2] = finert[j][2][0] = IN(r + 2);
    finert[j][1][1] = IN(r + 3);
    finert[j][1][2] = finert[j][2][1] = IN(r + 4);
    finert[j][2][2] = IN(r + 5);
  }
  for (int g = 0; g < G; ++g) {
    gsz[g] = mk3(IN(mi[R_GSIZE] + 3 * g), IN(mi[R_GSIZE] + 3 * g + 1),
                 IN(mi[R_GSIZE] + 3 * g + 2));
    gop[g] = mk3(IN(mi[R_GPOS] + 3 * g), IN(mi[R_GPOS] + 3 * g + 1),
                 IN(mi[R_GPOS] + 3 * g + 2));
    Q4 q = {IN(mi[R_GQUAT] + 4 * g), IN(mi[R_GQUAT] + 4 * g + 1),
            IN(mi[R_GQUAT] + 4 * g + 2), IN(mi[R_GQUAT] + 4 * g + 3)};
    goq[g] = q;
  }
  // warm-start impulses live in the output plane from here on
  for (int p = 0; p < P; ++p) {
    OUT(mi[S_LAM] + p) = IN(mi[R_LAM] + p);
    for (int c = 0; c < 3; ++c) OUT(mi[S_LAMT] + c * P + p) = IN(mi[R_LAMT] + c * P + p);
  }

  V3 bp[NB_MAX], aw[NB_MAX], cw[NB_MAX], cv[NB_MAX], vbw[NB_MAX], vbv[NB_MAX];
  Q4 bq[NB_MAX];
  V3 gp[G_MAX];
  Q4 gq[G_MAX];
  V3 comw[NB_MAX], St[NB_MAX], Sf[NB_MAX];
  float Iw[NB_MAX][6];
  float A[TRI(NALL_MAX)];  // lower-packed LHS, factored in place
  float rv[NALL_MAX], rp[NALL_MAX], dinv[NALL_MAX];
  V3 C[NALL_MAX];
  float Gn[NALL_MAX];
  int act[NALL_MAX];
  float fpose_n[F_MAX][7];

  for (int s = 0; s < n_substeps; ++s) {
    const bool last = (s == n_substeps - 1);
    // ---------------- FK (pre-composed joint quaternions) ----------------
    for (int i = 0; i < nq; ++i) {
      const int par = parent[i];
      V3 pp = par < 0 ? base_p : bp[par];
      Q4 pq = par < 0 ? base_q : bq[par];
      V3 fp = add(pp, qapply(pq, ld3(mf + mi[F_JPOS] + 3 * i)));
      V3 ax = ld3(mf + mi[F_JAXIS] + 3 * i);
      const float* Aq = mf + mi[F_AQ] + 4 * i;
      if (jtype[i] == 0) {  // revolute
        float half = 0.5f * qpos[i];
        float c = cosf(half), sn = sinf(half);
        const float* Bq = mf + mi[F_BQ] + 4 * i;
        Q4 m = {c * Aq[0] + sn * Bq[0], c * Aq[1] + sn * Bq[1], c * Aq[2] + sn * Bq[2],
                c * Aq[3] + sn * Bq[3]};
        bq[i] = qmul(pq, m);
        bp[i] = fp;
        aw[i] = qapply(bq[i], ax);
      } else {  // prismatic
        bq[i] = qmul(pq, ld4(Aq));
        aw[i] = qapply(bq[i], ax);
        bp[i] = add(fp, scl(aw[i], qpos[i]));
      }
    }
    // joint Plücker columns at ref and per-body spatial velocities
    for (int i = 0; i < nq; ++i) {
      if (jtype[i] == 0) {
        cw[i] = aw[i];
        cv[i] = cross(sub(bp[i], ref), aw[i]);
      } else {
        cw[i] = mk3(0.0f, 0.0f, 0.0f);
        cv[i] = aw[i];
      }
      vbw[i] = scl(cw[i], qvel[i]);
      vbv[i] = scl(cv[i], qvel[i]);
      if (parent[i] >= 0) {
        vbw[i] = add(vbw[parent[i]], vbw[i]);
        vbv[i] = add(vbv[parent[i]], vbv[i]);
      }
    }
    if (last) {
      for (int b = 0; b < nq; ++b) {
        OUT(mi[S_BPOS] + b) = bp[b].x;
        OUT(mi[S_BPOS] + nq + b) = bp[b].y;
        OUT(mi[S_BPOS] + 2 * nq + b) = bp[b].z;
        OUT(mi[S_AXIS] + b) = aw[b].x;
        OUT(mi[S_AXIS] + nq + b) = aw[b].y;
        OUT(mi[S_AXIS] + 2 * nq + b) = aw[b].z;
        OUT(mi[S_BQUAT] + b) = bq[b].w;
        OUT(mi[S_BQUAT] + nq + b) = bq[b].x;
        OUT(mi[S_BQUAT] + 2 * nq + b) = bq[b].y;
        OUT(mi[S_BQUAT] + 3 * nq + b) = bq[b].z;
      }
    }
    // ---------------- geom world poses ----------------
    for (int g = 0; g < G; ++g) {
      const int kind = gkind[g], b = gbody[g];
      V3 pp;
      Q4 pq;
      if (kind == KIND_ROBOT_LINK) {
        pp = b >= 0 ? bp[b] : base_p;
        pq = b >= 0 ? bq[b] : base_q;
      } else if (kind == KIND_FREE) {
        pp = ld3(fpose[b]);
        pq = ld4(fpose[b] + 3);
      } else if (kind == KIND_KINEMATIC) {
        const int r = mi[R_KIN] + 7 * b;
        pp = mk3(IN(r), IN(r + 1), IN(r + 2));
        Q4 q = {IN(r + 3), IN(r + 4), IN(r + 5), IN(r + 6)};
        pq = q;
      } else {
        pp = ld3(mf + mi[F_STATIC] + 7 * b);
        pq = ld4(mf + mi[F_STATIC] + 7 * b + 3);
      }
      gp[g] = add(pp, qapply(pq, gop[g]));
      gq[g] = qmul(pq, goq[g]);
    }

    for (int i = 0; i < TRI(n_all); ++i) A[i] = 0.0f;
    for (int i = 0; i < n_all; ++i) rv[i] = rp[i] = 0.0f;

    // ------- pass 1: forces at current velocities -> rhs + LHS coupling -------
    for (int p = 0; p < P; ++p) {
      PointCtx x;
      x.ct = contact_point(pfn[p], pga[p], pgb[p], pcorner[p], gp, gq, gsz, ghull, in + k, Ks,
                         mi);
      const V3 pos = x.ct.pos, nrm = x.ct.nrm;
      const float dep = x.ct.dep;
      x.rel = sub(pos, ref);
      x.lam = OUT(mi[S_LAM] + p);
      V3 lt = mk3(OUT(mi[S_LAMT] + p), OUT(mi[S_LAMT] + P + p), OUT(mi[S_LAMT] + 2 * P + p));
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
      const V3 f_vel = add(scl(nrm, f.fn_vel), f.ft);
      const V3 f_pos = add(scl(nrm, f.fn_pos), f.ft);
      if (last) {
        OUT(mi[S_FPT] + p) = f_pos.x;
        OUT(mi[S_FPT] + P + p) = f_pos.y;
        OUT(mi[S_FPT] + 2 * P + p) = f_pos.z;
      }
      const float h_dt = h * d_t, h_nn = h * (d_n - d_t);
      // contact-jacobian columns of the dofs that move this point; a pair
      // of one body with itself (PlugCharger's prongs) has sm = sg = 0 on
      // every dof: its columns cancel, and the point loads nothing
      int na = 0;
      for (int j = 0; j < nq; ++j) {
        const int sm = (ra >= 0 ? anc[ra * nq + j] : 0) - (rb >= 0 ? anc[rb * nq + j] : 0);
        if (sm != 0) {
          C[na] = scl(add(cv[j], cross(cw[j], x.rel)), (float)sm);
          act[na++] = j;
        }
      }
      for (int j = 0; j < F; ++j) {
        const float sg = (float)((fa == j) - (fb == j));
        if (sg != 0.0f) {
          const V3 arm = sub(pos, ld3(fpose[j]));
          const int o = nq + 6 * j;
          C[na] = mk3(0.0f, -arm.z * sg, arm.y * sg); act[na++] = o;      // ω_x
          C[na] = mk3(arm.z * sg, 0.0f, -arm.x * sg); act[na++] = o + 1;  // ω_y
          C[na] = mk3(-arm.y * sg, arm.x * sg, 0.0f); act[na++] = o + 2;  // ω_z
          C[na] = mk3(sg, 0.0f, 0.0f); act[na++] = o + 3;                 // v_x
          C[na] = mk3(0.0f, sg, 0.0f); act[na++] = o + 4;                 // v_y
          C[na] = mk3(0.0f, 0.0f, sg); act[na++] = o + 5;                 // v_z
        }
      }
      for (int i = 0; i < na; ++i) Gn[i] = dot(C[i], nrm);
      for (int i = 0; i < na; ++i) {
        const int d = act[i];
        rv[d] += dot(C[i], f_vel);
        rp[d] += dot(C[i], f_pos);
        const V3 cwi = scl(C[i], h_dt);
        const float gni = Gn[i] * h_nn;
        float* row = A + TRI(d);
        for (int j = 0; j <= i; ++j) row[act[j]] += dot(cwi, C[j]) + gni * Gn[j];
      }
    }

    // ---------------- robot mass matrix + bias ----------------
    for (int b = 0; b < nq; ++b) {
      comw[b] = sub(add(bp[b], qapply(bq[b], ld3(mf + mi[F_COM] + 3 * b))), ref);
      float Ic[3][3];
      for (int c = 0; c < 9; ++c) Ic[c / 3][c % 3] = mf[mi[F_ICOM] + 9 * b + c];
      rotate_inertia(bq[b], Ic, Iw[b]);
      const float m = mf[mi[F_MASS] + b];
      const int* ab = anc + b * nq;
      for (int kk = 0; kk < nq; ++kk) {
        if (!ab[kk]) continue;
        const V3 uk = add(cv[kk], cross(cw[kk], comw[b]));
        const V3 Iwk = sym_apply(Iw[b], cw[kk]);
        for (int l = 0; l <= kk; ++l) {
          if (!ab[l]) continue;
          const V3 ul = add(cv[l], cross(cw[l], comw[b]));
          A[TRI(kk) + l] += m * dot(uk, ul) + dot(cw[l], Iwk);
        }
      }
    }
    // bias: ṡ = v ×̂ s; a_bias = prefix(ṡ q̇); f = I a + v ×* I v - gravity
    for (int b = 0; b < nq; ++b) {
      V3 sdw = cross(vbw[b], cw[b]);
      V3 sdv = add(cross(vbw[b], cv[b]), cross(vbv[b], cw[b]));
      St[b] = scl(sdw, qvel[b]);  // St/Sf hold a_bias until reused below
      Sf[b] = scl(sdv, qvel[b]);
      if (parent[b] >= 0) {
        St[b] = add(St[parent[b]], St[b]);
        Sf[b] = add(Sf[parent[b]], Sf[b]);
      }
    }
    for (int b = 0; b < nq; ++b) {
      const float m = mf[mi[F_MASS] + b];
      // I_apply(a_bias)
      V3 z1 = add(Sf[b], cross(St[b], comw[b]));
      V3 t1 = add(sym_apply(Iw[b], St[b]), scl(cross(comw[b], z1), m));
      V3 f1 = scl(z1, m);
      // v ×* I v
      V3 zi = add(vbv[b], cross(vbw[b], comw[b]));
      V3 ti = add(sym_apply(Iw[b], vbw[b]), scl(cross(comw[b], zi), m));
      V3 fi = scl(zi, m);
      V3 t2 = add(cross(vbw[b], ti), cross(vbv[b], fi));
      V3 f2 = cross(vbw[b], fi);
      V3 Fg = scl(gvec, mf[mi[F_GMASK] + b] * m);
      V3 tg = cross(comw[b], Fg);
      St[b] = sub(add(t1, t2), tg);
      Sf[b] = sub(add(f1, f2), Fg);
    }
    for (int b = nq - 1; b >= 0; --b) {
      if (parent[b] >= 0) {
        St[parent[b]] = add(St[parent[b]], St[b]);
        Sf[parent[b]] = add(Sf[parent[b]], Sf[b]);
      }
    }
    for (int j = 0; j < nq; ++j) {
      const float tau_bias = dot(cw[j], St[j]) + dot(cv[j], Sf[j]);
      const float kp = IN(mi[R_KP] + j), kd = IN(mi[R_KD] + j), fl = IN(mi[R_FLIM] + j);
      const float td = fminf(fmaxf(kp * (IN(mi[R_TQ] + j) - qpos[j])
                                   + kd * (IN(mi[R_TV] + j) - qvel[j]), -fl), fl);
      const float lo = mf[mi[F_QLIM] + 2 * j], hi = mf[mi[F_QLIM] + 2 * j + 1];
      const float viol_lo = fmaxf(lo - qpos[j], 0.0f), viol_hi = fmaxf(qpos[j] - hi, 0.0f);
      const float in_viol = (viol_lo > 0.0f || viol_hi > 0.0f) ? 1.0f : 0.0f;
      const float t_lim = lim_k * (viol_lo - viol_hi) - lim_d * in_viol * qvel[j];
      const float jfric = mf[mi[F_JFRIC] + j];
      const float sat = fminf(fmaxf(qvel[j] / fvreg, -1.0f), 1.0f);
      const float in_band = fabsf(qvel[j]) < fvreg ? 1.0f : 0.0f;
      const float r = td + IN(mi[R_QF] + j) + t_lim - jfric * sat - tau_bias;
      rv[j] += r;
      rp[j] += r;
      A[TRI(j) + j] += h * (kp * h + kd) + h * mf[mi[F_JDAMP] + j] + 1e-6f
                       + h * in_band * jfric / fvreg + in_viol * (h * (lim_k * h + lim_d));
    }

    // ---------------- free-body diagonal blocks + rhs ([ω; v] order) -------
    for (int j = 0; j < F; ++j) {
      const Q4 q = ld4(fpose[j] + 3);
      float Iwj[6];
      rotate_inertia(q, finert[j], Iwj);
      const int o = nq + 6 * j;
      int u = 0;
      for (int c = 0; c < 3; ++c)
        for (int e = c; e < 3; ++e) A[TRI(o + e) + o + c] += Iwj[u++];
      for (int c = 0; c < 3; ++c) {
        A[TRI(o + c) + o + c] += 1e-9f;
        A[TRI(o + 3 + c) + o + 3 + c] += fmass[j] + 1e-9f;
      }
      const V3 w = ld3(fvel[j] + 3);
      const V3 gyro = cross(w, sym_apply(Iwj, w));
      rv[o] -= gyro.x; rv[o + 1] -= gyro.y; rv[o + 2] -= gyro.z;
      rp[o] -= gyro.x; rp[o + 1] -= gyro.y; rp[o + 2] -= gyro.z;
      rv[o + 3] += fmass[j] * gvec.x; rv[o + 4] += fmass[j] * gvec.y; rv[o + 5] += fmass[j] * gvec.z;
      rp[o + 3] += fmass[j] * gvec.x; rp[o + 4] += fmass[j] * gvec.y; rp[o + 5] += fmass[j] * gvec.z;
    }

    // ---------------- Cholesky pair solve (in place, lower packed) ---------
    // one factor, then the velocity and position right-hand sides, each
    // scaled by h (cholesky.cuh)
    chol_factor(A, dinv, n_all);
    chol_solve(A, dinv, rv, n_all, h);
    chol_solve(A, dinv, rp, n_all, h);

    // ---------------- integration ----------------
    for (int j = 0; j < nq; ++j) {
      qpos[j] += h * (qvel[j] + rp[j]);  // positions take the bias-inclusive pass
      qvel[j] += rv[j];
    }
    for (int j = 0; j < F; ++j) {
      const int o = nq + 6 * j;
      float wn[3], vn[3], wi[3], vi[3];
      for (int c = 0; c < 3; ++c) {
        wn[c] = fvel[j][3 + c] + rv[o + c];
        vn[c] = fvel[j][c] + rv[o + 3 + c];
        wi[c] = fvel[j][3 + c] + rp[o + c];
        vi[c] = fvel[j][c] + rp[o + 3 + c];
      }
      // velocity clamps: s = min(1, cap / |v|)
      const float swn = fminf(1.0f, max_w * rsqrtf(wn[0] * wn[0] + wn[1] * wn[1] + wn[2] * wn[2] + 1e-24f));
      const float svn = fminf(1.0f, max_v * rsqrtf(vn[0] * vn[0] + vn[1] * vn[1] + vn[2] * vn[2] + 1e-24f));
      const float swi = fminf(1.0f, max_w * rsqrtf(wi[0] * wi[0] + wi[1] * wi[1] + wi[2] * wi[2] + 1e-24f));
      const float svi = fminf(1.0f, max_v * rsqrtf(vi[0] * vi[0] + vi[1] * vi[1] + vi[2] * vi[2] + 1e-24f));
      for (int c = 0; c < 3; ++c) {
        fpose_n[j][c] = fpose[j][c] + h * (vi[c] * svi);
        fvel[j][c] = vn[c] * svn;
        fvel[j][3 + c] = wn[c] * swn;
      }
      // q' = normalize(exp(h ω) ∘ q)
      const V3 hw = mk3(h * wi[0] * swi, h * wi[1] * swi, h * wi[2] * swi);
      const float angle = sqrtf(dot(hw, hw) + 1e-18f);
      const float hf = 0.5f * angle;
      const float kq = sinf(hf) / angle;
      const Q4 e = {cosf(hf), hw.x * kq, hw.y * kq, hw.z * kq};
      Q4 qn = qmul(e, ld4(fpose[j] + 3));
      const float inv = 1.0f / fmaxf(sqrtf(qn.w * qn.w + qn.x * qn.x + qn.y * qn.y + qn.z * qn.z), 1e-12f);
      fpose_n[j][3] = qn.w * inv;
      fpose_n[j][4] = qn.x * inv;
      fpose_n[j][5] = qn.y * inv;
      fpose_n[j][6] = qn.z * inv;
    }

    // ------- pass 2: forces at the new velocities -> warm-start update -------
    for (int i = 0; i < nq; ++i) {
      vbw[i] = scl(cw[i], qvel[i]);
      vbv[i] = scl(cv[i], qvel[i]);
      if (parent[i] >= 0) {
        vbw[i] = add(vbw[parent[i]], vbw[i]);
        vbv[i] = add(vbv[parent[i]], vbv[i]);
      }
    }
    for (int p = 0; p < P; ++p) {
      PointCtx x;
      x.ct = contact_point(pfn[p], pga[p], pgb[p], pcorner[p], gp, gq, gsz, ghull, in + k, Ks,
                         mi);
      const V3 pos = x.ct.pos, nrm = x.ct.nrm;
      const float dep = x.ct.dep;
      x.rel = sub(pos, ref);
      x.lam = OUT(mi[S_LAM] + p);
      V3 lt = mk3(OUT(mi[S_LAMT] + p), OUT(mi[S_LAMT] + P + p), OUT(mi[S_LAMT] + 2 * P + p));
      x.lt = sub(lt, scl(nrm, dot(lt, nrm)));
      x.active = (float)(dep > -margin);
      const float spec = fminf(dep, 0.0f) / h;
      x.t_vel = spec;
      x.t_pos = spec + fminf(beta * fmaxf(dep, 0.0f) / h, bias_max);
      x.dn0 = dn0[p];
      x.mu = cmu[p];
      // free-body arms use the pre-integration poses (fpose, not fpose_n)
      V3 vrel = sub(side_vel(pra[p], pfa[p], pos, x.rel, vbw, vbv, fpose, fvel),
                    side_vel(prb[p], pfb[p], pos, x.rel, vbw, vbv, fpose, fvel));
      const float v_n = dot(vrel, nrm);
      Forces f = forces_at(x, v_n, sub(vrel, scl(nrm, v_n)));
      // memory only for touching points, ramped over 1 mm
      const float touch = fminf(fmaxf(1.0f + dep / 1e-3f, 0.0f), 1.0f);
      OUT(mi[S_LAM] + p) = fmaxf((1.0f - relax) * x.lam + relax * f.fn_vel, 0.0f) * touch;
      OUT(mi[S_LAMT] + p) = ((1.0f - relax) * x.lt.x + relax * f.ft.x) * touch;
      OUT(mi[S_LAMT] + P + p) = ((1.0f - relax) * x.lt.y + relax * f.ft.y) * touch;
      OUT(mi[S_LAMT] + 2 * P + p) = ((1.0f - relax) * x.lt.z + relax * f.ft.z) * touch;
    }
    for (int j = 0; j < F; ++j)
      for (int c = 0; c < 7; ++c) fpose[j][c] = fpose_n[j][c];
  }

  for (int i = 0; i < nq; ++i) {
    OUT(mi[S_QPOS] + i) = qpos[i];
    OUT(mi[S_QVEL] + i) = qvel[i];
  }
  for (int j = 0; j < F; ++j) {
    for (int c = 0; c < 7; ++c) OUT(mi[S_FPOSE] + 7 * j + c) = fpose[j][c];
    for (int c = 0; c < 6; ++c) OUT(mi[S_FVEL] + 6 * j + c) = fvel[j][c];
  }
#undef IN
#undef OUT
}

// Launch on the caller's stream; returns cudaGetLastError() of the launch.
extern "C" int mk_step(const float* in, float* out, const float* mf, const int* mi,
                       int K, int n_substeps, int block, void* stream) {
  const int grid = (K + block - 1) / block;
  mk_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, out, mf, mi, K, n_substeps);
  return (int)cudaGetLastError();
}

extern "C" const char* mk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
