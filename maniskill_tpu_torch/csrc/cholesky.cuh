// Column Cholesky factor and substitution for small SPD systems, one system
// per thread. Shared by the physics mega-kernel (megakernel.cu: the pair
// solve of K2, maniskill_tpu/physics/megakernel.py) and the batched
// SPD-solve kernel (solve_psd.cu: K1, maniskill_tpu/physics/
// pallas_kernels.py:_solve_kernel). Both TPU kernels factor column by
// column with the pivot clamp max(s, 1e-12) and a reciprocal square root.
//
// The matrix is lower triangle packed by rows: entry (i, j), j <= i, at
// A[TRI(i) + j]; at n <= 32 that is at most 528 floats. chol_factor and
// chol_solve run in one thread on its own array (K1 keeps it in local
// memory); chol_factor_warp is the same factor by the 32 lanes of a warp on
// a matrix in shared memory (K2), bit for bit.
#pragma once

#define TRI(i) ((i) * ((i) + 1) / 2)

// A = L Lᵀ in place: A is overwritten by L and dinv[j] = 1 / L_jj.
__device__ __forceinline__ void chol_factor(float* A, float* dinv, int n) {
  for (int jc = 0; jc < n; ++jc) {
    float s0 = A[TRI(jc) + jc];
    for (int kk = 0; kk < jc; ++kk) s0 -= A[TRI(jc) + kk] * A[TRI(jc) + kk];
    const float sc = fmaxf(s0, 1e-12f);
    const float di = rsqrtf(sc);
    dinv[jc] = di;
    A[TRI(jc) + jc] = sc * di;
    for (int i = jc + 1; i < n; ++i) {
      float s2 = A[TRI(i) + jc];
      for (int kk = 0; kk < jc; ++kk) s2 -= A[TRI(i) + kk] * A[TRI(jc) + kk];
      A[TRI(i) + jc] = s2 * di;
    }
  }
}

// chol_factor by a warp: column jc is one step, lane i computes row i >= jc
// with its dot product over kk in chol_factor's order (lane jc the pivot),
// so every entry gets the same bits. n <= 32; every lane of the warp calls
// it; A and dinv are in shared memory.
__device__ __forceinline__ void chol_factor_warp(float* A, float* dinv, int n, int lane) {
  for (int jc = 0; jc < n; ++jc) {
    float s = 0.0f;
    if (lane >= jc && lane < n) {
      s = A[TRI(lane) + jc];
      for (int kk = 0; kk < jc; ++kk) s -= A[TRI(lane) + kk] * A[TRI(jc) + kk];
    }
    const float sc = fmaxf(s, 1e-12f);
    const float di = __shfl_sync(0xffffffffu, rsqrtf(sc), jc);
    if (lane == jc) {
      dinv[jc] = di;
      A[TRI(jc) + jc] = sc * di;
    } else if (lane > jc && lane < n) {
      A[TRI(lane) + jc] = s * di;
    }
    __syncwarp();
  }
}

// Solve L Lᵀ x = scale * b in place (x holds b on entry): forward
// substitution L y = scale * b, then back substitution Lᵀ x = y.
__device__ __forceinline__ void chol_solve(const float* L, const float* dinv, float* x,
                                           int n, float scale) {
  for (int i = 0; i < n; ++i) {
    float s = x[i] * scale;
    for (int kk = 0; kk < i; ++kk) s -= L[TRI(i) + kk] * x[kk];
    x[i] = s * dinv[i];
  }
  for (int i = n - 1; i >= 0; --i) {
    float s = x[i];
    for (int kk = i + 1; kk < n; ++kk) s -= L[TRI(kk) + i] * x[kk];
    x[i] = s * dinv[i];
  }
}
