// Column Cholesky factor and substitution for small SPD systems, used by
// the physics mega-kernel (megakernel.cu: the pair solve of K2,
// maniskill_tpu/physics/megakernel.py), whose JAX kernel factors column by
// column with the pivot clamp max(s, 1e-12) and a reciprocal square root
// and keeps the clamped pivot as the diagonal.
//
// The matrix is lower triangle packed by rows: entry (i, j), j <= i, at
// A[TRI(i) + j]; at n <= 32 that is at most 528 floats. chol_factor_warp
// factors it by the 32 lanes of a warp on a matrix in shared memory;
// chol_solve runs in one thread. The batched SPD solve (solve_psd.cu, K1)
// has its own factor: its TPU kernel keeps the unclamped pivot.
#pragma once

#define TRI(i) ((i) * ((i) + 1) / 2)

// A = L Lᵀ in place by a warp (dinv[j] = 1 / L_jj): column jc is one step,
// lane i computes row i >= jc with its dot product over kk ascending (lane
// jc the pivot), so every entry gets the bits of a one-thread column loop.
// n <= 32; every lane of the warp calls it; A and dinv are in shared memory.
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
