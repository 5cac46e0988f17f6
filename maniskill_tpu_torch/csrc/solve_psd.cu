// Batched small SPD solve A x = b for Hopper (sm_90a), one system per thread.
//
// Replaces the Pallas TPU kernel maniskill_tpu/physics/pallas_kernels.py
// (_solve_kernel, launched by solve_psd_pallas): a column Cholesky with the
// pivot clamp max(s, 1e-12) and a reciprocal square root, then forward and
// back substitution. It computes what maniskill_tpu_torch/physics/linalg.py
// solve_psd computes; the factor and the substitution are the routines the
// physics mega-kernel's pair solve uses (cholesky.cuh).
//
// Layout: env-last, as the TPU kernel's. The matrix plane At is (n*n, K)
// with row j*n + i holding A[k, i, j] for system k, so that the 32 threads
// of a warp read 32 neighbouring floats of one row; b and x are (n, K).
// Only the lower triangle (i >= j) is read.
//
// What bounds it on this card: bytes. Per system it reads n(n+1)/2 of the
// n^2 matrix entries and n of b and writes n of x, against n^3/3 + 2 n^2
// operations: at n = 21 that is ~3,900 operations on ~1,900 bytes moved,
// two operations per byte, far under the card's 67 TFLOP/s over 3.35 TB/s
// = 20. A thread-per-system design with coalesced env-last loads matches
// that: the loads are full 128-byte lines per warp, and the factor runs
// from the thread's own (local, L1-cached) array. n is at most N_MAX.

#include <cuda_runtime.h>

#include "cholesky.cuh"

#define N_MAX 32

__global__ void __launch_bounds__(128) solve_psd_kernel(const float* __restrict__ At,
                                                        const float* __restrict__ bt,
                                                        float* __restrict__ xt, int n,
                                                        int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;  // ragged edge: no padding, the tail threads exit
  const size_t Ks = (size_t)K;
  float L[TRI(N_MAX)], dinv[N_MAX], x[N_MAX];
  for (int j = 0; j < n; ++j)
    for (int i = j; i < n; ++i) L[TRI(i) + j] = At[(size_t)(j * n + i) * Ks + k];
  for (int i = 0; i < n; ++i) x[i] = bt[(size_t)i * Ks + k];
  chol_factor(L, dinv, n);
  chol_solve(L, dinv, x, n, 1.0f);
  for (int i = 0; i < n; ++i) xt[(size_t)i * Ks + k] = x[i];
}

// Launch on the caller's stream; returns cudaGetLastError() of the launch.
extern "C" int solve_psd(const float* At, const float* bt, float* xt, int n, int K, int block,
                         void* stream) {
  const int grid = (K + block - 1) / block;
  solve_psd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(At, bt, xt, n, K);
  return (int)cudaGetLastError();
}

extern "C" const char* solve_psd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
