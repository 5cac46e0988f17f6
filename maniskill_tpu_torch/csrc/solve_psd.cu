// Batched small SPD solve A x = b for Hopper (sm_90a), one warp per system.
//
// Replaces the Pallas TPU kernel maniskill_tpu/physics/pallas_kernels.py
// (_solve_kernel, launched by solve_psd_pallas) and computes what it
// computes: a column Cholesky whose diagonal is L_jj = s * rsqrt(max(s,
// 1e-12)) (the clamp only guards the square root: a negative pivot gives a
// negative L_jj, a zero pivot a zero one), then forward and back
// substitution that divide by L_jj. Only the lower triangle of A is read.
// maniskill_tpu_torch/physics/linalg.py solve_psd is its plain version.
//
// Layout: solve_psd_pallas's own arguments, row-major and contiguous: A is
// (K, n, n) and b and x are (K, n). The TPU kernel wanted the env-last
// planes (one env a VPU lane); a warp here reads one system's row-major
// matrix, neighbouring lanes on neighbouring addresses, so the caller makes
// no transposing copy.
//
// The design. A block holds `warps` warps and each warp owns one system: it
// copies the lower triangle (row i's first i + 1 floats) into its slice of
// shared memory, and lane i then owns row i (n <= 32) and keeps it
// in registers. The kernel is compiled for each n from 1 to 32, so every
// loop below is unrolled and a row's entries are registers of fixed names.
// Column j is one step: every lane takes its row's dot product with row j
// (row j read from shared memory 4 entries a 16-byte load, all lanes on one
// address), lane j's reciprocal square root goes to the others by a
// shuffle, and lane i writes L_ij to its register and to the slice, where
// the later steps read it. The forward substitution runs in the same step
// (lane j finishes y_j = r_j / L_jj, the lanes below take r_i -= L_ij y_j,
// the TPU kernel's residual form), and the back substitution runs across
// lanes too (lane j finishes x_j, the lanes above take s_i -= L_ji x_j). A
// warp's steps are about n^2 / 2 multiply-adds a lane, against a thread per
// system's n^3 / 3. Warps past K exit, and nothing waits on them: no
// block-wide barrier.
//
// What bounds it on this card: bytes. Per system it reads the n(n+1)/2
// entries of the lower triangle and n of b and writes n of x, against n^3/3
// + 2 n^2 operations: at n = 21 about 3,900 operations on about 1,100 bytes,
// under 4 operations a byte, far below the card's 67 TFLOP/s over 3.35 TB/s
// = 20. What holds it back is instruction issue: a warp issues every step
// for all 32 lanes, of which n - j work in column j, and each column adds
// two shuffles, a reciprocal square root and a reciprocal. MIN_BLOCKS caps
// the registers at 64 a thread, so that 32 warps share an SM: measured
// against no cap (up to 124 registers) and caps of 51 and 85, it is the
// fastest at K = 65536 (PERF.md).
//
// Measured and not kept (PERF.md): the asynchronous form, a persistent grid
// in which each warp copies its next system's lower triangle with cp.async
// while it factors the current one, was slower than these plain loads at
// K = 65536. To measure a variant, edit it into one checkout and run
// solve_ab.py --parent against the other.

#include <cuda_runtime.h>

#define MIN_BLOCKS 4  // resident blocks of 256 threads an SM: at most 64 registers
#define FULL 0xffffffffu

// A warp's slice holds n rows of row_stride(n) floats: a multiple of 4, so a
// row starts 16-byte aligned, and an odd number of 16-byte units, so that 8
// lanes reading 16 bytes each from 8 rows fall on 8 distinct bank groups.
__host__ __device__ constexpr int row_stride(int n) { return 4 * (((n + 3) / 4) | 1); }

// Copy the lower triangle of one row-major N x N matrix into L (row stride
// S): the warp walks the matrix's N*N floats 32 at a time, and a lane keeps
// entry (i, j) only if j <= i.
template <int N>
__device__ __forceinline__ void load_lower(float* L, const float* __restrict__ A, int lane) {
  constexpr int S = row_stride(N), q = 32 / N, r = 32 % N;  // 32 floats on: q rows, r columns
  int i = lane / N, j = lane % N;
#pragma unroll
  for (int e0 = 0; e0 < N * N; e0 += 32) {
    const int e = e0 + lane;
    if (e < N * N && j <= i) L[i * S + j] = A[e];
    i += q;
    j += r;
    if (j >= N) {
      j -= N;
      ++i;
    }
  }
}

// Factor the warp's matrix in L and solve with lane i's entry b_i of the
// right-hand side; returns x_i on lane i < N. Every lane of the warp calls
// it. Lane i keeps its row in registers (a[k], compile-time k); the rows
// other lanes read (row j for column j, and L_ji in the back substitution)
// come from L, where lane i writes each L_ij it finds.
template <int N>
__device__ __forceinline__ float factor_solve(float* L, float b_i, int lane) {
  constexpr int S = row_stride(N);
  const float* own = L + (lane < N ? lane : N - 1) * S;  // lanes past N hold a copy of row N-1
  float a[N];
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(own + k);
    a[k] = v.x;
    if (k + 1 < N) a[k + 1] = v.y;
    if (k + 2 < N) a[k + 2] = v.z;
    if (k + 3 < N) a[k + 3] = v.w;
  }
  // entries past lane i's diagonal are the strict upper triangle's unread
  // slots: lane i computes with them only in columns j > i, whose results
  // it never uses
  float r = b_i;     // the forward residual; y_i once step i is done
  float dinv = 0.0f; // 1 / L_ii
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float* Lj = L + j * S;
    float s = a[j];
#pragma unroll
    for (int k = 0; k + 4 <= j; k += 4) {
      const float4 c = *reinterpret_cast<const float4*>(Lj + k);
      s = fmaf(-a[k], c.x, s);
      s = fmaf(-a[k + 1], c.y, s);
      s = fmaf(-a[k + 2], c.z, s);
      s = fmaf(-a[k + 3], c.w, s);
    }
#pragma unroll
    for (int k = j & ~3; k < j; ++k) s = fmaf(-a[k], Lj[k], s);
    // the pivot clamp max(s, 1e-12) as jnp.maximum takes it: a NaN pivot
    // stays NaN (fmaxf would return the bound)
    const float p = s < 1e-12f ? 1e-12f : s;
    const float l = s * __shfl_sync(FULL, rsqrtf(p), j);  // L_ij on lanes i >= j
    a[j] = l;
    // divide by L_jj: 1 / 0 is inf, so a zero pivot gives inf and NaN as
    // the division does (the reciprocal is within 2 ulp)
    const float inv = __fdividef(1.0f, l);
    if (lane == j) {
      dinv = inv;
      r *= inv;
    }
    const float y = __shfl_sync(FULL, r, j);
    if (lane > j && lane < N) {
      r = fmaf(-l, y, r);
      L[lane * S + j] = l;
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    if (lane == j) r *= dinv;
    const float x = __shfl_sync(FULL, r, j);
    if (lane < j) r = fmaf(-L[j * S + lane], x, r);
  }
  return r;
}

template <int N>
__global__ void __launch_bounds__(256, MIN_BLOCKS)
    solve_psd_kernel(const float* __restrict__ A, const float* __restrict__ b,
                     float* __restrict__ x, int K) {
  extern __shared__ float4 smem[];
  constexpr int S = row_stride(N), NN = N * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  float* L = reinterpret_cast<float*>(smem) + warp * N * S;
  size_t k = (size_t)blockIdx.x * warps + warp;
  if (k >= (size_t)K) return;  // ragged edge: no padding, these warps just exit
  const float bi = lane < N ? b[k * N + lane] : 0.0f;
  load_lower<N>(L, A + k * NN, lane);
  __syncwarp();
  const float xi = factor_solve<N>(L, bi, lane);
  if (lane < N) x[k * N + lane] = xi;
}

// A block of `warps` <= 8 warps (the launch bound) takes at most 8 * 32 * 36
// floats, 36,864 bytes of shared memory: under the 48 KB a launch may ask for
// without opting in.
template <int N>
static int launch(const float* A, const float* b, float* x, int K, int warps,
                  cudaStream_t stream) {
  const int smem = warps * N * row_stride(N) * (int)sizeof(float);
  const int grid = (K + warps - 1) / warps;
  solve_psd_kernel<N><<<grid, 32 * warps, smem, stream>>>(A, b, x, K);
  return (int)cudaGetLastError();
}

// Launch on the caller's stream; returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for n outside 1..32).
extern "C" int solve_psd(const float* A, const float* b, float* x, int n, int K, int warps,
                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define CASE(N) \
  case N:       \
    return launch<N>(A, b, x, K, warps, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
    CASE(17) CASE(18) CASE(19) CASE(20) CASE(21) CASE(22) CASE(23) CASE(24)
    CASE(25) CASE(26) CASE(27) CASE(28) CASE(29) CASE(30) CASE(31) CASE(32)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* solve_psd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
