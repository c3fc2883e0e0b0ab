// RBF kernel block: a float32 "NT" matrix product with the Gaussian
// epilogue fused before the write.
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_kernels.py::
// rbf_block_pallas (:212-246, body _rbf_kernel :194-209). For X (m,d),
// Y (n,d) f32 and the rows' squared norms x2 (m,), y2 (n,), computed
// outside the kernel as the JAX wrapper computes them outside its
// pallas_call (:223-225):
//
//   acc[i,j] = sum_k X[i,k] * Y[j,k]                     (fp32 FMAs)
//   out[i,j] = exp(-gamma * max(x2[i] + y2[j] - 2 acc[i,j], 0))
//
// Bound: operations. At the fit's X (50000,2048) by Y (2048,2048) the
// product is 2*m*n*d = 419 GFLOP, 6.26 ms at the H100's 67 TFLOP/s fp32
// rate, against 0.85 GB of inputs and output (0.25 ms at 3.35 TB/s).
// The contract is true fp32, as the TPU kernel runs its product at
// Precision.HIGHEST: TF32 tensor cores (about 3 decimal digits) would
// break the diagonal, where x2 + y2 - 2 acc cancels.
//
// Design: a classic tiled fp32 GEMM on the CUDA cores. A block of 256
// threads owns a 128x128 output tile and walks d in steps of 8; each
// step stages an 8-deep slice of X's and Y's rows in shared memory,
// transposed so that a thread reads its rows and columns as float4. Each
// thread keeps an 8x8 register tile of sums (rows ty*4+{0..3} and
// 64+ty*4+{0..3}, columns likewise), so one shared-memory read feeds
// eight FMAs. The next slice is fetched from device memory into
// registers while the current one is consumed, into the second of two
// shared-memory buffers. Ragged edges load zeros and store nothing. The
// epilogue runs in registers and the tile is written once. mma, wgmma
// and a 3xTF32 split are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;      // rows of X per block
constexpr int BN = 128;      // rows of Y per block
constexpr int BK = 8;        // depth per step
constexpr int PAD = 4;       // keeps the transposed stores conflict-free
constexpr int THREADS = 256;
constexpr int LOADS = BM * BK / THREADS;  // values of each operand a
                                          // thread fetches per step

__global__ void __launch_bounds__(THREADS, 2)
rbf_block_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                 const float* __restrict__ x2, const float* __restrict__ y2,
                 float* __restrict__ out, int m, int n, int d, float gamma) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  // loader: thread fetches depth lk of rows lr, lr+32, lr+64, lr+96
  const int lk = tid & (BK - 1), lr = tid >> 3;

  float ra[LOADS], rb[LOADS];
  auto fetch = [&](int k0) {
    const int k = k0 + lk;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int r = lr + 32 * i;
      ra[i] = (m0 + r < m && k < d) ? X[(size_t)(m0 + r) * d + k] : 0.f;
      rb[i] = (n0 + r < n && k < d) ? Y[(size_t)(n0 + r) * d + k] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      As[buf][lk][lr + 32 * i] = ra[i];
      Bs[buf][lk][lr + 32 * i] = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int steps = (d + BK - 1) / BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) fetch((s + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < steps) stash(buf ^ 1);
    __syncthreads();
  }

  float yy[8];
  int cols[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cols[j] = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    yy[j] = cols[j] < n ? y2[cols[j]] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
    const float xx = x2[row];
    float* orow = out + (size_t)row * n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (cols[j] < n) {
        const float d2 = (xx + yy[j]) - 2.f * acc[i][j];
        orow[cols[j]] = expf(-gamma * fmaxf(d2, 0.f));
      }
    }
  }
}

}  // namespace

extern "C" {

// X (m,d), Y (n,d), x2 (m,), y2 (n,) -> out (m,n); float32, contiguous,
// on the device. Launches on `stream` and returns cudaGetLastError().
int keystone_rbf_block(const void* X, const void* Y, const void* x2,
                       const void* y2, void* out, int m, int n, int d,
                       float gamma, void* stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  rbf_block_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)Y, (const float*)x2, (const float*)y2,
      (float*)out, m, n, d, gamma);
  return (int)cudaGetLastError();
}

const char* keystone_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
