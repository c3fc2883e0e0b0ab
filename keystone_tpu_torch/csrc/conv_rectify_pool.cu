// Fused conv + patch-mean correction + two-sided rectify + sum pool.
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_kernels.py::
// conv_rectify_pool_pallas (:591-659, body _conv_rect_pool_kernel
// :482-526). For images (N,H,W,C) f32 and a folded filter bank G (D,K)
// whose rows are in channel-major C·P·P order (hwio_to_cmajor):
//
//   z[p,f]   = sum_d bf16(patch_p[d]) * bf16(G[d,f])       (fp32 sums)
//   z[p,f]  -= mean_d(bf16(patch_p)) * colsum[f]            (if normalize)
//   z[p,f]  += bias[f]
//   out[n,cy,cx,f]   = sum_{p in window(cy,cx)} max(mv,  z[p,f] - alpha)
//   out[n,cy,cx,K+f] = sum_{p in window(cy,cx)} max(mv, -z[p,f] - alpha)
//
// Operands are rounded to bf16 as the TPU kernel feeds its matrix unit;
// a bf16 x bf16 product is exact in fp32, so fp32 FMAs on the rounded
// values give the same contract (bf16 operands, fp32 accumulation).
//
// Bound at the headline (per 2048-image microbatch, 32x32x3 images,
// P=6, K=256, 27x27 positions): 2·2048·729·108·256 ≈ 82.6 GFLOP, about
// 84 us at the H100's 989 TFLOP/s bf16 tensor-core peak, against about
// 42 MB of input and output (25 MB of images, 17 MB of pooled cells),
// about 13 us at 3.35 TB/s. The kernel is bound by operations.
//
// What this first design does about that bound: nothing yet. It runs
// the product on CUDA-core FMAs, not the tensor cores, so it can reach
// at best the 67 TFLOP/s fp32 rate. What it does keep is the fusion: the
// conv output and the channel-doubled activations live in registers and
// shared memory, and only the pooled (gy, gx, 2K) cells reach device
// memory. wgmma, TMA and an implicit-GEMM layout are later work.
//
// Design. One block owns one image and a tile of KT filters. The image
// and the filter tile are staged in shared memory, rounded to bf16. Each
// thread owns FT filters and computes a strip of PX neighbouring
// positions of one window row at a time (a register tile of FT x PX
// sums), so each shared-memory load feeds several FMAs. Work items are
// (pool cell, window row, column chunk); windows that overlap (pool 14,
// stride 13) recompute the shared positions, so every position is added
// into every cell whose window covers it. A thread sums its items' rows
// in registers and adds them into the block's per-cell sums in shared
// memory; the block writes its cells once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KT = 64;                 // filters per block
constexpr int FT = 4;                  // filters per thread
constexpr int FL = KT / FT;            // filter lanes
constexpr int PX = 4;                  // positions per thread per step
constexpr int NG = 16;                 // position groups per block
constexpr int THREADS = FL * NG;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(THREADS)
conv_rectify_pool_kernel(const float* __restrict__ images,
                         const float* __restrict__ g,
                         const float* __restrict__ colsum,
                         const float* __restrict__ bias,
                         float* __restrict__ out,
                         int h, int w, int c, int k, int patch, int pool,
                         int stride, int gy, int gx, float alpha,
                         float max_val, int normalize) {
  extern __shared__ float smem[];
  const int hwc = h * w * c;
  const int pp = patch * patch;
  const int d = c * pp;
  const int ph = h - patch + 1;
  const int pw = w - patch + 1;
  const int cells = gy * gx;
  float* img_s = smem;                  // hwc, bf16-rounded image
  float* g_s = img_s + hwc;             // d x KT, bf16-rounded filters
  float* mean_s = g_s + d * KT;         // ph x pw patch means
  float* acc_s = mean_s + ph * pw;      // cells x 2KT pooled sums

  const int n = blockIdx.x;
  const int k0 = blockIdx.y * KT;
  const int t = threadIdx.x;
  const float* img = images + (size_t)n * hwc;

  for (int i = t; i < hwc; i += THREADS) img_s[i] = bf16_round(img[i]);
  for (int i = t; i < d * KT; i += THREADS) {
    const int f = k0 + i % KT;
    g_s[i] = f < k ? bf16_round(g[(size_t)(i / KT) * k + f]) : 0.f;
  }
  for (int i = t; i < cells * 2 * KT; i += THREADS) acc_s[i] = 0.f;
  __syncthreads();

  if (normalize) {
    // mean of the bf16-rounded patch values, over d = C·P·P
    const float inv_d = 1.f / d;
    for (int p = t; p < ph * pw; p += THREADS) {
      const float* base = img_s + ((p / pw) * w + p % pw) * c;
      float s = 0.f;
      for (int ch = 0; ch < c; ++ch)
        for (int ii = 0; ii < patch; ++ii)
          for (int jj = 0; jj < patch; ++jj)
            s += base[(ii * w + jj) * c + ch];
      mean_s[p] = s * inv_d;
    }
    __syncthreads();
  }

  const int fl = t % FL;
  const int grp = t / FL;
  float cs[FT], bs[FT];
#pragma unroll
  for (int j = 0; j < FT; ++j) {
    const int f = k0 + fl + j * FL;
    cs[j] = (normalize && f < k) ? colsum[f] : 0.f;
    bs[j] = f < k ? bias[f] : 0.f;
  }

  const int chunks = (pool + PX - 1) / PX;
  const int items = cells * pool * chunks;
  float psum[FT], nsum[FT];
#pragma unroll
  for (int j = 0; j < FT; ++j) psum[j] = nsum[j] = 0.f;
  int cur_cell = -1;

  for (int it = grp; it < items; it += NG) {
    const int cell = it / (pool * chunks);
    const int r = (it / chunks) % pool;
    const int cx = (it % chunks) * PX;
    if (cell != cur_cell) {
      if (cur_cell >= 0) {
#pragma unroll
        for (int j = 0; j < FT; ++j) {
          atomicAdd(&acc_s[cur_cell * 2 * KT + fl + j * FL], psum[j]);
          atomicAdd(&acc_s[cur_cell * 2 * KT + KT + fl + j * FL], nsum[j]);
          psum[j] = nsum[j] = 0.f;
        }
      }
      cur_cell = cell;
    }
    const int y = (cell / gx) * stride + r;
    const int x = (cell % gx) * stride + cx;
    const int nq = min(PX, pool - cx);
    // positions past the window's edge re-read the strip's first
    // position, so no load leaves the image; their sums are dropped
    int qoff[PX];
#pragma unroll
    for (int q = 0; q < PX; ++q) qoff[q] = (q < nq ? q : 0) * c;

    float z[FT][PX];
#pragma unroll
    for (int j = 0; j < FT; ++j)
#pragma unroll
      for (int q = 0; q < PX; ++q) z[j][q] = 0.f;

    const float* gp = g_s + fl;
    for (int ch = 0; ch < c; ++ch) {
      for (int ii = 0; ii < patch; ++ii) {
        const float* row = img_s + ((y + ii) * w + x) * c + ch;
        for (int jj = 0; jj < patch; ++jj, gp += KT) {
          const float* src = row + jj * c;
          float a[PX], gv[FT];
#pragma unroll
          for (int q = 0; q < PX; ++q) a[q] = src[qoff[q]];
#pragma unroll
          for (int j = 0; j < FT; ++j) gv[j] = gp[j * FL];
#pragma unroll
          for (int j = 0; j < FT; ++j)
#pragma unroll
            for (int q = 0; q < PX; ++q) z[j][q] = fmaf(a[q], gv[j], z[j][q]);
        }
      }
    }

#pragma unroll
    for (int q = 0; q < PX; ++q) {
      if (q < nq) {
        const float m = normalize ? mean_s[y * pw + x + q] : 0.f;
#pragma unroll
        for (int j = 0; j < FT; ++j) {
          const float v = (z[j][q] - m * cs[j]) + bs[j];
          psum[j] += fmaxf(max_val, v - alpha);
          nsum[j] += fmaxf(max_val, -v - alpha);
        }
      }
    }
  }
  if (cur_cell >= 0) {
#pragma unroll
    for (int j = 0; j < FT; ++j) {
      atomicAdd(&acc_s[cur_cell * 2 * KT + fl + j * FL], psum[j]);
      atomicAdd(&acc_s[cur_cell * 2 * KT + KT + fl + j * FL], nsum[j]);
    }
  }
  __syncthreads();

  for (int i = t; i < cells * 2 * KT; i += THREADS) {
    const int cell = i / (2 * KT);
    const int half = (i / KT) % 2;
    const int f = k0 + i % KT;
    if (f < k)
      out[((size_t)n * cells + cell) * 2 * k + half * k + f] = acc_s[i];
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
size_t keystone_conv_rectify_pool_smem(int h, int w, int c, int patch,
                                       int gy, int gx) {
  const int ph = h - patch + 1, pw = w - patch + 1;
  return sizeof(float) * ((size_t)h * w * c + (size_t)c * patch * patch * KT +
                          (size_t)ph * pw + (size_t)gy * gx * 2 * KT);
}

// images (N,H,W,C), g (C·P·P, K), colsum (K,), bias (K,) -> out
// (N,gy,gx,2K); all float32, contiguous, on the device. Launches on
// `stream` and returns cudaGetLastError().
int keystone_conv_rectify_pool(const void* images, const void* g,
                               const void* colsum, const void* bias,
                               void* out, int n, int h, int w, int c, int k,
                               int patch, int pool, int stride, float alpha,
                               float max_val, int normalize, void* stream) {
  const int ph = h - patch + 1, pw = w - patch + 1;
  const int gy = (ph - pool) / stride + 1, gx = (pw - pool) / stride + 1;
  const size_t smem = keystone_conv_rectify_pool_smem(h, w, c, patch, gy, gx);
  cudaError_t err = cudaFuncSetAttribute(
      conv_rectify_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n, (k + KT - 1) / KT);
  conv_rectify_pool_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)images, (const float*)g, (const float*)colsum,
      (const float*)bias, (float*)out, h, w, c, k, patch, pool, stride, gy, gx,
      alpha, max_val, normalize);
  return (int)cudaGetLastError();
}

const char* keystone_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
