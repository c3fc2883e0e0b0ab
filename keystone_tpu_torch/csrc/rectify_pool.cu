// Two-sided rectify + sum pool.
//
// Replaces the TPU kernels keystone_tpu/ops/pallas_kernels.py::
// rectify_pool_pallas (:132-159, body :118-129) and, as a flatten of its
// output, keystone_tpu/ops/chain_kernels.py::rectify_pool_vectorize_pallas
// (:346-381). For x (N,H,W,K) f32:
//
//   out[n,cy,cx,f]   = sum_{(i,j) in window(cy,cx)} max(mv,  x[n,i,j,f] - alpha)
//   out[n,cy,cx,K+f] = sum_{(i,j) in window(cy,cx)} max(mv, -x[n,i,j,f] - alpha)
//
// Bound: the kernel moves bytes. At (2048,27,27,256) it reads 1.53 GB
// and writes 17 MB, about 0.46 ms at 3.35 TB/s; its four operations per
// input value are far below the card's rate.
//
// Design. A block owns one (image, pool cell) and a run of channels;
// one thread per channel walks the window, so each load of a window
// position is coalesced across the channels. Windows that overlap read
// the shared positions again (from L2 for the most part).

#include <cuda_runtime.h>

namespace {

__global__ void rectify_pool_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int h, int w,
                                    int k, int pool, int stride, int gy,
                                    int gx, float alpha, float max_val) {
  const int cells = gy * gx;
  const int n = blockIdx.x / cells;
  const int cell = blockIdx.x % cells;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  if (f >= k) return;
  const int y0 = (cell / gx) * stride;
  const int x0 = (cell % gx) * stride;
  const float* base = x + (((size_t)n * h + y0) * w + x0) * k + f;
  float ps = 0.f, ns = 0.f;
  for (int i = 0; i < pool; ++i) {
    const float* row = base + (size_t)i * w * k;
#pragma unroll 7
    for (int j = 0; j < pool; ++j) {
      const float v = row[(size_t)j * k];
      ps += fmaxf(max_val, v - alpha);
      ns += fmaxf(max_val, -v - alpha);
    }
  }
  float* o = out + ((size_t)n * cells + cell) * 2 * k + f;
  o[0] = ps;
  o[k] = ns;
}

}  // namespace

extern "C" {

// x (N,H,W,K) -> out (N,gy,gx,2K); float32, contiguous, on the device.
// Launches on `stream` and returns cudaGetLastError().
int keystone_rectify_pool(const void* x, void* out, int n, int h, int w, int k,
                          int pool, int stride, float alpha, float max_val,
                          void* stream) {
  const int gy = (h - pool) / stride + 1, gx = (w - pool) / stride + 1;
  const int threads = k >= 256 ? 256 : ((k + 31) / 32) * 32;
  dim3 grid(n * gy * gx, (k + threads - 1) / threads);
  rectify_pool_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, h, w, k, pool, stride, gy, gx, alpha,
      max_val);
  return (int)cudaGetLastError();
}

const char* keystone_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
