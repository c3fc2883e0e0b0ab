// A chain of per-row stage bodies, applied in one pass.
//
// Replaces the TPU kernel keystone_tpu/ops/chain_kernels.py::
// elementwise_chain_pallas (:504-577, stage bodies :157-250). For x
// (N, ...) f32, every row goes through the chain's stages in order:
//
//   PixelScaler       v / 255
//   GrayScaler        0.299 v[3j] + 0.587 v[3j+1] + 0.114 v[3j+2]
//                     (the identity on a last axis of 1)
//   Image/MatrixVectorizer   nothing (the row is already flat)
//   LinearRectifier   max(mv, v - alpha)
//   NormalizeRows     v / max(sqrt(sum of v^2 over the row), eps)
//   SignedHellinger   sign(v) sqrt(|v|)
//   RandomSign        v * s[e % D]
//   StandardScaler    (v - mean[e % D]) / std[e % D], or v - mean[e % D]
//
// where e is the element's index in the row and D the length of the
// row's last axis as the stage sees it (the vectors broadcast along the
// last axis, as the JAX bodies' (1, D) operands do). A masked stage
// multiplies its output by the row's mask value (1 without a mask), at
// its place in the chain.
//
// Bound: the kernel moves bytes. Each input row is read once and each
// output row written once; at LinearPixels' (4096,32,32,3) -> (4096,1024)
// that is 67 MB, about 0.020 ms at 3.35 TB/s. The operations, a few per
// element, are far below the card's rate.
//
// Design. One block owns one row and keeps it in shared memory from its
// load to its store, so the chain's intermediates never reach device
// memory: the block applies each stage in place, one thread per element
// in strides of the block. The GrayScaler is the one stage that
// shortens the row; it writes into a second buffer and the two swap.
// NormalizeRows is a block-wide sum of squares (warp shuffles, then one
// warp over the warps' sums). The chain arrives by value as a small
// table of stage codes, row lengths, broadcast periods, offsets into one
// packed f32 buffer of the stages' vectors, the stages' scalars and the
// mask flags. The wrapper sizes the two buffers and refuses a row that
// does not fit the block's shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_STAGES = 16;
constexpr int THREADS = 256;

enum StageCode {
  kPixelScaler = 0,
  kGrayScaler = 1,
  kVectorizer = 2,
  kLinearRectifier = 3,
  kNormalizeRows = 4,
  kSignedHellinger = 5,
  kRandomSign = 6,
  kStandardScale = 7,
  kStandardCenter = 8,
};

struct Chain {
  int num_stages;
  int code[MAX_STAGES];
  int len[MAX_STAGES];     // row length entering the stage
  int last[MAX_STAGES];    // last-axis length entering the stage
  int off[MAX_STAGES];     // offset of the stage's vectors in params
  int masked[MAX_STAGES];
  float s0[MAX_STAGES];    // LinearRectifier mv, NormalizeRows eps
  float s1[MAX_STAGES];    // LinearRectifier alpha
};

__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : v);  // keeps 0, -0 and NaN
}

__global__ void __launch_bounds__(THREADS)
elementwise_chain_kernel(const float* __restrict__ x,
                         const float* __restrict__ mask,
                         const float* __restrict__ params,
                         float* __restrict__ out, int in_len, int out_len,
                         int buf0_len, int buf1_len, Chain chain) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;
  float* other = smem + buf0_len;
  float* scratch = other + buf1_len;
  const size_t row = blockIdx.x;
  const float* xr = x + row * in_len;
  const int t = threadIdx.x;

  if ((in_len & 3) == 0 && ((size_t)xr & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* c4 = reinterpret_cast<float4*>(cur);
    for (int i = t; i < (in_len >> 2); i += THREADS) c4[i] = x4[i];
  } else {
    for (int i = t; i < in_len; i += THREADS) cur[i] = xr[i];
  }
  __syncthreads();
  const float m = mask != nullptr ? mask[row] : 1.f;

  for (int s = 0; s < chain.num_stages; ++s) {
    const int code = chain.code[s];
    const int len = chain.len[s];
    const int last = chain.last[s];
    const bool masked = chain.masked[s] != 0;
    const float* vec = params + chain.off[s];
    if (code == kGrayScaler && last == 3) {
      const int n_out = len / 3;
      for (int i = t; i < n_out; i += THREADS) {
        float v = __fadd_rn(__fadd_rn(__fmul_rn(cur[3 * i], 0.299f),
                                      __fmul_rn(cur[3 * i + 1], 0.587f)),
                            __fmul_rn(cur[3 * i + 2], 0.114f));
        other[i] = masked ? v * m : v;
      }
      float* tmp = cur;
      cur = other;
      other = tmp;
    } else if (code == kNormalizeRows) {
      float ss = 0.f;
      for (int i = t; i < len; i += THREADS) ss += cur[i] * cur[i];
      const float denom = fmaxf(sqrtf(block_sum(ss, scratch)), chain.s0[s]);
      for (int i = t; i < len; i += THREADS) {
        const float v = cur[i] / denom;
        cur[i] = masked ? v * m : v;
      }
    } else {
      for (int i = t; i < len; i += THREADS) {
        float v = cur[i];
        switch (code) {
          case kPixelScaler:
            v = v / 255.f;
            break;
          case kLinearRectifier: {
            const float r = v - chain.s1[s];
            v = r != r ? r : fmaxf(chain.s0[s], r);
            break;
          }
          case kSignedHellinger:
            v = sign_of(v) * sqrtf(fabsf(v));
            break;
          case kRandomSign:
            v = v * vec[i % last];
            break;
          case kStandardScale:
            v = (v - vec[i % last]) / vec[last + i % last];
            break;
          case kStandardCenter:
            v = v - vec[i % last];
            break;
          default:  // the vectorizers, a GrayScaler on one channel
            break;
        }
        cur[i] = masked ? v * m : v;
      }
    }
    __syncthreads();
  }

  float* orow = out + row * out_len;
  if ((out_len & 3) == 0 && ((size_t)orow & 15) == 0 &&
      ((size_t)cur & 15) == 0) {
    const float4* c4 = reinterpret_cast<const float4*>(cur);
    float4* o4 = reinterpret_cast<float4*>(orow);
    for (int i = t; i < (out_len >> 2); i += THREADS) o4[i] = c4[i];
  } else {
    for (int i = t; i < out_len; i += THREADS) orow[i] = cur[i];
  }
}

}  // namespace

extern "C" {

int keystone_elementwise_chain_max_stages() { return MAX_STAGES; }

// x (N, in_len) -> out (N, out_len); float32, contiguous, on the device.
// mask (N,) f32 or null; params: the stages' vectors, packed. The
// per-stage tables have num_stages entries. buf0_len and buf1_len are the
// two row buffers' lengths in floats, multiples of 4. Launches on
// `stream` and returns the first CUDA error, or 0.
int keystone_elementwise_chain(const void* x, const void* mask,
                               const void* params, void* out, int n,
                               int in_len, int out_len, int buf0_len,
                               int buf1_len, int num_stages,
                               const int* codes, const int* lens,
                               const int* lasts, const int* offs,
                               const int* masked, const float* s0,
                               const float* s1, void* stream) {
  if (num_stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  Chain chain = {};
  chain.num_stages = num_stages;
  for (int s = 0; s < num_stages; ++s) {
    chain.code[s] = codes[s];
    chain.len[s] = lens[s];
    chain.last[s] = lasts[s];
    chain.off[s] = offs[s];
    chain.masked[s] = masked[s];
    chain.s0[s] = s0[s];
    chain.s1[s] = s1[s];
  }
  const size_t smem = (size_t)(buf0_len + buf1_len + 32) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      elementwise_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  elementwise_chain_kernel<<<n, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)mask, (const float*)params,
      (float*)out, in_len, out_len, buf0_len, buf1_len, chain);
  return (int)cudaGetLastError();
}

const char* keystone_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
