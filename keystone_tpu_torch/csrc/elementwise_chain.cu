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
// Bound: bytes. Each input row is read once and each output row written
// once; at LinearPixels' (4096,32,32,3) -> (4096,1024) that is 67 MB,
// 0.0200 ms at 3.35 TB/s. The operations, a few per element, are far
// below the card's rate. So the design keeps the memory system busy and
// touches each byte once:
//
// - Persistent grid. As many 128-thread blocks as the SMs hold at this
//   kernel's shared memory and registers; block b takes steps b,
//   b + grid, ... A step is one row, or several consecutive rows where
//   rows are short (below 4 KB), so that a step moves at least 16 KB,
//   as many rows for each of the block's four warps.
// - Copies in. A step arrives by one TMA bulk copy (cp.async.bulk) into
//   the block's slot of shared memory and completes on the slot's
//   mbarrier; a thread waits on the barrier, not on its own loads. A
//   block has one slot: the SM's other resident blocks (nine at
//   LinearPixels' rows, bound by registers) keep their copies in flight
//   while one block computes. A ring of two or three slots a block
//   measured slower at LinearPixels' rows (fewer resident blocks, or
//   more copies queued at a launch's start). A step whose first byte is
//   not 16-byte aligned (a row length that is not a multiple of 4, an
//   offset base) copies its head and tail, under 16 bytes each, with
//   plain loads, and reads its rows from shared memory one float at a
//   time.
// - The stages run as one pass in registers. A thread owns a unit of
//   four output values (twelve inputs before a three-channel
//   GrayScaler), reads it from shared memory once, applies every stage
//   to it and stores it straight to device memory as a float4. A
//   NormalizeRows needs the sum of squares of its input first: the
//   block runs the stages before it once more, only to sum (warp
//   shuffles, then one warp over the warps' sums), and the next pass
//   divides. Rows that share a step take a warp each, so their sums
//   need only shuffles.
// - Order of operations as in the plain version: multiplications and
//   additions are written __fmul_rn/__fadd_rn so that no two stages
//   contract into one FMA; only the norm's order of summation differs.
//
// The host builds a plan once per chain and row shape (the stage table,
// the grid, the shared-memory attribute); a launch is then one call with
// the pointers, the row count and the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_STAGES = 16;
constexpr int THREADS = 128;
constexpr int MAX_DEVICES = 64;
// shared memory ahead of the row slot: the slot's mbarrier, the block
// reduction's warp sums, and each row group's norm denominators
constexpr int BARRIER_BYTES = 16;
constexpr int FIXED_SMEM =
    BARRIER_BYTES + 4 * 32 + 4 * (THREADS / 32) * MAX_STAGES;

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
  int last[MAX_STAGES];    // last-axis length entering the stage
  int off[MAX_STAGES];     // offset of the stage's vectors in params
  int masked[MAX_STAGES];
  float s0[MAX_STAGES];    // LinearRectifier mv, NormalizeRows eps
  float s1[MAX_STAGES];    // LinearRectifier alpha
  int num_norms;
  int norm_at[MAX_STAGES];  // stage index of each NormalizeRows
  int gray_at;              // the three-channel GrayScaler, or -1
  int in_len, out_len;      // floats per input and output row
  int rows;                 // rows per step
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Start the copy of step `step` into `slot` (one thread). The rows land
// at slot + (src mod 16), so that the bulk copy's middle is aligned on
// both sides; the head and tail bytes are copied here with plain loads,
// before the arrive that releases them to the waiting threads.
__device__ __forceinline__ void load_step(const float* x, long long n,
                                          long long step, const Chain& c,
                                          unsigned char* slot, uint64_t* bar) {
  const long long row0 = step * c.rows;
  const long long rows = min((long long)c.rows, n - row0);
  const char* src = reinterpret_cast<const char*>(x + row0 * c.in_len);
  const uint32_t bytes = (uint32_t)(rows * c.in_len * 4);
  const uint32_t pad = (uint32_t)((uintptr_t)src & 15u);
  unsigned char* dst = slot + pad;
  const uint32_t head = min(bytes, (16u - pad) & 15u);
  const uint32_t mid = (bytes - head) & ~15u;
  for (uint32_t b = 0; b < head; b += 4)
    *reinterpret_cast<float*>(dst + b) =
        __ldg(reinterpret_cast<const float*>(src + b));
  for (uint32_t b = head + mid; b < bytes; b += 4)
    *reinterpret_cast<float*>(dst + b) =
        __ldg(reinterpret_cast<const float*>(src + b));
  mbar_expect_tx(bar, mid);
  if (mid != 0) bulk_copy(dst + head, src + head, mid, bar);
}

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : v);  // keeps 0, -0 and NaN
}

// The sum of `ss` over the row group, then max(sqrt(sum), eps) into
// *dst, visible to the whole group on return.
template <int G>
__device__ __forceinline__ void group_norm(float ss, float* scratch,
                                           float* dst, float eps) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const int lane = threadIdx.x & 31;
  if (G == 32) {
    if (lane == 0) *dst = fmaxf(sqrtf(ss), eps);
    __syncwarp();
    return;
  }
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < THREADS / 32 ? scratch[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) *dst = fmaxf(sqrtf(v), eps);
  }
  __syncthreads();
}

// Stages [0, stop) on one unit: v holds `cnt` values, the first of which
// is element `base` of the row entering stage 0. dn: this row's norm
// denominators so far; m: its mask value.
template <int F>
__device__ __forceinline__ void run_stages(const Chain& c, int stop,
                                           float (&v)[4 * F], int& cnt,
                                           int base, int j,
                                           const float* __restrict__ params,
                                           float m, const float* dn) {
  int norm = 0;
  for (int s = 0; s < stop; ++s) {
    const int code = c.code[s];
    const float* vec = params + c.off[s];
    const int last = c.last[s];
    switch (code) {
      case kPixelScaler:
#pragma unroll
        for (int i = 0; i < 4 * F; ++i)
          if (i < cnt) v[i] = v[i] / 255.f;
        break;
      case kGrayScaler:
        if constexpr (F == 3) {
          if (s == c.gray_at) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = __fadd_rn(__fadd_rn(__fmul_rn(v[3 * i], 0.299f),
                                         __fmul_rn(v[3 * i + 1], 0.587f)),
                               __fmul_rn(v[3 * i + 2], 0.114f));
            cnt /= 3;
            base = 4 * j;
          }
        }
        break;
      case kLinearRectifier:
#pragma unroll
        for (int i = 0; i < 4 * F; ++i)
          if (i < cnt) {
            const float r = __fsub_rn(v[i], c.s1[s]);
            v[i] = r != r ? r : fmaxf(c.s0[s], r);
          }
        break;
      case kNormalizeRows: {
        const float d = dn[norm++];
#pragma unroll
        for (int i = 0; i < 4 * F; ++i)
          if (i < cnt) v[i] = v[i] / d;
        break;
      }
      case kSignedHellinger:
#pragma unroll
        for (int i = 0; i < 4 * F; ++i)
          if (i < cnt) v[i] = __fmul_rn(sign_of(v[i]), sqrtf(fabsf(v[i])));
        break;
      case kRandomSign: {
        int q = base % last;
#pragma unroll
        for (int i = 0; i < 4 * F; ++i)
          if (i < cnt) {
            v[i] = __fmul_rn(v[i], __ldg(vec + q));
            q = q + 1 == last ? 0 : q + 1;
          }
        break;
      }
      case kStandardScale: {
        int q = base % last;
#pragma unroll
        for (int i = 0; i < 4 * F; ++i)
          if (i < cnt) {
            v[i] = __fsub_rn(v[i], __ldg(vec + q)) / __ldg(vec + last + q);
            q = q + 1 == last ? 0 : q + 1;
          }
        break;
      }
      case kStandardCenter: {
        int q = base % last;
#pragma unroll
        for (int i = 0; i < 4 * F; ++i)
          if (i < cnt) {
            v[i] = __fsub_rn(v[i], __ldg(vec + q));
            q = q + 1 == last ? 0 : q + 1;
          }
        break;
      }
      default:  // the vectorizers, a GrayScaler on one channel
        break;
    }
    if (c.masked[s]) {
#pragma unroll
      for (int i = 0; i < 4 * F; ++i)
        if (i < cnt) v[i] = __fmul_rn(v[i], m);
    }
  }
}

// G: threads per row (THREADS: the block on one row a step; 32: a warp
// a row). F: inputs per output (3 with a three-channel GrayScaler, else 1).
template <int G, int F>
__global__ void __launch_bounds__(THREADS)
elementwise_chain_kernel(const float* __restrict__ x,
                         const float* __restrict__ mask,
                         const float* __restrict__ params,
                         float* __restrict__ out, long long n,
                         int store_vec, const __grid_constant__ Chain c) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + BARRIER_BYTES);
  unsigned char* slot = smem + FIXED_SMEM;
  const int t = threadIdx.x;
  const int group = t / G, lane = t % G;
  constexpr int GROUPS = THREADS / G;
  float* dn = scratch + 32 + group * MAX_STAGES;
  const long long steps = (n + c.rows - 1) / c.rows;
  const int units = (c.out_len + 3) >> 2;

  if (t == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (blockIdx.x < steps) load_step(x, n, blockIdx.x, c, slot, bar);
  }
  __syncthreads();

  uint32_t parity = 0;
  for (long long s = blockIdx.x; s < steps; s += gridDim.x, parity ^= 1u) {
    mbar_wait(bar, parity);
    const long long row0 = s * c.rows;
    const int rows = (int)min((long long)c.rows, n - row0);
    const uintptr_t src = (uintptr_t)(x + row0 * c.in_len);
    const int pad = (int)((src & 15u) >> 2);
    const float* base = reinterpret_cast<const float*>(slot) + pad;
    const bool vec = pad == 0 && (c.in_len & 3) == 0;

    for (int r = group; r < rows; r += GROUPS) {
      const float* rs = base + (size_t)r * c.in_len;
      const long long row = row0 + r;
      const float m = mask != nullptr ? __ldg(mask + row) : 1.f;
      float* orow = out + row * c.out_len;
      for (int p = 0; p <= c.num_norms; ++p) {
        const bool summing = p < c.num_norms;
        const int stop = summing ? c.norm_at[p] : c.num_stages;
        float ss = 0.f;
        for (int j = lane; j < units; j += G) {
          const int nout = min(4, c.out_len - 4 * j);
          int cnt = nout * F;
          const float* in = rs + 4 * F * j;
          float v[4 * F];
          if (vec && nout == 4) {
#pragma unroll
            for (int q = 0; q < F; ++q) {
              const float4 a = reinterpret_cast<const float4*>(in)[q];
              v[4 * q] = a.x;
              v[4 * q + 1] = a.y;
              v[4 * q + 2] = a.z;
              v[4 * q + 3] = a.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < 4 * F; ++i) v[i] = i < cnt ? in[i] : 0.f;
          }
          run_stages<F>(c, stop, v, cnt, 4 * F * j, j, params, m, dn);
          if (summing) {
#pragma unroll
            for (int i = 0; i < 4 * F; ++i)
              if (i < cnt) ss = fmaf(v[i], v[i], ss);
          } else if (store_vec && nout == 4) {
            *reinterpret_cast<float4*>(orow + 4 * j) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (i < nout) orow[4 * j + i] = v[i];
          }
        }
        if (summing)
          group_norm<G>(ss, scratch, &dn[p], c.s0[c.norm_at[p]]);
      }
    }
    __syncthreads();  // every thread is done with the slot
    const long long next = s + gridDim.x;
    if (t == 0 && next < steps) load_step(x, n, next, c, slot, bar);
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*,
                        long long, int, Chain);

Kernel kernel_for(int group, int f) {
  if (group == THREADS)
    return f == 3 ? elementwise_chain_kernel<THREADS, 3>
                  : elementwise_chain_kernel<THREADS, 1>;
  return f == 3 ? elementwise_chain_kernel<32, 3>
                : elementwise_chain_kernel<32, 1>;
}

struct Plan {
  Chain chain;
  Kernel kernel;
  const float* params;
  int smem;
  int grid;
};

// the largest dynamic shared memory set so far, per device and kernel
int smem_set[MAX_DEVICES][4];

}  // namespace

extern "C" {

int keystone_elementwise_chain_max_stages() { return MAX_STAGES; }

int keystone_elementwise_chain_fixed_smem() { return FIXED_SMEM; }

// Build a plan for rows of in_len floats in and out_len out, on the
// current device: the stage table (num_stages entries per array), the
// packed stage vectors `params` (kept by the caller for the plan's
// life), rows per step, threads per row (`group`, THREADS or 32), the
// slot's size and the shared memory (FIXED_SMEM + slot_bytes). Sets the
// kernel's shared-memory attribute where this size exceeds the last one
// set. The grid is the SMs times the blocks an SM holds at this shared
// memory and the kernel's registers. Writes the plan and its grid;
// returns a CUDA error, or 0.
int keystone_elementwise_chain_plan(
    const void* params, int in_len, int out_len, int rows, int group,
    int slot_bytes, int smem_bytes, int num_stages, const int* codes,
    const int* lasts, const int* offs, const int* masked, const float* s0,
    const float* s1, void** plan_out, int* grid_out) {
  if (num_stages < 1 || num_stages > MAX_STAGES ||
      (group != THREADS && group != 32) || rows < 1 || in_len < 1 ||
      out_len < 1 || slot_bytes % 16 != 0 ||
      (long long)slot_bytes < (long long)rows * in_len * 4 + 16 ||
      smem_bytes != FIXED_SMEM + slot_bytes ||
      (group == THREADS && rows != 1))
    return (int)cudaErrorInvalidValue;
  Chain c = {};
  c.num_stages = num_stages;
  c.gray_at = -1;
  for (int s = 0; s < num_stages; ++s) {
    c.code[s] = codes[s];
    c.last[s] = lasts[s];
    c.off[s] = offs[s];
    c.masked[s] = masked[s];
    c.s0[s] = s0[s];
    c.s1[s] = s1[s];
    if (codes[s] == kNormalizeRows) c.norm_at[c.num_norms++] = s;
    if (codes[s] == kGrayScaler && lasts[s] == 3) {
      if (c.gray_at >= 0) return (int)cudaErrorInvalidValue;
      c.gray_at = s;
    }
  }
  const int f = c.gray_at >= 0 ? 3 : 1;
  if (out_len * f != in_len) return (int)cudaErrorInvalidValue;
  c.in_len = in_len;
  c.out_len = out_len;
  c.rows = rows;

  int dev = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const Kernel kernel = kernel_for(group, f);
  int& set = smem_set[dev][(group == THREADS ? 2 : 0) + (f == 3 ? 1 : 0)];
  if (smem_bytes > set) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    set = smem_bytes;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      THREADS, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  Plan* plan =
      new Plan{c, kernel, (const float*)params, smem_bytes, sms * resident};
  *plan_out = plan;
  *grid_out = plan->grid;
  return 0;
}

// x (n, in_len) -> out (n, out_len) under `plan`; float32, contiguous,
// on the plan's device. mask (n,) f32 or null. Launches on `stream` and
// returns the launch's CUDA error, or 0.
int keystone_elementwise_chain_run(const void* plan, const void* x,
                                   const void* mask, void* out, long long n,
                                   void* stream) {
  const Plan* p = static_cast<const Plan*>(plan);
  if (n <= 0) return 0;
  const long long steps = (n + p->chain.rows - 1) / p->chain.rows;
  const int grid = steps < p->grid ? (int)steps : p->grid;
  const int store_vec =
      (p->chain.out_len & 3) == 0 && ((uintptr_t)out & 15u) == 0;
  p->kernel<<<grid, THREADS, p->smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)mask, p->params, (float*)out, n,
      store_vec, p->chain);
  return (int)cudaGetLastError();
}

void keystone_elementwise_chain_free(void* plan) {
  delete static_cast<Plan*>(plan);
}

const char* keystone_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
