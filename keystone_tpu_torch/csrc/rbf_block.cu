// RBF kernel block as a 3xTF32 tensor-core GEMM (wgmma) for Hopper
// (sm_90a), with the Gaussian epilogue fused before the write.
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_kernels.py::
// rbf_block_pallas (:212-246, body _rbf_kernel :194-209). For X (m,d)
// and Y (n,d) f32:
//
//   x2[i] = sum_k X[i,k]^2,  y2[j] = sum_k Y[j,k]^2              (fp32)
//   acc[i,j] ~ sum_k X[i,k] * Y[j,k]                           (3xTF32)
//   out[i,j] = exp(-gamma * max(x2[i] + y2[j] - 2 acc[i,j], 0))
//
// Bound. The TPU kernel runs its product at Precision.HIGHEST: fp32
// accuracy from several passes of the matrix unit. Hopper's counterpart
// is three TF32 tensor-core products, so the least time for the work is
// 3 * 2*m*n*d operations at the H100's 495 TFLOP/s dense TF32 rate: at
// the fit's X (50000,2048) by Y (2048,2048), 1.26e12 operations, 2.54
// ms, against 0.85 GB of inputs and output (0.25 ms at 3.35 TB/s):
// bound by operations. (The fp32 CUDA-core rate, 67 TFLOP/s, gave the
// 6.26 ms bound of the SGEMM this file held before.)
//
// Split. A prepass (split_kernel) reads each row of X and Y once and
// writes lo = x - hi, where hi = bits(x) & 0xffffe000 is x truncated to
// TF32 (both exact in fp32), and the row's squared norm in fp32, as the
// JAX wrapper takes the norms outside its pallas_call (:223-225). A TF32
// tensor core reads an fp32 value as its truncation (a card test holds
// the results of raw X and of a written hi bit for bit), so X and Y
// themselves serve as hi when their rows are 16-byte aligned; otherwise
// the prepass writes hi too, at a row stride rounded up to 4 floats.
// Each k8 step issues hi.lo, lo.hi and hi.hi (lo.lo, about 2^-22 of the
// product, is dropped; lo as TF32 keeps 11 of its bits, an error of about
// 2^-21 relative). One TF32 product alone misses by about 6e-3 on a
// diagonal at the fit width (tests/test_torch_rbf_split.py).
//
// Accumulation. Tensor cores may add into their fp32 accumulator with
// truncation rather than rounding to nearest (Fasi et al., PeerJ CS
// 2021, measured it on V100 and A100). Over a 2048-deep diagonal, sums
// near |x|^2 ~ 2048 whose ulp is 2.4e-4, 256 biased k8 additions would
// move d2 by a few hundredths, about 5e-5 at the output at gamma 2e-3:
// the whole tolerance. So the wgmma accumulator holds one 32-float slab
// only (its first product overwrites it), the two small terms before the
// large one, and after each slab it is added into an fp32 sum in
// registers, rounded to nearest. The accumulator's own error then stays
// near an ulp of 32, and the register sum's is unbiased. On an H100 the
// fit geometry's diagonal comes within 7e-6 of 1 (chip_smoke.py).
//
// Layout. A block owns a 128x128 output tile: 288 threads, two consumer
// warpgroups (64 rows each, wgmma.m64n128k8.f32.tf32.tf32, 64 accumulator
// and 64 sum registers a thread) and one producer warp. A stage holds a
// 32-float (128-byte) slab of X's hi and lo and of Y's hi and lo, 16 KB
// each, brought by four TMA loads (2-D tensor maps, 128-byte swizzle,
// zero fill past every edge) onto one mbarrier; three stages (192 KB) in
// a ring, each released by the consumers' eight warps on a second
// mbarrier. The operands reach wgmma from shared memory by descriptor,
// K-major with the same 128-byte swizzle; a k8 step advances the start
// address by 32 bytes. The epilogue runs on the sums in registers and
// stores each thread's pairs of columns directly (masked at the edges).
// Blocks run over the tiles with the n tiles fastest, so the blocks in
// flight share Y's tiles in L2 and read each X tile from device memory
// once. A block takes 197,680 bytes of dynamic shared memory (the ring,
// 1 KB of alignment, six mbarriers), so one block an SM; ptxas (nvcc
// 12.9, -Xptxas -v) gives the product 133 registers a thread and the
// prepass 48, no spills (<lib>.log; chip_smoke.py's build line).
// Not done: persistent blocks that overlap a tile's epilogue with the
// next tile's loads, TMA multicast of a tile to a cluster, and the
// prepass folded into the product.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // rows of X per block
constexpr int BN = 128;           // rows of Y per block
constexpr int BK = 32;            // floats of depth per slab (128 bytes)
constexpr int STAGES = 3;
constexpr int WG = 128;           // threads of a warpgroup
constexpr int CONSUMERS = 2;      // warpgroups, 64 rows of the tile each
constexpr int THREADS = CONSUMERS * WG + 32;  // and one producer warp
constexpr uint32_t TILE_BYTES = BM * BK * 4;  // one operand's slab, 16 KB
constexpr uint32_t STAGE_BYTES = 4 * TILE_BYTES;
constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
constexpr uint32_t TF32_MASK = 0xffffe000u;
constexpr int SPLIT_THREADS = 256;  // a warp a row

// errors of the tensor-map encoder, beside cudaError_t's positive codes
constexpr int ERR_NO_ENCODER = -1;
constexpr int ERR_ENCODE = -2;

static_assert(BM == BN, "the tiles of X and Y share TILE_BYTES");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// the box at (c0 along the depth, c1 along the rows) of `map` into
// shared memory at `dst`, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of
// 128 bytes, groups of 8 rows 1024 bytes apart (SBO), layout type 1
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define ACC8(i)                                                     \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),   \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64x128] (+)= A[64x8] · B[128x8]^T, TF32 operands by descriptor
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef ACC8

// keep the compiler from moving accumulator reads or writes across the
// asynchronous product
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float tf32_hi(float v) {
  return __uint_as_float(__float_as_uint(v) & TF32_MASK);
}

// Rows of src (rows, d), row stride d: lo (row stride ld) = x - hi(x),
// hi(x) too where hi is given, zeros in columns d..ld-1, and the row's
// squared norm. A warp a row; `vec` reads and writes float4 (d % 4 == 0,
// src 16-byte aligned, ld == d).
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kernel(const float* __restrict__ src, int rows, int d, int ld,
             float* __restrict__ lo, float* __restrict__ hi,
             float* __restrict__ norms, int vec) {
  const int lane = threadIdx.x % 32;
  const int warps = SPLIT_THREADS / 32;
  for (long long r = (long long)blockIdx.x * warps + threadIdx.x / 32;
       r < rows; r += (long long)gridDim.x * warps) {
    const float* s = src + r * d;
    float* l = lo + r * ld;
    float* h = hi ? hi + r * ld : nullptr;
    float acc = 0.f;
    if (vec) {
      for (int k = lane * 4; k < d; k += 128) {
        const float4 v = *reinterpret_cast<const float4*>(s + k);
        const float4 vh = make_float4(tf32_hi(v.x), tf32_hi(v.y),
                                      tf32_hi(v.z), tf32_hi(v.w));
        *reinterpret_cast<float4*>(l + k) =
            make_float4(v.x - vh.x, v.y - vh.y, v.z - vh.z, v.w - vh.w);
        if (h) *reinterpret_cast<float4*>(h + k) = vh;
        acc = fmaf(v.x, v.x, acc);
        acc = fmaf(v.y, v.y, acc);
        acc = fmaf(v.z, v.z, acc);
        acc = fmaf(v.w, v.w, acc);
      }
    } else {
      for (int k = lane; k < ld; k += 32) {
        const float v = k < d ? s[k] : 0.f;
        const float vh = tf32_hi(v);
        l[k] = v - vh;
        if (h) h[k] = vh;
        acc = fmaf(v, v, acc);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) norms[r] = acc;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
rbf_gemm_kernel(const __grid_constant__ CUtensorMap a_hi,
                const __grid_constant__ CUtensorMap a_lo,
                const __grid_constant__ CUtensorMap b_hi,
                const __grid_constant__ CUtensorMap b_lo,
                const float* __restrict__ x2, const float* __restrict__ y2,
                float* __restrict__ out, int m, int n, int slabs,
                float gamma) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int t = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (t >= CONSUMERS * WG) {
    // producer: one thread keeps the ring full
    if (t == CONSUMERS * WG) {
      for (int s = 0; s < slabs; ++s) {
        const int st = s % STAGES;
        if (s >= STAGES) mbar_wait(empty(st), ((s / STAGES) - 1) & 1);
        const uint32_t dst = base + st * STAGE_BYTES;
        const int k0 = s * BK;
        mbar_expect_tx(full(st), STAGE_BYTES);
        tma_load(dst, &a_hi, k0, m0, full(st));
        tma_load(dst + TILE_BYTES, &a_lo, k0, m0, full(st));
        tma_load(dst + 2 * TILE_BYTES, &b_hi, k0, n0, full(st));
        tma_load(dst + 3 * TILE_BYTES, &b_lo, k0, n0, full(st));
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg*64..wg*64+63 of the tile
  // (warp-uniform, as the compiler can see: wgmma outside divergent code)
  const int wg = __shfl_sync(0xffffffffu, t / WG, 0);
  const int warp = (t % WG) / 32, lane = t % 32;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
    sum[i] = 0.f;
  }
  for (int s = 0; s < slabs; ++s) {
    const int st = s % STAGES;
    mbar_wait(full(st), (s / STAGES) & 1);
    const uint32_t ahi = base + st * STAGE_BYTES + wg * 64 * BK * 4;
    const uint32_t alo = ahi + TILE_BYTES;
    const uint32_t bhi = base + st * STAGE_BYTES + 2 * TILE_BYTES;
    const uint32_t blo = bhi + TILE_BYTES;
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // the small terms first, into an accumulator that starts the slab
    // at zero, then the large one
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      wgmma(acc, desc(ahi + 32 * kk), desc(blo + 32 * kk), kk > 0);
      wgmma(acc, desc(alo + 32 * kk), desc(bhi + 32 * kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      wgmma(acc, desc(ahi + 32 * kk), desc(bhi + 32 * kk), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  }

  // sum i holds row r0 + 8·((i>>1)&1) and column n0 + 8·(i>>2) + 2tq +
  // (i&1)
  const int gq = lane / 4, tq = lane % 4;
  const int r0 = m0 + wg * 64 + warp * 16 + gq;
  const bool pairs = (n % 2) == 0;  // float2 stores stay aligned
  float xx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) xx[h] = r0 + 8 * h < m ? x2[r0 + 8 * h] : 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = n0 + 8 * j + 2 * tq;
    const float y0 = c < n ? y2[c] : 0.f;
    const float y1 = c + 1 < n ? y2[c + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= m || c >= n) continue;
      const float d0 = (xx[h] + y0) - 2.f * sum[4 * j + 2 * h];
      const float d1 = (xx[h] + y1) - 2.f * sum[4 * j + 2 * h + 1];
      const float o0 = expf(-gamma * fmaxf(d0, 0.f));
      const float o1 = expf(-gamma * fmaxf(d1, 0.f));
      float* o = out + (size_t)row * n + c;
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(o0, o1);
      } else {
        o[0] = o0;
        if (c + 1 < n) o[1] = o1;
      }
    }
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, d) fp32 matrix at row stride ld floats, read in boxes of BK
// floats by BM rows with the 128-byte swizzle, zeros past its edges
int tensor_map(CUtensorMap* map, const void* ptr, int rows, int d, int ld) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

int launch_split(const void* src, int rows, int d, int ld, void* lo, void* hi,
                 void* norms, cudaStream_t stream) {
  const int vec = (d % 4 == 0) && (ld == d) &&
                  ((reinterpret_cast<uintptr_t>(src) & 15) == 0);
  const int warps = SPLIT_THREADS / 32;
  long long blocks = ((long long)rows + warps - 1) / warps;
  if (blocks > 65536) blocks = 65536;
  split_kernel<<<(unsigned)blocks, SPLIT_THREADS, 0, stream>>>(
      (const float*)src, rows, d, ld, (float*)lo, (float*)hi, (float*)norms,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The prepass alone: src (rows, d) f32 contiguous -> lo (rows, ld), hi
// (rows, ld) unless null, norms (rows,). ld >= d; columns d..ld-1 of lo
// and hi are written as zeros. Launches on `stream` and returns
// cudaGetLastError().
int keystone_rbf_split(const void* src, int rows, int d, int ld, void* lo,
                       void* hi, void* norms, void* stream) {
  return launch_split(src, rows, d, ld, lo, hi, norms, (cudaStream_t)stream);
}

// X (m,d), Y (n,d) f32 contiguous -> out (m,n) f32. Scratch: lo (m+n,
// ld), the rows of X then of Y; hi (m+n, ld) or null, in which case X and
// Y serve as hi (ld == d, both 16-byte aligned, d % 4 == 0); norms
// (m+n,). ld is a multiple of 4, at least d. The prepass and the product
// launch on `stream`; returns cudaGetLastError(), or a negative code if
// the tensor maps cannot be made.
int keystone_rbf_block(const void* X, const void* Y, void* lo, void* hi,
                       void* norms, void* out, int m, int n, int d, int ld,
                       float gamma, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  float* lo_f = (float*)lo;
  float* hi_f = (float*)hi;
  float* nrm = (float*)norms;
  const size_t y_off = (size_t)m * ld;
  int err = launch_split(X, m, d, ld, lo_f, hi_f, nrm, st);
  if (err != 0) return err;
  err = launch_split(Y, n, d, ld, lo_f + y_off, hi_f ? hi_f + y_off : nullptr,
                     nrm + m, st);
  if (err != 0) return err;
  CUtensorMap maps[4];
  const int hi_ld = hi_f ? ld : d;
  if ((err = tensor_map(&maps[0], hi_f ? (const void*)hi_f : X, m, d, hi_ld)) ||
      (err = tensor_map(&maps[1], lo_f, m, d, ld)) ||
      (err = tensor_map(&maps[2], hi_f ? (const void*)(hi_f + y_off) : Y, n,
                        d, hi_ld)) ||
      (err = tensor_map(&maps[3], lo_f + y_off, n, d, ld)))
    return err;
  const cudaError_t e = cudaFuncSetAttribute(
      rbf_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  rbf_gemm_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      maps[0], maps[1], maps[2], maps[3], nrm, nrm + m, (float*)out, m, n,
      (d + BK - 1) / BK, gamma);
  return (int)cudaGetLastError();
}

const char* keystone_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found in the driver";
  if (err == ERR_ENCODE) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
