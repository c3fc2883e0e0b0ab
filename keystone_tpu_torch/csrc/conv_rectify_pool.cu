// Fused conv + patch-mean correction + two-sided rectify + sum pool, as a
// bf16 tensor-core implicit GEMM (wgmma) for Hopper (sm_90a).
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_kernels.py::
// conv_rectify_pool_pallas (:591, body _conv_rect_pool_kernel :482-526).
// For images (N,H,W,C) f32 and a folded filter bank G (D,K), D = C·P·P,
// whose rows are in channel-major order (hwio_to_cmajor):
//
//   z[p,f]   = sum_d bf16(patch_p[d]) * bf16(G[d,f])       (fp32 sums)
//   z[p,f]  -= mean_d(bf16(patch_p)) * colsum[f]            (if normalize)
//   z[p,f]  += bias[f]
//   out[n,cy,cx,f]   = sum_{p in window(cy,cx)} max(mv,  z[p,f] - alpha)
//   out[n,cy,cx,K+f] = sum_{p in window(cy,cx)} max(mv, -z[p,f] - alpha)
//
// Bound at the headline (2048 images of 32x32x3, P=6, K=256, 27x27
// positions, pool 14 stride 13): 2·2048·729·108·256 = 82.6 GFLOP, 0.0835
// ms at the H100's 989 TFLOP/s bf16 peak, against 42 MB of input and
// output (13 us at 3.35 TB/s): bound by operations. The padded work this
// kernel issues is 2·2048·776·112·256 = 91.1 GFLOP, 10% over the real
// work: 776 position columns (729 and the plan's padding, below) in six
// 128-wide tiles and one 8-wide tile, depth 108 padded to 112.
//
// Design.
// - Implicit GEMM, transposed: z^T = G^T · patches^T. M is the filters
//   (64-row tiles), N one image's conv positions (128-wide tiles, then
//   8-wide tiles for the rest), the depth D padded with zeros to a
//   multiple of 16. A warpgroup runs wgmma.m64n128k16 (bf16 in, fp32
//   accumulators: 64 registers a thread) with both operands in shared
//   memory (the SS form). Filters as M put 32 positions of 2 filters in
//   each thread's accumulators, so the pool sums are taken in registers.
//   (Positions as M, with A gathered into registers, was tried first: it
//   spreads each window's positions over lanes and warps, and the sums
//   then cost shuffles and shared-memory atomics: 2.3 ms at the
//   headline on an H100 SXM at 700 W.)
// - A, the filter bank, is rounded to bf16 and laid out once per block
//   in the descriptor's K-major, unswizzled core-matrix layout (8
//   filters x 8 depths per 128 bytes; 57,344 bytes at the headline). It
//   stays resident while the block walks over images. Where the whole
//   bank does not fit shared memory (K above 448 at the headline's image
//   and pool), the wrapper launches the kernel once per chunk of filters
//   that does, each chunk writing its own columns of the output (ldk is
//   the whole bank's K).
// - B, the patches of one N tile, is gathered from the image held as
//   bf16 in shared memory into the same layout (positions for filters),
//   16 bytes a store, and read by all the tile's filter tiles. It never
//   reaches device memory, where the JAX wrapper builds it with
//   conv_general_dilated_patches. B is double-buffered, so one barrier
//   per N tile orders its gather against the products.
// - Persistent blocks: one block of four warpgroups (512 threads, at
//   most 128 registers each; ptxas gives 120 and no spills) per SM walks
//   over the images; at the headline each warpgroup owns one filter tile. The next image's f32 pixels are
//   fetched with cp.async into a second buffer while the current one is
//   computed. The image is rounded to bf16 once, and the patch means are
//   taken once per image from the bf16 pixels as separable box sums
//   (channel sums, P rows, P columns).
// - Plan and epilogue. The N columns are the positions that lie in at
//   least one pool window, ordered by the window range they fall in along
//   each axis (their class), each class padded to a multiple of 8
//   (pool_window_ranges and conv_row_plan in ops/kernels.py build the
//   table; one word per 8 columns gives the class). A thread applies the
//   mean correction, bias and two-sided rectify to its accumulators in
//   registers (an FMA, two adds, two maxima per value) and keeps a
//   running sum per (filter, sign) while the class stays the same. Where
//   the class changes, for all lanes at once, the 4 lanes that share a
//   filter sum their running sums with two shuffles and each adds one of
//   the 4 totals into every window of the class, in the block's per-cell
//   sums in shared memory; no other thread writes those sums, so no
//   atomics are needed. Each position is computed once per filter and
//   added into every window that covers it; positions in no window are
//   not computed. An image's (gy, gx, 2K) cells are written to device
//   memory once.
//
// What this does about the limits of the CUDA-core design it replaces:
// (1) the product runs on the tensor cores; (2) operands reach them by
// descriptor from shared memory, not as scalar loads per FMA; (3) each
// image is staged once and the bank once per block, not per (image,
// filter tile); (4) each position is computed once, not once per window
// row that holds it; (5) partial sums reach shared memory once per class
// run, after shuffles, with no atomics.
// Not yet done: within a warpgroup the epilogue of one tile does not
// overlap the product of the next (the four warpgroups overlap each
// other); the gather runs on CUDA cores between barriers; the layouts are
// unswizzled.
// bf16 input: where the precision planner stores the kernel's input
// boundary as bf16 (RandomPatchCifar's PixelScaler output), the same
// kernel reads the bf16 values directly (template parameter In): the
// bits are the ones the f32 variant rounds to, so no upcast pass runs
// and the input bytes halve; the image is then read from device memory
// in the conversion loop instead of being prefetched by cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WG = 128;            // threads of a warpgroup
constexpr int WGS = 4;             // warpgroups per block
constexpr int THREADS = WG * WGS;
constexpr int MT = 64;             // filters per M tile
constexpr int NT = 128;            // positions per wide N tile
constexpr int NS = 8;              // positions per narrow N tile
constexpr int GROUP = 8;           // positions per class word
constexpr int PAD_FLAG = 1 << 28;  // the class word's 8 columns hold padding

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// byte offsets of the block's buffers in dynamic shared memory
struct Layout {
  size_t a, b, b_bytes, imgf, imgf_bytes, imgb, csum, vsum, mean, rows,
      groups, doff, cs, bias, acc, total;
};

__host__ __device__ inline Layout layout(int h, int w, int c, int patch,
                                         int kpad, int rows, int cells,
                                         int k) {
  const int hwc = h * w * c;
  const int dpad = (c * patch * patch + 15) / 16 * 16;
  Layout l;
  size_t o = 0;
  l.a = o;       o += align16((size_t)kpad * dpad * 2);
  l.b_bytes = align16((size_t)NT * dpad * 2);
  l.b = o;       o += 2 * l.b_bytes;
  l.imgf_bytes = align16((size_t)hwc * 4);
  l.imgf = o;    o += 2 * l.imgf_bytes;
  l.imgb = o;    o += align16((size_t)hwc * 2);
  l.csum = o;    o += align16((size_t)h * w * 4);
  l.vsum = o;    o += align16((size_t)(h - patch + 1) * w * 4);
  l.mean = o;    o += align16((size_t)rows * 4);
  l.rows = o;    o += align16((size_t)rows * 4);
  l.groups = o;  o += align16((size_t)(rows / GROUP) * 4);
  l.doff = o;    o += align16((size_t)dpad * 4);
  l.cs = o;      o += align16((size_t)kpad * 4);
  l.bias = o;    o += align16((size_t)kpad * 4);
  l.acc = o;     o += align16((size_t)cells * 2 * k * 4);
  l.total = o;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_value(uint16_t b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

// byte offset of (row, depth) in the K-major, unswizzled core-matrix
// layout [row/8][depth/8][row%8][depth%8] of bf16 values
__device__ __forceinline__ uint32_t core_offset(int row, int dd, int dpad) {
  return (row / 8) * dpad * 16 + (dd / 8) * 128 + (row % 8) * 16 +
         (dd % 8) * 2;
}

// wgmma shared-memory descriptor of that layout: LBO = 128 bytes between
// the two core matrices of one 16-deep k-step, SBO = dpad·16 bytes
// between groups of 8 rows
__device__ __forceinline__ uint64_t desc(uint32_t addr, int dpad) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(((dpad * 16) >> 4) & 0x3FFF) << 32);
}

#define ACC8(i)                                                     \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),   \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64x128] (+)= A[64x16] · B[16x128], both by descriptor
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef ACC8

// d[64x8] (+)= A[64x16] · B[16x8], both by descriptor
__device__ __forceinline__ void wgmma(float (&d)[4], uint64_t da,
                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous product
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

struct Tile {
  const float* mean_s;  // per column of the plan
  const int* row_s;     // position of each column, -1 for padding
  const int* grp_s;     // class word per 8 columns
  const float* cs_s;
  const float* bias_s;
  float* acc_s;         // (cells, 2K) sums of the current image
  uint32_t a_base;
  int dpad, ksteps, k, gx;
  float alpha, max_val;
};

// the 4 lanes of a quad hold the same two filters: sum their running
// sums, then lane t adds total t (filter f0 or f1, sign t&1) into every
// window of the class; only this lane ever writes those sums
__device__ __forceinline__ void flush(const Tile& tl, int word, float (&run)[4],
                                     int f0, int tq) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    run[v] += __shfl_xor_sync(0xffffffffu, run[v], 1);
    run[v] += __shfl_xor_sync(0xffffffffu, run[v], 2);
  }
  const float val = tq == 0 ? run[0] : tq == 1 ? run[1] : tq == 2 ? run[2]
                                                                   : run[3];
  const int f = f0 + (tq >> 1) * 8;
  if (f < tl.k) {
    const int wy0 = word & 127, wy1 = (word >> 7) & 127;
    const int wx0 = (word >> 14) & 127, wx1 = (word >> 21) & 127;
    const int col = (tq & 1) * tl.k + f;
    for (int wy = wy0; wy <= wy1; ++wy)
      for (int wx = wx0; wx <= wx1; ++wx)
        tl.acc_s[(size_t)(wy * tl.gx + wx) * 2 * tl.k + col] += val;
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) run[v] = 0.f;
}

// one warpgroup: filter tile m against the N tile whose first column is
// n0 and whose patches are in B (NB blocks of 8 columns), then the
// epilogue into the block's per-cell sums. `meanwhile` runs while the
// product is in flight.
template <int NB, typename F>
__device__ __forceinline__ void tile_product(const Tile& tl, uint32_t b_base,
                                             int m, int n0, int warp,
                                             int lane, F&& meanwhile) {
  float acc[4 * NB];
  const uint32_t a0 = tl.a_base + m * (MT / 8) * tl.dpad * 16;
  fence_regs(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int ks = 0; ks < tl.ksteps; ++ks)
    wgmma(acc, desc(a0 + ks * 256, tl.dpad), desc(b_base + ks * 256, tl.dpad),
          ks > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  meanwhile();
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(acc);

  // accumulator i holds filter f0 + 8·((i>>1)&1) and column
  // n0 + 8·(i>>2) + 2tq + (i&1)
  const int gq = lane / 4, tq = lane % 4;
  const int f0 = m * MT + warp * 16 + gq;
  // z = (acc − mean·colsum) + bias, taken as t + (bias − α) and
  // (−bias − α) − t with t = acc − mean·colsum
  const float cs[2] = {tl.cs_s[f0], tl.cs_s[f0 + 8]};
  const float bp[2] = {tl.bias_s[f0] - tl.alpha, tl.bias_s[f0 + 8] - tl.alpha};
  const float bn[2] = {-tl.bias_s[f0] - tl.alpha,
                       -tl.bias_s[f0 + 8] - tl.alpha};
  float run[4] = {0.f, 0.f, 0.f, 0.f};  // (f0,+), (f0,-), (f1,+), (f1,-)
  int cur = tl.grp_s[n0 / GROUP];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int word = tl.grp_s[n0 / GROUP + b];
    if (word != cur) {
      flush(tl, cur, run, f0, tq);
      cur = word;
    }
    const int c = n0 + b * 8 + 2 * tq;
    const float2 mean = *(const float2*)&tl.mean_s[c];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float tz =
            fmaf(-(e ? mean.y : mean.x), cs[h], acc[4 * b + 2 * h + e]);
        run[2 * h] += fmaxf(tl.max_val, tz + bp[h]);
        run[2 * h + 1] += fmaxf(tl.max_val, bn[h] - tz);
      }
    if (word & PAD_FLAG) {
      // a padding column's patch and mean are 0, so t is 0: take back
      // exactly what it added
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (tl.row_s[c + e] < 0)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            run[2 * h] -= fmaxf(tl.max_val, bp[h]);
            run[2 * h + 1] -= fmaxf(tl.max_val, bn[h]);
          }
    }
  }
  flush(tl, cur, run, f0, tq);
}

// In is float (the images copied into shared memory a block ahead by
// cp.async, rounded to bf16 there) or __nv_bfloat16 (a bf16 storage
// trail the precision planner chose: the bits are read as they are, the
// values the float variant rounds to, so both give the same result).
template <typename In>
__global__ void __launch_bounds__(THREADS, 1)
conv_rectify_pool_kernel(const In* __restrict__ images,
                         const float* __restrict__ g,
                         const float* __restrict__ colsum,
                         const float* __restrict__ bias,
                         const int* __restrict__ row_pos,
                         const int* __restrict__ group_windows,
                         float* __restrict__ out, int n, int h, int w, int c,
                         int k, int ldk, int patch, int gx, int cells,
                         int rows, float alpha, float max_val,
                         int normalize) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hwc = h * w * c;
  const int d = c * patch * patch;
  const int dpad = (d + 15) / 16 * 16;
  const int mtiles = (k + MT - 1) / MT;
  const int kpad = mtiles * MT;
  const int pw = w - patch + 1;
  const int ph = h - patch + 1;
  const Layout L = layout(h, w, c, patch, kpad, rows, cells, k);
  unsigned char* a_s = smem + L.a;
  unsigned char* b_s = smem + L.b;
  uint16_t* imgb = (uint16_t*)(smem + L.imgb);
  float* csum = (float*)(smem + L.csum);
  float* vsum = (float*)(smem + L.vsum);
  float* mean_s = (float*)(smem + L.mean);
  int* row_s = (int*)(smem + L.rows);
  int* grp_s = (int*)(smem + L.groups);
  int* doff_s = (int*)(smem + L.doff);
  float* cs_s = (float*)(smem + L.cs);
  float* bias_s = (float*)(smem + L.bias);
  float* acc_s = (float*)(smem + L.acc);
  const int t = threadIdx.x;

  constexpr bool kF32 = std::is_same<In, float>::value;
  auto prefetch = [&](int img, int buf) {
    if constexpr (kF32) {
      const float* src = images + (size_t)img * hwc;
      const uint32_t dst = smem_u32(smem + L.imgf + buf * L.imgf_bytes);
      for (int i = t; i < hwc; i += THREADS)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         dst + 4 * i),
                     "l"(src + i));
    }
  };
  prefetch(blockIdx.x, 0);  // the grid has at most n blocks
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // once per block: the bank as bf16 core matrices, the per-depth gather
  // offsets, the row plan, colsum and bias
  for (int i = t; i < dpad * kpad; i += THREADS) {
    const int dd = i / kpad, f = i % kpad;
    const float v = (dd < d && f < k) ? g[(size_t)dd * ldk + f] : 0.f;
    *(uint16_t*)(a_s + core_offset(f, dd, dpad)) = bf16_bits(v);
  }
  for (int i = t; i < dpad; i += THREADS) {
    const int pp = patch * patch;
    doff_s[i] = i < d ? (((i % pp) / patch) * w + i % patch) * c + i / pp
                      : -1;
  }
  for (int i = t; i < kpad; i += THREADS) {
    cs_s[i] = (normalize && i < k) ? colsum[i] : 0.f;
    bias_s[i] = i < k ? bias[i] : 0.f;
  }
  for (int i = t; i < rows; i += THREADS) {
    row_s[i] = row_pos[i];
    mean_s[i] = 0.f;
  }
  for (int i = t; i < rows / GROUP; i += THREADS) grp_s[i] = group_windows[i];
  for (int i = t; i < cells * 2 * k; i += THREADS) acc_s[i] = 0.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // warp-uniform, as the compiler can see: wgmma outside divergent code
  const int wg = __shfl_sync(0xffffffffu, t / WG, 0);
  const int warp = (t % WG) / 32;
  const int lane = t % 32;
  const int wide = rows / NT;
  const int ntiles = wide + (rows - wide * NT) / NS;
  const float inv_d = 1.f / d;
  const int chunks8 = dpad / 8;  // 16-byte chunks of one position's depth
  Tile tl;
  tl.mean_s = mean_s;
  tl.row_s = row_s;
  tl.grp_s = grp_s;
  tl.cs_s = cs_s;
  tl.bias_s = bias_s;
  tl.acc_s = acc_s;
  tl.a_base = smem_u32(a_s);
  tl.dpad = dpad;
  tl.ksteps = dpad / 16;
  tl.k = k;
  tl.gx = gx;
  tl.alpha = alpha;
  tl.max_val = max_val;

  int it = 0;
  for (int img = blockIdx.x; img < n; img += gridDim.x, ++it) {
    const int buf = it & 1;
    if (img + (int)gridDim.x < n) prefetch(img + gridDim.x, buf ^ 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    // the image in bf16 and, per pixel, the sum of its bf16 channels
    const float* cur = (const float*)(smem + L.imgf + buf * L.imgf_bytes);
    const uint16_t* cur_b =
        (const uint16_t*)(const void*)images + (size_t)img * hwc;
    for (int px = t; px < h * w; px += THREADS) {
      float s = 0.f;
      for (int ch = 0; ch < c; ++ch) {
        uint16_t b;
        if constexpr (kF32)
          b = bf16_bits(cur[px * c + ch]);
        else
          b = cur_b[px * c + ch];
        imgb[px * c + ch] = b;
        s += bf16_value(b);
      }
      csum[px] = s;
    }
    __syncthreads();
    if (normalize) {
      // patch means as separable box sums of the bf16 pixels: P rows of
      // channel sums, then P columns of those
      for (int i = t; i < ph * w; i += THREADS) {
        float s = 0.f;
        for (int ii = 0; ii < patch; ++ii) s += csum[i + ii * w];
        vsum[i] = s;
      }
      __syncthreads();
      for (int r = t; r < rows; r += THREADS) {
        const int p = row_s[r];
        if (p < 0) continue;
        const float* v = vsum + (p / pw) * w + p % pw;
        float s = 0.f;
        for (int jj = 0; jj < patch; ++jj) s += v[jj];
        mean_s[r] = s * inv_d;
      }
    }

    // B is double-buffered: the patches of tile nt+1 are gathered while
    // the products of tile nt are in flight, and one barrier per N tile
    // orders the two
    auto tile_cols = [&](int nt, int& n0, int& width) {
      n0 = nt < wide ? nt * NT : wide * NT + (nt - wide) * NS;
      width = nt < wide ? NT : NS;
    };
    // the patches of columns n0..n0+width-1 into buffer nt&1, one 16-byte
    // chunk of 8 depths per store, chunk i at byte 16·i of the layout
    auto gather = [&](int nt) {
      int n0, width;
      tile_cols(nt, n0, width);
      unsigned char* bt = b_s + (nt & 1) * L.b_bytes;
      for (int i = t; i < width * chunks8; i += THREADS) {
        const int col = (i / (8 * chunks8)) * 8 + i % 8;
        const int dc = (i / 8) % chunks8;
        const int p = row_s[n0 + col];
        const int base = p >= 0 ? ((p / pw) * w + p % pw) * c : 0;
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o0 = doff_s[dc * 8 + 2 * j], o1 = doff_s[dc * 8 + 2 * j + 1];
          const uint32_t lo = (p >= 0 && o0 >= 0) ? imgb[base + o0] : 0u;
          const uint32_t hi = (p >= 0 && o1 >= 0) ? imgb[base + o1] : 0u;
          v[j] = lo | (hi << 16);
        }
        *(uint4*)(bt + 16 * (size_t)i) = make_uint4(v[0], v[1], v[2], v[3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    gather(0);
    __syncthreads();
    for (int nt = 0; nt < ntiles; ++nt) {
      int n0, width;
      tile_cols(nt, n0, width);
      const uint32_t bt = smem_u32(b_s + (nt & 1) * L.b_bytes);
      bool gathered = nt + 1 == ntiles;
      auto next = [&] {
        if (!gathered) gather(nt + 1);
        gathered = true;
      };
      for (int m = wg; m < mtiles; m += WGS) {
        if (width == NT)
          tile_product<NT / 8>(tl, bt, m, n0, warp, lane, next);
        else
          tile_product<NS / 8>(tl, bt, m, n0, warp, lane, next);
      }
      next();
      __syncthreads();
    }

    // (cell, sign, filter) of the chunk into the whole bank's columns
    float* o = out + (size_t)img * cells * 2 * ldk;
    for (int i = t; i < cells * 2 * k; i += THREADS) {
      const int cell = i / (2 * k), r = i % (2 * k);
      o[(size_t)cell * 2 * ldk + (r / k) * ldk + r % k] = acc_s[i];
      acc_s[i] = 0.f;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes, for k filters and a row plan
// of `rows` columns.
size_t keystone_conv_rectify_pool_smem(int h, int w, int c, int patch, int k,
                                       int cells, int rows) {
  const int kpad = (k + MT - 1) / MT * MT;
  return layout(h, w, c, patch, kpad, rows, cells, k).total;
}

// images (N,H,W,C) float32, or bfloat16 where images_bf16 is set; g
// (C·P·P, ldk), colsum (k,), bias (k,) float32;
// row_pos (rows,) and group_windows (rows/8,) int32, the row plan of
// ops/kernels.py::conv_row_plan -> out (N,gy,gx,2·ldk) float32, of which
// this launch writes columns [0, k) and [ldk, ldk + k): the first k of
// the bank's ldk filters (the caller offsets g, colsum, bias and out to
// a chunk). All on the device; rows of g and out as the strides say.
// Launches on `stream` and returns cudaGetLastError().
int keystone_conv_rectify_pool(const void* images, const void* g,
                               const void* colsum, const void* bias,
                               const void* row_pos, const void* group_windows,
                               void* out, int n, int h, int w, int c, int k,
                               int ldk, int patch, int pool, int stride,
                               int rows, float alpha, float max_val,
                               int normalize, int images_bf16, void* stream) {
  const int ph = h - patch + 1, pw = w - patch + 1;
  const int gy = (ph - pool) / stride + 1, gx = (pw - pool) / stride + 1;
  const size_t smem =
      keystone_conv_rectify_pool_smem(h, w, c, patch, k, gy * gx, rows);
  cudaError_t err = images_bf16
      ? cudaFuncSetAttribute(conv_rectify_pool_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem)
      : cudaFuncSetAttribute(conv_rectify_pool_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = n < sms ? n : sms;
  if (images_bf16)
    conv_rectify_pool_kernel<__nv_bfloat16>
        <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            (const __nv_bfloat16*)images, (const float*)g,
            (const float*)colsum, (const float*)bias, (const int*)row_pos,
            (const int*)group_windows, (float*)out, n, h, w, c, k, ldk, patch,
            gx, gy * gx, rows, alpha, max_val, normalize);
  else
    conv_rectify_pool_kernel<float>
        <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            (const float*)images, (const float*)g, (const float*)colsum,
            (const float*)bias, (const int*)row_pos,
            (const int*)group_windows, (float*)out, n, h, w, c, k, ldk, patch,
            gx, gy * gx, rows, alpha, max_val, normalize);
  return (int)cudaGetLastError();
}

const char* keystone_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
