// Building blocks of the tile-blocked Cholesky kernels (blocked_cholesky.cu,
// hbm_cholesky.cu): 128x128 f32 tiles.
//
//   tile_product_kernel  out(i,c) = [base(i,c)] + s A1 B1^T - sum_j L_ij L_cj^T
//                        [+ diag on diagonal tiles], or the strip part alone
//                        added atomically (a strip split over j). A1 B1^T is
//                        the fused Gram Z_i Z_c^T, or the panel C_ik L_kk^-T
//                        with the explicit tile inverse.
//   tile_factor_kernel   L_kk = chol(C_kk) and L_kk^-1, one CTA a matrix, by
//                        factor_sub_panels, which the fused GP-MLL kernel
//                        (fused_mll.cu) shares in a packed layout
//
// Precision: no product here is single-pass TF32. The tile products run on
// the tensor cores in 3xTF32: each f32 operand is split as a = a_hi + a_lo
// (a_hi = a rounded to TF32 as cvt.rna.tf32.f32 rounds, a_lo = a - a_hi
// rounded the same way) and a b is
// accumulated in f32 as a_hi b_hi + a_hi b_lo + a_lo b_hi, which keeps
// about f32 accuracy (ops/tf32x3.py repeats this arithmetic for the CPU
// tests). The factor kernel is f32 FFMA.
//
// tile_product_kernel: one CTA a 128x128 output tile, 288 threads. Warp 8
// is the producer: one thread streams 32-deep chunks of the two operands
// (128 rows x 128 bytes each) into a ring of 3 shared-memory stages by TMA
// (cp.async.bulk.tensor, 128-byte swizzle, one mbarrier a stage for "full"
// and one for "empty"). Warps 0-7 are two consumer warpgroups, each owning
// 64 rows of the output tile: when a stage arrives they split it in place
// into hi and lo planes (one pass of all 256 threads, then a named barrier;
// the split of stage t + 1 runs while the tensor cores work on stage t),
// and each warpgroup runs 12 wgmma.m64n128k8.f32.tf32.tf32 with both
// operands K-major in shared memory (L_ij and L_cj are row-major with j
// along the row, Z is [N, D] row-major: no transpose). The tensor cores
// add with truncation, so each stage's product starts a fresh wgmma
// accumulator and is added, with its sign and scale, into an f32 register
// accumulator by FFMA (64 + 64 f32 a thread). The epilogue adds the base
// tile and the diagonal and stores, or adds atomically.
//
// Tiles are addressed through a TileView (epilogue, factor) and a TileMap
// (TMA), so one set of kernels serves a dense [B, N, N] matrix (ld = N) and
// the tile-blocked [B, nt, nt, T, T] layout (ld = T). Every global offset is
// 64-bit: at N = 106496 a matrix has 1.1e10 elements.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_chol {

constexpr int T = 128;  // tile edge

struct TileView {
  float* p;
  long long batch, ti, tj;  // element strides of a matrix, a tile row, a tile
  int ld;                   // row stride inside a tile
  __host__ __device__ float* at(int b, int i, int j) const {
    return p + (long long)b * batch + (long long)i * ti + (long long)j * tj;
  }
};

inline TileView dense_view(float* p, int n) {
  return TileView{p, (long long)n * n, (long long)T * n, T, n};
}

inline TileView tiled_view(float* p, int n) {
  const long long nt = n / T;
  return TileView{p, nt * nt * T * T, nt * T * T, (long long)T * T, T};
}

// ------------------------------------------------------------- TMA maps

constexpr int kChunk = 32;  // depth of a stage: 32 f32, the 128-byte swizzle

// Chunk q of tile (i, j) starts at column xj j + 32 q, row yi i + yj j.
struct MapCoord {
  int xj, yi, yj;
};

struct TileMap {
  CUtensorMap map;
  MapCoord at;
};

// A 3-D map {cols, rows, batch} of f32 with row stride ld and matrix stride
// batch_stride (elements), box {32, 128, 1}, 128-byte swizzle. Returns 0 or
// minus the CUresult.
inline int encode_map(TileMap* m, const float* p, long long cols,
                      long long rows, long long batch, long long ld,
                      long long batch_stride, MapCoord at) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * sizeof(float),
                                 (cuuint64_t)batch_stride * sizeof(float)};
  const cuuint32_t box[3] = {kChunk, T, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  m->at = at;
  const CUresult r = cuTensorMapEncodeTiled(
      &m->map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// [B, N, N], tile (i, j) at rows 128 i, columns 128 j
inline int dense_map(TileMap* m, const float* p, int n, int batch) {
  return encode_map(m, p, n, n, batch, n, (long long)n * n, {T, T, 0});
}

// [B, nt, nt, T, T] seen as [B, nt nt T, T]: tile (i, j) at row (i nt + j) T
inline int tiled_map(TileMap* m, const float* p, int n, int batch) {
  const long long nt = n / T;
  return encode_map(m, p, T, nt * nt * T, batch, T, nt * nt * T * T,
                    {0, (int)(nt * T), T});
}

// Z [B, N, D]: tile i is rows 128 i, its chunks run along D
inline int rows_map(TileMap* m, const float* p, int n, int d, int batch) {
  return encode_map(m, p, d, n, batch, d, (long long)n * d, {0, T, 0});
}

// the [B, T, T] scratch of tile inverses: every tile index maps to the one
// tile of matrix b
inline int inverse_map(TileMap* m, const float* p, int batch) {
  return encode_map(m, p, T, T, batch, T, (long long)T * T, {0, 0, 0});
}

// ------------------------------------------------------ device helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// chunk q of tile (i, j) of matrix b into shared memory at dst
__device__ __forceinline__ void load_chunk(uint32_t dst, const TileMap& m,
                                           int b, int i, int j, int q,
                                           uint32_t bar) {
  const int x = m.at.xj * j + kChunk * q, y = m.at.yi * i + m.at.yj * j;
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&m.map)), "r"(x), "r"(y), "r"(b),
      "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major operand with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (base 1024-byte aligned)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// d (64 rows x 128 columns of this warpgroup) = A B^T + (accumulate ? d :
// 0), A [64, 8] and B [128, 8] tf32, both K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The rounding of cvt.rna.tf32.f32 (nearest, ties away from zero, low 13
// bits zero) in two integer operations on the bit pattern: the sign bit
// stays apart, so adding half an ulp to the magnitude rounds both signs
// alike, and a carry into the exponent is the right result. The integer
// pipes run at full rate where the conversion does not.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ float4 split_hi(float4 x, float4& lo) {
  const float4 hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                                tf32_rna(x.w));
  lo = make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                   tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
  return hi;
}

// ------------------------------------------------------ tile product

constexpr int kStages = 3;
constexpr int kPlane = T * kChunk * 4;   // 16 KB: one operand's chunk
constexpr int kStageBytes = 4 * kPlane;  // A hi, B hi, A lo, B lo
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kProductThreads = kConsumers + 32;
constexpr size_t kProductSmem =
    (size_t)kStages * kStageBytes + 16 * kStages + 1024;

struct ProductArgs {
  TileMap a1, b1;  // the first product's operands (Gram: Z, Z; panel: L, L^-1)
  TileMap strip;   // L: the strip's operands
  TileView out, base;  // base.p == nullptr: no base tile
  int k;               // column (left-looking) or step (right-looking)
  int tri;   // 1: blockIdx.x enumerates the pairs k < c <= i; 0: the column
  int row0;  // column mode: i = k + row0 + blockIdx.x, c = k
  int n1;    // chunks of the first product (A1 tile (i, k), B1 tile (c, k))
  int j_begin, j_chunk, j_end;  // strip range of split y: [j_begin + y
                                // j_chunk, j_end), at most j_chunk tiles
  float scale1, diag;
};

// out(i, c) of matrix b = blockIdx.z. Without kAtomic the CTA writes
// base + scale1 A1 B1^T - its part of the strip (+ diag on the diagonal);
// with kAtomic it adds minus its part of the strip to out.
template <bool kAtomic>
__global__ void __launch_bounds__(kProductThreads, 1)
    tile_product_kernel(const __grid_constant__ ProductArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + kStages * kStageBytes;
  const uint32_t empty0 = full0 + 8 * kStages;
  const int b = blockIdx.z;
  int i, c;
  if (g.tri) {
    const int x = blockIdx.x;
    int r = (int)((sqrtf(8.f * x + 1.f) - 1.f) * 0.5f);
    while (r * (r + 1) / 2 > x) --r;
    while ((r + 1) * (r + 2) / 2 <= x) ++r;
    i = g.k + 1 + r;
    c = g.k + 1 + x - r * (r + 1) / 2;
  } else {
    i = g.k + g.row0 + blockIdx.x;
    c = g.k;
  }
  const int jb = g.j_begin + blockIdx.y * g.j_chunk;
  const int je = min(jb + g.j_chunk, g.j_end);
  const int total = g.n1 + (je > jb ? 4 * (je - jb) : 0);
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (threadIdx.x == kConsumers) {
      for (int t = 0; t < total; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty0 + 8 * s, (t / kStages - 1) & 1);
        const uint32_t full = full0 + 8 * s, dst = sbase + s * kStageBytes;
        mbar_expect_tx(full, 2 * kPlane);
        if (t < g.n1) {
          load_chunk(dst, g.a1, b, i, g.k, t, full);
          load_chunk(dst + kPlane, g.b1, b, c, g.k, t, full);
        } else {
          const int u = t - g.n1, j = jb + u / 4, q = u % 4;
          load_chunk(dst, g.strip, b, i, j, q, full);
          load_chunk(dst + kPlane, g.strip, b, c, j, q, full);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63. The tensor
  // cores add with truncation, so each stage's 32-deep product goes to a
  // fresh wgmma accumulator (part) and is then added into acc by FFMA, with
  // round-to-nearest and its sign and scale: the truncation bias stays
  // within one stage, however deep the strip.
  const int wg = warp / 4;
  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.f;
  // split stage t in place once it has arrived: hi over the raw chunk, lo
  // 32 KB on; the named barrier that follows makes it whole for both
  // warpgroups
  auto split_stage = [&](int t) {
    const int s = t % kStages;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    float4* hi = reinterpret_cast<float4*>(smem + s * kStageBytes);
#pragma unroll
    for (int r = 0; r < 2 * kPlane / 16 / kConsumers; ++r) {
      const int f = threadIdx.x + kConsumers * r;
      float4 lo;
      hi[f] = split_hi(hi[f], lo);
      hi[f + 2 * kPlane / 16] = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };
  if (total > 0) split_stage(0);
  for (int t = 0; t < total; ++t) {
    const int s = t % kStages;
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    const uint32_t sa = sbase + s * kStageBytes + wg * (kPlane / 2);
    const uint32_t sb = sbase + s * kStageBytes + kPlane;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 8; ++kk) {
      const uint64_t ah = sw128_desc(sa + 32 * kk);
      const uint64_t al = sw128_desc(sa + 2 * kPlane + 32 * kk);
      const uint64_t bh = sw128_desc(sb + 32 * kk);
      const uint64_t bl = sw128_desc(sb + 2 * kPlane + 32 * kk);
      wgmma_tf32(part, ah, bl, kk > 0);  // the small terms first
      wgmma_tf32(part, al, bh, 1);
      wgmma_tf32(part, ah, bh, 1);
    }
    wgmma_commit();
    if (t + 1 < total) split_stage(t + 1);  // while the tensor cores run
    wgmma_wait<0>();
    mbar_arrive(empty0 + 8 * s);
    const float f = t < g.n1 ? g.scale1 : -1.f;
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = fmaf(part[e], f, acc[e]);
  }

  // accumulator layout of m64n128: acc[4 g + 2 h + e] is row
  // 16 (warp % 4) + lane / 4 + 8 h, column 8 g + 2 (lane % 4) + e
  const int lane = threadIdx.x % 32;
  float* o = g.out.at(b, i, c);
  const float* base = g.base.p ? g.base.at(b, i, c) : nullptr;
#pragma unroll
  for (int gi = 0; gi < 16; ++gi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * h;
      const int col = 8 * gi + 2 * (lane % 4);
      float2 v = make_float2(acc[4 * gi + 2 * h], acc[4 * gi + 2 * h + 1]);
      float* dst = o + (size_t)row * g.out.ld + col;
      if (kAtomic) {
        atomicAdd(dst, v.x);
        atomicAdd(dst + 1, v.y);
      } else {
        if (base) {
          const float2 bv = *reinterpret_cast<const float2*>(
              base + (size_t)row * g.base.ld + col);
          v.x += bv.x;
          v.y += bv.y;
        }
        if (i == c && row == col) v.x += g.diag;
        if (i == c && row == col + 1) v.y += g.diag;
        *reinterpret_cast<float2*>(dst) = v;
      }
    }
  }
}

// ------------------------------------------------------- tile factor

constexpr int kFLd = T + 1;  // padded row: conflict-free column reads
constexpr int kPLd = 3 * 32 + 1;
constexpr int kFactorThreads = 256;
constexpr size_t kFactorSmem = sizeof(float) * (2 * T * kFLd + 32 * kPLd);

// lane r holds row r of a 32x32 SPD block in v (zero above the diagonal):
// right-looking Cholesky in registers and shuffles, no barrier. On return
// v is row r of L (entries above the diagonal undefined) and rinv[j] is
// 1 / L_jj on every lane. The chain from one column to the next is one
// shuffle: lane j + 1 updates its own diagonal entry first and broadcasts
// it as the next pivot, before the other lanes' updates.
__device__ __forceinline__ void chol32(float (&v)[32], float (&rinv)[32],
                                       int lane) {
  float piv = __shfl_sync(0xffffffffu, v[0], 0);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(piv));
    rinv[j] = r;
    const float l = (lane == j) ? piv * r : v[j] * r;
    v[j] = l;
    if (j + 1 < 32)
      piv = __shfl_sync(0xffffffffu, fmaf(-l, l, v[j + 1]), j + 1);
#pragma unroll
    for (int c = j + 1; c < 32; ++c)
      v[c] = fmaf(-l, __shfl_sync(0xffffffffu, l, c), v[c]);
  }
}

// Where entry (r, c) of the factor's matrices L and X sits in shared
// memory. Dense: row-major [T][kFLd]. LowerBlocks: only the 32x32 blocks on
// and below the diagonal, block (i, j) the (i (i + 1) / 2 + j)-th, each
// [32][33] (42 KB where Dense takes 66). In both, a row of a 32x32 block is
// contiguous and rows lie kRowLd = 1 mod 32 floats apart (conflict-free
// column reads). The factor touches no block above the diagonal.
struct Dense {
  static constexpr int kRowLd = kFLd;
  __device__ static int at(int r, int c) { return r * kFLd + c; }
};

struct LowerBlocks {
  static constexpr int kRowLd = 33;
  static constexpr int kBlock = 32 * kRowLd;
  static constexpr int kFloats = (T / 32) * (T / 32 + 1) / 2 * kBlock;
  __device__ static int at(int r, int c) {
    const int i = r >> 5;
    return ((i * (i + 1) >> 1) + (c >> 5)) * kBlock + (r & 31) * kRowLd +
           (c & 31);
  }
};

// (c) of the factor below: L[r][c] -= sum_m X[r][m] X[c][m] over the
// trailing rows and columns o + 32 + ty + 16 x, o + 32 + tx + 16 y
// (x, y < kN16), for c <= r; X = L[., o:o + 32]
template <int kN16, class Lay>
__device__ __forceinline__ void trailing_update(float* L, int o, int tid) {
  const int tx = tid % 16, ty = tid / 16;
  int rr[kN16], rc[kN16];  // rows' offsets at column o
#pragma unroll
  for (int x = 0; x < kN16; ++x) {
    rr[x] = Lay::at(o + 32 + ty + 16 * x, o);
    rc[x] = Lay::at(o + 32 + tx + 16 * x, o);
  }
  float acc[kN16][kN16];
#pragma unroll
  for (int x = 0; x < kN16; ++x)
#pragma unroll
    for (int y = 0; y < kN16; ++y) acc[x][y] = 0.f;
#pragma unroll 4
  for (int m = 0; m < 32; ++m) {
    float xr[kN16], xc[kN16];
#pragma unroll
    for (int x = 0; x < kN16; ++x) {
      xr[x] = L[rr[x] + m];
      xc[x] = L[rc[x] + m];
    }
#pragma unroll
    for (int x = 0; x < kN16; ++x)
#pragma unroll
      for (int y = 0; y < kN16; ++y) acc[x][y] = fmaf(xr[x], xc[y], acc[x][y]);
  }
#pragma unroll
  for (int x = 0; x < kN16; ++x)
#pragma unroll
    for (int y = 0; y < kN16; ++y) {
      const int r = o + 32 + ty + 16 * x, c = o + 32 + tx + 16 * y;
      if (c <= r) L[Lay::at(r, c)] -= acc[x][y];
    }
}

// Row block p of the tile inverse, X[o:o+32, :o] = -D_p^-1 P (o = 32 p,
// D_p^-1 = X[o:o+32, o:o+32], P [32][kPLd]), on kNW warps: warp r0 forms
// rows r0 + kNW u, the lane a column.
template <int kNW, class Lay>
__device__ __forceinline__ void inverse_rows(float* X, const float* P, int o,
                                             int p, int r0, int lane) {
  constexpr int kRows = (32 + kNW - 1) / kNW;
  const float* dr = X + Lay::at(o + r0, o);
  for (int q = 0; q < p; ++q) {
    float sum[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) sum[u] = 0.f;
#pragma unroll 4
    for (int m = 0; m < 32; ++m) {
      const float t = P[m * kPLd + 32 * q + lane];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (32 % kNW == 0 || r0 + kNW * u < 32)
          sum[u] = fmaf(dr[kNW * u * Lay::kRowLd + m], t, sum[u]);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      if (32 % kNW == 0 || r0 + kNW * u < 32)
        X[Lay::at(o + r0 + kNW * u, 32 * q) + lane] = -sum[u];
  }
}

// The SPD matrix in the leading m x m block of L (m = 32 np <= T, stored
// as Lay says; only the lower triangle is read) into its Cholesky factor in
// place, and its explicit inverse into X (the diagonal blocks and the
// blocks below them; the blocks above are left as they were), on the 256
// threads of the CTA, which have synchronised after filling L. Factored by
// 32-wide sub-panels p = 0..np-1, o = 32 p:
//   (a) warp 0 factors the 32x32 diagonal block D_p in registers (chol32)
//       and inverts it by a right-looking substitution, one column a lane;
//       meanwhile warps 1-7 form P = L[o:o+32, :o] X[:o, :o] from the rows
//       of L^-1 = X finished so far;
//   (b) the rows below become L[o+32:m, o:o+32] D_p^-T, in place, two
//       threads a row, while the other threads finish row block p of the
//       inverse, X[o:o+32, :o] = -D_p^-1 P;
//   (c) the trailing part loses the new panel times its transpose, a 16x16
//       grid of threads with 6x6, 4x4 or 2x2 outputs each;
// 3 np - 1 block barriers where a column sweep takes m. Ends synchronised.
template <class Lay>
__device__ __forceinline__ void factor_sub_panels(float* L, float* X,
                                                  float* P, int np, int tid) {
  constexpr int ld = Lay::kRowLd;  // rows apart inside a 32x32 block
  const int lane = tid % 32, warp = tid / 32;
  for (int p = 0; p < np; ++p) {
    const int o = 32 * p;
    float* dl = L + Lay::at(o, o);  // the diagonal blocks D_p and its inverse
    float* dx = X + Lay::at(o, o);
    if (warp == 0) {  // (a)
      float v[32], rinv[32];
      float* row = dl + lane * ld;
#pragma unroll
      for (int m = 0; m < 32; ++m) v[m] = (m <= lane) ? row[m] : 0.f;
      chol32(v, rinv, lane);
#pragma unroll
      for (int m = 0; m < 32; ++m) row[m] = (m <= lane) ? v[m] : 0.f;
      __syncwarp();
      // column `lane` of D_p^-1: s stays 0 above the diagonal
      float s[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r] = (r == lane) ? 1.f : 0.f;
#pragma unroll
      for (int m = 0; m < 32; ++m) {
        s[m] *= rinv[m];
#pragma unroll
        for (int r = m + 1; r < 32; ++r)
          s[r] = fmaf(-dl[r * ld + m], s[m], s[r]);
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) dx[r * ld + lane] = s[r];
    } else if (p > 0) {  // P, warp w rows w - 1 + 7 u, the lane a column
      for (int q = 0; q < p; ++q) {
        float sum[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
        for (int qq = q; qq < p; ++qq) {  // X[32 qq.., 32 q + lane]
          const float* xc = X + Lay::at(32 * qq, 32 * q) + lane;
          const float* lr = L + Lay::at(o + warp - 1, 32 * qq);
#pragma unroll 4
          for (int m = 0; m < 32; ++m) {
            const float x = xc[m * ld];
#pragma unroll
            for (int u = 0; u < 5; ++u)
              if (warp - 1 + 7 * u < 32)
                sum[u] = fmaf(lr[7 * u * ld + m], x, sum[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 5; ++u)
          if (warp - 1 + 7 * u < 32)
            P[(warp - 1 + 7 * u) * kPLd + 32 * q + lane] = sum[u];
      }
    }
    __syncthreads();

    const int nb = 32 * np - o - 32;  // rows below the diagonal block
    if (tid < 2 * nb) {  // (b) row o + 32 + tid / 2, columns of parity tid % 2
      float* ar = L + Lay::at(o + 32 + tid / 2, o);
      float av[32];
#pragma unroll
      for (int m = 0; m < 32; ++m) av[m] = ar[m];
      __syncwarp();  // both threads of the row have read it: write in place
#pragma unroll 4
      for (int h = tid % 2; h < 32; h += 2) {
        const float* dr = dx + h * ld;
        float sum = 0.f;
#pragma unroll
        for (int m = 0; m < 32; ++m) sum = fmaf(av[m], dr[m], sum);
        ar[h] = sum;
      }
    } else if (nb == 64) {  // X[o:o+32, :o] = -D_p^-1 P on the other warps
      inverse_rows<4, Lay>(X, P, o, p, (tid - 2 * nb) / 32, lane);
    } else if (nb == 32) {
      inverse_rows<6, Lay>(X, P, o, p, (tid - 2 * nb) / 32, lane);
    } else if (nb == 0) {
      inverse_rows<8, Lay>(X, P, o, p, tid / 32, lane);
    }
    __syncthreads();
    if (nb == 0) break;

    // (c) the trailing part
    if (nb == 96)
      trailing_update<6, Lay>(L, o, tid);
    else if (nb == 64)
      trailing_update<4, Lay>(L, o, tid);
    else
      trailing_update<2, Lay>(L, o, tid);
    __syncthreads();
  }
}

// L_kk = chol(A_kk) of matrix b = blockIdx.x in place (zeros above the
// diagonal), and L_kk^-1 into linv[b] ([T, T], zeros above). Only the lower
// triangle of A_kk is read. 12 block barriers a tile where a column sweep
// takes 128.
__global__ void __launch_bounds__(kFactorThreads, 1)
    tile_factor_kernel(TileView a, int k, float* __restrict__ linv) {
  extern __shared__ float fsm[];
  float* L = fsm;               // [T][kFLd]: the tile, then L_kk
  float* X = fsm + T * kFLd;    // [T][kFLd]: L_kk^-1
  float* P = X + T * kFLd;      // [32][kPLd]: L[o:o+32, :o] X[:o, :o]
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  float* tile = a.at(b, k, k);
#pragma unroll 8
  for (int idx = tid; idx < T * T; idx += kFactorThreads) {
    const int r = idx / T, c = idx % T;
    L[r * kFLd + c] = tile[(size_t)r * a.ld + c];
    X[r * kFLd + c] = 0.f;
  }
  __syncthreads();
  factor_sub_panels<Dense>(L, X, P, T / 32, tid);

  float* inv = linv + (size_t)b * T * T;
#pragma unroll 8
  for (int idx = tid; idx < T * T; idx += kFactorThreads) {
    const int r = idx / T, c = idx % T;
    tile[(size_t)r * a.ld + c] = c <= r ? L[r * kFLd + c] : 0.f;
    inv[(size_t)r * T + c] = c <= r ? X[r * kFLd + c] : 0.f;
  }
}

// Raise the dynamic shared-memory limit of the kernels that need more than
// 48 KB; returns a cudaError_t.
inline int set_smem_limits() {
  cudaError_t err = cudaFuncSetAttribute(
      tile_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFactorSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(tile_product_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kProductSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(tile_product_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kProductSmem);
}

}  // namespace tile_chol
