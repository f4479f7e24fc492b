// Fused one-vs-rest linear-kernel GP marginal log-likelihood for Hopper.
//
// Replaces the Pallas TPU kernel
//   deep_kernel_transfer_tpu/ops/pallas/fused_mll.py::fused_linear_mll
//   (pallas_call at fused_mll.py:165, kernel _episode_kernel at :54-154).
//
// For episode b and way w, with M = 32 ceil(N / 32):
//   G      = Z_b Z_b^T                                  (f32 FFMA, no TF32)
//   K_w    = s_w G + (noise + jitter) I, padded to M x M with an identity block
//   L      = chol(K_w),  X = L^-1                       (explicit inverse)
//   y      = X diff_w,   alpha = X^T y                  (products)
// s_w and diff_w are shared by the batch (training) or the episode's own
// (test-time adaptation): the kernel reads them through an episode stride
// that is 0 for the shared form, so both forms run the same arithmetic.
//   mll    = -0.5 (|y|^2 + 2 sum_{i<N} log L_ii + N log 2pi) / N
// The identity block adds exactly nothing: its rows of L and X are zero left
// of the diagonal, its entries of diff are 0, and the log sum stops at N.
// For the backward (torch ops in ops/fused_mll.py) the forward writes X
// [B, W, N, N] (zeros above the diagonal), alpha [B, W, N] and G [B, N, N]:
// K^-1 = X^T X and G need no triangular solve and no second Gram there.
//
// Two kernels on the caller's stream:
//   gram_kernel     one CTA for each episode and each of S <= 8 shares of D,
//                   a thread for each 4x8 tile on or below the diagonal (up
//                   to 9 warps). 32-deep chunks of Z's rows are staged
//                   depth-major in shared memory by cp.async, a ring of 4
//                   (three chunks in flight while one is summed). The CTA
//                   writes its share to a workspace [S, B, M, M].
//   episode_kernel  one CTA of 256 threads for each (way, episode): adds the
//                   S shares in a fixed order into K in shared memory (the
//                   way-0 CTA also writes G), factors K by 32-wide sub-panels
//                   with the explicit inverse (tile_chol::factor_sub_panels,
//                   the diagonal-tile factor of the Cholesky kernels), then
//                   y and alpha as products with X, a thread a row of X for y
//                   and a column for alpha. L and X keep only their 10 blocks
//                   on and below the diagonal (96 KB of shared memory in all)
//                   and the kernel at most 128 registers a thread, so two
//                   CTAs fit on an SM and the main path's 160 run in one wave.
//
// Bound at the main-path shape (B=32 episodes, N=100, D=1600, W=5) on an
// H100 SXM: the Gram's lower triangle is B N (N+1) D = 0.517 GFLOP of f32;
// with the B W factors and inverses (2 N^3 / 3 each) and the two products
// (2 N^2) 0.627 GFLOP, 9.4 us at the 67 TFLOP/s FFMA rate. The bytes (Z in;
// X, alpha and G out) are 28.2 MB, 8.4 us at 3.35 TB/s. Operations bind.
//
// What the first design was bound by, and what this one does about it:
//   1. Each (way, episode) CTA formed the whole padded 128x128 Gram over all
//      of D: 5 times an episode, 8.4 GFLOP on 160 CTAs. Now each episode's
//      Gram is formed once, only its tiles on and below the diagonal, spread
//      over 8 CTAs an episode by D shares.
//   2. The factor was a chain of N rank-1 steps with a block barrier each.
//      Now M / 32 sub-panels, 3 M / 32 - 1 barriers, each 32x32 diagonal
//      block factored in one warp's registers.
//   3. The two solves were 2 N serial steps in one warp while the other 7
//      warps had returned. Now two products with the explicit inverse, on N
//      threads.
//   4. The backward solved L X = I for K^-1 and formed Z Z^T again. Now it
//      reads X and G.
// What binds now (PERF.md): the factor's chain, about 45 us for one
// CTA alone, and 1.5 times that where two CTAs share an SM; and the Gram's
// sums, which wait on the shared-memory pipe (a float4 shared load costs
// four cycles of it: 3 for 32 FFMA), not on FFMA.

#include <climits>

#include <cuda_runtime.h>

#include "tile_cholesky.cuh"

namespace {

using tile_chol::kFactorThreads;
using tile_chol::kPLd;
using tile_chol::T;

constexpr int kMaxN = T;
constexpr int kBlk = 32;  // the factor's sub-panels, the Gram's chunk depth
constexpr int kMaxGramThreads = 288;  // the 272 4x8 tiles of 128 rows
constexpr int kMaxSplits = 8;

using Lay = tile_chol::LowerBlocks;
constexpr int kWarps = kFactorThreads / 32;
constexpr size_t kEpisodeSmem =
    sizeof(float) * (2 * Lay::kFloats + 32 * kPLd + 2 * T + 2 * kWarps);

// The Gram's tiles: 4 rows x 8 columns, on and below the diagonal. Row
// group r (rows 4 r .. 4 r + 3) has r / 2 + 1 of them.
__host__ __device__ inline int gram_tiles(int n) {
  int t = 0;
  for (int r = 0; r < (n + 3) / 4; ++r) t += r / 2 + 1;
  return t;
}

// tile t: row group tr, column group tc
__device__ __forceinline__ void tile_of(int t, int& tr, int& tc) {
  int base = 0;
  tr = 0;
  while (base + tr / 2 + 1 <= t) base += tr++ / 2 + 1;
  tc = t - base;
}

struct GramPlan {
  int m;          // N padded to a multiple of 32
  int splits;     // shares of D, one CTA each an episode
  int per_split;  // 32-deep chunks of D in a share
  int threads;    // the tiles, in whole warps
};

GramPlan gram_plan(int n, int d) {
  GramPlan p;
  p.m = kBlk * ((n + kBlk - 1) / kBlk);
  const int chunks = (d + kBlk - 1) / kBlk;
  p.per_split = (chunks + kMaxSplits - 1) / kMaxSplits;
  p.splits = (chunks + p.per_split - 1) / p.per_split;
  p.threads = 32 * ((gram_tiles(n) + 31) / 32);
  return p;
}

// kStages stages of a 32-deep chunk of Z's rows, depth-major, lines of
// m + 4 floats (float4s stay aligned; the 32 lanes' 4-byte copies of one
// row fall in 8 banks): 66 KB at m = 128, up to three CTAs an SM.
constexpr int kStages = 4;
size_t gram_smem(int m) { return sizeof(float) * kStages * kBlk * (m + 4); }

// 4 bytes from global to shared memory, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
          (uint32_t)__cvta_generic_to_shared(dst)),
      "l"(src), "r"(valid ? 4 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// part[split, b] ([m, m]) = Z_b Z_b^T over chunks [split c, (split + 1) c)
// of 32 of D, on and below the diagonal (entries above it, and in rows >=
// 4 ceil(n / 4), may be left unwritten); split = blockIdx.x, episode b =
// blockIdx.y. A thread sums one 4x8 tile from the staged chunk in shared
// memory while the next three arrive by cp.async.
__global__ void __launch_bounds__(kMaxGramThreads, 2)
    gram_kernel(const float* __restrict__ z, float* __restrict__ part,
                int batch, int n, int d, int m, int per_split) {
  extern __shared__ __align__(16) float stage[];
  const int ld = m + 4;
  const int split = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the tiles' rows and columns: 8 ceil(n / 8) <= m
  const int warps = blockDim.x / 32, rows = 8 * ((n + 7) / 8);
  int tr, tc;
  tile_of(tid, tr, tc);
  const bool live = tid < gram_tiles(n);
  const int c_begin = split * per_split;
  const int c_end = min(c_begin + per_split, (d + kBlk - 1) / kBlk);
  const float* zb = z + (size_t)b * n * d;

  // chunk c into its stage: warp w copies rows w + warps u, the lane a
  // depth; rows >= n and depths >= d are zero
  auto fetch = [&](int c) {
    if (c >= c_end) return;
    float* st = stage + (c - c_begin) % kStages * kBlk * ld;
    const int col = kBlk * c + lane;
    for (int r = warp; r < rows; r += warps) {
      const bool valid = r < n && col < d;
      cp_async4(st + lane * ld + r, valid ? zb + (size_t)r * d + col : zb,
                valid);
    }
  };
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // a ring of kStages: chunk c is summed while c + 1 .. c + kStages - 1
  // arrive (one commit group a chunk, empty past the end)
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    fetch(c_begin + t);
    cp_async_commit();
  }
  for (int c = c_begin; c < c_end; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has arrived
    __syncthreads();  // ... for every thread; chunk c - 1's stage is free
    fetch(c + kStages - 1);
    cp_async_commit();
    const float* cur = stage + (c - c_begin) % kStages * kBlk * ld;
    if (live) {
#pragma unroll 4
      for (int k = 0; k < kBlk; ++k) {
        const float* line = cur + k * ld;
        const float4 a = *reinterpret_cast<const float4*>(line + 4 * tr);
        const float4 b0 = *reinterpret_cast<const float4*>(line + 8 * tc);
        const float4 b1 = *reinterpret_cast<const float4*>(line + 8 * tc + 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  if (!live) return;
  float* out = part + ((size_t)split * batch + b) * m * m;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(out + (size_t)(4 * tr + i) * m + 8 * tc +
                                 4 * h) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
}

// One (way w = blockIdx.x, episode b = blockIdx.y): mll, X = L^-1 and
// alpha, from the S shares of G in part [S, B, m, m]; the way-0 CTA also
// writes G [B, n, n]. L and X keep only their blocks on and below the
// diagonal (Lay), so that two CTAs fit on an SM.
__global__ void __launch_bounds__(kFactorThreads, 2)
    episode_kernel(const float* __restrict__ part,
                   const float* __restrict__ diffs,
                   const float* __restrict__ scales, float* __restrict__ mll,
                   float* __restrict__ linv, float* __restrict__ alpha,
                   float* __restrict__ gram, int batch, int n, int n_way,
                   int m, int splits, int scale_stride, int diff_stride,
                   float diag_add, float n_log_2pi) {
  extern __shared__ float fsm[];
  float* L = fsm;                  // K_w, then L
  float* X = L + Lay::kFloats;     // L^-1
  float* P = X + Lay::kFloats;     // [32][kPLd]: the factor's scratch
  float* v = P + 32 * kPLd;        // [T]: diff_w, zero-padded
  float* y = v + T;                // [T]: X diff_w, zero-padded
  float* red = y + T;              // [2][kWarps]: the warps' sums
  const int w = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  // K = s_w G + diag on and below the diagonal, the identity block beyond
  // N. G is the sum of the shares in a fixed order; float4s of the blocks
  // on and below the diagonal, kLoads positions a thread at a time.
  constexpr int kLoads = 10;  // all of m = 128
  const float s = scales[(size_t)b * scale_stride + w];
  const int nb = m / kBlk, lower4 = nb * (nb + 1) / 2 * kBlk * 8;
  const size_t share = (size_t)batch * m * m;
  const float4* pb = reinterpret_cast<const float4*>(part + (size_t)b * m * m);
  float* gb = gram + (size_t)b * n * n;
  for (int f0 = tid; f0 < lower4; f0 += kLoads * kFactorThreads) {
    int off[kLoads];  // float4 index in [m, m] of position u
    float4 g[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      // position f: block t = f / 256 of the lower blocks, its row and
      // float4 within the row
      const int f = min(f0 + u * kFactorThreads, lower4 - 1);
      int bi = 0;
      while ((bi + 1) * (bi + 2) / 2 <= f / 256) ++bi;
      const int bj = f / 256 - bi * (bi + 1) / 2;
      off[u] = (kBlk * bi + f % 256 / 8) * (m / 4) + 8 * bj + f % 8;
      g[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 2
    for (int sp = 0; sp < splits; ++sp)
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const float4 t = pb[sp * share / 4 + off[u]];
        g[u] = make_float4(g[u].x + t.x, g[u].y + t.y, g[u].z + t.z,
                           g[u].w + t.w);
      }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (f0 + u * kFactorThreads >= lower4) break;
      const int i = off[u] / (m / 4), j0 = 4 * (off[u] % (m / 4));
      const float gv[4] = {g[u].x, g[u].y, g[u].z, g[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        float k = (i == j) ? 1.f : 0.f;
        if (i < n && j <= i) {
          k = s * gv[e] + (i == j ? diag_add : 0.f);
          if (w == 0) gb[i * n + j] = gb[j * n + i] = gv[e];
        }
        L[Lay::at(i, j)] = k;
        X[Lay::at(i, j)] = 0.f;
      }
    }
  }
  for (int i = tid; i < m; i += kFactorThreads)
    v[i] = i < n ? diffs[(size_t)b * diff_stride + (size_t)w * n + i] : 0.f;
  __syncthreads();

  tile_chol::factor_sub_panels<Lay>(L, X, P, m / kBlk, tid);

  // y = X diff, a thread a row (X is 0 above its diagonal, diff beyond N);
  // |y|^2 and sum log L_ii over the real rows
  float quad = 0.f, logdiag = 0.f;
  if (tid < n) {
    float acc = 0.f;
    for (int jb = 0; jb <= tid / kBlk; ++jb) {
      const float* xr = X + Lay::at(tid, kBlk * jb);
#pragma unroll 8
      for (int j = 0; j < kBlk; ++j) acc = fmaf(xr[j], v[kBlk * jb + j], acc);
    }
    y[tid] = acc;
    quad = acc * acc;
    logdiag = logf(L[Lay::at(tid, tid)]);
  } else if (tid < m) {
    y[tid] = 0.f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    quad += __shfl_xor_sync(0xffffffffu, quad, off);
    logdiag += __shfl_xor_sync(0xffffffffu, logdiag, off);
  }
  if (lane == 0) {
    red[warp] = quad;
    red[kWarps + warp] = logdiag;
  }
  __syncthreads();

  const size_t bw = (size_t)b * n_way + w;
  if (tid < n) {  // alpha = X^T y, a thread a column
    float acc = 0.f;
    for (int ib = tid / kBlk; ib < m / kBlk; ++ib) {
      const float* xc = X + Lay::at(kBlk * ib, tid);
#pragma unroll 8
      for (int i = 0; i < kBlk; ++i)
        acc = fmaf(xc[i * Lay::kRowLd], y[kBlk * ib + i], acc);
    }
    alpha[bw * n + tid] = acc;
  }
  if (tid == 0) {
    float q = 0.f, l = 0.f;
    for (int u = 0; u < kWarps; ++u) {
      q += red[u];
      l += red[kWarps + u];
    }
    mll[bw] = -0.5f * (q + 2.f * l + n_log_2pi) / (float)n;
  }
  float* xb = linv + bw * n * n;
  for (int idx = tid; idx < n * n; idx += kFactorThreads) {
    const int i = idx / n, j = idx % n;
    xb[idx] = (j <= i) ? X[Lay::at(i, j)] : 0.f;
  }
}

bool valid(int batch, int n, int d, int n_way) {
  return n >= 1 && n <= kMaxN && d >= 1 && n_way >= 1 && n_way <= 65535 &&
         batch >= 1 && batch <= 65535;
}

}  // namespace

extern "C" {

// Floats of the workspace that fused_mll_forward takes at this shape: the S
// shares of the Gram, [S, B, M, M] (0 for a shape it refuses).
long long fused_mll_workspace_floats(int batch, int n, int d) {
  if (!valid(batch, n, d, 1)) return 0;
  const GramPlan p = gram_plan(n, d);
  return (long long)p.splits * batch * p.m * p.m;
}

// z [B, N, D], diffs [W, N] or [B, W, N], scales [W] or [B, W] -> mll
// [B, W], linv = L^-1 [B, W, N, N], alpha [B, W, N], gram = Z Z^T
// [B, N, N]; work: the workspace (fused_mll_workspace_floats). per_episode_
// scales and per_episode_diffs say which form each of the two has. All f32,
// contiguous, on the device, work 16-byte aligned. Launches on `stream` and
// returns a cudaError_t (0 on success).
int fused_mll_forward(const float* z, const float* diffs, const float* scales,
                      float* mll, float* linv, float* alpha, float* gram,
                      float* work, int batch, int n, int d, int n_way,
                      int per_episode_scales, int per_episode_diffs,
                      float diag_add, void* stream) {
  if (!valid(batch, n, d, n_way) || (long long)batch * n_way * n > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const GramPlan p = gram_plan(n, d);
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gram_smem(kMaxN));
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(episode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kEpisodeSmem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  gram_kernel<<<dim3(p.splits, batch), p.threads, gram_smem(p.m), s>>>(
      z, work, batch, n, d, p.m, p.per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float n_log_2pi = (float)(n * 1.8378770664093453);
  episode_kernel<<<dim3(n_way, batch), kFactorThreads, kEpisodeSmem, s>>>(
      work, diffs, scales, mll, linv, alpha, gram, batch, n, n_way, p.m,
      p.splits, per_episode_scales ? n_way : 0,
      per_episode_diffs ? n_way * n : 0, diag_add, n_log_2pi);
  return (int)cudaGetLastError();
}

}  // extern "C"
