// Building blocks of the tile-blocked Cholesky kernels (blocked_cholesky.cu,
// hbm_cholesky.cu): 128x128 f32 tiles, 256 threads a CTA, f32 FFMA only (no
// TF32: every product here feeds a Cholesky).
//
//   tile_update_kernel  C_ic = base(i,c) - sum_{j in range} L_ij L_cj^T
//                       base: a tile of a matrix, or s * Z_i Z_c^T (Gram
//                       built on the fly), + diag on diagonal tiles; or no
//                       base, atomically added to C (split over j)
//   tile_factor_kernel  L_kk = chol(A_kk) in shared memory, zero above
//   tile_panel_kernel   L_ik = A_ik L_kk^-T, a column sweep of the
//                       triangular solve with the tile in registers
//
// Tiles are addressed through a TileView, so one set of kernels serves a
// dense [B, N, N] matrix (ld = N) and the tile-blocked [B, nt, nt, T, T]
// layout (ld = T). Every global offset is 64-bit: at N = 106496 a matrix has
// 1.1e10 elements.
#pragma once

#include <cuda_runtime.h>

namespace tile_chol {

constexpr int T = 128;        // tile edge
constexpr int kThreads = 256; // 16 x 16 threads, each an 8x8 block
constexpr int KC = 16;        // depth of one staged chunk
constexpr int LDS = T + 4;    // padded row of a staged chunk (16-byte rows)

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

// Thread (tx, ty) owns rows {4ty..4ty+3, 64+4ty..64+4ty+3} and the same
// pattern of columns with tx, so every staged read is a conflict-free
// 16-byte load.
__device__ __forceinline__ int own(int slot, int t) {
  return (slot < 4) ? 4 * t + slot : 64 + 4 * t + slot - 4;
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
}

// acc (+/-)= A[0:128, 0:depth] B[0:128, 0:depth]^T, both row-major with
// leading dimensions lda, ldb; depth a multiple of KC. Chunks are staged
// transposed in shared memory (As, Bs: [KC][LDS]); the next chunk is loaded
// into registers while the current one is used.
template <bool kSub>
__device__ __forceinline__ void gemm_acc(float (&acc)[8][8],
                                         const float* __restrict__ A, int lda,
                                         const float* __restrict__ B, int ldb,
                                         int depth, float* As, float* Bs) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int idx = tid + kThreads * p;
      const int r = idx >> 2, q = idx & 3;
      ra[p] = *reinterpret_cast<const float4*>(A + (size_t)r * lda + k0 + 4 * q);
      rb[p] = *reinterpret_cast<const float4*>(B + (size_t)r * ldb + k0 + 4 * q);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < depth; k0 += KC) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int idx = tid + kThreads * p;
      const int r = idx >> 2, q = idx & 3;
      As[(4 * q + 0) * LDS + r] = ra[p].x;
      As[(4 * q + 1) * LDS + r] = ra[p].y;
      As[(4 * q + 2) * LDS + r] = ra[p].z;
      As[(4 * q + 3) * LDS + r] = ra[p].w;
      Bs[(4 * q + 0) * LDS + r] = rb[p].x;
      Bs[(4 * q + 1) * LDS + r] = rb[p].y;
      Bs[(4 * q + 2) * LDS + r] = rb[p].z;
      Bs[(4 * q + 3) * LDS + r] = rb[p].w;
    }
    __syncthreads();
    if (k0 + KC < depth) fetch(k0 + KC);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * LDS + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * LDS + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * LDS + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * LDS + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[a][c] = fmaf(kSub ? -av[a] : av[a], bv[c], acc[a][c]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void load_tile(float (&acc)[8][8], const float* t,
                                          int ld) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float* row = t + (size_t)own(a, ty) * ld;
    const float4 v0 = *reinterpret_cast<const float4*>(row + 4 * tx);
    const float4 v1 = *reinterpret_cast<const float4*>(row + 64 + 4 * tx);
    acc[a][0] = v0.x; acc[a][1] = v0.y; acc[a][2] = v0.z; acc[a][3] = v0.w;
    acc[a][4] = v1.x; acc[a][5] = v1.y; acc[a][6] = v1.z; acc[a][7] = v1.w;
  }
}

template <bool kAtomic>
__device__ __forceinline__ void store_tile(const float (&acc)[8][8], float* t,
                                           int ld) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float* row = t + (size_t)own(a, ty) * ld;
    if (kAtomic) {
#pragma unroll
      for (int c = 0; c < 8; ++c) atomicAdd(row + own(c, tx), acc[a][c]);
    } else {
      *reinterpret_cast<float4*>(row + 4 * tx) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      *reinterpret_cast<float4*>(row + 64 + 4 * tx) =
          make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
    }
  }
}

// One CTA per output tile (i, c) of matrix b = blockIdx.z:
//   kTri:  blockIdx.x enumerates the lower pairs c <= i of the tiles below
//          and right of k (right-looking trailing update, c, i > k);
//   else:  i = k + blockIdx.x, c = k (left-looking column k).
// Without kAtomic the CTA writes base(i, c) + diag [i == c] minus its part
// of the strip; with kAtomic it adds minus its part of the strip to C.
// The strip range of split y = blockIdx.y is [j_begin + y j_chunk, j_end).
template <bool kGram, bool kAtomic, bool kTri>
__global__ void __launch_bounds__(kThreads, 2)
tile_update_kernel(TileView out, TileView base, const float* __restrict__ z,
                   long long z_batch, int d, TileView strip, int k,
                   int j_begin, int j_chunk,
                   int j_end, float scale, float diag) {
  __shared__ __align__(16) float As[KC * LDS];
  __shared__ __align__(16) float Bs[KC * LDS];
  const int b = blockIdx.z;
  int i, c;
  if (kTri) {
    const int x = blockIdx.x;
    int r = (int)((sqrtf(8.f * x + 1.f) - 1.f) * 0.5f);
    while (r * (r + 1) / 2 > x) --r;
    while ((r + 1) * (r + 2) / 2 <= x) ++r;
    i = k + 1 + r;
    c = k + 1 + x - r * (r + 1) / 2;
  } else {
    i = k + blockIdx.x;
    c = k;
  }
  const int jb = j_begin + blockIdx.y * j_chunk;
  const int je = min(jb + j_chunk, j_end);

  float acc[8][8];
  if (kAtomic) {
    zero(acc);
  } else if (kGram) {
    // s Z_i Z_c^T, Z [B, N, d] row-major
    const float* zb = z + (long long)b * z_batch;
    zero(acc);
    gemm_acc<false>(acc, zb + (long long)i * T * d, d,
                    zb + (long long)c * T * d, d, d, As, Bs);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[a][q] *= scale;
  } else {
    load_tile(acc, base.at(b, i, c), base.ld);
  }
  if (!kAtomic && i == c && diag != 0.f) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (own(a, ty) == own(q, tx)) acc[a][q] += diag;
  }
  for (int j = jb; j < je; ++j)
    gemm_acc<true>(acc, strip.at(b, i, j), strip.ld, strip.at(b, c, j),
                   strip.ld, T, As, Bs);
  store_tile<kAtomic>(acc, out.at(b, i, c), out.ld);
}

constexpr int kFactorLd = T + 1;
constexpr size_t kFactorSmem = sizeof(float) * T * kFactorLd;

// L_kk = chol(A_kk) of matrix b = blockIdx.x, in place: the tile goes to
// shared memory ([T][T+1], conflict-free column reads), a right-looking
// factorisation runs there (one barrier a step: column j is scaled one step
// late, when no thread reads it), and L comes back with zeros above the
// diagonal. Only the lower triangle of A_kk is read.
__global__ void __launch_bounds__(kThreads)
tile_factor_kernel(TileView a, int k) {
  extern __shared__ float K[];
  const int ld = kFactorLd;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float* t = a.at(blockIdx.x, k, k);
  for (int idx = tid; idx < T * T; idx += kThreads) {
    const int r = idx / T, c = idx % T;
    if (c <= r) K[r * ld + c] = t[(size_t)r * a.ld + c];
  }
  __syncthreads();
  float d_prev = 0.f;
  for (int j = 0; j < T; ++j) {
    const float dj = sqrtf(K[j * ld + j]);
    if (j > 0) {
      for (int r = j - 1 + tid; r < T; r += kThreads)
        K[r * ld + j - 1] = (r == j - 1) ? d_prev : K[r * ld + j - 1] / d_prev;
    }
    float li[8], lk[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = j + 1 + ty + 16 * q;
      li[q] = (r < T) ? K[r * ld + j] / dj : 0.f;
      const int c = j + 1 + tx + 16 * q;
      lk[q] = (c < T) ? K[c * ld + j] / dj : 0.f;
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int r = j + 1 + ty + 16 * p;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = j + 1 + tx + 16 * q;
        if (r < T && c <= r) K[r * ld + c] -= li[p] * lk[q];
      }
    }
    d_prev = dj;
    __syncthreads();
  }
  if (tid == 0) K[(T - 1) * ld + T - 1] = d_prev;
  __syncthreads();
  for (int idx = tid; idx < T * T; idx += kThreads) {
    const int r = idx / T, c = idx % T;
    t[(size_t)r * a.ld + c] = (c <= r) ? K[r * ld + c] : 0.f;
  }
}

constexpr size_t kPanelSmem = sizeof(float) * (T * LDS + 2 * T);

// L_ik = A_ik L_kk^-T for tile row i = k + 1 + blockIdx.x of matrix
// b = blockIdx.y, in place. L_kk^T sits in shared memory; the 128x128 panel
// tile sits in registers (8x8 a thread). Column j of X is A[:, j] / L_jj,
// computed by the 16 threads that own it and broadcast through shared
// memory (double-buffered by the parity of j, so one barrier a step); every
// thread then removes X[:, j] L[c, j] from its columns c > j.
__global__ void __launch_bounds__(kThreads)
tile_panel_kernel(TileView a, int k) {
  extern __shared__ __align__(16) float smem[];
  float* Lt = smem;           // [T][LDS], Lt[j][c] = L_kk[c][j]
  float* xs = smem + T * LDS; // [2][T]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y;
  const float* lkk = a.at(b, k, k);
  for (int idx = tid; idx < T * (T / 4); idx += kThreads) {
    const int r = idx % T, c4 = idx / T;  // rows fastest: conflict-free stores
    const float4 v = *reinterpret_cast<const float4*>(lkk + (size_t)r * a.ld + 4 * c4);
    Lt[(4 * c4 + 0) * LDS + r] = v.x;
    Lt[(4 * c4 + 1) * LDS + r] = v.y;
    Lt[(4 * c4 + 2) * LDS + r] = v.z;
    Lt[(4 * c4 + 3) * LDS + r] = v.w;
  }
  float* tile = a.at(b, k + 1 + blockIdx.x, k);
  float acc[8][8];
  load_tile(acc, tile, a.ld);
  __syncthreads();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    for (int t = 0; t < 16; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 64 * h + 4 * t + e;
        const int slot = 4 * h + e;
        float* xb = xs + (j & 1) * T;
        if (tx == t) {
          const float inv = 1.f / Lt[j * LDS + j];
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            acc[p][slot] *= inv;
            xb[own(p, ty)] = acc[p][slot];
          }
        }
        __syncthreads();
        const float4 x0 = *reinterpret_cast<const float4*>(xb + 4 * ty);
        const float4 x1 = *reinterpret_cast<const float4*>(xb + 64 + 4 * ty);
        const float4 l0 = *reinterpret_cast<const float4*>(Lt + j * LDS + 4 * tx);
        const float4 l1 = *reinterpret_cast<const float4*>(Lt + j * LDS + 64 + 4 * tx);
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float lv[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (own(q, tx) > j) {
#pragma unroll
            for (int p = 0; p < 8; ++p) acc[p][q] = fmaf(-xv[p], lv[q], acc[p][q]);
          }
        }
      }
    }
  }
  store_tile<false>(acc, tile, a.ld);
}

// Raise the dynamic shared-memory limit of the two kernels that need more
// than 48 KB; returns a cudaError_t.
inline int set_smem_limits() {
  cudaError_t err = cudaFuncSetAttribute(
      tile_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFactorSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(tile_panel_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kPanelSmem);
}

}  // namespace tile_chol
