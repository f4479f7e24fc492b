// Batched lower Cholesky of [B, N, N] f32, N a multiple of 128 up to 512,
// right-looking over 128-tiles, for Hopper.
//
// Replaces the Pallas TPU kernel
//   deep_kernel_transfer_tpu/ops/pallas/blocked_cholesky.py::blocked_cholesky
//   (pallas_call at blocked_cholesky.py:154, kernel at :52-139).
//
//   L = K with the tiles above the diagonal zeroed
//   for k in tiles:
//     L_kk = chol(L_kk), L_kk^-1         tile_factor_kernel, one CTA a matrix
//     L_ik = L_ik (L_kk^-1)^T, i > k     tile_product_kernel, one CTA a tile
//     L_ij -= L_ik L_jk^T, k < j <= i    tile_product_kernel, one CTA a tile
//
// The TPU kernel holds the whole matrix in VMEM; an SM's 227 KB of shared
// memory holds one 128x128 tile and its inverse, not a 512^2 matrix (1 MB),
// so the matrix stays in global memory (L2-resident: B=8, N=512 is 8 MB of
// the 50 MB L2) and each step's independent tiles run on their own CTAs.
// As in the TPU kernel, the panel goes through an explicit inverse of the
// diagonal tile (there refined by a Newton step; here one exact triangular
// inverse from the factor kernel), so panel and trailing update are both
// 3xTF32 wgmma tile products (tile_cholesky.cuh). The upper triangle of L
// is exactly zero.
//
// Bound at the benchmark's shape (B=8, N=512) on an H100 SXM: B N^3/3 =
// 0.358 GFLOP at the 67 TFLOP/s f32 FFMA rate is 5.3 us, at the 3xTF32 rate
// this design uses (165 TFLOP/s) 2.2 us; the bytes (the lower triangle of
// K read, L written, 12.6 MB) take 3.8 us at 3.35 TB/s. What binds instead
// is the serial chain: 4 column steps of 3 launches, each step's factor on
// one CTA a matrix. The factor works by 32-wide sub-panels (a warp-register
// Cholesky of each 32x32 diagonal block, then products), 12 block barriers
// a tile for factor and inverse where a column sweep took 128.

#include <cuda_runtime.h>

#include "tile_cholesky.cuh"

using namespace tile_chol;

namespace {

// L = K on and below the diagonal tiles, 0 above them.
__global__ void copy_lower_tiles_kernel(const float4* __restrict__ k,
                                        float4* __restrict__ l, int n,
                                        long long total4) {
  const int n4 = n / 4;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total4; idx += (long long)gridDim.x * blockDim.x) {
    const long long e = idx % ((long long)n * n4);
    const int r = (int)(e / n4), c = (int)(e % n4) * 4;
    l[idx] = (c / T <= r / T) ? k[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

extern "C" {

int blocked_cholesky_max_n() { return 512; }

// k, l: [batch, n, n] f32; linv: [batch, 128, 128] f32 scratch; contiguous,
// on the device, n a multiple of 128. Launches on `stream`; returns 0, a
// cudaError_t, or minus a CUresult.
int blocked_cholesky_forward(const float* k, float* l, float* linv,
                             int batch, int n, void* stream) {
  if (n < T || n % T != 0 || batch < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = set_smem_limits();
  if (err != 0) return err;
  TileMap lmap, imap;
  if ((err = dense_map(&lmap, l, n, batch)) != 0) return err;
  if ((err = inverse_map(&imap, linv, batch)) != 0) return err;
  const long long total4 = (long long)batch * n * n / 4;
  const long long copy_blocks = (total4 + 255) / 256;
  copy_lower_tiles_kernel<<<(unsigned)(copy_blocks < 4096 ? copy_blocks : 4096),
                            256, 0, s>>>(
      reinterpret_cast<const float4*>(k), reinterpret_cast<float4*>(l), n,
      total4);
  const TileView v = dense_view(l, n);

  // the panel: L_ik (L_kk^-1)^T for the rows below the diagonal tile
  ProductArgs panel{};
  panel.a1 = panel.strip = lmap;
  panel.b1 = imap;
  panel.out = v;
  panel.base = TileView{};
  panel.row0 = 1;
  panel.n1 = T / kChunk;
  panel.scale1 = 1.f;
  // the trailing update: L_ij - L_ik L_jk^T, a strip of one tile
  ProductArgs up{};
  up.a1 = up.b1 = up.strip = lmap;
  up.out = up.base = v;
  up.tri = 1;
  up.j_chunk = 1;
  up.scale1 = 1.f;

  const int nt = n / T;
  for (int kk = 0; kk < nt; ++kk) {
    tile_factor_kernel<<<batch, kFactorThreads, kFactorSmem, s>>>(v, kk, linv);
    const int rows = nt - kk - 1;
    if (rows == 0) break;
    panel.k = kk;
    tile_product_kernel<false>
        <<<dim3(rows, 1, batch), kProductThreads, kProductSmem, s>>>(panel);
    up.k = up.j_begin = kk;
    up.j_end = kk + 1;
    tile_product_kernel<false>
        <<<dim3(rows * (rows + 1) / 2, 1, batch), kProductThreads,
           kProductSmem, s>>>(up);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
