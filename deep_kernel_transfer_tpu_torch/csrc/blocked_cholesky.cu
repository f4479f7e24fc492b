// Batched lower Cholesky of [B, N, N] f32, N a multiple of 128 up to 512,
// right-looking over 128-tiles, for Hopper.
//
// Replaces the Pallas TPU kernel
//   deep_kernel_transfer_tpu/ops/pallas/blocked_cholesky.py::blocked_cholesky
//   (pallas_call at blocked_cholesky.py:154, kernel at :52-139).
//
//   L = K with the tiles above the diagonal zeroed
//   for k in tiles:
//     L_kk = chol(L_kk)                  tile_factor_kernel, one CTA a matrix
//     L_ik = L_ik L_kk^-T, i > k         tile_panel_kernel, one CTA a tile
//     L_ij -= L_ik L_jk^T, k < j <= i    tile_update_kernel, one CTA a tile
//
// The TPU kernel holds the whole matrix in VMEM; an SM's 227 KB of shared
// memory holds one 128x128 tile, not a 512^2 matrix (1 MB), so the matrix
// stays in global memory (L2-resident: B=8, N=512 is 8 MB of the 50 MB L2)
// and each step's independent tiles run on their own CTAs. The TPU kernel's
// explicit tile inverse with a Newton step becomes a triangular solve
// against the factor held in shared memory. The upper triangle of L is
// exactly zero.
//
// Bound at the benchmark's shape (B=8, N=512) on an H100 SXM: B N^3/3 =
// 0.358 GFLOP at the 67 TFLOP/s f32 rate is 5.3 us; the bytes (the lower
// triangle of K read, L written, 12.6 MB) take 3.8 us at 3.35 TB/s. The
// operations bind. What binds this first design instead is its serial
// chain: 4 column steps of 3 launches, each step's factor a chain of 128
// barriers on one CTA a matrix.

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

// k, l: [batch, n, n] f32, contiguous, on the device, n a multiple of 128.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
int blocked_cholesky_forward(const float* k, float* l, int batch, int n,
                             void* stream) {
  if (n < T || n % T != 0 || batch < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = set_smem_limits();
  if (err != 0) return err;
  const long long total4 = (long long)batch * n * n / 4;
  const long long copy_blocks = (total4 + 255) / 256;
  copy_lower_tiles_kernel<<<(unsigned)(copy_blocks < 4096 ? copy_blocks : 4096),
                            256, 0, s>>>(
      reinterpret_cast<const float4*>(k), reinterpret_cast<float4*>(l), n,
      total4);
  const TileView v = dense_view(l, n);
  const int nt = n / T;
  for (int kk = 0; kk < nt; ++kk) {
    tile_factor_kernel<<<batch, kThreads, kFactorSmem, s>>>(v, kk);
    const int rows = nt - kk - 1;
    if (rows == 0) break;
    tile_panel_kernel<<<dim3(rows, batch), kThreads, kPanelSmem, s>>>(v, kk);
    tile_update_kernel<false, false, true>
        <<<dim3(rows * (rows + 1) / 2, 1, batch), kThreads, 0, s>>>(
            v, v, nullptr, 0, 0, v, kk, kk, 1, kk + 1, 1.f, 0.f);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
