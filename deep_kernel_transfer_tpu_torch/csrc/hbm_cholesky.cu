// Left-looking tile-blocked Cholesky for large N, for Hopper, in two modes:
//   general: L = chol(K + diag I),         K [B, N, N]
//   fused:   L = chol(s Z Z^T + diag I),    Z [B, N, D]; no N x N Gram is
//            ever stored, each tile s Z_i Z_k^T is built where it is used
// L is written tile-blocked, [B, nt, nt, 128, 128]; tiles above the
// diagonal are never written.
//
// Replaces the Pallas TPU kernel
//   deep_kernel_transfer_tpu/ops/pallas/hbm_cholesky.py::_call_tiled
//   (pallas_call at hbm_cholesky.py:283, kernel body _make_kernel :136-259),
//   reached by hbm_blocked_cholesky (general) and fused_gram_cholesky /
//   fused_gram_cholesky_tiled (fused).
//
//   for k in tiles:
//     C_ik = G(i,k) - sum_{j<k} L_ij L_kj^T, i >= k     tile_update_kernel
//     L_kk = chol(C_kk)                                 tile_factor_kernel
//     L_ik = C_ik L_kk^-T, i > k                        tile_panel_kernel
//
// The TPU kernel runs one program per matrix, in order on one core; here
// the column's nt - k tiles run on their own CTAs, and when they are too few
// to fill the card (late columns, small B) the strip sum over j is split
// across CTAs that add their parts atomically. The 7-step Newton inverse of
// the diagonal tile becomes a triangular solve against the factor in
// shared memory.
//
// Bound on an H100 SXM: the work is B N^3/3 (+ B N (N+1) D for the fused
// Gram's lower triangle) in f32 at 67 TFLOP/s; the bytes are K's lower
// triangle or Z read and L written at 3.35 TB/s. At B=2, N=2048 the
// operations bind (0.0855 ms general, 0.1175 ms fused with D=256); at B=1,
// N=32768, D=256 the tiled output is 179 ms of operations. The strip
// updates are those operations; this first design runs them as an FFMA
// tile product (128x128 a CTA, 8x8 a thread, 16-deep chunks staged in
// shared memory) without wgmma or TMA, and adds a serial chain of three
// launches per column step.

#include <cuda_runtime.h>

#include "tile_cholesky.cuh"

using namespace tile_chol;

extern "C" {

// src: Z [batch, n, d] when fused, else K [batch, n, n]; out: tiled
// [batch, nt, nt, 128, 128]. All f32, contiguous, on the device; n and d
// multiples of 128. Launches on `stream`; returns cudaGetLastError().
int hbm_cholesky_forward(const float* src, float* out, int batch, int n,
                         int d, int fused, float scale, float diag,
                         void* stream) {
  if (n < T || n % T != 0 || batch < 1 || (fused && (d < T || d % T != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = set_smem_limits();
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int target = 2 * sms;  // two update CTAs fit on an SM

  const int nt = n / T;
  const TileView lv = tiled_view(out, n);
  const TileView kv = dense_view(const_cast<float*>(src), n);
  const long long z_batch = (long long)n * d;
  for (int k = 0; k < nt; ++k) {
    const int rows = nt - k;
    // split the strip j < k so that about `target` CTAs run, each over at
    // least 4 tiles of depth
    int chunk = k;
    if (k > 0 && rows * batch < target) {
      int splits = (target + rows * batch - 1) / (rows * batch);
      splits = splits < (k + 3) / 4 ? splits : (k + 3) / 4;
      chunk = (k + splits - 1) / splits;
    }
    const int first_end = k < chunk ? k : chunk;
    if (fused)
      tile_update_kernel<true, false, false>
          <<<dim3(rows, 1, batch), kThreads, 0, s>>>(
              lv, lv, src, z_batch, d, lv, k, 0, first_end, first_end, scale,
              diag);
    else
      tile_update_kernel<false, false, false>
          <<<dim3(rows, 1, batch), kThreads, 0, s>>>(
              lv, kv, nullptr, 0, 0, lv, k, 0, first_end, first_end, 1.f,
              diag);
    if (first_end < k) {
      const int rest = (k - first_end + chunk - 1) / chunk;
      tile_update_kernel<false, true, false>
          <<<dim3(rows, rest, batch), kThreads, 0, s>>>(
              lv, lv, nullptr, 0, 0, lv, k, first_end, chunk, k, 1.f, 0.f);
    }
    tile_factor_kernel<<<batch, kThreads, kFactorSmem, s>>>(lv, k);
    if (rows > 1)
      tile_panel_kernel<<<dim3(rows - 1, batch), kThreads, kPanelSmem, s>>>(
          lv, k);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
