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
//     C_ik = G(i,k) - sum_{j<k} L_ij L_kj^T, i >= k      tile_product_kernel
//     L_kk = chol(C_kk), L_kk^-1 into a [B, T, T] scratch tile_factor_kernel
//     L_ik = C_ik (L_kk^-1)^T, i > k                      tile_product_kernel
//
// The TPU kernel runs one program per matrix, in order on one core; here
// the column's nt - k tiles run on their own CTAs (one an SM), and the
// strip sum over j is split across CTAs that add their parts atomically
// when a wave model (strip_splits) says the column alone would leave SMs
// idle. Column k + 1's update over j < k runs on a side stream while column
// k's factor and panel run (lookahead), so the serial chain of one CTA a
// matrix overlaps the long updates. Like the TPU kernel (its 7-step Newton
// inverse, :92-133), the panel goes through an explicit inverse of the
// diagonal tile; here one exact triangular inverse, formed by the factor
// kernel, and the panel is a tile product on the same path as the strip.
//
// Bound on an H100 SXM: the work is B N^3/3 (+ B N (N+1) D for the fused
// Gram's lower triangle) in f32; the bytes are K's lower triangle or Z read
// and L written at 3.35 TB/s. The operations bind: at 67 TFLOP/s (f32
// FFMA) 0.0855 ms general and 0.1175 ms fused (D=256) at B=2, N=2048, and
// 179 ms tiled at B=1, N=32768, D=256; at the 3xTF32 rate this design uses
// (495 / 3 = 165 TFLOP/s) 0.0347, 0.0477 and 72.7 ms. The strip, Gram and
// panel products run on the tensor cores in 3xTF32 wgmma with TMA-fed
// shared-memory stages (tile_cholesky.cuh); what the lookahead cannot hide
// is the chain of each column step (factor on one CTA a matrix, panel, the
// last strip tile), which binds at small N.

#include <cuda_runtime.h>

#include "tile_cholesky.cuh"

using namespace tile_chol;

namespace {

// Into how many parts to split the strip j < k of a column of `ctas` tiles,
// one CTA an SM: the count that minimises the time in tiles of depth,
// waves x (depth of a part + 1, a CTA's fixed cost), each part at least 4
// tiles deep. Split parts add atomically after a launch that writes the
// base, one more wave of fixed costs.
int strip_splits(int ctas, int k, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= (k > 4 ? k / 4 : 1); ++s) {
    const long long waves = ((long long)ctas * s + sms - 1) / sms;
    const long long cost = waves * ((k + s - 1) / s + 1) +
                           (s > 1 ? (ctas + sms - 1) / sms : 0);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// The lookahead's side stream on device dev and its two events, made on
// first use and kept. Returns a cudaError_t.
struct Side {
  cudaStream_t stream;
  cudaEvent_t fork, join;
};

int side_stream(int dev, Side* out) {
  constexpr int kDevices = 64;
  static Side made[kDevices];
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  Side& m = made[dev];
  if (m.stream == nullptr) {
    cudaError_t err = cudaStreamCreateWithFlags(&m.stream,
                                                cudaStreamNonBlocking);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&m.fork, cudaEventDisableTiming);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&m.join, cudaEventDisableTiming);
    if (err != cudaSuccess) {
      m.stream = nullptr;
      return (int)err;
    }
  }
  *out = m;
  return 0;
}

}  // namespace

extern "C" {

// src: Z [batch, n, d] when fused, else K [batch, n, n]; out: tiled
// [batch, nt, nt, 128, 128]; linv: [batch, 128, 128] scratch. All f32,
// contiguous, on the device; n and d multiples of 128. Launches on
// `stream`; returns 0, a cudaError_t, or minus a CUresult.
int hbm_cholesky_forward(const float* src, float* out, float* linv,
                         int batch, int n, int d, int fused, float scale,
                         float diag, void* stream) {
  if (n < T || n % T != 0 || batch < 1 || (fused && (d < T || d % T != 0)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = set_smem_limits();
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);

  TileMap lmap, imap, zmap;
  if ((err = tiled_map(&lmap, out, n, batch)) != 0) return err;
  if ((err = inverse_map(&imap, linv, batch)) != 0) return err;
  if (fused && (err = rows_map(&zmap, src, n, d, batch)) != 0) return err;
  const TileView lv = tiled_view(out, n);
  const TileView none{};

  Side side;
  if ((err = side_stream(dev, &side)) != 0) return err;

  // the column update: base (K, or the Gram of Z) + diag minus the strip
  ProductArgs up{};
  up.a1 = up.b1 = fused ? zmap : lmap;
  up.strip = lmap;
  up.out = lv;
  up.base = fused ? none : dense_view(const_cast<float*>(src), n);
  up.n1 = fused ? d / kChunk : 0;
  up.scale1 = scale;
  up.diag = diag;
  // the panel: C_ik (L_kk^-1)^T for the rows below the diagonal tile
  ProductArgs panel{};
  panel.a1 = panel.strip = lmap;
  panel.b1 = imap;
  panel.out = lv;
  panel.base = none;
  panel.row0 = 1;
  panel.n1 = T / kChunk;
  panel.scale1 = 1.f;

  const int nt = n / T;
  // column k's update over the strip j < depth, on stream st: the base
  // (with the Gram) and the first part, then the other parts atomically
  auto update = [&](int k, int depth, cudaStream_t st) {
    const int rows = nt - k;
    const int splits = strip_splits(rows * batch, depth, sms);
    up.k = k;
    up.j_begin = 0;
    up.j_chunk = up.j_end = splits == 1 ? depth : 0;
    tile_product_kernel<false>
        <<<dim3(rows, 1, batch), kProductThreads, kProductSmem, st>>>(up);
    if (splits > 1) {
      ProductArgs part = up;
      part.n1 = 0;
      part.j_chunk = (depth + splits - 1) / splits;
      part.j_end = depth;
      tile_product_kernel<true>
          <<<dim3(rows, (depth + part.j_chunk - 1) / part.j_chunk, batch),
             kProductThreads, kProductSmem, st>>>(part);
    }
  };
  // Lookahead: column k + 1's update over j < k needs no part of column k,
  // so it runs on the side stream while column k's factor and panel run on
  // `stream`; its last strip tile, j = k, follows the panel atomically, and
  // `stream` has joined the side stream by the end.
  update(0, 0, s);
  for (int k = 0; k < nt; ++k) {
    const bool next = k + 1 < nt;
    if (next) {
      cudaEventRecord(side.fork, s);
      cudaStreamWaitEvent(side.stream, side.fork, 0);
      update(k + 1, k, side.stream);
      cudaEventRecord(side.join, side.stream);
    }
    tile_factor_kernel<<<batch, kFactorThreads, kFactorSmem, s>>>(lv, k,
                                                                  linv);
    if (next) {
      panel.k = k;
      tile_product_kernel<false>
          <<<dim3(nt - k - 1, 1, batch), kProductThreads, kProductSmem, s>>>(
              panel);
      cudaStreamWaitEvent(s, side.join, 0);
      ProductArgs last = up;
      last.k = k + 1;
      last.n1 = 0;
      last.j_begin = k;
      last.j_chunk = 1;
      last.j_end = k + 1;
      tile_product_kernel<true>
          <<<dim3(nt - k - 1, 1, batch), kProductThreads, kProductSmem, s>>>(
              last);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
