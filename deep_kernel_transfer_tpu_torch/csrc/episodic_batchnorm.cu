// Episodic BatchNorm in training mode, with an optional fused ReLU, for
// bfloat16 activations in channels-last memory, on Hopper.
//
// Replaces no Pallas kernel: the JAX package leaves its BatchNorm
// (deep_kernel_transfer_tpu/models/backbones.py:120-139) to XLA, which fuses
// the one-pass statistics into one multi-output reduction. The port's torch
// chain (f32 cast, grouped view, mean, square, mean, subtract, rsqrt,
// multiply, add, cast, a separate ReLU, and autograd's replay of all of it
// backward) took three quarters of a training step; these kernels stand in
// for it.
//
// An activation x [G n, C, H, W] in channels-last memory is, for each of the
// G episodes, a dense [P, C] block with P = n H W rows of C channels. With
// count = P, per (episode g, channel c):
//   mean = sum x / P,  var = max(sum x^2 / P - mean^2, 0)   (one pass, f32)
//   rstd = rsqrt(var + eps),  scale = w rstd,  shift = b - mean scale
//   y    = bf16(x scale + shift), then max(y, 0) with the ReLU
// with w and b the float32 weight and bias rounded to bf16. Backward, with
// dy' = dy [y > 0] under the ReLU (else dy) and xh = (x - mean) rstd:
//   dx   = scale (dy' - sum dy' / P - xh sum(dy' xh) / P)
// and the per-(g, c) sums sum dy' and sum dy' xh written out for the bias
// and weight gradients. The ReLU mask is recomputed from x, scale and shift
// by the forward's own arithmetic, so y is never read back.
//
// Eight kernels, four entry points, all on the caller's stream:
//   forward:  episodic_bn_stats     one read of x: f32 partial sums
//             episodic_bn_finalize  mean, var, rstd, scale, shift
//             episodic_bn_apply     one read of x, one write of y
//   backward: episodic_bn_grad_stats   one read of dy and x: partial sums
//             episodic_bn_grad_finalize  the sums of the partials
//             episodic_bn_grad_apply     one read of dy and x, one write of dx
//   eval:     episodic_bn_eval_finalize  scale, shift from the running
//                                        mean and var
//             episodic_bn_apply     one read of x, one write of y
//   eval ConvBlock: episodic_bn_eval_finalize, then
//             episodic_bn_eval_epilogue  one read of x, one write of y or of
//                                        its 2x2 max-pool
// In eval mode the normalisation is one per-channel affine map, with the
// running mean and var in place of the batch's, over the whole batch as
// one group: G = 1, and the row split is the caller's, since no partial
// sums tie it to the training kernels' split. A ConvBlock's convolution
// runs without its bias b_c there, and the epilogue adds it, rounded to
// bf16 as ATen's separate bias pass after cuDNN rounds it: one pass gives
// the chain's output (bias add, BatchNorm, ReLU, max-pool) bit for bit.
// A streaming CTA takes one episode and a run of `per_split` rows of it, all
// C channels: a thread owns 8 neighbouring channels (one 16-byte access) and
// walks the rows C / 8 threads apart, four rows in flight, so its channels'
// coefficients sit in registers for the whole run. Partial sums are [G, S, 2,
// C]; each CTA reduces its threads' sums through shared memory in a fixed
// order, and the finalize kernels add the S partials in order: no atomics, so
// a call repeats bit for bit.
//
// Bound: BatchNorm moves bytes, not operations. The least any implementation
// moves is x in and y out forward, dy and x in and dx out backward: 10 bytes
// an element in bf16. These kernels move 16 (x is read twice each way, since
// the statistics must be complete before the apply pass): at 3.35 TB/s the
// Conv4 step's 2.01e9 elements take 9.6 ms, against the 6.0 ms bound.
// In eval mode the bound is x in and y out, 4 bytes an element, and the one
// apply pass moves just that. Where the block pools, the least is x in and
// the pooled y out, 2.5 bytes an element, in place of the 10.5 that the
// bias add (4), the apply (4) and torch's max-pool (2.5) moved as three
// passes; episodic_bn_eval_epilogue moves just the 2.5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;        // bf16 channels in one 16-byte access
constexpr int kThreads = 256;  // at most, a streaming CTA
constexpr int kUnroll = 4;     // rows a thread has in flight
constexpr int kMaxC = kVec * kThreads;
constexpr int kFinalizeThreads = 256;
// CTAs an SM holds at once (register budgets of 64 and 128 a thread): the
// backward kernels keep six coefficients a channel in registers.
constexpr int kStreamCtas = 4;
constexpr int kGradCtas = 2;
// The eval epilogue holds two 2x2 windows (eight 16-byte vectors) in
// flight a thread: 85 registers a thread.
constexpr int kEpilogueCtas = 3;

// A streaming CTA's shape: `lanes` threads across a row, `rows` rows at once.
struct Tile {
  int lanes, rows;
};

__host__ __device__ inline Tile tile_of(int c) {
  const int lanes = c / kVec;
  return {lanes, kThreads / lanes};
}

__device__ __forceinline__ void unpack(const uint4& raw, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return raw;
}

__device__ __forceinline__ uint4 load(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// max(v, 0) that keeps a NaN, as torch's relu does.
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// The forward's output before the ReLU, by the apply kernel's arithmetic.
__device__ __forceinline__ float affine(float x, float scale, float shift) {
  return fmaf(x, scale, shift);
}

// This thread's place in a streaming CTA over episode blockIdx.y, rows
// [begin, end) of it.
struct Walk {
  Tile tile;
  int lane, row0;
  long long begin, end;
  long long offset;  // of the thread's first channel of the episode, elements
};

__device__ __forceinline__ Walk walk_of(long long rows, int c,
                                        long long per_split) {
  Walk w;
  w.tile = tile_of(c);
  w.lane = threadIdx.x % w.tile.lanes;
  w.row0 = threadIdx.x / w.tile.lanes;
  const long long first = (long long)blockIdx.x * per_split;
  w.begin = first + w.row0;
  w.end = min(rows, first + per_split);
  w.offset = (long long)blockIdx.y * rows * c + w.lane * kVec;
  return w;
}

// 8 floats of a [.., G, C] table at (episode blockIdx.y, the thread's
// channels).
__device__ __forceinline__ void coeffs(const float* table, int c,
                                       const Walk& w, float* out) {
  const float4* p = reinterpret_cast<const float4*>(
      table + (long long)blockIdx.y * c + w.lane * kVec);
  const float4 a = p[0], b = p[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Adds the CTA's per-thread sums a and b over its rows, in row order, and
// writes them to out[0, c) and out[c, 2c).
__device__ void reduce_rows(const float* a, const float* b, float* out, int c,
                            const Walk& w) {
  __shared__ float red[2 * kThreads * kVec];  // [2][tile.rows][c]
  const int rows = w.tile.rows;
  float* ra = red + w.row0 * c + w.lane * kVec;
  float* rb = red + (rows + w.row0) * c + w.lane * kVec;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    ra[i] = a[i];
    rb[i] = b[i];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * c; k += blockDim.x) {
    const int which = k / c;
    const float* col = red + which * rows * c + (k - which * c);
    float acc = 0.f;
    for (int j = 0; j < rows; ++j) acc += col[j * c];
    out[k] = acc;
  }
}

// Partial sums of x and x^2: part [G, S, 2, C].
__global__ void __launch_bounds__(kThreads, kStreamCtas)
episodic_bn_stats(const __nv_bfloat16* __restrict__ x,
                  float* __restrict__ part, long long rows, int c,
                  long long per_split) {
  const Walk w = walk_of(rows, c, per_split);
  const __nv_bfloat16* src = x + w.offset;
  const int step = w.tile.rows;
  float s1[kVec] = {}, s2[kVec] = {};
  long long r = w.begin;
  for (; r + (kUnroll - 1) * step < w.end; r += kUnroll * step) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = load(src + (r + u * step) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[kVec];
      unpack(raw[u], v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s1[i] += v[i];
        s2[i] = fmaf(v[i], v[i], s2[i]);
      }
    }
  }
  for (; r < w.end; r += step) {
    float v[kVec];
    unpack(load(src + r * c), v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      s1[i] += v[i];
      s2[i] = fmaf(v[i], v[i], s2[i]);
    }
  }
  reduce_rows(s1, s2,
              part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * 2 * c,
              c, w);
}

// The two sums of (episode g, channel ch) over the S partials, in order.
__device__ __forceinline__ float2 sum_splits(const float* part, int g, int ch,
                                             int splits, int c) {
  const float* p = part + (long long)g * splits * 2 * c + ch;
  float a = 0.f, b = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    a += p[2 * s * c];
    b += p[(2 * s + 1) * c];
  }
  return make_float2(a, b);
}

// stats [5, G, C] = mean, var, rstd, scale, shift.
__global__ void __launch_bounds__(kFinalizeThreads)
episodic_bn_finalize(const float* __restrict__ part,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias,
                     float* __restrict__ stats, int groups, int splits, int c,
                     float count, float eps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= groups * c) return;
  const int g = idx / c, ch = idx - g * c;
  const float2 s = sum_splits(part, g, ch, splits, c);
  const float mean = s.x / count;
  const float var = relu(s.y / count - mean * mean);
  const float rstd = rsqrtf(var + eps);
  const float scale = round_bf16(weight[ch]) * rstd;
  const long long gc = (long long)groups * c;
  stats[idx] = mean;
  stats[gc + idx] = var;
  stats[2 * gc + idx] = rstd;
  stats[3 * gc + idx] = scale;
  stats[4 * gc + idx] = fmaf(-mean, scale, round_bf16(bias[ch]));
}

template <bool kRelu>
__global__ void __launch_bounds__(kThreads, kStreamCtas)
episodic_bn_apply(const __nv_bfloat16* __restrict__ x,
                  __nv_bfloat16* __restrict__ y,
                  const float* __restrict__ stats, int groups, long long rows,
                  int c, long long per_split) {
  const Walk w = walk_of(rows, c, per_split);
  const long long gc = (long long)groups * c;
  float scale[kVec], shift[kVec];
  coeffs(stats + 3 * gc, c, w, scale);
  coeffs(stats + 4 * gc, c, w, shift);
  const __nv_bfloat16* src = x + w.offset;
  __nv_bfloat16* dst = y + w.offset;
  const int step = w.tile.rows;
  auto out = [&](const uint4& raw) {
    float v[kVec];
    unpack(raw, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      v[i] = affine(v[i], scale[i], shift[i]);
      if (kRelu) v[i] = relu(v[i]);
    }
    return pack(v);
  };
  long long r = w.begin;
  for (; r + (kUnroll - 1) * step < w.end; r += kUnroll * step) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = load(src + (r + u * step) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      *reinterpret_cast<uint4*>(dst + (r + u * step) * c) = out(raw[u]);
  }
  for (; r < w.end; r += step)
    *reinterpret_cast<uint4*>(dst + r * c) = out(load(src + r * c));
}

// The backward's per-channel coefficients of this thread.
struct GradCoeffs {
  float mean[kVec], rstd[kVec], scale[kVec], shift[kVec];
};

template <bool kRelu>
__device__ __forceinline__ void grad_coeffs(const float* stats, int groups,
                                            int c, const Walk& w,
                                            GradCoeffs& k) {
  const long long gc = (long long)groups * c;
  coeffs(stats, c, w, k.mean);
  coeffs(stats + 2 * gc, c, w, k.rstd);
  coeffs(stats + 3 * gc, c, w, k.scale);
  if (kRelu) coeffs(stats + 4 * gc, c, w, k.shift);
}

// dy' and xh of 8 channels: the gradient masked where the forward's output
// was not positive (with the ReLU), and the normalised input.
template <bool kRelu>
__device__ __forceinline__ void masked(const uint4& dy_raw, const uint4& x_raw,
                                       const GradCoeffs& k, float* d,
                                       float* xh) {
  float xv[kVec];
  unpack(dy_raw, d);
  unpack(x_raw, xv);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (kRelu && !(round_bf16(affine(xv[i], k.scale[i], k.shift[i])) > 0.f))
      d[i] = 0.f;
    xh[i] = (xv[i] - k.mean[i]) * k.rstd[i];
  }
}

// Partial sums of dy' and dy' xh: part [G, S, 2, C].
template <bool kRelu>
__global__ void __launch_bounds__(kThreads, kGradCtas)
episodic_bn_grad_stats(const __nv_bfloat16* __restrict__ dy,
                       const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ stats,
                       float* __restrict__ part, int groups, long long rows,
                       int c, long long per_split) {
  const Walk w = walk_of(rows, c, per_split);
  GradCoeffs k;
  grad_coeffs<kRelu>(stats, groups, c, w, k);
  const __nv_bfloat16* gsrc = dy + w.offset;
  const __nv_bfloat16* xsrc = x + w.offset;
  const int step = w.tile.rows;
  float s1[kVec] = {}, s2[kVec] = {};
  auto add = [&](const uint4& g, const uint4& xr) {
    float d[kVec], xh[kVec];
    masked<kRelu>(g, xr, k, d, xh);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      s1[i] += d[i];
      s2[i] = fmaf(d[i], xh[i], s2[i]);
    }
  };
  long long r = w.begin;
  for (; r + (kUnroll - 1) * step < w.end; r += kUnroll * step) {
    uint4 g[kUnroll], xr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      g[u] = load(gsrc + (r + u * step) * c);
      xr[u] = load(xsrc + (r + u * step) * c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add(g[u], xr[u]);
  }
  for (; r < w.end; r += step) add(load(gsrc + r * c), load(xsrc + r * c));
  reduce_rows(s1, s2,
              part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * 2 * c,
              c, w);
}

// sums [2, G, C] = sum dy', sum dy' xh.
__global__ void __launch_bounds__(kFinalizeThreads)
episodic_bn_grad_finalize(const float* __restrict__ part,
                          float* __restrict__ sums, int groups, int splits,
                          int c) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= groups * c) return;
  const int g = idx / c;
  const float2 s = sum_splits(part, g, idx - g * c, splits, c);
  sums[idx] = s.x;
  sums[(long long)groups * c + idx] = s.y;
}

template <bool kRelu>
__global__ void __launch_bounds__(kThreads, kGradCtas)
episodic_bn_grad_apply(const __nv_bfloat16* __restrict__ dy,
                       const __nv_bfloat16* __restrict__ x,
                       __nv_bfloat16* __restrict__ dx,
                       const float* __restrict__ stats,
                       const float* __restrict__ sums, int groups,
                       long long rows, int c, long long per_split,
                       float count) {
  const Walk w = walk_of(rows, c, per_split);
  GradCoeffs k;
  grad_coeffs<kRelu>(stats, groups, c, w, k);
  float mdy[kVec], mdyx[kVec];
  coeffs(sums, c, w, mdy);
  coeffs(sums + (long long)groups * c, c, w, mdyx);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    mdy[i] /= count;
    mdyx[i] /= count;
  }
  const __nv_bfloat16* gsrc = dy + w.offset;
  const __nv_bfloat16* xsrc = x + w.offset;
  __nv_bfloat16* dst = dx + w.offset;
  const int step = w.tile.rows;
  auto out = [&](const uint4& g, const uint4& xr) {
    float d[kVec], xh[kVec];
    masked<kRelu>(g, xr, k, d, xh);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      d[i] = k.scale[i] * (d[i] - mdy[i] - xh[i] * mdyx[i]);
    return pack(d);
  };
  long long r = w.begin;
  for (; r + (kUnroll - 1) * step < w.end; r += kUnroll * step) {
    uint4 g[kUnroll], xr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      g[u] = load(gsrc + (r + u * step) * c);
      xr[u] = load(xsrc + (r + u * step) * c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      *reinterpret_cast<uint4*>(dst + (r + u * step) * c) = out(g[u], xr[u]);
  }
  for (; r < w.end; r += step)
    *reinterpret_cast<uint4*>(dst + r * c) =
        out(load(gsrc + r * c), load(xsrc + r * c));
}

// stats [5, 1, C] = running mean, running var, rstd, scale, shift: the
// training finalize's law with the running statistics in place of the
// batch's.
__global__ void __launch_bounds__(kFinalizeThreads)
episodic_bn_eval_finalize(const float* __restrict__ weight,
                          const float* __restrict__ bias,
                          const float* __restrict__ running_mean,
                          const float* __restrict__ running_var,
                          float* __restrict__ stats, int c, float eps) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  const float mean = running_mean[ch], var = running_var[ch];
  const float rstd = rsqrtf(var + eps);
  const float scale = round_bf16(weight[ch]) * rstd;
  stats[ch] = mean;
  stats[c + ch] = var;
  stats[2 * c + ch] = rstd;
  stats[3 * c + ch] = scale;
  stats[4 * c + ch] = fmaf(-mean, scale, round_bf16(bias[ch]));
}

// The larger of m and v, v where it is NaN, as torch's max_pool2d takes it.
__device__ __forceinline__ float pool_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// The eval epilogue of a convolution made without its bias b_c, in one
// pass: bf16(x + bf16(b_c)) (ATen's bias add, rounded as it rounds), the
// eval BatchNorm's affine map and the ReLU in f32, and with kPool the 2x2
// max-pool of stride 2: x [n, h, w, C] in, y [n, h / 2, w / 2, C] out
// (floor sizes: an odd map's last row and column are not read); without,
// y [n, h, w, C]. The walk's rows are output pixels: a thread owns 8
// channels of one, loads its window's 16-byte vectors (four, or one), and
// stores the rounded max as one 16-byte vector. The max comes after the
// map, whose scale may be negative; rounding to bf16 is monotone, so
// rounding the max is the max of the rounded values, and the window is
// walked in max_pool2d's order, so ties resolve alike. Neighbouring threads
// of a warp take neighbouring pooled pixels of one row, so each load
// instruction reads whole 32-byte sectors and a window's two loads of a row
// read 256 contiguous bytes. conv_bias null adds nothing.
template <bool kRelu, bool kPool>
__global__ void __launch_bounds__(kThreads, kEpilogueCtas)
episodic_bn_eval_epilogue(const __nv_bfloat16* __restrict__ x,
                          __nv_bfloat16* __restrict__ y,
                          const float* __restrict__ stats,
                          const float* __restrict__ conv_bias, int h, int w,
                          int c, long long rows, long long per_split) {
  constexpr int kWindow = kPool ? 4 : 1;
  const Walk wk = walk_of(rows, c, per_split);
  float scale[kVec], shift[kVec], add[kVec];
  coeffs(stats + 3 * c, c, wk, scale);
  coeffs(stats + 4 * c, c, wk, shift);
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    add[i] = conv_bias == nullptr ? 0.f
                                  : round_bf16(conv_bias[wk.lane * kVec + i]);
  const unsigned ho = h / 2, wo = w / 2;
  const long long down = (long long)w * c;  // one input row further
  const __nv_bfloat16* src = x + wk.offset;
  __nv_bfloat16* dst = y + wk.offset;
  const int step = wk.tile.rows;
  // The offset of output pixel r's window's top-left element (pooled:
  // rows < 2^31).
  auto corner = [&](long long r) -> long long {
    if (!kPool) return r * c;
    const unsigned p = (unsigned)r, q = p / wo, j = p - q * wo;
    const unsigned image = q / ho, i = q - image * ho;
    return (((long long)image * h + 2 * i) * w + 2 * j) * c;
  };
  auto window = [&](long long r, uint4* raw) {
    const __nv_bfloat16* p = src + corner(r);
    raw[0] = load(p);
    if (kPool) {
      raw[1] = load(p + c);
      raw[2] = load(p + down);
      raw[3] = load(p + down + c);
    }
  };
  auto out = [&](const uint4* raw) {
    float m[kVec];
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      float v[kVec];
      unpack(raw[k], v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        v[i] = affine(round_bf16(v[i] + add[i]), scale[i], shift[i]);
        if (kRelu) v[i] = relu(v[i]);
        m[i] = k == 0 ? v[i] : pool_max(m[i], v[i]);
      }
    }
    return pack(m);
  };
  long long r = wk.begin;
  for (; r + step < wk.end; r += 2 * step) {  // two windows in flight
    uint4 raw[2][kWindow];
    window(r, raw[0]);
    window(r + step, raw[1]);
    *reinterpret_cast<uint4*>(dst + r * c) = out(raw[0]);
    *reinterpret_cast<uint4*>(dst + (r + step) * c) = out(raw[1]);
  }
  for (; r < wk.end; r += step) {
    uint4 raw[kWindow];
    window(r, raw);
    *reinterpret_cast<uint4*>(dst + r * c) = out(raw);
  }
}

template <bool kRelu>
void launch_epilogue(bool pool, int splits, int threads, cudaStream_t s,
                     const __nv_bfloat16* x, __nv_bfloat16* y,
                     const float* stats, const float* conv_bias, int h, int w,
                     int c, long long rows, long long per_split) {
  if (pool)
    episodic_bn_eval_epilogue<kRelu, true><<<dim3(splits), threads, 0, s>>>(
        x, y, stats, conv_bias, h, w, c, rows, per_split);
  else
    episodic_bn_eval_epilogue<kRelu, false><<<dim3(splits), threads, 0, s>>>(
        x, y, stats, conv_bias, h, w, c, rows, per_split);
}

bool valid(int groups, long long rows, int c, int splits,
           long long per_split) {
  return groups >= 1 && groups <= 65535 && rows >= 1 && c >= kVec &&
         c <= kMaxC && c % kVec == 0 && splits >= 1 && splits <= 65535 &&
         per_split >= 1 && (long long)splits * per_split >= rows &&
         (long long)groups * c <= (1 << 30);
}

dim3 stream_grid(int groups, int splits) { return dim3(splits, groups); }

int finalize_blocks(int groups, int c) {
  return (groups * c + kFinalizeThreads - 1) / kFinalizeThreads;
}

}  // namespace

extern "C" {

// x, y [G P, C] bf16 (channels-last [G n, C, H, W], P = n H W rows an
// episode), weight and bias [C] f32; part [G, splits, 2, C] f32 scratch;
// stats [5, G, C] f32 out (mean, var, rstd, scale, shift). Rows
// [s per_split, (s + 1) per_split) of each episode go to CTA s. x, y and
// part 16-byte aligned. Launches on `stream`; returns a cudaError_t.
int episodic_bn_forward(const void* x, void* y, const float* weight,
                        const float* bias, float* part, float* stats,
                        int groups, long long rows, int c, int splits,
                        long long per_split, float eps, int relu,
                        void* stream) {
  if (!valid(groups, rows, c, splits, per_split))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Tile t = tile_of(c);
  const int threads = t.lanes * t.rows;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  episodic_bn_stats<<<stream_grid(groups, splits), threads, 0, s>>>(
      xb, part, rows, c, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  episodic_bn_finalize<<<finalize_blocks(groups, c), kFinalizeThreads, 0, s>>>(
      part, weight, bias, stats, groups, splits, c, (float)rows, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (relu)
    episodic_bn_apply<true><<<stream_grid(groups, splits), threads, 0, s>>>(
        xb, yb, stats, groups, rows, c, per_split);
  else
    episodic_bn_apply<false><<<stream_grid(groups, splits), threads, 0, s>>>(
        xb, yb, stats, groups, rows, c, per_split);
  return (int)cudaGetLastError();
}

// dy, x, dx [G P, C] bf16; stats [5, G, C] from the forward; part [G,
// splits, 2, C] f32 scratch; sums [2, G, C] f32 out (sum dy', sum dy' xh).
// The same split of rows as the forward's. Launches on `stream`; returns a
// cudaError_t.
int episodic_bn_backward(const void* dy, const void* x, void* dx,
                         const float* stats, float* part, float* sums,
                         int groups, long long rows, int c, int splits,
                         long long per_split, int relu, void* stream) {
  if (!valid(groups, rows, c, splits, per_split))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Tile t = tile_of(c);
  const int threads = t.lanes * t.rows;
  const dim3 grid = stream_grid(groups, splits);
  const auto* gb = static_cast<const __nv_bfloat16*>(dy);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* db = static_cast<__nv_bfloat16*>(dx);
  if (relu)
    episodic_bn_grad_stats<true><<<grid, threads, 0, s>>>(
        gb, xb, stats, part, groups, rows, c, per_split);
  else
    episodic_bn_grad_stats<false><<<grid, threads, 0, s>>>(
        gb, xb, stats, part, groups, rows, c, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  episodic_bn_grad_finalize<<<finalize_blocks(groups, c), kFinalizeThreads, 0,
                              s>>>(part, sums, groups, splits, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (relu)
    episodic_bn_grad_apply<true><<<grid, threads, 0, s>>>(
        gb, xb, db, stats, sums, groups, rows, c, per_split, (float)rows);
  else
    episodic_bn_grad_apply<false><<<grid, threads, 0, s>>>(
        gb, xb, db, stats, sums, groups, rows, c, per_split, (float)rows);
  return (int)cudaGetLastError();
}

// Eval mode. x, y [P, C] bf16 (channels-last [n, C, H, W], P = n H W
// rows); weight, bias, running_mean, running_var [C] f32; stats [5, 1, C]
// f32 out (running mean, running var, rstd, scale, shift). Rows
// [s per_split, (s + 1) per_split) go to CTA s. x and y 16-byte aligned.
// Launches on `stream`; returns a cudaError_t.
int episodic_bn_eval_forward(const void* x, void* y, const float* weight,
                             const float* bias, const float* running_mean,
                             const float* running_var, float* stats,
                             long long rows, int c, int splits,
                             long long per_split, float eps, int relu,
                             void* stream) {
  if (!valid(1, rows, c, splits, per_split))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Tile t = tile_of(c);
  const int threads = t.lanes * t.rows;
  episodic_bn_eval_finalize<<<finalize_blocks(1, c), kFinalizeThreads, 0,
                              s>>>(weight, bias, running_mean, running_var,
                                   stats, c, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (relu)
    episodic_bn_apply<true><<<stream_grid(1, splits), threads, 0, s>>>(
        xb, yb, stats, 1, rows, c, per_split);
  else
    episodic_bn_apply<false><<<stream_grid(1, splits), threads, 0, s>>>(
        xb, yb, stats, 1, rows, c, per_split);
  return (int)cudaGetLastError();
}

// The eval ConvBlock epilogue. x [n h w, C] bf16 (channels-last [n, C, h,
// w]), a convolution's output made without its bias; conv_bias [C] f32 or
// null; y [n (h / 2) (w / 2), C] bf16 with `pool` (channels-last [n, C,
// h / 2, w / 2]; h and w at least 2), else [n h w, C]; weight, bias,
// running_mean, running_var and stats as for episodic_bn_eval_forward.
// Output rows [s per_split, (s + 1) per_split) go to CTA s. x and y 16-byte
// aligned. Launches on `stream`; returns a cudaError_t.
int episodic_bn_eval_epilogue_forward(
    const void* x, void* y, const float* weight, const float* bias,
    const float* running_mean, const float* running_var,
    const float* conv_bias, float* stats, int n, int h, int w, int c,
    int pool, int splits, long long per_split, float eps, int relu,
    void* stream) {
  const long long rows =
      pool ? (long long)n * (h / 2) * (w / 2) : (long long)n * h * w;
  if (n < 1 || h < 1 + !!pool || w < 1 + !!pool ||
      (pool && rows > 0x7fffffffLL) || !valid(1, rows, c, splits, per_split))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Tile t = tile_of(c);
  const int threads = t.lanes * t.rows;
  episodic_bn_eval_finalize<<<finalize_blocks(1, c), kFinalizeThreads, 0,
                              s>>>(weight, bias, running_mean, running_var,
                                   stats, c, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (relu)
    launch_epilogue<true>(pool, splits, threads, s, xb, yb, stats, conv_bias,
                          h, w, c, rows, per_split);
  else
    launch_epilogue<false>(pool, splits, threads, s, xb, yb, stats, conv_bias,
                           h, w, c, rows, per_split);
  return (int)cudaGetLastError();
}

}  // extern "C"
