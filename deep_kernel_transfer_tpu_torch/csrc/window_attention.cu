// Shifted-window multi-head self-attention with a learned relative-position
// bias (Swin Transformer, Liu et al. 2021), forward and backward, for
// bfloat16 activations on Hopper.
//
// Replaces no Pallas kernel: the JAX package has no transformer trunk. It
// was added for models/backbones.py::SwinTransformer, whose attention the
// plain torch chain (ops/window_attention.py::window_attention_torch) runs
// as a roll, a window partition copy, a product, a scale, a gathered bias
// and a mask added, an f32 softmax, a product, a reverse partition and a
// roll back: the [windows, heads, 49, 49] scores, more elements than the
// trunk's activations, are written and read about ten times a step, and
// kept for the backward.
//
// For each window of M x M tokens (L = M^2 <= 64) and each head (width 32),
// with q, k, v the head's slices of the qkv product's output and B the
// bias table [(2M - 1)^2, heads]:
//   s    = (q k^T) / sqrt(32) + B[idx] + mask          (f32)
//   p    = bf16(softmax(s))                            (f32 softmax)
//   o    = bf16(p v)                                   (f32 sums)
// idx(a, b) = (a_i - b_i + M - 1)(2M - 1) + (a_j - b_j + M - 1) for query a
// and key b at (row, column) a_i, a_j and b_i, b_j of the window; mask is
// -100 where a and b lie in different regions of the cyclically shifted map
// (rows [0, H - M), [H - M, H - shift), [H - shift, H), and so for columns),
// 0 elsewhere and in unshifted windows. Backward, with do the gradient of o:
//   dp = do v^T,  ds = p (dp - sum_b p dp)                 (f32)
//   dq = ds k / sqrt(32),  dk = ds^T q / sqrt(32),  dv = p^T do
//   dB[idx(a, b), head] += ds(a, b)   summed over every window
// where p is recomputed from q and k (each row of s fits one warp's
// registers, so no softmax statistics are kept from the forward), and ds
// enters the products rounded to bf16. The exponential is the SFU's
// (__expf, a few f32 ulps from expf) and a row is scaled by its sum's
// reciprocal: both far below the bf16 rounding of p.
//
// The cyclic shift and the window partition are index arithmetic: the
// token at (i, j) of window (wy, wx) of the shifted map is the token at
// ((wy M + i + shift) mod H, (wx M + j + shift) mod W) of the map, so q, k
// and v are read from the qkv output [n H W, 3C] in token order, and o, dq,
// dk and dv are written to the same positions: no roll, partition or
// reverse runs, and no [windows, heads, L, L] tensor is ever written. The
// region of a token is computed from its coordinates, the bias index from
// its row and column.
//
// A CTA of four warps takes one head and walks windows gridDim.x apart. A
// window's q, k, v (and do) are staged in shared memory, padded with zero
// rows to 64, and a warp owns 16 query rows: its scores, softmax and
// products stay in registers, run as mma.sync m16n8k16 bf16 products with
// f32 sums (the scores' accumulator fragments are the next product's
// operand fragments). The backward stages p^T and ds^T (bf16) so that a warp
// can take 16 keys for dk and dv. Each CTA adds its windows' ds into a
// [(2M - 1)^2] f32 table in shared memory by shared atomics (so dB is not
// reproducible bit for bit; o, dq, dk and dv are) and writes it to
// part[head, cta]; the wrapper sums the parts in order.
//
// Bound: the attention core moves bytes, not operations. Forward it must
// read q, k, v and write o, 8 bytes an element of [n H W, C] in bf16;
// backward read q, k, v and do and write dq, dk and dv, 14 bytes: 22 an
// element. At Swin-T's step of 840 images at 224 px (1.43 M elements an
// image over the 12 blocks) that is 26.4 GB, 7.9 ms at 3.35 TB/s; its
// seven products (two forward, five backward) are 0.82 TFLOP, 0.8 ms at
// 989 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 32;                 // a head's width
constexpr int kRows = 64;              // a window's tokens, padded
constexpr int kWarps = 4;              // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kLdD = kD + 8;           // row stride of [token][d] tiles
constexpr int kLdT = kRows + 8;        // row stride of [*][token] tiles
constexpr int kMaxM = 8;
constexpr int kMaxTable = (2 * kMaxM - 1) * (2 * kMaxM - 1);
constexpr float kMaskValue = -100.0f;

// The backward's shared memory: q, k, v, do [64][40]; q^T, k^T, do^T
// [32][72]; p^T, ds^T [64][72] (bf16); the bias and its gradient [225]
// (f32); the window's token offsets (int64), the tokens' key offsets
// (int) and regions.
constexpr int kBwdTiles = 4 * kRows * kLdD + 3 * kD * kLdT + 2 * kRows * kLdT;
constexpr size_t kBwdSmem = sizeof(bf16) * kBwdTiles +
                            sizeof(float) * 2 * kMaxTable +
                            (sizeof(long long) + sizeof(int) + 1) * kRows;

struct Geometry {
  int h, w, heads, m, shift;
  int wins_x, wins, len, table;  // windows across, windows an image, M^2
  long long windows;             // n images x wins
  float scale;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t word(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment (16 x 16) at rows r0.., depth k0.. of a tile stored
// [row][depth] with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int ld,
                                       int r0, int k0, int gid, int tig) {
  const bf16* p = t + (r0 + gid) * ld + k0 + 2 * tig;
  a[0] = word(p);
  a[1] = word(p + 8 * ld);
  a[2] = word(p + 8);
  a[3] = word(p + 8 * ld + 8);
}

// The A fragment of depth k-step kk from accumulator fragments c[8][4] of
// a 16 x 64 product: the scores' layout is the next product's operand's.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[8][4],
                                         int kk) {
  a[0] = pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// The B fragment (16 x 8) at columns n0.., depth k0.. of a tile stored
// [column][depth] with row stride ld.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* t,
                                       int ld, int n0, int k0, int gid,
                                       int tig) {
  const bf16* p = t + (n0 + gid) * ld + k0 + 2 * tig;
  b0 = word(p);
  b1 = word(p + 8);
}

__device__ __forceinline__ int region(int v, int size, int m, int shift) {
  return v < size - m ? 0 : (v < size - shift ? 1 : 2);
}

// Token `t` of window `win`: its row offset in [n H W] (stok) and its region
// of the shifted map.
__device__ __forceinline__ void token(const Geometry& g, long long win, int t,
                                      long long* stok, int8_t* sreg) {
  const long long img = win / g.wins;
  const int r = (int)(win - img * g.wins);
  const int wy = r / g.wins_x, wx = r - wy * g.wins_x;
  const int i = t / g.m, j = t - i * g.m;
  const int ys = wy * g.m + i, xs = wx * g.m + j;
  int y = ys + g.shift, x = xs + g.shift;
  if (y >= g.h) y -= g.h;
  if (x >= g.w) x -= g.w;
  stok[t] = (img * g.h + y) * g.w + x;
  sreg[t] = g.shift ? (int8_t)(region(ys, g.h, g.m, g.shift) * 3 +
                               region(xs, g.w, g.m, g.shift))
                    : (int8_t)0;
}

// Token t (row i, column j of the window) as a key of the bias table,
// i (2M - 1) + j, and as a query, (i + M - 1)(2M - 1) + j + M - 1: the
// table's row for query a and key b is query(a) - key(b). -1 past L. The
// same in every window, so each CTA computes them once.
__device__ __forceinline__ int key_offset(const Geometry& g, int t) {
  return t < g.len ? (t / g.m) * (2 * g.m - 1) + t % g.m : -1;
}

__device__ __forceinline__ int query_base(const Geometry& g, int t) {
  return t < g.len ? key_offset(g, t) + (g.m - 1) * 2 * g.m : -1;
}

// The 16 x 64 scores of the warp's query rows r0.. (rows ra = r0 + gid and
// rb = ra + 8 in a thread's fragments, whose query(..) is qbase), scaled,
// biased and masked, then their softmax in place (f32); keys past L read
// 0.
__device__ __forceinline__ void scores_softmax(
    float (&s)[8][4], const bf16* sq, const bf16* sk, const float* sbias,
    const int* skey, const int8_t* sreg, const int (&qbase)[2],
    const Geometry& g, int r0, int gid, int tig) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4];
    load_a(a, sq, kLdD, r0, kk * 16, gid, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b0, b1;
      load_b(b0, b1, sk, kLdD, nt * 8, kk * 16, gid, tig);
      mma_bf16(s[nt], a, b0, b1);
    }
  }
  const int8_t reg[2] = {sreg[r0 + gid], sreg[r0 + gid + 8]};
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + 2 * tig + (e & 1), key = skey[col];
      float v = s[nt][e] * g.scale;
      if (key < 0) {
        v = -INFINITY;
      } else if (qbase[e >> 1] >= 0) {
        v += sbias[qbase[e >> 1] - key];
        if (reg[e >> 1] != sreg[col]) v += kMaskValue;
      }
      s[nt][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = __expf(s[nt][e] - mx[e >> 1]);
      sum[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] *= inv[e >> 1];
}

__global__ void __launch_bounds__(kThreads)
    window_attn_fwd(const bf16* __restrict__ qkv, const bf16* __restrict__ table,
                    bf16* __restrict__ out, Geometry g) {
  __shared__ __align__(16) bf16 sq[kRows * kLdD];
  __shared__ __align__(16) bf16 sk[kRows * kLdD];
  __shared__ __align__(16) bf16 svt[kD * kLdT];
  __shared__ float sbias[kMaxTable];
  __shared__ long long stok[kRows];
  __shared__ int skey[kRows];
  __shared__ int8_t sreg[kRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int head = blockIdx.y;
  const int c = g.heads * kD;
  for (int e = tid; e < kRows * kLdD; e += kThreads)
    sq[e] = sk[e] = __float2bfloat16(0.f);
  for (int e = tid; e < kD * kLdT; e += kThreads) svt[e] = __float2bfloat16(0.f);
  for (int e = tid; e < g.table; e += kThreads)
    sbias[e] = __bfloat162float(table[e * g.heads + head]);
  for (int e = tid; e < kRows; e += kThreads) {
    skey[e] = key_offset(g, e);
    sreg[e] = 0;
  }
  const int r0 = warp * 16;
  const int qbase[2] = {query_base(g, r0 + gid), query_base(g, r0 + gid + 8)};

  for (long long win = blockIdx.x; win < g.windows; win += gridDim.x) {
    __syncthreads();  // the last window's tiles are read
    if (tid < g.len) token(g, win, tid, stok, sreg);
    __syncthreads();
    for (int e = tid; e < g.len * 12; e += kThreads) {
      const int row = e / 12, part = (e % 12) >> 2, chunk = e & 3;
      const uint4 v = *reinterpret_cast<const uint4*>(
          qkv + stok[row] * 3 * c + part * c + head * kD + chunk * 8);
      if (part == 0) {
        *reinterpret_cast<uint4*>(sq + row * kLdD + chunk * 8) = v;
      } else if (part == 1) {
        *reinterpret_cast<uint4*>(sk + row * kLdD + chunk * 8) = v;
      } else {
        const bf16* pv = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k) svt[(chunk * 8 + k) * kLdT + row] = pv[k];
      }
    }
    __syncthreads();

    float s[8][4];
    scores_softmax(s, sq, sk, sbias, skey, sreg, qbase, g, r0, gid, tig);
    float o[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, svt, kLdT, nt * 8, kk * 16, gid, tig);
        mma_bf16(o[nt], a, b0, b1);
      }
    }
    const int ra = r0 + gid, rb = ra + 8;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = head * kD + nt * 8 + 2 * tig;
      if (ra < g.len)
        *reinterpret_cast<uint32_t*>(out + stok[ra] * c + d) =
            pack(o[nt][0], o[nt][1]);
      if (rb < g.len)
        *reinterpret_cast<uint32_t*>(out + stok[rb] * c + d) =
            pack(o[nt][2], o[nt][3]);
    }
  }
}

// A 64-token-deep product for the warp's 16 rows kr0.. of a [row][token]
// tile `at` times a [d][token] tile `bt`: acc [4][4] over d = 0..31.
__device__ __forceinline__ void rows_times(float (&acc)[4][4], const bf16* at,
                                           const bf16* bt, int kr0, int gid,
                                           int tig) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    uint32_t a[4];
    load_a(a, at, kLdT, kr0, kk * 16, gid, tig);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t b0, b1;
      load_b(b0, b1, bt, kLdT, nt * 8, kk * 16, gid, tig);
      mma_bf16(acc[nt], a, b0, b1);
    }
  }
}

// Rows ra and rb (fragment rows gid, gid + 8) of acc [4][4] times `scale`
// to dst + stok[row] * ld + col0.
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[4][4],
                                           const long long* stok, int ra, int len,
                                           long long ld, int col0, float scale,
                                           int tig) {
  const int rb = ra + 8;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int d = col0 + nt * 8 + 2 * tig;
    if (ra < len)
      *reinterpret_cast<uint32_t*>(dst + stok[ra] * ld + d) =
          pack(acc[nt][0] * scale, acc[nt][1] * scale);
    if (rb < len)
      *reinterpret_cast<uint32_t*>(dst + stok[rb] * ld + d) =
          pack(acc[nt][2] * scale, acc[nt][3] * scale);
  }
}

__global__ void __launch_bounds__(kThreads)
    window_attn_bwd(const bf16* __restrict__ qkv, const bf16* __restrict__ table,
                    const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                    float* __restrict__ part, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kRows * kLdD;
  bf16* sv = sk + kRows * kLdD;
  bf16* sdo = sv + kRows * kLdD;
  bf16* sqt = sdo + kRows * kLdD;
  bf16* skt = sqt + kD * kLdT;
  bf16* sdot = skt + kD * kLdT;
  bf16* spt = sdot + kD * kLdT;
  bf16* sdst = spt + kRows * kLdT;
  float* sbias = reinterpret_cast<float*>(sdst + kRows * kLdT);
  float* sdb = sbias + kMaxTable;
  long long* stok = reinterpret_cast<long long*>(sdb + kMaxTable);
  int* skey = reinterpret_cast<int*>(stok + kRows);
  int8_t* sreg = reinterpret_cast<int8_t*>(skey + kRows);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int head = blockIdx.y;
  const int c = g.heads * kD;
  for (int e = tid; e < 4 * kRows * kLdD + 3 * kD * kLdT; e += kThreads)
    sq[e] = __float2bfloat16(0.f);
  for (int e = tid; e < g.table; e += kThreads) {
    sbias[e] = __bfloat162float(table[e * g.heads + head]);
    sdb[e] = 0.f;
  }
  for (int e = tid; e < kRows; e += kThreads) {
    skey[e] = key_offset(g, e);
    sreg[e] = 0;
  }
  const int r0 = warp * 16, ra = r0 + gid, rb = ra + 8;
  const int qbase[2] = {query_base(g, ra), query_base(g, rb)};

  for (long long win = blockIdx.x; win < g.windows; win += gridDim.x) {
    __syncthreads();  // the last window's tiles are read
    if (tid < g.len) token(g, win, tid, stok, sreg);
    __syncthreads();
    for (int e = tid; e < g.len * 16; e += kThreads) {
      const int row = e >> 4, part4 = (e >> 2) & 3, chunk = e & 3;
      const uint4 v = *reinterpret_cast<const uint4*>(
          part4 < 3 ? qkv + stok[row] * 3 * c + part4 * c + head * kD + chunk * 8
                    : dout + stok[row] * c + head * kD + chunk * 8);
      bf16* rowwise = part4 == 0 ? sq : part4 == 1 ? sk : part4 == 2 ? sv : sdo;
      *reinterpret_cast<uint4*>(rowwise + row * kLdD + chunk * 8) = v;
      bf16* tr = part4 == 0 ? sqt : part4 == 1 ? skt : part4 == 3 ? sdot : nullptr;
      if (tr != nullptr) {
        const bf16* pv = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k) tr[(chunk * 8 + k) * kLdT + row] = pv[k];
      }
    }
    __syncthreads();

    float p[8][4];
    scores_softmax(p, sq, sk, sbias, skey, sreg, qbase, g, r0, gid, tig);
    // dp = do v^T, then ds = p (dp - sum_b p dp) in place
    float ds[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sdo, kLdD, r0, kk * 16, gid, tig);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, sv, kLdD, nt * 8, kk * 16, gid, tig);
        mma_bf16(ds[nt], a, b0, b1);
      }
    }
    float dot[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dot[e >> 1] += p[nt][e] * ds[nt][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 2);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ra : rb, col = nt * 8 + 2 * tig + (e & 1);
        const int key = skey[col];
        const float v = p[nt][e] * (ds[nt][e] - dot[e >> 1]);
        ds[nt][e] = v;
        if (qbase[e >> 1] >= 0 && key >= 0)
          atomicAdd(&sdb[qbase[e >> 1] - key], v);
        spt[col * kLdT + row] = __float2bfloat16(p[nt][e]);
        sdst[col * kLdT + row] = __float2bfloat16(v);
      }
    // dq = ds k / sqrt(32): k^T as the [d][key] tile
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, ds, kk);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, skt, kLdT, nt * 8, kk * 16, gid, tig);
        mma_bf16(acc[nt], a, b0, b1);
      }
    }
    store_rows(dqkv, acc, stok, ra, g.len, 3LL * c, head * kD, g.scale, tig);
    __syncthreads();  // p^T and ds^T complete
    // the warp's 16 keys: dv = p^T do, dk = ds^T q / sqrt(32)
    rows_times(acc, spt, sdot, r0, gid, tig);
    store_rows(dqkv, acc, stok, ra, g.len, 3LL * c, 2 * c + head * kD, 1.f, tig);
    rows_times(acc, sdst, sqt, r0, gid, tig);
    store_rows(dqkv, acc, stok, ra, g.len, 3LL * c, c + head * kD, g.scale, tig);
  }
  __syncthreads();
  for (int e = tid; e < g.table; e += kThreads)
    part[((long long)head * gridDim.x + blockIdx.x) * g.table + e] = sdb[e];
}

bool make_geometry(Geometry& g, int n, int h, int w, int heads, int m,
                   int shift, int ctas) {
  if (n < 1 || heads < 1 || heads > 65535 || m < 1 || m > kMaxM || h < m ||
      w < m || h % m || w % m || shift < 0 || shift >= m || ctas < 1)
    return false;
  g.h = h;
  g.w = w;
  g.heads = heads;
  g.m = m;
  g.shift = shift;
  g.wins_x = w / m;
  g.wins = (h / m) * (w / m);
  g.len = m * m;
  g.table = (2 * m - 1) * (2 * m - 1);
  g.windows = (long long)n * g.wins;
  g.scale = (float)(1.0 / sqrt((double)kD));  // as torch rounds d ** -0.5
  return true;
}

}  // namespace

extern "C" {

// qkv [n h w, 3 C] bf16, C = 32 heads, the qkv product's output in token
// order of the h x w map (the channels of q, k and v, each head's 32 in
// order); table [(2m - 1)^2, heads] bf16; out [n h w, C] bf16. The map is
// cut into m x m windows after a cyclic shift by `shift` (0: none) rows and
// columns towards the origin. `ctas` CTAs a head. All 16-byte aligned.
// Launches on `stream`; returns a cudaError_t.
int window_attention_forward(const void* qkv, const void* table, void* out,
                             int n, int h, int w, int heads, int m, int shift,
                             int ctas, void* stream) {
  Geometry g;
  if (!make_geometry(g, n, h, w, heads, m, shift, ctas))
    return (int)cudaErrorInvalidValue;
  window_attn_fwd<<<dim3(ctas, heads), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(table),
      static_cast<bf16*>(out), g);
  return (int)cudaGetLastError();
}

// As the forward, with dout [n h w, C] bf16 the gradient of out; dqkv [n h
// w, 3 C] bf16 out (every element written); part [heads, ctas, (2m - 1)^2]
// f32 out, each CTA's sum of the bias table's gradient over its windows.
int window_attention_backward(const void* qkv, const void* table,
                              const void* dout, void* dqkv, float* part, int n,
                              int h, int w, int heads, int m, int shift,
                              int ctas, void* stream) {
  Geometry g;
  if (!make_geometry(g, n, h, w, heads, m, shift, ctas))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  window_attn_bwd<<<dim3(ctas, heads), kThreads, kBwdSmem,
                    (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(table),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), part, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
