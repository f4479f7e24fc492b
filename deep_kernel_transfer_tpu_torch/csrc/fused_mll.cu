// Fused one-vs-rest linear-kernel GP marginal log-likelihood for Hopper.
//
// Replaces the Pallas TPU kernel
//   deep_kernel_transfer_tpu/ops/pallas/fused_mll.py::fused_linear_mll
//   (forward: _episode_kernel, fused_mll.py:54-154).
//
// Per episode b and way w (one CTA each):
//   G    = Z_b Z_b^T                                  (f32 FFMA, no TF32)
//   K_w  = s_w G + (noise + jitter) I
//   L    = chol(K_w)                                  (in shared memory)
//   y    = L^-1 diff_w,  alpha = L^-T y
//   mll  = -0.5 (|y|^2 + 2 sum log diag L + N log 2pi) / N
// and L [B, W, N, N] (upper triangle zero), alpha [B, W, N] are written out
// for the closed-form backward, which runs as torch ops in the wrapper.
//
// Bound at the main-path shape (B=32 episodes, N=100, D=1600, W=5) on an
// H100 SXM: G is symmetric and the Cholesky reads only its lower triangle,
// so the least Gram work is B*N*(N+1)*D = 0.52 GFLOP of f32 (TF32 is not
// allowed for a matrix that feeds a Cholesky); with the B*W factorisations
// (N^3/3) and solves that is 0.57 GFLOP, 8.6 us at the 67 TFLOP/s f32 rate.
// The bytes are 20.5 MB of Z in and 6.4 MB of L out, 8.0 us at 3.35 TB/s.
// The two terms are almost level; the operations bind, at about 8.6 us.
//
// What this first design is bound by instead: the factorisation is a serial
// chain of N dependent rank-1 steps, one __syncthreads each, and the two
// triangular solves are serial chains of N steps in one warp. Every CTA also
// recomputes its episode's Gram (W times per episode). Sharing G across the
// ways, wgmma for the Gram and TMA for Z are later work.
//
// Layout: K lives in a row-major [N][N+1] shared tile (the odd stride keeps
// column reads conflict-free); Z is streamed through shared memory in
// 32-wide chunks of D, rows beyond N zero-filled. Each of the 16x16 threads
// owns an 8x8 block of G (rows ty+16a, columns tx+16c) in registers.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kPer = kMaxN / kTile;  // rows and columns of G per thread
constexpr int kChunk = 32;           // columns of Z staged per pass
constexpr int kZld = kChunk + 1;

__global__ void __launch_bounds__(kThreads)
fused_mll_kernel(const float* __restrict__ z, const float* __restrict__ diffs,
                 const float* __restrict__ scales, float* __restrict__ mll,
                 float* __restrict__ chol, float* __restrict__ alpha, int n,
                 int d, int n_way, float diag_add, float n_log_2pi) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  float* K = smem;                   // [n][ld]
  float* Zs = K + n * ld;            // [kMaxN][kZld]
  float* r = Zs + kMaxN * kZld;      // [kMaxN] right-hand side of the solves

  const int w = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kTile;
  const int ty = tid / kTile;
  const float* zb = z + (size_t)b * n * d;

  // ---- 1. G = Z Z^T, each thread an 8x8 register block ------------------
  float acc[kPer][kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[a][c] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kChunk) {
    for (int idx = tid; idx < kMaxN * kChunk; idx += kThreads) {
      const int row = idx / kChunk;
      const int col = idx % kChunk;
      float v = 0.f;
      if (row < n && d0 + col < d) v = zb[(size_t)row * d + d0 + col];
      Zs[row * kZld + col] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      float zi[kPer], zj[kPer];
#pragma unroll
      for (int a = 0; a < kPer; ++a) zi[a] = Zs[(ty + kTile * a) * kZld + k];
#pragma unroll
      for (int c = 0; c < kPer; ++c) zj[c] = Zs[(tx + kTile * c) * kZld + k];
#pragma unroll
      for (int a = 0; a < kPer; ++a)
#pragma unroll
        for (int c = 0; c < kPer; ++c) acc[a][c] = fmaf(zi[a], zj[c], acc[a][c]);
    }
    __syncthreads();
  }

  // ---- 2. K = s G + (noise + jitter) I, lower triangle ------------------
  const float s = scales[w];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int i = ty + kTile * a;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int j = tx + kTile * c;
      if (i < n && j <= i) {
        const float g = s * acc[a][c];
        K[i * ld + j] = (i == j) ? g + diag_add : g;
      }
    }
  }
  __syncthreads();

  // ---- 3. right-looking Cholesky, in place ------------------------------
  // Step j reads column j (after j rank-1 updates) and updates the trailing
  // lower triangle; column j itself is scaled by 1/sqrt(pivot) one step
  // later, when nobody reads it any more, so each step needs one barrier.
  float d_prev = 0.f;
  for (int j = 0; j < n; ++j) {
    const float dj = sqrtf(K[j * ld + j]);
    if (j > 0) {
      for (int i = j - 1 + tid; i < n; i += kThreads)
        K[i * ld + j - 1] = (i == j - 1) ? d_prev : K[i * ld + j - 1] / d_prev;
    }
    float li[kPer], lk[kPer];
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int i = j + 1 + ty + kTile * a;
      li[a] = (i < n) ? K[i * ld + j] / dj : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int k = j + 1 + tx + kTile * c;
      lk[c] = (k < n) ? K[k * ld + j] / dj : 0.f;
    }
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int i = j + 1 + ty + kTile * a;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int k = j + 1 + tx + kTile * c;
        if (i < n && k <= i) K[i * ld + k] -= li[a] * lk[c];
      }
    }
    d_prev = dj;
    __syncthreads();
  }
  if (tid == 0) K[(n - 1) * ld + n - 1] = d_prev;
  __syncthreads();

  // ---- 4. write L, zero above the diagonal ------------------------------
  float* lb = chol + ((size_t)b * n_way + w) * n * n;
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n;
    const int k = idx % n;
    lb[idx] = (k <= i) ? K[i * ld + k] : 0.f;
  }

  // ---- 5. both solves, quad and logdet in warp 0 ------------------------
  if (tid >= 32) return;
  const int lane = tid;
  const float* dw = diffs + (size_t)w * n;
  for (int k = lane; k < n; k += 32) r[k] = dw[k];
  __syncwarp();
  for (int i = 0; i < n; ++i) {  // forward: L y = diff, column sweep
    const float yi = r[i] / K[i * ld + i];
    __syncwarp();
    for (int k = i + 1 + lane; k < n; k += 32) r[k] -= K[k * ld + i] * yi;
    if (lane == 0) r[i] = yi;
    __syncwarp();
  }
  float quad = 0.f, logdiag = 0.f;
  for (int k = lane; k < n; k += 32) {
    quad += r[k] * r[k];
    logdiag += logf(K[k * ld + k]);
  }
  __syncwarp();
  for (int i = n - 1; i >= 0; --i) {  // back: L^T alpha = y, row sweep
    const float ai = r[i] / K[i * ld + i];
    __syncwarp();
    for (int k = lane; k < i; k += 32) r[k] -= K[i * ld + k] * ai;
    if (lane == 0) r[i] = ai;
    __syncwarp();
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    quad += __shfl_xor_sync(0xffffffffu, quad, off);
    logdiag += __shfl_xor_sync(0xffffffffu, logdiag, off);
  }
  float* ab = alpha + ((size_t)b * n_way + w) * n;
  for (int k = lane; k < n; k += 32) ab[k] = r[k];
  if (lane == 0)
    mll[b * n_way + w] = -0.5f * (quad + 2.f * logdiag + n_log_2pi) / (float)n;
}

}  // namespace

extern "C" {

int fused_mll_max_n() { return kMaxN; }

// z [B, N, D], diffs [W, N], scales [W] -> mll [B, W], chol [B, W, N, N],
// alpha [B, W, N]; all f32, contiguous, on the device. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int fused_mll_forward(const float* z, const float* diffs, const float* scales,
                      float* mll, float* chol, float* alpha, int batch, int n,
                      int d, int n_way, float diag_add, void* stream) {
  if (n < 1 || n > kMaxN || d < 1 || n_way < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)n * (n + 1) + kMaxN * kZld + kMaxN);
  const size_t smem_max =
      sizeof(float) * ((size_t)kMaxN * (kMaxN + 1) + kMaxN * kZld + kMaxN);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
  if (err != cudaSuccess) return (int)err;
  const float n_log_2pi = (float)(n * 1.8378770664093453);
  dim3 grid(n_way, batch);
  fused_mll_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      z, diffs, scales, mll, chol, alpha, n, d, n_way, diag_add, n_log_2pi);
  return (int)cudaGetLastError();
}

}  // extern "C"
