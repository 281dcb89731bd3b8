// Mamba2 SSD intra-chunk piece for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::_ssd_kernel (launched
// by ssd_intra_chunk_pallas).  The plain PyTorch version of the same function
// is repro_torch/kernels/ssd/ref.py::ssd_intra_chunk_ref.
//
// What it computes, per (batch b, chunk c, head h), with Q chunk positions,
// P head channels and N state channels:
//   cb[i][j]     = sum_n C[i][n] B[j][n]                          (Q x Q)
//   L[i][j]      = exp(cum_i - cum_j) for j <= i, else 0  (masked before the exp)
//   y[i][p]      = sum_j (cb[i][j] L[i][j]) xbar[j][p]              (Q x P)
//   state[p][n]  = sum_j (B[j][n] exp(cum_{Q-1} - cum_j)) xbar[j][p] (P x N)
// B and C are read through their strides: the model broadcasts one state
// group over all heads as a head stride of 0, so each block reads its
// group's rows and nothing is materialised per head.  States come out in the
// model's (P, N) order (the TPU kernel's (N, P) order was a tiling choice).
//
// What bounds it on this card: at the served zamba2-7b shape (b=4, nc=32,
// Q=128, H=112, P=N=64) it moves 1.19 GB (xbar in, y and states out) and
// does 7.5e10 FLOP, in f32 as the reference contracts in f32.  Hopper's
// tensor cores take no IEEE f32 inputs, so the bound is the 67 TFLOP/s
// CUDA-core f32 rate: 1.12 ms, against 0.36 ms for the bytes.  The design
// keeps the whole chunk on chip: one block of 256 threads per (b*c, h)
// stages B, C, xbar and cum in shared memory (one coalesced pass each),
// computes cb in registers (an 8 x 8 patch per thread), scales it by L
// computed on the fly, parks cb*L in shared memory over the dead C tile
// (128 x 129 floats, 66 KB), then forms y (8 x W patch per thread) and the
// state (W x W patch) from shared memory with IEEE f32 FMAs (no TF32: the
// contractions are f32 in the reference).  Dynamic shared memory is 133 KB
// at the served shape, so one block per SM; packing two (smaller cb tiles)
// and tensor-core split-f32 products are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // a 16 x 16 thread grid
constexpr int kMaxQ = 128;        // chunk positions: ty + 16 * ii, ii < 8
constexpr int kQT = kMaxQ / 16;
constexpr int kMaxPN = 128;       // P and N: tx + 16 * w, w < W <= 8

struct BCStrides {
  long long b, c, i, h;   // elements; the state dim is unit-stride
};

// W channels of P and of N per thread, so P, N <= 16 * W.
template <int W>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const float* __restrict__ xbar,   // (b, nc, Q, H, P)
                       const float* __restrict__ Bm,     // (b, nc, Q, H, N) via bs
                       const float* __restrict__ Cm,     // (b, nc, Q, H, N) via cs
                       const float* __restrict__ cum,    // (b, nc, Q, H)
                       float* __restrict__ y,            // (b, nc, Q, H, P)
                       float* __restrict__ states,       // (b, nc, H, P, N)
                       int nc, int Q, int H, int P, int N, BCStrides bs, BCStrides cs) {
  extern __shared__ float smem[];
  const int ns = N + 1;                 // B/C row stride: 16 rows a warp reads sit in 16 banks
  const int qs = Q + 1;                 // cb*L row stride
  float* Bs = smem;                                   // [Q][N+1]
  float* U = Bs + Q * ns;                             // C [Q][N+1], then cb*L [Q][Q+1]
  float* Xs = U + Q * (Q > N ? qs : ns);              // [Q][P]
  float* cs_ = Xs + Q * P;                            // cum [Q]
  float* dec = cs_ + Q;                               // exp(cum_{Q-1} - cum_j) [Q]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long bc = blockIdx.x;
  const int h = blockIdx.y;
  const long long bi = bc / nc, ci = bc - bi * nc;

  const float* bp = Bm + bi * bs.b + ci * bs.c + h * bs.h;
  const float* cp = Cm + bi * cs.b + ci * cs.c + h * cs.h;
  for (int idx = tid; idx < Q * N; idx += kThreads) {
    const int i = idx / N, n = idx - i * N;
    Bs[i * ns + n] = bp[i * bs.i + n];
    U[i * ns + n] = cp[i * cs.i + n];
  }
  const float* xp = xbar + (bc * Q * H + h) * P;
  for (int idx = tid; idx < Q * P; idx += kThreads) {
    const int i = idx / P, p = idx - i * P;
    Xs[i * P + p] = xp[static_cast<long long>(i) * H * P + p];
  }
  for (int i = tid; i < Q; i += kThreads) cs_[i] = cum[(bc * Q + i) * H + h];
  __syncthreads();
  for (int j = tid; j < Q; j += kThreads) dec[j] = expf(cs_[Q - 1] - cs_[j]);

  // cb = C B^T for rows ty + 16 ii, columns tx + 16 jj
  float cb[kQT][kQT];
#pragma unroll
  for (int ii = 0; ii < kQT; ++ii)
#pragma unroll
    for (int jj = 0; jj < kQT; ++jj) cb[ii][jj] = 0.0f;
#pragma unroll 2
  for (int n = 0; n < N; ++n) {
    float cr[kQT], br[kQT];
#pragma unroll
    for (int ii = 0; ii < kQT; ++ii) {
      const int i = ty + 16 * ii, j = tx + 16 * ii;
      cr[ii] = i < Q ? U[i * ns + n] : 0.0f;
      br[ii] = j < Q ? Bs[j * ns + n] : 0.0f;
    }
#pragma unroll
    for (int ii = 0; ii < kQT; ++ii)
#pragma unroll
      for (int jj = 0; jj < kQT; ++jj) cb[ii][jj] = fmaf(cr[ii], br[jj], cb[ii][jj]);
  }
  __syncthreads();   // every thread is done reading C: U now takes cb * L
#pragma unroll
  for (int ii = 0; ii < kQT; ++ii) {
    const int i = ty + 16 * ii;
    if (i >= Q) continue;
#pragma unroll
    for (int jj = 0; jj < kQT; ++jj) {
      const int j = tx + 16 * jj;
      if (j < Q) U[i * qs + j] = j <= i ? cb[ii][jj] * expf(cs_[i] - cs_[j]) : 0.0f;
    }
  }
  __syncthreads();

  // y = (cb * L) xbar for rows ty + 16 ii, channels tx + 16 w
  {
    float acc[kQT][W];
#pragma unroll
    for (int ii = 0; ii < kQT; ++ii)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[ii][w] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < Q; ++j) {
      float lr[kQT], xr[W];
#pragma unroll
      for (int ii = 0; ii < kQT; ++ii) {
        const int i = ty + 16 * ii;
        lr[ii] = i < Q ? U[i * qs + j] : 0.0f;
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int p = tx + 16 * w;
        xr[w] = p < P ? Xs[j * P + p] : 0.0f;
      }
#pragma unroll
      for (int ii = 0; ii < kQT; ++ii)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[ii][w] = fmaf(lr[ii], xr[w], acc[ii][w]);
    }
#pragma unroll
    for (int ii = 0; ii < kQT; ++ii) {
      const int i = ty + 16 * ii;
      if (i >= Q) continue;
      float* yp = y + ((bc * Q + i) * H + h) * P;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int p = tx + 16 * w;
        if (p < P) yp[p] = acc[ii][w];
      }
    }
  }

  // state[p][n] = sum_j (B[j][n] dec[j]) xbar[j][p], p = ty + 16 u, n = tx + 16 w
  {
    float acc[W][W];
#pragma unroll
    for (int u = 0; u < W; ++u)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[u][w] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < Q; ++j) {
      float xr[W], br[W];
      const float dj = dec[j];
#pragma unroll
      for (int u = 0; u < W; ++u) {
        const int p = ty + 16 * u;
        xr[u] = p < P ? Xs[j * P + p] : 0.0f;
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int n = tx + 16 * w;
        br[w] = n < N ? Bs[j * ns + n] * dj : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < W; ++u)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[u][w] = fmaf(br[w], xr[u], acc[u][w]);
    }
    float* sp = states + (bc * H + h) * static_cast<long long>(P) * N;
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int p = ty + 16 * u;
      if (p >= P) continue;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int n = tx + 16 * w;
        if (n < N) sp[p * N + n] = acc[u][w];
      }
    }
  }
}

template <int W>
cudaError_t launch_w(const float* xbar, const float* Bm, const float* Cm, const float* cum,
                     float* y, float* states, int batch, int nc, int Q, int H, int P, int N,
                     BCStrides bs, BCStrides cs, cudaStream_t stream) {
  const size_t u = static_cast<size_t>(Q) * (Q > N ? Q + 1 : N + 1);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(Q) * (N + 1) + u + static_cast<size_t>(Q) * P + 2 * Q);
  auto kernel = ssd_intra_chunk_kernel<W>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(batch) * nc, H);
  kernel<<<grid, kThreads, smem, stream>>>(xbar, Bm, Cm, cum, y, states, nc, Q, H, P, N, bs, cs);
  return cudaGetLastError();
}

}  // namespace

// Strides of B and C are in elements (the head stride may be 0); xbar,
// cum, y and states are contiguous.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int ssd_intra_chunk_launch(const float* xbar, const float* Bm, const float* Cm,
                                      const float* cum, float* y, float* states, int batch,
                                      int nc, int Q, int H, int P, int N, long long b_sb,
                                      long long b_sc, long long b_si, long long b_sh,
                                      long long c_sb, long long c_sc, long long c_si,
                                      long long c_sh, void* stream) {
  if (batch < 1 || nc < 1 || Q < 1 || Q > kMaxQ || H < 1 || H > 65535 || P < 1 ||
      P > kMaxPN || N < 1 || N > kMaxPN)
    return cudaErrorInvalidValue;
  const BCStrides bs{b_sb, b_sc, b_si, b_sh}, cs{c_sb, c_sc, c_si, c_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int widest = P > N ? P : N;
  if (widest <= 16) return launch_w<1>(xbar, Bm, Cm, cum, y, states, batch, nc, Q, H, P, N, bs, cs, st);
  if (widest <= 32) return launch_w<2>(xbar, Bm, Cm, cum, y, states, batch, nc, Q, H, P, N, bs, cs, st);
  if (widest <= 64) return launch_w<4>(xbar, Bm, Cm, cum, y, states, batch, nc, Q, H, P, N, bs, cs, st);
  return launch_w<8>(xbar, Bm, Cm, cum, y, states, batch, nc, Q, H, P, N, bs, cs, st);
}
