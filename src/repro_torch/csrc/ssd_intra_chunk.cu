// Mamba2 SSD intra-chunk piece for Hopper (sm_90a), in two designs: a
// tensor-core design for the served chunk (Q = 128, P = 64, N = 64 or 128,
// 16-byte-aligned rows) and a SIMT design for every other shape.  The
// wrapper (kernels/ssd/kernel.py) picks the design by those rules
// (kernel.py::design) and passes the choice in.
//
// Both designs replace the TPU kernel repro/kernels/ssd/kernel.py::_ssd_kernel
// (launched by ssd_intra_chunk_pallas).  The plain PyTorch version of the
// same function is repro_torch/kernels/ssd/ref.py::ssd_intra_chunk_ref.
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
// The reference contracts in f32; both designs hold 2e-5 of max|value|.
//
// What bounds it on this card: at the served zamba2-7b shape (b=4, nc=32,
// Q=128, H=112, P=N=64, one state group) it must move 1.190 GB (xbar and cum
// in, y and states out, B and C once) and do 4.533e10 FLOP (the causal half
// of cb and y, Q(Q+1)/2 pairs, and the full state product), the counts
// chip_smoke.py uses.  Bytes take 0.355 ms at 3.35 TB/s.  Hopper's tensor
// cores take no IEEE f32, so the tensor-core design runs each product as
// six bf16 passes (below): 2.72e11 split FLOP, 0.275 ms at 989 TFLOP/s.
// So the card's bound is the bytes, 0.355 ms.  (As f32 FMAs on CUDA cores
// the same FLOP take 0.677 ms at 67 TFLOP/s.)
//
// The tensor-core design (namespace tc; the swizzle, descriptor and wgmma
// helpers are shared with the flash kernels in hopper_tc.cuh, the split and
// pass order with the fpca kernel).  Every f32
// operand x is split into three bf16 parts by truncation: hi = x's top 16
// bits, mid = the top 16 bits of x - hi, lo = x - hi - mid (at most 8
// significant bits, so a bf16 exactly), whose sum is x; masks, subtractions
// and byte permutes, no conversion instruction.  Each product a.b runs as
// six bf16 wgmma passes into one f32 accumulator, hi.hi + hi.mid + mid.hi +
// hi.lo + lo.hi + mid.mid: every term above 2^-16 |a||b|, the dropped
// ones below 2^-21.  (Two parts and three passes reach ~1.1e-5 of
// max|value| in the host emulation, tests/test_torch_ssd_tc.py: past half
// of the 2e-5 limit.  The six passes measure 3.6e-7 on the served inputs,
// chip_smoke.py on an H100.)  L is taken from the hardware's exp2 (__expf).
//
// A block is one warpgroup on one (b, c, h) tile; blockIdx.x is the head,
// so the heads of a chunk run together and share their group's B and C
// rows in L2.  It stages B (Q x N) and xbar (Q x P) from device memory
// once, each split into three bf16 tiles in wgmma's 128-byte swizzle, cum
// and dec_j = exp(cum_{Q-1} - cum_j), and loads C's rows straight into
// split A fragments.  Then, for rows 0-63 (keys 0-63) and rows 64-127 (keys
// 0-127: the causal half is the only live work):
//   cb  = C B^T: RS wgmma, B's tiles read K-major;
//   p   = cb * L on the accumulator fragments, the mask evaluated on the
//         diagonal 64 x 64 block only, split into A fragments (the
//         accumulator's layout is the A layout), 64 keys at a time;
//   y  += p . xbar: RS wgmma, xbar's tiles read MN-major;
// and state^T[n][p] = (B * dec)^T . xbar over two 64-key halves, its A
// built in registers from B's staged parts (ldmatrix.trans, summed, times
// dec_j, split again), its B the xbar tiles already staged for y.  Products
// are issued ahead of work that does not need them: rows 64-127's cb runs
// under rows 0-63's p and y, each state half's A is built while the
// products before it run.  y is stored as float2 per lane, the state as
// 32-byte runs of n, both with streaming stores (and xbar read with
// streaming loads), so B, C and cum keep the L2.  At N = 64 a block takes
// 98 KB of shared memory and up to 255 registers a thread, and two blocks
// share an SM: one block's loads, staging, exps and splits run while the
// other's products do (an earlier build with two warpgroups a block and
// 128 registers a thread had its wgmma serialised by ptxas for want of
// registers).  At N = 128 a block takes 146 KB, one an SM, and stages B in
// two rounds.  Executed a tile at N = P = 64: 4.19 MFLOP a pass (3 of the
// 4 cb / y blocks, and the state), 6.01e10 FLOP a pass at the served
// shape, 3.61e11 in six passes (0.365 ms at the bf16 peak).
//
// The SIMT design (ragged chunks, other P and N) keeps the whole chunk on
// chip: one block of 256 threads per (b*c, h) stages B, C, xbar and cum in
// shared memory (one coalesced pass each), computes the full square cb in
// registers (an 8 x 8 patch per thread), scales it by L computed on the fly,
// parks cb*L in shared memory over the dead C tile (128 x 129 floats, 66
// KB), then forms y (8 x W patch per thread) and the state (W x W patch)
// from shared memory with IEEE f32 FMAs on CUDA cores.  133 KB of shared
// memory at the served shape, one block per SM: 7.9-8.1 ms there against the
// tensor-core design's ~0.85 ms on an H100.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

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


// ===========================================================================
// The tensor-core design: Q = 128, P = 64, N = 64 or 128
// ===========================================================================
namespace tc {

constexpr int kChunk = 128;   // Q the design takes: two row blocks of 64
constexpr int kHeadP = 64;    // P the design takes
constexpr int kBlock = 128;   // threads: one warpgroup a block

struct Problem {
  int nc, H;
  BCStrides bs, cs;
};

// Does the tensor-core design take these inputs?  The chunk and widths
// above, 16-byte-aligned xbar, B and C, B and C strides in whole 16-byte
// units (their rows are staged by float4 loads), and a grid within 65535
// chunks (batch x chunks).
bool ssd_takes(const void* xbar, const void* Bm, const void* Cm, int batch, int nc, int Q, int P, int N,
               const long long* strides) {
  if (Q != kChunk || P != kHeadP || (N != 64 && N != 128) || static_cast<long long>(batch) * nc > 65535)
    return false;
  const void* const ptrs[3] = {xbar, Bm, Cm};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  for (int i = 0; i < 8; ++i)
    if (strides[i] % 4 != 0) return false;
  return true;
}

template <int N>
struct Layout {
  static constexpr uint32_t kBPart = kChunk * N * 2;        // one bf16 part of B: Q rows x N
  static constexpr uint32_t kXPart = kChunk * kHeadP * 2;   // one bf16 part of xbar: Q rows x P
  static constexpr uint32_t kX = 3 * kBPart;                // xbar's three parts after B's,
  static constexpr uint32_t kCum = kX + 3 * kXPart;         // then cum[Q] and dec[Q]
  static constexpr size_t kSmem = 1024 + kCum + 2 * kChunk * sizeof(float);
};

// a bf16 pair (low, high) -> two f32, exactly
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v[0]), "r"(v[1]), "r"(v[2]),
               "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

template <int A, int B, int C>
__device__ __forceinline__ void pin(uint32_t (&r)[A][B][C]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) pin(r[i][j]);
}

// 8 f32 (two float4) -> one 16-byte unit in each of the three part tiles,
// part_bytes apart
__device__ __forceinline__ void store_unit(uint32_t dst, uint32_t part_bytes, const float4& a, const float4& b) {
  uint32_t h[4], m[4], l[4];
  split3(a.x, a.y, h[0], m[0], l[0]);
  split3(a.z, a.w, h[1], m[1], l[1]);
  split3(b.x, b.y, h[2], m[2], l[2]);
  split3(b.z, b.w, h[3], m[3], l[3]);
  st_shared_v4(dst, h);
  st_shared_v4(dst + part_bytes, m);
  st_shared_v4(dst + 2 * part_bytes, l);
}

// acc += A . (three part tiles, part_bytes apart, from `tile`): the six
// passes of KS 16-deep steps each, A from registers; B read K-major
// (kTransB 0: its rows are the output columns) or MN-major (1: its rows are
// the reduction dim)
template <int kTransB, int NACC, int KS>
__device__ __forceinline__ void passes(float (&acc)[NACC], const uint32_t (&a)[3][KS][4], uint32_t tile,
                                       uint32_t part_bytes) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const uint32_t t = tile + pass_b(i) * part_bytes;
    const uint64_t d = opaque(kTransB ? mnmajor(t, kChunk) : kmajor(t, kChunk, 0));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<kTransB>(acc, a[pass_a(i)][kk], d + (kTransB ? mnmajor_step(kk) : kmajor_step(kChunk, kk)));
  }
}

// this warpgroup's 64 rows [r0, r0 + 64) of C as f32 A-fragment values:
// k-step kk, register q holds rows row (+ 8 if q odd), columns
// 16 kk + 8 (q >> 1) + 2 t, +1
template <int N>
__device__ __forceinline__ void load_c(float2 (&cv)[N / 16][4], const float* cp, long long si, int r0, int tid) {
  const int lane = tid & 31;
  const float* crow = cp + (r0 + 16 * (tid >> 5) + (lane >> 2)) * si + 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cv[kk][q] = __ldg(reinterpret_cast<const float2*>(crow + 8 * (q & 1) * si + 16 * kk + 8 * (q >> 1)));
}

template <int N>
__device__ __forceinline__ void split_c(const float2 (&cv)[N / 16][4], uint32_t (&c)[3][N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) split3(cv[kk][q].x, cv[kk][q].y, c[0][kk][q], c[1][kk][q], c[2][kk][q]);
}

// cb for chunk rows [NJ - 64, NJ) over the keys [0, NJ) they see: C's rows
// (split A fragments c) . B^T, B's tiles read K-major; one wgmma group
template <int N, int NJ>
__device__ __forceinline__ void issue_cb(float (&s)[NJ / 2], const uint32_t (&c)[3][N / 16][4], uint32_t sB) {
#pragma unroll
  for (int i = 0; i < NJ / 2; ++i) s[i] = 0.0f;
  pin(s);
  wgmma_fence();
  passes<0>(s, c, sB, Layout<N>::kBPart);
  wgmma_commit();
}

// p = cb * L in place, for the thread's rows row, row + 8; only the last 64
// keys (the diagonal block) need the mask.  L by the hardware's exp2
// (__expf): within ~6e-8 |cum_i - cum_j| of expf relative, which is ~1e-6
// where L is not negligible
template <int NJ>
__device__ __forceinline__ void scale_by_l(float (&s)[NJ / 2], const float* s_cum, int row, int lane) {
  const float cum_r[2] = {s_cum[row], s_cum[row + 8]};
#pragma unroll
  for (int j = 0; j < NJ / 2; ++j) {
    const int col = frag_col(j, lane);
    const float e = __expf(cum_r[(j >> 1) & 1] - s_cum[col]);
    if (8 * (j >> 2) < NJ - 64)
      s[j] *= e;
    else
      s[j] = col <= row + frag_row(j) ? s[j] * e : 0.0f;
  }
}

// acc += p[:, keys 64 half ..] . xbar[keys 64 half ..]: p's 32 values of
// that half split into A fragments pp, xbar's tiles read MN-major; one
// wgmma group
template <int N, int NS>
__device__ __forceinline__ void issue_y(float (&acc)[32], const float (&s)[NS], int half, uint32_t (&pp)[3][4][4],
                                        uint32_t sX) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = 32 * half + 8 * kk + 2 * q;
      split3(s[e], s[e + 1], pp[0][kk][q], pp[1][kk][q], pp[2][kk][q]);
    }
  pin(acc);
  wgmma_fence();
  passes<1>(acc, pp, sX + half * 64 * 128, Layout<N>::kXPart);
  wgmma_commit();
}

__device__ __forceinline__ void store_y(const float (&acc)[32], float* yb, long long y_row, int row, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* o = yb + (row + 8 * half) * y_row;
#pragma unroll
    for (int nb = 0; nb < kHeadP / 8; ++nb)
      __stcs(reinterpret_cast<float2*>(o + 8 * nb + 2 * (lane & 3)),
             make_float2(acc[4 * nb + 2 * half], acc[4 * nb + 2 * half + 1]));
  }
}

// The state's A for rows n [n0, n0 + 64) and keys [64 half, 64 half + 64):
// (B * dec)^T, built from B's staged parts (ldmatrix.trans, summed: exactly
// B), times dec_j, split again
template <int N>
__device__ __forceinline__ void build_state_a(uint32_t (&ap)[3][4][4], uint32_t sB, const float* s_dec, int n0,
                                              int half, int lane, int warp) {
  const int nb = n0 + 16 * warp, t = lane & 3;
  // ldmatrix: lanes 8m..8m+7 address the 8 rows j of matrix m, whose
  // columns n start at nb + 8 (m & 1) and rows j at jb + 8 (m >> 1)
  const int mj = 8 * (lane >> 4) + (lane & 7), mn = (nb + 8 * ((lane >> 3) & 1)) >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int jb = 64 * half + 16 * kk;
    uint32_t v[3][4];
#pragma unroll
    for (int part = 0; part < 3; ++part)
      ldmatrix_x4_trans(v[part], sB + part * Layout<N>::kBPart + swz(kChunk, jb + mj, mn));
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // A rows nb + lane / 4 (+ 8 if q odd), keys j, j + 1
      const int j = jb + 8 * (q >> 1) + 2 * t;
      const float2 h = unpack(v[0][q]), m = unpack(v[1][q]), l = unpack(v[2][q]);
      split3((h.x + m.x + l.x) * s_dec[j], (h.y + m.y + l.y) * s_dec[j + 1], ap[0][kk][q], ap[1][kk][q],
             ap[2][kk][q]);
    }
  }
}

// ---------------------------------------------------------------------------
// grid (H, batch * nc); a block of one warpgroup owns one (b, c, h) tile,
// and the heads of a chunk are neighbours in the grid.  At N = 64 two
// blocks share an SM: each block's staging, exps and splits run while the
// other's products do.  Within a block the products are issued ahead of
// the work that does not need them: rows 64-127's cb behind rows 0-63's,
// so that it runs under rows 0-63's p and y, and each state half's A is
// built while the products before it run.
// ---------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(kBlock, N == 64 ? 2 : 1)
ssd_tc_kernel(const float* __restrict__ xbar, const float* __restrict__ Bm, const float* __restrict__ Cm,
              const float* __restrict__ cum, float* __restrict__ y, float* __restrict__ states, Problem P) {
  using Lay = Layout<N>;
  constexpr int kUB = kChunk * N / 8 / kBlock, kUX = kChunk * kHeadP / 8 / kBlock;   // units a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sB = (raw + 1023) & ~1023u, sX = sB + Lay::kX;
  float* s_cum = reinterpret_cast<float*>(smem_raw + (sB - raw) + Lay::kCum);
  float* s_dec = s_cum + kChunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, H = P.H;
  const long long bc = blockIdx.y, bi = bc / P.nc, ci = bc - bi * P.nc;
  const float* bp = Bm + bi * P.bs.b + ci * P.bs.c + h * P.bs.h;
  const float* cp = Cm + bi * P.cs.b + ci * P.cs.c + h * P.cs.h;
  const long long x_row = static_cast<long long>(H) * kHeadP;
  const float* xp = xbar + bc * kChunk * x_row + h * kHeadP;

  // Loads are issued before any is used (the shared-memory stores clobber
  // memory: a load after one could not be hoisted above it): xbar's and
  // B's rows, 8 floats a unit, cum, and C's rows 0-63 (at N = 64 also rows
  // 64-127) as A-fragment values.  At N = 128 B is staged in two rounds, and
  // rows 64-127 of C are loaded once rows 0-63's cb is issued, to stay
  // within the registers.
  constexpr int kRound = kUB < 8 ? kUB : 8;   // B units a round
  float2 cv[N / 16][4], cv1[N == 64 ? N / 16 : 1][4];
  const float* cq = cum + bc * kChunk * H + h;
  float cum_j, cum_last;
#pragma unroll
  for (int r = 0; r < kUB / kRound; ++r) {
    float4 ub[2 * kRound], ux[2 * kUX];
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      const int v = (r * kRound + i) * kBlock + tid, row = v / (N / 8), c8 = v % (N / 8);
      const float4* src = reinterpret_cast<const float4*>(bp + row * P.bs.i + 8 * c8);
      ub[2 * i] = __ldg(src);
      ub[2 * i + 1] = __ldg(src + 1);
    }
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < kUX; ++i) {   // xbar is read once: streaming loads
        const int v = i * kBlock + tid, row = v / (kHeadP / 8), c8 = v % (kHeadP / 8);
        const float4* src = reinterpret_cast<const float4*>(xp + row * x_row + 8 * c8);
        ux[2 * i] = __ldcs(src);
        ux[2 * i + 1] = __ldcs(src + 1);
      }
      cum_j = cq[tid * H];
      cum_last = cq[(kChunk - 1) * H];
      load_c<N>(cv, cp, P.cs.i, 0, tid);
      if constexpr (N == 64) load_c<N>(cv1, cp, P.cs.i, 64, tid);
    }
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      const int v = (r * kRound + i) * kBlock + tid, row = v / (N / 8), c8 = v % (N / 8);
      store_unit(sB + swz(kChunk, row, c8), Lay::kBPart, ub[2 * i], ub[2 * i + 1]);
    }
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < kUX; ++i) {
        const int v = i * kBlock + tid, row = v / (kHeadP / 8), c8 = v % (kHeadP / 8);
        store_unit(sX + swz(kChunk, row, c8), Lay::kXPart, ux[2 * i], ux[2 * i + 1]);
      }
    }
  }
  s_cum[tid] = cum_j;
  s_dec[tid] = expf(cum_last - cum_j);
  uint32_t c0[3][N / 16][4], c1[3][N / 16][4];
  split_c<N>(cv, c0);
  if constexpr (N == 64) split_c<N>(cv1, c1);
  fence_async_smem();   // the generic-proxy stores above, visible to wgmma
  __syncthreads();

  const int row = 16 * warp + (lane >> 2);   // this thread's rows of a row block: row, row + 8
  float* yb = y + bc * kChunk * x_row + h * kHeadP;
  float s0[32], s1[64], acc[32];
  uint32_t pp[3][4][4];
  // At N = 64 rows 64-127's cb is issued behind rows 0-63's and runs under
  // their p and y; at N = 128 its C fragments (96 registers) wait until
  // rows 0-63's y is done.
  issue_cb<N, 64>(s0, c0, sB);   // rows 0-63, keys 0-63
  if constexpr (N == 64) {
    issue_cb<N, 128>(s1, c1, sB);   // rows 64-127, keys 0-127
    wgmma_wait<1>();
  } else {
    load_c<N>(cv, cp, P.cs.i, 64, tid);
    wgmma_wait<0>();
  }
  pin(s0);
  pin(c0);
  scale_by_l<64>(s0, s_cum, row, lane);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  issue_y<N>(acc, s0, 0, pp, sX);
  if constexpr (N == 64) {
    wgmma_wait<1>();   // rows 64-127's cb; rows 0-63's y still runs
  } else {
    wgmma_wait<0>();
    pin(acc);
    pin(pp);
    split_c<N>(cv, c1);
    issue_cb<N, 128>(s1, c1, sB);
    wgmma_wait<0>();
  }
  pin(s1);
  pin(c1);
  scale_by_l<128>(s1, s_cum, 64 + row, lane);
  wgmma_wait<0>();
  pin(acc);
  pin(pp);
  store_y(acc, yb, x_row, row, lane);

#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  issue_y<N>(acc, s1, 0, pp, sX);
  wgmma_wait<0>();
  pin(acc);
  pin(pp);
  issue_y<N>(acc, s1, 1, pp, sX);

  // the state, 64 of its rows n at a time, each as two 64-key halves; the
  // next half's A is built while the products before it run
  float* sb = states + (bc * H + h) * static_cast<long long>(kHeadP) * N;
  uint32_t ap[2][3][4][4];
  float st[32];
  build_state_a<N>(ap[0], sB, s_dec, 0, 0, lane, warp);
  wgmma_wait<0>();
  pin(acc);
  pin(pp);
  store_y(acc, yb, x_row, 64 + row, lane);
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += 64) {
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = (n0 / 64) * 2 + half;   // ap[k & 1] holds this half's A
      pin(st);
      wgmma_fence();
      passes<1>(st, ap[k & 1], sX + half * 64 * 128, Lay::kXPart);
      wgmma_commit();
      if (k + 1 < 2 * (N / 64)) {
        // the next half's A goes into the other buffer, free once the
        // group before this one is done
        wgmma_wait<1>();
        pin(ap[(k + 1) & 1]);
        build_state_a<N>(ap[(k + 1) & 1], sB, s_dec, 64 * ((k + 1) / 2), (k + 1) & 1, lane, warp);
      }
    }
    wgmma_wait<0>();
    pin(st);
    pin(ap[0]);
    pin(ap[1]);
    const int n = n0 + row;
#pragma unroll
    for (int j = 0; j < 32; ++j) __stcs(sb + frag_col(j, lane) * N + n + frag_row(j), st[j]);
  }
}

template <int N>
cudaError_t launch(const float* xbar, const float* Bm, const float* Cm, const float* cum, float* y,
                   float* states, int batch, const Problem& P, cudaStream_t st) {
  auto kernel = ssd_tc_kernel<N>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Layout<N>::kSmem));
  if (e == cudaSuccess)   // room for two blocks an SM at N = 64
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(P.H, static_cast<unsigned>(batch) * P.nc);
  kernel<<<grid, kBlock, Layout<N>::kSmem, st>>>(xbar, Bm, Cm, cum, y, states, P);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Strides of B and C are in elements (the head stride may be 0); xbar,
// cum, y and states are contiguous.  tensor_cores: 1 launches the
// tensor-core design (which takes only what tc::ssd_takes accepts, else
// returns cudaErrorInvalidValue), 0 the SIMT design.  Launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int ssd_intra_chunk_launch(const float* xbar, const float* Bm, const float* Cm,
                                      const float* cum, float* y, float* states, int batch,
                                      int nc, int Q, int H, int P, int N, long long b_sb,
                                      long long b_sc, long long b_si, long long b_sh,
                                      long long c_sb, long long c_sc, long long c_si,
                                      long long c_sh, int tensor_cores, void* stream) {
  if (batch < 1 || nc < 1 || Q < 1 || Q > kMaxQ || H < 1 || H > 65535 || P < 1 ||
      P > kMaxPN || N < 1 || N > kMaxPN)
    return cudaErrorInvalidValue;
  const BCStrides bs{b_sb, b_sc, b_si, b_sh}, cs{c_sb, c_sc, c_si, c_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    const long long strides[8] = {b_sb, b_sc, b_si, b_sh, c_sb, c_sc, c_si, c_sh};
    if (!tc::ssd_takes(xbar, Bm, Cm, batch, nc, Q, P, N, strides)) return cudaErrorInvalidValue;
    const tc::Problem prob{nc, H, bs, cs};
    return N == 64 ? tc::launch<64>(xbar, Bm, Cm, cum, y, states, batch, prob, st)
                   : tc::launch<128>(xbar, Bm, Cm, cum, y, states, batch, prob, st);
  }
  const int widest = P > N ? P : N;
  if (widest <= 16) return launch_w<1>(xbar, Bm, Cm, cum, y, states, batch, nc, Q, H, P, N, bs, cs, st);
  if (widest <= 32) return launch_w<2>(xbar, Bm, Cm, cum, y, states, batch, nc, Q, H, P, N, bs, cs, st);
  if (widest <= 64) return launch_w<4>(xbar, Bm, Cm, cum, y, states, batch, nc, Q, H, P, N, bs, cs, st);
  return launch_w<8>(xbar, Bm, Cm, cum, y, states, batch, nc, Q, H, P, N, bs, cs, st);
}
