// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, GQA, causal and sliding-window masks, whole-tile skipping, in two
// designs: a tensor-core design for bf16 (D % 16 == 0, D <= 128, rows 16-byte
// aligned) and a SIMT design for everything else (f32, fp16, other D).  The
// wrapper (kernels/flash_attention/bwd.py) picks the design by those rules.
//
// Replace the TPU kernels repro/kernels/flash_attention/bwd_kernel.py::_dq_kernel
// and ::_dkdv_kernel (launched by flash_attention_bwd_pallas).  The plain PyTorch
// version of the same function is
// repro_torch/kernels/flash_attention/bwd_ref.py::flash_attention_bwd_ref, a port of
// the reference's recompute-based custom_vjp backward (repro/models/attention.py::_flash_bwd).
//
// What they compute, per (batch b, query head h, kv head h / G, G = H / KV):
//   p_ij  = exp(s_ij * scale - lse_i), s_ij = q_i . k_j, over the live pairs
//           (j < Sk, and j <= i if causal, and i - j < window if windowed);
//           a dead pair's score is -1e30, so its p is 0, as in _masked_p
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i) * scale, delta_i = dO_i . O_i (f32, given)
//   dq kernel:   dQ_i = sum_j ds_ij k_j
//   dkdv kernel: dV_j = sum_{g, i} p_ij dO_i and dK_j = sum_{g, i} ds_ij q_i,
//                summed over the G query heads of kv head j's head in f32.
// q, k, v and dO are read through their (batch, seq, head) strides (only the
// head dim must be unit-stride); lse and delta are (B, H, Sq) f32; dq is
// written (B, Sq, H, D) in q's dtype, dk and dv (B, Sk, KV, D) in k's dtype.
// Neither design uses atomics: the same inputs give bit-identical outputs.
//
// What bounds them on this card: at the trained qwen3-1.7b shape (B=4, S=4096,
// H=16, KV=8, D=128, bf16, causal) dQ does three products over the live
// pairs (s, dp, ds k: 6 D FLOP a pair, 4.1e11 FLOP) and dK/dV four (s, dp,
// p^T dO, ds^T q: 8 D, 5.5e11 FLOP) against about 0.27 GB of inputs and
// outputs each, some 1,500-2,000 FLOP per byte: both are bound by
// arithmetic, and the 989 TFLOP/s bf16 tensor-core rate is the card's bound.
//
// The tensor-core design (namespace tc).  The TPU kernels upcast every operand
// and keep p and ds in f32.  q, k, v and dO arrive in bf16 and a bf16 x bf16
// product is exact in f32, so s = q k^T and dp = dO v^T run as bf16 wgmma with
// f32 accumulators and differ from f32 FMAs only in summation order.  The
// products with an f32 operand (ds k, p^T dO, ds^T q) split it into bf16
// x_hi = bf16(x) and x_lo = bf16(x - x_hi) and run two wgmma passes, hi and
// lo, into one f32 accumulator: x_hi + x_lo holds x to about 2^-17, far below
// the bf16 rounding of the output (2^-9).  So the kernels execute 4 passes of
// 2 D FLOP a live pair (dq) and 6 (dkdv) for the algorithm's 3 and 4.
//   dq:   a block of two warpgroups owns 128 query rows of one head; Q and dO
//         stay in shared memory, lse and delta in registers.  It walks 64-key
//         tiles of K and V through a two-stage ring filled by cp.async (issued
//         one tile ahead).  Per tile and warpgroup (64 rows): S and dP as SS
//         wgmma m64n64k16 (K-major), the mask, p and ds on the accumulator
//         fragments, ds split in registers, and dQ += ds_hi K + ds_lo K as RS
//         wgmma m64n(D)k16: A is the ds accumulator re-packed as bf16 (its
//         fragment layout is the A layout), B the same staged K tile read
//         MN-major (transposed).  The last query tile, which sees the most
//         keys under a causal mask, is launched first.
//   dkdv: a block of two warpgroups owns 128 keys of one kv head; K and V
//         stay in shared memory.  It walks the G query heads and their 64-query
//         tiles (Q, dO, lse, delta through the same ring).  Per tile and
//         warpgroup (64 keys): S^T = K Q^T and dP^T = V dO^T (keys are the
//         accumulator rows; lse and delta index its columns), p and ds, then
//         dV += p_hi^T dO + p_lo^T dO and dK += ds_hi^T Q + ds_lo^T Q as RS
//         wgmma with the staged Q and dO tiles read MN-major.  The dK, dV
//         accumulators (2 x 64 f32 a thread at D = 128) hold the G heads' sum
//         in f32; each is written once.  Key tile 0 goes first.
//   Shared memory holds every tile in the 128-byte-swizzle layout, so one
//   staged tile serves as the K-major B of S / dP and the MN-major B of the
//   accumulation.  cp.async rather than TMA: the library is one .cu with a
//   plain C interface that links no libcuda, so a tensor map would need the
//   driver entry point, and cp.async's zero-fill gives the ragged edges and
//   the strided (batch, seq, head) reads for free.  A warpgroup skips a tile
//   wholly masked for its rows; only tiles that cross the diagonal, the window
//   edge or a ragged end evaluate the mask per element.  Shared memory pads
//   the head dim with zeros to 64 (D <= 64) or 128.  Both kernels take about
//   130 KB of shared memory and 256 threads: one block an SM.  At D = 128 the
//   dK/dV kernel needs all 255 registers a thread may have (0 spills, ptxas);
//   p's and ds's fragments therefore share one pair of arrays.
//   The cp.async, descriptor, wgmma and fragment helpers, the input rule
//   (tc::wgmma_takes), the mask (live_pair) and dQ's key walk (tc::KeyWalk:
//   tile order, tile range, skip and edge tests, the ring) are in
//   hopper_tc.cuh, shared with the forward kernel.
//
// The SIMT design (f32 and fp16, a D that is not a multiple of 16, and the
// smoke config's f32 training) does every product as an IEEE f32 FMA on CUDA
// cores, with every operand staged once per tile in shared memory as f32:
//   dq:   a block of 256 threads owns 64 query rows of one head (Q and dO
//         rows stationary in shared memory, lse and delta in registers) and
//         walks 64-key tiles of K and V, stored transposed.  Each thread owns
//         a 4 x 4 patch of the 64 x 64 s and dp tiles, writes its ds patch to
//         shared memory, and then a 4-row x DPT-column patch of dQ (held in
//         registers across the walk).  The walk breaks at the first tile
//         wholly in the future and skips tiles wholly before the window, as
//         the forward does.
//   dkdv: a block owns 64 keys of one kv head (K and V rows stationary) and
//         walks the G query heads of that kv head and, for each, the 64-query
//         tiles (Q and dO stored transposed, lse and delta in shared memory)
//         from the first tile that can see the key tile (causal) to the last
//         (window).  Each thread owns a 4 x 4 patch of the transposed s and dp
//         tiles, parks p and ds in shared memory, and accumulates 4 keys x DPT
//         dims of both dK and dV in registers (64 floats at D = 128).  Summing
//         the G heads inside the block keeps the group sum in f32 (the Pallas
//         kernel writes per-query-head partials in k's dtype and sums them
//         outside, bwd_kernel.py:217-218) and writes each of dK and dV once.
// Shared memory row strides D + 1 and 65 make the row reads and the
// transposed stores conflict-free for any D <= 128: 149 KB (dq) and 166 KB
// (dkdv) at D = 128, so one block of 8 warps runs on each SM.
//
// Numerics, both designs: f32 sums, expf (no --use_fast_math); ds is formed
// as (p * (dp - delta)) * scale, the reference's order.  Rows beyond Sq load
// lse and delta as 0 and q, dO as 0 (the Pallas wrapper pads lse with 0), keys
// beyond Sk load as 0; both are masked, so they add exact zeros.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kBQ = 64;            // query rows per tile
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // a 16 x 16 thread grid
constexpr int kRows = 4;           // tile rows per thread: ty + 16 * i
constexpr int kCols = 4;           // tile columns per thread: tx + 16 * j
struct Problem {
  int Sq, Sk, H, KV, D;
  Strides qs, ks, vs, dos;
  int causal, window;  // window <= 0: none
  float scale;
};

// ---------------------------------------------------------------------------
// dQ: grid (ceil(Sq / 64), H, B)
// ---------------------------------------------------------------------------
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Problem P) {
  extern __shared__ float smem[];
  const int D = P.D;
  const int rs = D + 1;       // row stride of the stationary Q / dO tiles
  const int ts = kBK + 1;     // row stride of the transposed K / V tiles and of ds
  float* Qs = smem;           // [kBQ][D+1]
  float* Gs = Qs + kBQ * rs;  // [kBQ][D+1]  dO
  float* Kt = Gs + kBQ * rs;  // [D][kBK+1]
  float* Vt = Kt + D * ts;    // [D][kBK+1]
  float* Ds = Vt + D * ts;    // [kBQ][kBK+1]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (P.H / P.KV);
  const T* qb = q + b * P.qs.b + h * P.qs.h;
  const T* gb = dout + b * P.dos.b + h * P.dos.h;
  const T* kb = k + b * P.ks.b + kvh * P.ks.h;
  const T* vb = v + b * P.vs.b + kvh * P.vs.h;
  const long long row_base = (static_cast<long long>(b) * P.H + h) * P.Sq;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int row = q0 + r;
    const bool in = row < P.Sq;
    Qs[r * rs + d] = in ? to_f(qb[row * P.qs.s + d]) : 0.0f;
    Gs[r * rs + d] = in ? to_f(gb[row * P.dos.s + d]) : 0.0f;
  }
  float lse_r[kRows], delta_r[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < P.Sq ? lse[row_base + row] : 0.0f;
    delta_r[i] = row < P.Sq ? delta[row_base + row] : 0.0f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, P.Sq) - 1;
  const int n_tiles = (P.Sk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    if (P.causal && k0 > q_last) break;                                // this and later tiles: future
    if (P.window > 0 && k0 + kBK - 1 < q0 - P.window + 1) continue;    // wholly before the window
    __syncthreads();   // the previous tile's readers are done with Kt, Vt, Ds (and Qs, Gs are loaded)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      const int key = k0 + c;
      float kv = 0.0f, vv = 0.0f;
      if (key < P.Sk) {
        kv = to_f(kb[key * P.ks.s + d]);
        vv = to_f(vb[key * P.vs.s + d]);
      }
      Kt[d * ts + c] = kv;
      Vt[d * ts + c] = vv;
    }
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qr[kRows], gr[kRows], kc[kCols], vc[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qr[i] = Qs[(ty + 16 * i) * rs + d];
        gr[i] = Gs[(ty + 16 * i) * rs + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kc[j] = Kt[d * ts + tx + 16 * j];
        vc[j] = Vt[d * ts + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(gr[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int qi = q0 + ty + 16 * i, kj = k0 + tx + 16 * j;
        const float sv = live_pair(P, qi, kj) ? s[i][j] * P.scale : kNegInf;
        const float p = expf(sv - lse_r[i]);
        Ds[(ty + 16 * i) * ts + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * P.scale;
      }
    __syncthreads();   // Ds complete

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float dsr[kRows], kr[DPT];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsr[i] = Ds[(ty + 16 * i) * ts + c];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const int d = tx + 16 * dd;
        kr[dd] = d < D ? Kt[d * ts + c] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = fmaf(dsr[i], kr[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= P.Sq) continue;
    T* o = dq + ((static_cast<long long>(b) * P.Sq + row) * P.H + h) * D;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      const int d = tx + 16 * dd;
      if (d < D) o[d] = from_f<T>(acc[i][dd]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK / dV: grid (ceil(Sk / 64), KV, B)
// ---------------------------------------------------------------------------
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      Problem P) {
  extern __shared__ float smem[];
  const int D = P.D;
  const int rs = D + 1;        // row stride of the stationary K / V tiles
  const int ts = kBQ + 1;      // row stride of the transposed Q / dO tiles and of p, ds
  float* Ks = smem;            // [kBK][D+1]
  float* Vs = Ks + kBK * rs;   // [kBK][D+1]
  float* Qt = Vs + kBK * rs;   // [D][kBQ+1]
  float* Gt = Qt + D * ts;     // [D][kBQ+1]  dO
  float* Ps = Gt + D * ts;     // [kBK][kBQ+1] p, keys as rows
  float* Ds = Ps + kBK * ts;   // [kBK][kBQ+1] ds, keys as rows
  float* Ls = Ds + kBK * ts;   // [kBQ] lse
  float* Es = Ls + kBQ;        // [kBQ] delta

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = P.H / P.KV;
  const T* kb = k + b * P.ks.b + kvh * P.ks.h;
  const T* vb = v + b * P.vs.b + kvh * P.vs.h;

  for (int idx = tid; idx < kBK * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int key = k0 + r;
    const bool in = key < P.Sk;
    Ks[r * rs + d] = in ? to_f(kb[key * P.ks.s + d]) : 0.0f;
    Vs[r * rs + d] = in ? to_f(vb[key * P.vs.s + d]) : 0.0f;
  }
  float dk_acc[kRows][DPT], dv_acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) dk_acc[i][dd] = dv_acc[i][dd] = 0.0f;

  const int k_last = min(k0 + kBK, P.Sk) - 1;
  const int n_tiles = (P.Sq + kBQ - 1) / kBQ;
  const int t_first = P.causal ? k0 / kBQ : 0;   // earlier query tiles lie wholly before the keys
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + b * P.qs.b + h * P.qs.h;
    const T* gb = dout + b * P.dos.b + h * P.dos.h;
    const long long row_base = (static_cast<long long>(b) * P.H + h) * P.Sq;
    for (int t = t_first; t < n_tiles; ++t) {
      const int q0 = t * kBQ;
      if (P.window > 0 && q0 > k_last + P.window - 1) break;   // this and later tiles: past the window
      __syncthreads();   // the previous tile's readers are done with Qt, Gt, Ps, Ds, Ls, Es
      for (int idx = tid; idx < kBQ * D; idx += kThreads) {
        const int r = idx / D, d = idx - r * D;
        const int row = q0 + r;
        const bool in = row < P.Sq;
        Qt[d * ts + r] = in ? to_f(qb[row * P.qs.s + d]) : 0.0f;
        Gt[d * ts + r] = in ? to_f(gb[row * P.dos.s + d]) : 0.0f;
      }
      if (tid < kBQ) {
        const int row = q0 + tid;
        Ls[tid] = row < P.Sq ? lse[row_base + row] : 0.0f;
        Es[tid] = row < P.Sq ? delta[row_base + row] : 0.0f;
      }
      __syncthreads();

      float s[kRows][kCols], dp[kRows][kCols];   // [key][query]
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kr[kRows], vr[kRows], qc[kCols], gc[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kr[i] = Ks[(ty + 16 * i) * rs + d];
          vr[i] = Vs[(ty + 16 * i) * rs + d];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qc[j] = Qt[d * ts + tx + 16 * j];
          gc[j] = Gt[d * ts + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], gc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int kj = k0 + ty + 16 * i, c = tx + 16 * j;
          const float sv = live_pair(P, q0 + c, kj) ? s[i][j] * P.scale : kNegInf;
          const float p = expf(sv - Ls[c]);
          Ps[(ty + 16 * i) * ts + c] = p;
          Ds[(ty + 16 * i) * ts + c] = p * (dp[i][j] - Es[c]) * P.scale;
        }
      __syncthreads();   // Ps, Ds complete

#pragma unroll 2
      for (int c = 0; c < kBQ; ++c) {
        float pr[kRows], dsr[kRows], gv[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pr[i] = Ps[(ty + 16 * i) * ts + c];
          dsr[i] = Ds[(ty + 16 * i) * ts + c];
        }
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) {
          const int d = tx + 16 * dd;
          gv[dd] = d < D ? Gt[d * ts + c] : 0.0f;
          qv[dd] = d < D ? Qt[d * ts + c] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int dd = 0; dd < DPT; ++dd) {
            dv_acc[i][dd] = fmaf(pr[i], gv[dd], dv_acc[i][dd]);
            dk_acc[i][dd] = fmaf(dsr[i], qv[dd], dk_acc[i][dd]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= P.Sk) continue;
    const long long off = ((static_cast<long long>(b) * P.Sk + key) * P.KV + kvh) * D;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      const int d = tx + 16 * dd;
      if (d < D) {
        dk[off + d] = from_f<T>(dk_acc[i][dd]);
        dv[off + d] = from_f<T>(dv_acc[i][dd]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int DPT>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int B, const Problem& P,
                      cudaStream_t stream) {
  const size_t D = P.D;
  const size_t smem = sizeof(float) * (2 * kBQ * (D + 1) + 2 * D * (kBK + 1) + kBQ * (kBK + 1));
  auto kernel = flash_bwd_dq_kernel<T, DPT>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((P.Sq + kBQ - 1) / kBQ, P.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<const T*>(dout),
                                           lse, delta, static_cast<T*>(dq), P);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int B,
                        const Problem& P, cudaStream_t stream) {
  const size_t D = P.D;
  const size_t smem =
      sizeof(float) * (2 * kBK * (D + 1) + 2 * D * (kBQ + 1) + 2 * kBK * (kBQ + 1) + 2 * kBQ);
  auto kernel = flash_bwd_dkdv_kernel<T, DPT>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((P.Sk + kBK - 1) / kBK, P.KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<const T*>(dout),
                                           lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), P);
  return cudaGetLastError();
}

// DPT output dims per thread (tx + 16 * dd), so D <= 16 * DPT.
template <typename T>
cudaError_t dispatch(bool want_dq, const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* out0, void* out1, int B,
                     const Problem& P, cudaStream_t st) {
#define FLASH_BWD_CASE(DPT)                                                              \
  return want_dq ? launch_dq<T, DPT>(q, k, v, dout, lse, delta, out0, B, P, st)          \
                 : launch_dkdv<T, DPT>(q, k, v, dout, lse, delta, out0, out1, B, P, st)
  if (P.D <= 16) FLASH_BWD_CASE(1);
  if (P.D <= 32) FLASH_BWD_CASE(2);
  if (P.D <= 64) FLASH_BWD_CASE(4);
  FLASH_BWD_CASE(8);
#undef FLASH_BWD_CASE
}

// ===========================================================================
// The tensor-core design: bf16 inputs, D % 16 == 0, D <= 128
// ===========================================================================
namespace tc {

// ---------------------------------------------------------------------------
// dQ: grid (ceil(Sq / 128), H, B); a block owns 128 query rows of one head
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq, Problem P) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t kStatBytes = kRows * DP * 2;
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sG = sQ + kStatBytes;   // dO, then the walk's K and V ring

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int D = P.D, h = blockIdx.y, b = blockIdx.z;
  const KeyWalk<DP> walk(P, k, v, sG + kStatBytes, tid);
  const int row = walk.row;   // this thread's rows: row, row + 8

  load_tile<kRows, DP>(sQ, q + b * P.qs.b + h * P.qs.h, P.qs.s, walk.q0, P.Sq, D, tid);
  load_tile<kRows, DP>(sG, dout + b * P.dos.b + h * P.dos.h, P.dos.s, walk.q0, P.Sq, D, tid);
  walk.start(P, tid);

  const long long row_base = (static_cast<long long>(b) * P.H + h) * P.Sq;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row + 8 * i < P.Sq;
    lse_r[i] = in ? lse[row_base + row + 8 * i] : 0.0f;
    delta_r[i] = in ? delta[row_base + row + 8 * i] : 0.0f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;

  for (int it = 0; it < walk.n_items; ++it) {
    walk.advance(P, it, tid);
    const int k0 = walk.key0(it);
    if (!walk.skip(P, k0)) {
      const uint32_t tK = walk.k_tile(it);
      float s[32], dp[32];
      issue_scores<DP>(s, sQ, 64 * wg, tK);
      issue_scores<DP>(dp, sG, 64 * wg, walk.v_tile(it));
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(dp);
      const bool edge = walk.edge(P, k0);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int half = (j >> 1) & 1;
        float sv = s[j] * P.scale;
        if (edge && !live_pair(P, row + frag_row(j), k0 + frag_col(j, lane))) sv = kNegInf;
        const float p = expf(sv - lse_r[half]);
        dp[j] = p * (dp[j] - delta_r[half]) * P.scale;   // ds
      }
      uint32_t hi[16], lo[16];
      split(dp, hi, lo);
      wgmma_fence();
      issue_accumulate(acc, hi, lo, tK);   // dQ += ds_hi . K + ds_lo . K
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      pin(hi);
      pin(lo);
    }
    __syncthreads();   // both warpgroups are done with this stage before it is refilled
  }
  cp_async_wait<0>();

  store_rows<DP>(acc, dq + ((static_cast<long long>(b) * P.Sq) * P.H + h) * D, static_cast<long long>(P.H) * D,
                 row, P.Sq, D, lane);
}

// ---------------------------------------------------------------------------
// dK / dV: grid (ceil(Sk / 128), KV, B); a block owns 128 keys of one kv head
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     Problem P) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t kStatBytes = kRows * DP * 2, kTileBytes = kStream * DP * 2;
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + kStatBytes;
  const uint32_t sQ = sV + kStatBytes;               // [kStages] query tiles
  const uint32_t sG = sQ + kStages * kTileBytes;     // [kStages] dO tiles
  const uint32_t sL = sG + kStages * kTileBytes;     // [kStages][64] lse, then [kStages][64] delta
  const float* lse_s = reinterpret_cast<const float*>(smem_raw + (sL - smem_u32(smem_raw)));
  const float* delta_s = lse_s + kStages * kStream;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int D = P.D, G = P.H / P.KV;
  const int k0 = blockIdx.x * kRows;   // causal: key tile 0 sees the most queries and goes first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const bf16* kb = k + b * P.ks.b + kvh * P.ks.h;
  const bf16* vb = v + b * P.vs.b + kvh * P.vs.h;

  // query tiles [t_lo, t_hi) of each of the G heads: none wholly before the
  // keys (causal), none wholly past the window
  const int k_last = min(k0 + kRows, P.Sk) - 1;
  int t_lo = 0, t_hi = (P.Sq + kStream - 1) / kStream;
  if (P.causal) t_lo = k0 / kStream;
  if (P.window > 0) t_hi = min(t_hi, (k_last + P.window - 1) / kStream + 1);
  const int nt = max(0, t_hi - t_lo), n_items = G * nt;

  // item i: head kvh * G + i / nt, query tile t_lo + i % nt, into stage st
  auto load_item = [&](int i, int st) {
    const int hh = kvh * G + i / nt, q0 = (t_lo + i % nt) * kStream;
    load_tile<kStream, DP>(sQ + st * kTileBytes, q + b * P.qs.b + hh * P.qs.h, P.qs.s, q0, P.Sq, D, tid);
    load_tile<kStream, DP>(sG + st * kTileBytes, dout + b * P.dos.b + hh * P.dos.h, P.dos.s, q0, P.Sq, D, tid);
    if (tid < 2 * kStream) {
      const int c = tid & (kStream - 1);
      const float* src = (tid < kStream ? lse : delta) + (static_cast<long long>(b) * P.H + hh) * P.Sq;
      const bool ok = q0 + c < P.Sq;
      cp_async4(sL + 4 * ((tid < kStream ? 0 : kStages * kStream) + st * kStream + c), ok ? src + q0 + c : src, ok);
    }
  };

  load_tile<kRows, DP>(sK, kb, P.ks.s, k0, P.Sk, D, tid);
  load_tile<kRows, DP>(sV, vb, P.vs.s, k0, P.Sk, D, tid);
  if (n_items > 0) load_item(0, 0);
  cp_async_commit();

  const int kw0 = k0 + 64 * wg;                      // the warpgroup's keys
  const int kw_last = min(kw0 + 63, P.Sk - 1);
  const int key = kw0 + 16 * warp + (lane >> 2);     // this thread's keys: key, key + 8
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  for (int it = 0; it < n_items; ++it) {
    const int q0 = (t_lo + it % nt) * kStream, st = it & 1;
    if (it + 1 < n_items) load_item(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();

    const bool skip = kw0 >= P.Sk || (P.causal && q0 + kStream - 1 < kw0) ||
                      (P.window > 0 && q0 > kw_last + P.window - 1);
    if (!skip) {
      const uint32_t tQ = sQ + st * kTileBytes, tG = sG + st * kTileBytes;
      const float* L = lse_s + st * kStream;
      const float* E = delta_s + st * kStream;
      float s[32], dp[32];   // transposed: keys are the rows, queries the columns
      issue_scores<DP>(s, sK, 64 * wg, tQ);
      issue_scores<DP>(dp, sV, 64 * wg, tG);
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(dp);
      const bool edge = q0 + kStream > P.Sq || kw0 + 64 > P.Sk || (P.causal && kw0 + 63 > q0) ||
                        (P.window > 0 && q0 + kStream - 1 - kw0 >= P.window);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = frag_col(j, lane);
        float sv = s[j] * P.scale;
        if (edge && !live_pair(P, q0 + c, key + frag_row(j))) sv = kNegInf;
        const float p = expf(sv - L[c]);
        s[j] = p;
        dp[j] = p * (dp[j] - E[c]) * P.scale;   // ds
      }
      // one pair of fragment arrays, p's and then ds's: at D = 128 the two
      // pairs live at once beside the dK and dV accumulators spill
      uint32_t hi[16], lo[16];
      split(s, hi, lo);
      wgmma_fence();
      issue_accumulate(dv_acc, hi, lo, tG);   // dV += p_hi^T . dO + p_lo^T . dO
      wgmma_commit();
      wgmma_wait_all();
      pin(dv_acc);
      pin(hi);
      pin(lo);
      split(dp, hi, lo);
      wgmma_fence();
      issue_accumulate(dk_acc, hi, lo, tQ);   // dK += ds_hi^T . Q + ds_lo^T . Q
      wgmma_commit();
      wgmma_wait_all();
      pin(dk_acc);
      pin(hi);
      pin(lo);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  const long long off = (static_cast<long long>(b) * P.Sk * P.KV + kvh) * D;
  const long long rs = static_cast<long long>(P.KV) * D;
  store_rows<DP>(dk_acc, dk + off, rs, key, P.Sk, D, lane);
  store_rows<DP>(dv_acc, dv + off, rs, key, P.Sk, D, lane);
}

template <int DP>
cudaError_t launch(bool want_dq, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* out0, void* out1, int B,
                   const Problem& P, cudaStream_t st) {
  const size_t stat = kRows * DP * 2, tile = kStream * DP * 2;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  const auto* gg = static_cast<const bf16*>(dout);
  if (want_dq) {
    const size_t smem = 1024 + 2 * stat + 2 * kStages * tile;
    auto kernel = flash_bwd_dq_wgmma<DP>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((P.Sq + kRows - 1) / kRows, P.H, B);
    kernel<<<grid, kThreads, smem, st>>>(qq, kk, vv, gg, lse, delta, static_cast<bf16*>(out0), P);
  } else {
    const size_t smem = 1024 + 2 * stat + 2 * kStages * tile + 2 * kStages * kStream * sizeof(float);
    auto kernel = flash_bwd_dkdv_wgmma<DP>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((P.Sk + kRows - 1) / kRows, P.KV, B);
    kernel<<<grid, kThreads, smem, st>>>(qq, kk, vv, gg, lse, delta, static_cast<bf16*>(out0),
                                         static_cast<bf16*>(out1), P);
  }
  return cudaGetLastError();
}

}  // namespace tc

int launch(bool want_dq, bool tensor_cores, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta, void* out0, void* out1,
           int dtype, int B, int Sq, int Sk, int H, int KV, int D, const long long* strides,
           int causal, int window, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H < KV || H % KV != 0 || D < 1 || D > kMaxD ||
      H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const Problem P{Sq, Sk, H, KV, D,
                  Strides{strides[0], strides[1], strides[2]},
                  Strides{strides[3], strides[4], strides[5]},
                  Strides{strides[6], strides[7], strides[8]},
                  Strides{strides[9], strides[10], strides[11]},
                  causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    const void* ptrs[4] = {q, k, v, dout};
    if (!tc::wgmma_takes(ptrs, dtype, D, strides)) return cudaErrorInvalidValue;
    return D <= 64 ? tc::launch<64>(want_dq, q, k, v, dout, lse, delta, out0, out1, B, P, st)
                   : tc::launch<128>(want_dq, q, k, v, dout, lse, delta, out0, out1, B, P, st);
  }
  switch (dtype) {
    case 0:
      return dispatch<float>(want_dq, q, k, v, dout, lse, delta, out0, out1, B, P, st);
    case 1:
      return dispatch<__nv_bfloat16>(want_dq, q, k, v, dout, lse, delta, out0, out1, B, P, st);
    case 2:
      return dispatch<__half>(want_dq, q, k, v, dout, lse, delta, out0, out1, B, P, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v, dO and the outputs share
// it).  lse and delta: (B, H, Sq) contiguous f32.  strides: 12 element
// strides, (batch, seq, head) of q, k, v and dO in that order.  window <= 0
// means no window.  tensor_cores: 1 launches the wgmma design (which takes
// only what tc::wgmma_takes accepts, else returns cudaErrorInvalidValue), 0 the
// SIMT design.  Launch on `stream`; return cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* delta, void* dq, int dtype, int B,
                                             int Sq, int Sk, int H, int KV, int D,
                                             const long long* strides, int causal, int window,
                                             float scale, int tensor_cores, void* stream) {
  return launch(true, tensor_cores != 0, q, k, v, dout, lse, delta, dq, nullptr, dtype, B, Sq, Sk,
                H, KV, D, strides, causal, window, scale, stream);
}

extern "C" int flash_attention_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                                               const void* dout, const float* lse,
                                               const float* delta, void* dk, void* dv, int dtype,
                                               int B, int Sq, int Sk, int H, int KV, int D,
                                               const long long* strides, int causal, int window,
                                               float scale, int tensor_cores, void* stream) {
  return launch(false, tensor_cores != 0, q, k, v, dout, lse, delta, dk, dv, dtype, B, Sq, Sk, H,
                KV, D, strides, causal, window, scale, stream);
}
