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

namespace {

constexpr int kBQ = 64;            // query rows per tile
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // a 16 x 16 thread grid
constexpr int kRows = 4;           // tile rows per thread: ty + 16 * i
constexpr int kCols = 4;           // tile columns per thread: tx + 16 * j
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

struct Strides {
  long long b, s, h;   // elements; the head dim is unit-stride
};

struct Problem {
  int Sq, Sk, H, KV, D;
  Strides qs, ks, vs, dos;
  int causal, window;  // window <= 0: none
  float scale;
};

__device__ __forceinline__ bool live_pair(const Problem& P, int qi, int kj) {
  bool live = qi < P.Sq && kj < P.Sk;
  if (P.causal) live = live && qi >= kj;
  if (P.window > 0) live = live && qi - kj < P.window;
  return live;
}

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

using bf16 = __nv_bfloat16;

constexpr int kWG = 2;                   // warpgroups per block, each on its own 64 stationary rows
constexpr int kThreads = 128 * kWG;
constexpr int kRows = 64 * kWG;          // stationary rows per block: queries (dq) or keys (dkdv)
constexpr int kStream = 64;              // rows per streamed tile: keys (dq) or queries (dkdv)
constexpr int kStages = 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; nothing is read and zeros land when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's shared-memory writes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pin registers that an in-flight wgmma reads or writes at this point of the program
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Tiles live in shared memory in the 128-byte-swizzle layout of wgmma: a
// tile of R rows x DP bf16 columns is DP / 64 column chunks of R rows x 128
// bytes each, and the 16-byte unit u of row r sits at unit u ^ (r % 8).
// Tiles start 1024-byte aligned, so the hardware's swizzle (address bits
// 4-6 XOR bits 7-9) is this one.
__device__ __forceinline__ uint32_t swz(int R, int r, int c8) {
  return (c8 >> 3) * R * 128 + r * 128 + (((c8 & 7) ^ (r & 7)) << 4);
}

// rows [row0, row0 + R) of a (n_rows, D) bf16 matrix with row stride rs
// (elements) into a tile; rows >= n_rows and columns >= D land as zeros
template <int R, int DP>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* base, long long rs, int row0,
                                          int n_rows, int D, int tid) {
  constexpr int kChunks = DP / 8;
  static_assert(R * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int idx = i * kThreads + tid;
    const int r = idx / kChunks, c8 = idx % kChunks;
    const int row = row0 + r;
    const bool ok = row < n_rows && c8 * 8 < D;
    cp_async16(tile + swz(R, r, c8), ok ? base + row * rs + c8 * 8 : base, ok);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand: rows [r0, r0 + 64) (A) or the tile's 64 rows (B) of an
// R-row tile; 8-row groups 1024 B apart.  Reduction columns [16 kk, 16 kk + 16)
// start kmajor_step(R, kk) 16-byte units further on.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int R, int r0) {
  return desc(tile + r0 * 128, 16, 1024);
}
__device__ __forceinline__ constexpr uint64_t kmajor_step(int R, int kk) {
  return static_cast<uint64_t>(((kk >> 2) * R * 128 + (kk & 3) * 32) >> 4);
}
// MN-major (transposed) B: the tile read with its rows as the reduction
// dim, all DP columns; column chunks R * 128 B apart (LBO), 8-row groups
// 1024 B apart (SBO).  Rows [16 kk, 16 kk + 16) start 2048 kk bytes on.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int R) { return desc(tile, R * 128, 1024); }
__device__ __forceinline__ constexpr uint64_t mnmajor_step(int kk) { return static_cast<uint64_t>(kk * 2048 >> 4); }
// Rebuilt from the tile address on every tile: the compiler would otherwise
// hold every k-step's descriptor of the stationary tiles in registers for the
// whole walk (32 registers at D = 128), which spills the dK/dV kernel.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// s = (the warpgroup's 64 rows [r0, r0 + 64) of a stationary tile) . (a
// streamed 64-row tile)^T over the head dim: SS wgmmas, both K-major
template <int DP>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t a_tile, int r0, uint32_t b_tile) {
  // (ptxas notes C7517 here, a warpgroup.wait before these registers, the
  // last tile's accumulators, are rewritten; no wgmma is in flight by then)
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  pin(s);
  wgmma_fence();
  const uint64_t da = opaque(kmajor(a_tile, kRows, r0)), db = opaque(kmajor(b_tile, kStream, 0));
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_m64n64(s, da + kmajor_step(kRows, kk), db + kmajor_step(kStream, kk));
}

// an f32 accumulator of 64 x 64 -> the bf16 hi and lo parts of each
// element (x_lo = bf16(x - x_hi)) as wgmma A fragments: the accumulator's
// elements 2j, 2j+1 are register j, and k-step kk takes registers 4kk..4kk+3
__device__ __forceinline__ void split(const float (&x)[32], uint32_t (&hi)[16], uint32_t (&lo)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    const float2 f = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x[2 * j] - f.x, x[2 * j + 1] - f.y);
    hi[j] = *reinterpret_cast<const uint32_t*>(&h);
    lo[j] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// acc += (hi + lo) . tile over the 64 rows of a streamed tile read
// transposed: RS wgmmas, two passes of four k-steps
template <int N>
__device__ __forceinline__ void issue_accumulate(float (&acc)[N], const uint32_t (&hi)[16],
                                                 const uint32_t (&lo)[16], uint32_t tile) {
  const uint64_t db = opaque(mnmajor(tile, kStream));
#pragma unroll
  for (int kk = 0; kk < kStream / 16; ++kk) {
    const uint32_t h[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3]};
    wgmma_rs_tb(acc, h, db + mnmajor_step(kk));
  }
#pragma unroll
  for (int kk = 0; kk < kStream / 16; ++kk) {
    const uint32_t l[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3]};
    wgmma_rs_tb(acc, l, db + mnmajor_step(kk));
  }
}

// Accumulator layout of an m64nN wgmma: warp w of the warpgroup holds rows
// 16 w + lane / 4 (+ 8), and element j of a thread sits at row + 8 * ((j >> 1) & 1),
// column 8 * (j >> 2) + 2 * (lane % 4) + (j & 1).
__device__ __forceinline__ int frag_row(int j) { return 8 * ((j >> 1) & 1); }
__device__ __forceinline__ int frag_col(int j, int lane) { return 8 * (j >> 2) + 2 * (lane & 3) + (j & 1); }

template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2], bf16* out, long long row_stride,
                                           int row, int n_rows, int D, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= n_rows) continue;
    bf16* o = out + r * row_stride;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int c = 8 * nb + 2 * (lane & 3);
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(o + c) =
            __floats2bfloat162_rn(acc[4 * nb + 2 * half], acc[4 * nb + 2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (ceil(Sq / 128), H, B); a block owns 128 query rows of one head
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq, Problem P) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t kStatBytes = kRows * DP * 2, kTileBytes = kStream * DP * 2;
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sG = sQ + kStatBytes;            // dO
  const uint32_t sK = sG + kStatBytes;            // [kStages] key tiles
  const uint32_t sV = sK + kStages * kTileBytes;  // [kStages] value tiles

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int D = P.D;
  const int n_qt = (P.Sq + kRows - 1) / kRows;
  // causal: the last query tile sees the most keys, so it goes first
  const int q0 = (P.causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x)) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (P.H / P.KV);
  const bf16* qb = q + b * P.qs.b + h * P.qs.h;
  const bf16* gb = dout + b * P.dos.b + h * P.dos.h;
  const bf16* kb = k + b * P.ks.b + kvh * P.ks.h;
  const bf16* vb = v + b * P.vs.b + kvh * P.vs.h;

  // key tiles [t_lo, t_hi): none wholly in the future, none wholly before the window
  const int q_last = min(q0 + kRows, P.Sq) - 1;
  int t_lo = 0, t_hi = (P.Sk + kStream - 1) / kStream;
  if (P.causal) t_hi = min(t_hi, q_last / kStream + 1);
  if (P.window > 0) t_lo = max(0, q0 - P.window + 1) / kStream;
  const int n_items = max(0, t_hi - t_lo);

  load_tile<kRows, DP>(sQ, qb, P.qs.s, q0, P.Sq, D, tid);
  load_tile<kRows, DP>(sG, gb, P.dos.s, q0, P.Sq, D, tid);
  if (n_items > 0) {
    load_tile<kStream, DP>(sK, kb, P.ks.s, t_lo * kStream, P.Sk, D, tid);
    load_tile<kStream, DP>(sV, vb, P.vs.s, t_lo * kStream, P.Sk, D, tid);
  }
  cp_async_commit();

  const int r0 = q0 + 64 * wg;                        // the warpgroup's rows
  const int r_last = min(r0 + 63, P.Sq - 1);
  const int row = r0 + 16 * warp + (lane >> 2);       // this thread's rows: row, row + 8
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

  for (int it = 0; it < n_items; ++it) {
    const int k0 = (t_lo + it) * kStream, st = it & 1;
    if (it + 1 < n_items) {   // prefetch the next tile into the other stage
      load_tile<kStream, DP>(sK + (st ^ 1) * kTileBytes, kb, P.ks.s, k0 + kStream, P.Sk, D, tid);
      load_tile<kStream, DP>(sV + (st ^ 1) * kTileBytes, vb, P.vs.s, k0 + kStream, P.Sk, D, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();   // everything but the prefetch has landed
    fence_async_smem();
    __syncthreads();

    const bool skip = r0 >= P.Sq || (P.causal && k0 > r_last) ||
                      (P.window > 0 && k0 + kStream - 1 < r0 - P.window + 1);
    if (!skip) {
      const uint32_t tK = sK + st * kTileBytes, tV = sV + st * kTileBytes;
      float s[32], dp[32];
      issue_scores<DP>(s, sQ, 64 * wg, tK);
      issue_scores<DP>(dp, sG, 64 * wg, tV);
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(dp);
      // a tile that crosses the causal diagonal, the window's edge or a ragged end
      const bool edge = k0 + kStream > P.Sk || r0 + 64 > P.Sq || (P.causal && k0 + kStream - 1 > r0) ||
                        (P.window > 0 && r0 + 63 - k0 >= P.window);
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

// Does the tensor-core design take this problem?  bf16, D % 16 == 0, D <= 128,
// and every row of q, k, v and dO 16-byte aligned (the cp.async unit).
bool wgmma_takes(const void* const* ptrs, int dtype, int D, const long long* strides) {
  if (dtype != 1 || D % 16 != 0 || D > kMaxD) return false;
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

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
    if (!wgmma_takes(ptrs, dtype, D, strides)) return cudaErrorInvalidValue;
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
// only what wgmma_takes accepts, else returns cudaErrorInvalidValue), 0 the
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
