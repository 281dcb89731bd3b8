// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, GQA, causal and sliding-window masks, whole-tile skipping.
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
//
// What bounds them on this card: at the trained qwen3-1.7b shape (B=4, S=4096,
// H=16, KV=8, D=128, bf16, causal) dQ does three products over the live
// pairs (s, dp, ds k: 6 D FLOP a pair, 4.1e11 FLOP) and dK/dV four (s, dp,
// p^T dO, ds^T q: 8 D, 5.5e11 FLOP) against about 0.27 GB of inputs and
// outputs each, some 1,500-2,000 FLOP per byte: both are bound by
// arithmetic, and the 989 TFLOP/s bf16 tensor-core rate is the card's bound.
// This first design, like the forward's, does not use tensor cores: the TPU
// kernels upcast every operand and keep p and ds in f32, and bf16 tensor-core
// products would round them.  So every product is an IEEE f32 FMA on CUDA
// cores (67 TFLOP/s peak), with every operand staged once per tile in shared
// memory as f32:
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
// (dkdv) at D = 128, so one block of 8 warps runs on each SM.  Tensor cores
// (wgmma with split products that keep p and ds in f32) and TMA staging are
// later work.
//
// Numerics: f32 throughout, expf (no --use_fast_math); ds is formed as
// (p * (dp - delta)) * scale, the reference's order.  Rows beyond Sq load lse
// and delta as 0 and q, dO as 0 (the Pallas wrapper pads lse with 0), keys
// beyond Sk load as 0; both are masked, so they add exact zeros.

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

int launch(bool want_dq, const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* out0, void* out1, int dtype, int B, int Sq,
           int Sk, int H, int KV, int D, const long long* strides, int causal, int window,
           float scale, void* stream) {
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
// means no window.  Launch on `stream`; return cudaGetLastError() (0 on
// success).
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* delta, void* dq, int dtype, int B,
                                             int Sq, int Sk, int H, int KV, int D,
                                             const long long* strides, int causal, int window,
                                             float scale, void* stream) {
  return launch(true, q, k, v, dout, lse, delta, dq, nullptr, dtype, B, Sq, Sk, H, KV, D, strides,
                causal, window, scale, stream);
}

extern "C" int flash_attention_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                                               const void* dout, const float* lse,
                                               const float* delta, void* dk, void* dv, int dtype,
                                               int B, int Sq, int Sk, int H, int KV, int D,
                                               const long long* strides, int causal, int window,
                                               float scale, void* stream) {
  return launch(false, q, k, v, dout, lse, delta, dk, dv, dtype, B, Sq, Sk, H, KV, D, strides,
                causal, window, scale, stream);
}
