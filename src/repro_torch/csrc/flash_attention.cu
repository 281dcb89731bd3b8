// Flash-attention forward for Hopper (sm_90a): online softmax over key
// tiles, GQA, causal and sliding-window masks, whole-tile skipping.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::_flash_kernel
// (launched by flash_attention_pallas).  The plain PyTorch version of the
// same function is repro_torch/kernels/flash_attention/ref.py::flash_attention_ref
// (repro_torch/models/attention.py::attend_blockwise above 2048 tokens).
//
// What it computes, per (batch b, query head h, query row i):
//   s_j = (q_i . k_j) * D^-1/2 over the live keys j of kv head h / (H/KV)
//         (live: j < Sk, and j <= i if causal, and i - j < window if windowed)
//   out_i = sum_j softmax(s)_j v_j, in q's dtype;
//   and, when the lse pointer is not null (training), the row log-sum-exp
//   lse[b, h, i] = m_i + log(max(l_i, 1e-30)) in f32, which the backward
//   kernels (flash_attention_bwd.cu) recompute the probabilities from.
//   The LSE store is a template switch, not a runtime branch: serving
//   passes null and runs an instantiation without it (a runtime test cost
//   5 registers and 8% at the served zamba2 shape on the H100).
// Inputs are read through their (batch, seq, head) strides, so the model's
// (B, S, H, D) layout is used as it is; only the head dim must be unit-stride.
//
// What bounds it on this card: at the served zamba2-7b shape (B=4, S=4096,
// H=KV=32, D=112, bf16, causal) the two products are 4.8e11 FLOP against
// 0.47 GB of q/k/v/out, about 1,000 FLOP per byte, so it is bound by
// arithmetic.  The 989 TFLOP/s bf16 tensor-core rate is the card's bound,
// but this first design does not use tensor cores: the TPU kernel upcasts
// q, k, v and keeps P in f32 (kernel.py:67-69), and a bf16 tensor-core PV
// product would round P to bf16.  So both products are IEEE f32 FMAs on
// CUDA cores (67 TFLOP/s peak), and the design keeps every operand on chip
// and reads q/k/v once per (query tile, key tile): a block of 256 threads
// owns 64 query rows of one head, stages them in shared memory once, then
// walks 64-key tiles of K (transposed) and V through shared memory.  Each
// thread owns a 4 x 4 patch of the 64 x 64 score tile and a 4-row x
// DPT-column patch of the output accumulator (both in registers); the
// row max and row sum are reduced across the 16 lanes that share a row
// with warp shuffles.  Tiles wholly in the future (causal) or wholly before
// the window are skipped, as kernel.py:57-63 does.  Tensor cores (wgmma
// with P kept in f32 via split products) and TMA staging are later work.
//
// Numerics: f32 throughout, expf (no --use_fast_math), final acc / l with
// l clamped at 1e-30 as the TPU kernel does.  The mask value and the
// initial running max are -1e30, not -inf: a row whose keys in a tile are
// all masked gets exp(0) = 1 junk that the next live tile's correction
// factor exp(-1e30 - m) = 0 wipes; with -inf it would be NaN.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // a 16 x 16 thread grid
constexpr int kRows = kBQ / 16;    // query rows per thread: ty + 16 * i
constexpr int kCols = kBK / 16;    // keys per thread: tx + 16 * j
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

// DPT output dims per thread (tx + 16 * dd), so D <= 16 * DPT; kLse: write lse.
template <typename T, int DPT, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int KV, int D, Strides qs,
                 Strides ks, Strides vs, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int dq = D + 1;                 // Q row stride: two rows a warp reads sit in two banks
  const int kt_stride = kBK + 1;        // K^T row stride: conflict-free transposed stores
  const int ps_stride = kBK + 1;
  float* Qs = smem;                     // [kBQ][D+1]
  float* Kt = Qs + kBQ * dq;            // [D][kBK+1]
  float* Vs = Kt + D * kt_stride;       // [kBK][D]
  float* Ps = Vs + kBK * D;             // [kBQ][kBK+1]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int row = q0 + r;
    Qs[r * dq + d] = row < Sq ? to_f(qb[row * qs.s + d]) : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int n_tiles = (Sk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    if (causal && k0 > q_last) break;                              // this and later tiles: future
    if (window > 0 && k0 + kBK - 1 < q0 - window + 1) continue;    // wholly before the window
    __syncthreads();   // the previous tile's readers are done with Kt, Vs, Ps
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      const int key = k0 + c;
      float kv = 0.0f, vv = 0.0f;
      if (key < Sk) {
        kv = to_f(kb[key * ks.s + d]);
        vv = to_f(vb[key * vs.s + d]);
      }
      Kt[d * kt_stride + c] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[kRows], kc[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qr[i] = Qs[(ty + 16 * i) * dq + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kc[j] = Kt[d * kt_stride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int pq = q0 + ty + 16 * i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int pk = k0 + tx + 16 * j;
        bool live = pq < Sq && pk < Sk;
        if (causal) live = live && pq >= pk;
        if (window > 0) live = live && pq - pk < window;
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * ps_stride + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[i][dd] *= corr;
    }
    __syncthreads();   // Ps complete

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pr[kRows], vr[DPT];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = Ps[(ty + 16 * i) * ps_stride + c];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const int d = tx + 16 * dd;
        vr[dd] = d < D ? Vs[c * D + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = fmaf(pr[i], vr[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // m and l are the same in the 16 lanes of a row (butterfly reductions)
    if constexpr (kLse) {
      if (tx == 0) lse[(static_cast<long long>(b) * H + h) * Sq + row] = m[i] + logf(denom);
    }
    T* o = out + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      const int d = tx + 16 * dd;
      if (d < D) o[d] = from_f<T>(acc[i][dd] / denom);
    }
  }
}

template <typename T, int DPT>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
                         int Sk, int H, int KV, int D, Strides qs, Strides ks, Strides vs,
                         int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) +
                                       static_cast<size_t>(D) * (kBK + 1) +
                                       static_cast<size_t>(kBK) * D + kBQ * (kBK + 1));
  auto kernel = lse != nullptr ? flash_fwd_kernel<T, DPT, true> : flash_fwd_kernel<T, DPT, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), lse, Sq,
                                           Sk, H, KV, D, qs, ks, vs, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dpt(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
                       int Sk, int H, int KV, int D, Strides qs, Strides ks, Strides vs,
                       int causal, int window, float scale, cudaStream_t stream) {
  if (D <= 16)
    return launch_typed<T, 1>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, qs, ks, vs, causal, window, scale, stream);
  if (D <= 32)
    return launch_typed<T, 2>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, qs, ks, vs, causal, window, scale, stream);
  if (D <= 64)
    return launch_typed<T, 4>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, qs, ks, vs, causal, window, scale, stream);
  return launch_typed<T, 8>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, qs, ks, vs, causal, window, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and out share it).
// lse: null, or (B, H, Sq) contiguous f32.  window <= 0 means no window.
// Strides are in elements.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                          float* lse, int dtype, int B, int Sq, int Sk, int H, int KV, int D,
                                          long long q_sb, long long q_ss, long long q_sh,
                                          long long k_sb, long long k_ss, long long k_sh,
                                          long long v_sb, long long v_ss, long long v_sh,
                                          int causal, int window, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H < KV || H % KV != 0 || D < 1 || D > kMaxD ||
      H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dpt<float>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, qs, ks, vs, causal, window, scale, st);
    case 1:
      return launch_dpt<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, qs, ks, vs, causal, window, scale, st);
    case 2:
      return launch_dpt<__half>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, qs, ks, vs, causal, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
