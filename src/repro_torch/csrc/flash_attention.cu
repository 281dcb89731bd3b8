// Flash-attention forward for Hopper (sm_90a): online softmax over key
// tiles, GQA, causal and sliding-window masks, whole-tile skipping, in two
// designs: a tensor-core design for bf16 (D % 16 == 0, D <= 128, rows 16-byte
// aligned) and a SIMT design for everything else (f32, fp16, other D).  The
// wrapper (kernels/flash_attention/kernel.py) picks the design by those rules
// (kernel.py::design) and passes the choice in.
//
// Both designs replace the TPU kernel
// repro/kernels/flash_attention/kernel.py::_flash_kernel (launched by
// flash_attention_pallas).  The plain PyTorch version of the same function is
// repro_torch/kernels/flash_attention/ref.py::flash_attention_ref
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
// Neither design uses atomics: the same inputs give bit-identical outputs.
//
// What bounds it on this card: at the served zamba2-7b shape (B=4, S=4096,
// H=KV=32, D=112, bf16, causal) the two products are 4.8e11 FLOP against
// 0.47 GB of q/k/v/out, about 1,000 FLOP per byte, so it is bound by
// arithmetic, and the 989 TFLOP/s bf16 tensor-core rate is the card's bound
// (the trained qwen3-1.7b shape, D = 128 and GQA 16/8, likewise).
//
// The tensor-core design (namespace tc; the staging, descriptor, wgmma and
// fragment helpers and the query block's key walk, tc::KeyWalk, are shared
// with the backward's dQ kernel in hopper_tc.cuh).  The TPU
// kernel upcasts q, k, v and keeps p in f32 (kernel.py:67-69).  q and k
// arrive in bf16 and a bf16 x bf16 product is exact in f32, so s = q k^T
// runs as bf16 wgmma with an f32 accumulator and differs from f32 FMAs only
// in summation order.  p is f32 and a bf16 p would round it to 2^-9, so
// p . v splits p into p_hi = bf16(p) and p_lo = bf16(p - p_hi) and runs both
// halves as wgmma into one f32 accumulator: p_hi + p_lo holds p to about
// 2^-17, far below the bf16 rounding of the output.  So the kernel executes
// 3 passes of 2 D FLOP a live pair for the algorithm's 2.  A block of two
// warpgroups owns 128 query rows of one head; Q stays in shared memory.  It
// walks 64-key tiles of K and V through a two-stage ring filled by cp.async
// (issued one tile ahead).  Per tile and warpgroup (64 rows): s as SS wgmma
// m64n64k16 (both K-major); scale, mask (per element only on tiles that
// cross the causal diagonal, the window's edge or a ragged end: the tile
// body, tc::fwd_tile, is instantiated with and without the mask), the
// running max and sum on the accumulator fragments (a row's 64 scores lie
// in the 4 lanes of a quad: two shuffles), corr rescales the output
// accumulator, then acc += p_hi V + p_lo V as RS wgmma m64n(DP)k16: A is the
// score accumulator re-packed as bf16 (its fragment layout is the A
// layout), B the staged V tile read MN-major.  A warpgroup skips tiles wholly
// in the future or before the window; the last query tile, which sees the
// most keys under a causal mask, is launched first.  Shared memory pads the
// head dim with zeros to DP = 64 (D <= 64) or 128: zero columns add exact
// zeros to s and the padded output columns are never stored.  At the served
// D = 112 that is 12.5% of the products spent on padding (an m64n112
// accumulation would save the p . v part of it).  About 97 KB of shared
// memory and 256 threads a block: one block an SM.
//
// The SIMT design (f32, fp16, a D that is not a multiple of 16, unaligned
// rows, and the smoke configs' f32 paths) does both products as IEEE f32 FMAs
// on CUDA cores (67 TFLOP/s peak) and keeps every operand on chip, reading
// q/k/v once per (query tile, key tile): a block of 256 threads owns 64
// query rows of one head, stages them in shared memory once, then walks
// 64-key tiles of K (transposed) and V through shared memory.  Each thread
// owns a 4 x 4 patch of the 64 x 64 score tile and a 4-row x DPT-column
// patch of the output accumulator (both in registers); the row max and row
// sum are reduced across the 16 lanes that share a row with warp shuffles.
// Tiles wholly in the future (causal) or wholly before the window are
// skipped, as kernel.py:57-63 does.
//
// Numerics, both designs: f32 softmax, expf (no --use_fast_math), final
// acc / l with l clamped at 1e-30 as the TPU kernel does.  The mask value
// and the initial running max are -1e30, not -inf: a row whose keys in a
// tile are all masked gets exp(0) = 1 junk that the next live tile's
// correction factor exp(-1e30 - m) = 0 wipes; with -inf it would be NaN.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // a 16 x 16 thread grid
constexpr int kRows = kBQ / 16;    // query rows per thread: ty + 16 * i
constexpr int kCols = kBK / 16;    // keys per thread: tx + 16 * j
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

// ===========================================================================
// The tensor-core design: bf16 inputs, D % 16 == 0, D <= 128
// ===========================================================================
struct Problem {
  int Sq, Sk, H, KV, D;
  Strides qs, ks, vs;
  int causal, window;  // window <= 0: none
  float scale;
};

namespace tc {

// the max (kMax) or sum of x over the 4 lanes of a quad, which hold one
// accumulator row between them
template <bool kMax>
__device__ __forceinline__ float quad_reduce(float x) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
}

// One key tile [k0, k0 + 64) of one warpgroup: s = Q K^T as SS wgmma, scale,
// mask, the online softmax on the accumulator fragments, then
// acc += p_hi V + p_lo V as RS wgmma.  kEdge: the tile crosses the causal
// diagonal, the window's edge or a ragged end, so the mask is evaluated per
// element; the kernel instantiates both, so a tile with no edge carries none
// of those tests (as one body with a runtime test, nvcc predicated the 32
// tests into every tile).
template <int DP, bool kEdge>
__device__ __forceinline__ void fwd_tile(const Problem& P, uint32_t sQ, uint32_t tK, uint32_t tV, int wg,
                                         int row, int k0, int lane, float (&m)[2], float (&l)[2],
                                         float (&acc)[DP / 2]) {
  float s[32];
  issue_scores<DP>(s, sQ, 64 * wg, tK);
  wgmma_commit();
  wgmma_wait_all();
  pin(s);
  float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float sv = s[j] * P.scale;
    if (kEdge && !live_pair(P, row + frag_row(j), k0 + frag_col(j, lane))) sv = kNegInf;
    s[j] = sv;
    row_max[(j >> 1) & 1] = fmaxf(row_max[(j >> 1) & 1], sv);
  }
  float corr[2], row_sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_reduce<true>(row_max[i]));
    corr[i] = expf(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    s[j] = expf(s[j] - m[(j >> 1) & 1]);   // p
    row_sum[(j >> 1) & 1] += s[j];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_reduce<false>(row_sum[i]);
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
  uint32_t hi[16], lo[16];
  split(s, hi, lo);
  wgmma_fence();
  issue_accumulate(acc, hi, lo, tV);   // acc += p_hi . V + p_lo . V
  wgmma_commit();
  wgmma_wait_all();
  pin(acc);
  pin(hi);
  pin(lo);
}

// ---------------------------------------------------------------------------
// grid (ceil(Sq / 128), H, B); a block owns 128 query rows of one head
// ---------------------------------------------------------------------------
template <int DP, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                bf16* __restrict__ out, float* __restrict__ lse, Problem P) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t kStatBytes = kRows * DP * 2;
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;   // then the walk's K and V ring

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int D = P.D, h = blockIdx.y, b = blockIdx.z;
  const KeyWalk<DP> walk(P, k, v, sQ + kStatBytes, tid);
  const int row = walk.row;   // this thread's rows: row, row + 8

  load_tile<kRows, DP>(sQ, q + b * P.qs.b + h * P.qs.h, P.qs.s, walk.q0, P.Sq, D, tid);
  walk.start(P, tid);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;

  for (int it = 0; it < walk.n_items; ++it) {
    walk.advance(P, it, tid);
    const int k0 = walk.key0(it);
    if (!walk.skip(P, k0)) {
      const uint32_t tK = walk.k_tile(it), tV = walk.v_tile(it);
      if (walk.edge(P, k0))
        fwd_tile<DP, true>(P, sQ, tK, tV, wg, row, k0, lane, m, l, acc);
      else
        fwd_tile<DP, false>(P, sQ, tK, tV, wg, row, k0, lane, m, l, acc);
    }
    __syncthreads();   // both warpgroups are done with this stage before it is refilled
  }
  cp_async_wait<0>();

  float denom[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) denom[i] = fmaxf(l[i], 1e-30f);
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = acc[j] / denom[(j >> 1) & 1];
  if constexpr (kLse) {
    // m and l are the same in the 4 lanes of a quad (butterfly reductions)
    const long long row_base = (static_cast<long long>(b) * P.H + h) * P.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if ((lane & 3) == 0 && row + 8 * i < P.Sq) lse[row_base + row + 8 * i] = m[i] + logf(denom[i]);
  }
  store_rows<DP>(acc, out + ((static_cast<long long>(b) * P.Sq) * P.H + h) * D, static_cast<long long>(P.H) * D,
                 row, P.Sq, D, lane);
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   const Problem& P, cudaStream_t st) {
  const size_t smem = 1024 + static_cast<size_t>(kRows) * DP * 2 + 2 * kStages * kStream * DP * 2;
  auto kernel = lse != nullptr ? flash_fwd_wgmma<DP, true> : flash_fwd_wgmma<DP, false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((P.Sq + kRows - 1) / kRows, P.H, B);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                       static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, P);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and out share it).
// lse: null, or (B, H, Sq) contiguous f32.  window <= 0 means no window.
// Strides are in elements.  tensor_cores: 1 launches the wgmma design (which
// takes only what tc::wgmma_takes accepts, else returns cudaErrorInvalidValue),
// 0 the SIMT design.  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                          float* lse, int dtype, int B, int Sq, int Sk, int H, int KV, int D,
                                          long long q_sb, long long q_ss, long long q_sh,
                                          long long k_sb, long long k_ss, long long k_sh,
                                          long long v_sb, long long v_ss, long long v_sh,
                                          int causal, int window, float scale, int tensor_cores,
                                          void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H < KV || H % KV != 0 || D < 1 || D > kMaxD ||
      H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    const void* ptrs[3] = {q, k, v};
    const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    if (!tc::wgmma_takes(ptrs, dtype, D, strides)) return cudaErrorInvalidValue;
    const Problem P{Sq, Sk, H, KV, D, qs, ks, vs, causal, window, scale};
    return D <= 64 ? tc::launch<64>(q, k, v, out, lse, B, P, st) : tc::launch<128>(q, k, v, out, lse, B, P, st);
  }
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
