// Building blocks of the tensor-core designs for Hopper (sm_90a): which
// inputs the flash design takes, the cp.async staging of bf16 tiles in
// wgmma's 128-byte swizzle, the shared-memory matrix descriptors (K-major
// and MN-major), the bf16 wgmma products (SS m64n64k16 for scores, RS
// m64n64k16 / m64n128k16 for products whose A operand is a register
// fragment, B read MN-major or K-major), the split of an f32 accumulator
// into bf16 hi + lo A fragments, the split of f32 values into three
// truncated bf16 parts with the six-pass order of their products, the
// no-swizzle descriptor and the narrow RS products (m64n32k16, m64n16k16)
// of the FPCA design, the accumulator's fragment layout, and the
// key walk of a query-stationary block; and what both flash designs share:
// the mask, the -1e30 sentinel, the head-dim limit, the (batch, seq, head)
// strides and the dtype conversions.  Included by flash_attention.cu (the
// forward), flash_attention_bwd.cu (dQ, dK/dV), ssd_intra_chunk.cu and
// fpca_conv.cu; each is its own library, so the helpers live in an unnamed
// namespace.
//
// The flash kernels share a block shape: two warpgroups, each on its own 64
// stationary rows of a 128-row tile, and 64-row streamed tiles through a
// two-stage ring.  The SSD kernel's blocks are one warpgroup each; the
// FPCA kernel's are two, walking 128-row tiles of its patch matrix.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;   // the mask value and the initial running max, never -inf

struct Strides {
  long long b, s, h;   // elements; the head dim is unit-stride
};

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

// Is (query qi, key kj) a pair the mask keeps?  P has Sq, Sk, causal and
// window (<= 0: none).  Both designs of every flash kernel mask with it.
template <class Problem>
__device__ __forceinline__ bool live_pair(const Problem& P, int qi, int kj) {
  bool live = qi < P.Sq && kj < P.Sk;
  if (P.causal) live = live && qi >= kj;
  if (P.window > 0) live = live && qi - kj < P.window;
  return live;
}

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWG = 2;                   // warpgroups per block, each on its own 64 stationary rows
constexpr int kThreads = 128 * kWG;
constexpr int kRows = 64 * kWG;          // stationary rows per block: queries (dq) or keys (dkdv)
constexpr int kStream = 64;              // rows per streamed tile: keys (dq) or queries (dkdv)
constexpr int kStages = 2;

// Does the tensor-core design take these inputs?  bf16 (dtype 1),
// D % 16 == 0, D <= 128, and every row of each of the N inputs 16-byte
// aligned (the cp.async unit): its pointer and its (batch, seq, head)
// strides in elements, 3 per input in the order of ptrs.
template <int N>
bool wgmma_takes(const void* const (&ptrs)[N], int dtype, int D, const long long* strides) {
  if (dtype != 1 || D % 16 != 0 || D > 128) return false;
  for (int i = 0; i < N; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < 3 * N; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; nothing is read and zeros land when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// 16 bytes global -> shared of which the first `bytes` (0, 4, 8, 12 or 16)
// are read and the rest land as zeros
__device__ __forceinline__ void cp_async16_n(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
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
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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
template <int A, int B>
__device__ __forceinline__ void pin(uint32_t (&r)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i) pin(r[i]);
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
// No-swizzle ("interleave") descriptor of a K-major operand stored as 8-row x
// 16-byte core matrices of 128 contiguous bytes: lbo = the byte step between
// core matrices along K, sbo = between 8-row groups.  A k-step of 16 bf16 is
// two core matrices along K, so it starts 2 lbo bytes on.
__device__ __forceinline__ uint64_t desc_interleave(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}
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

// RS wgmma: A from registers (a bf16 fragment), B from shared memory read
// MN-major (kTransB 1, "tb") or K-major (0); N = 16, 32, 64 or 128 output
// columns (8, 16, 32 or 64 accumulator registers)
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTransB));
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

// The six passes of a split product, in order: (A part, B part), parts
// 0 = hi, 1 = mid, 2 = lo
__device__ __forceinline__ constexpr int pass_a(int i) { return i == 2 || i == 5 ? 1 : i == 4 ? 2 : 0; }
__device__ __forceinline__ constexpr int pass_b(int i) { return i == 1 || i == 5 ? 1 : i == 3 ? 2 : 0; }

// two f32 -> their bf16 hi, mid and lo parts, packed in pairs (a low, b
// high).  hi is x's top 16 bits (x truncated to bf16), mid the top 16 bits
// of x - hi, lo = x - hi - mid, which has at most 8 significant bits and so
// is a bf16 exactly: hi + mid + lo = x, |mid| < 2^-7 |x|, |lo| < 2^-15 |x|.
// Masks, subtractions and byte permutes only: no conversion instruction.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  const float ra = a - __uint_as_float(ua & 0xffff0000u), rb = b - __uint_as_float(ub & 0xffff0000u);
  const uint32_t va = __float_as_uint(ra), vb = __float_as_uint(rb);
  const float la = ra - __uint_as_float(va & 0xffff0000u), lb = rb - __uint_as_float(vb & 0xffff0000u);
  hi = __byte_perm(ua, ub, 0x7632);
  mid = __byte_perm(va, vb, 0x7632);
  lo = __byte_perm(__float_as_uint(la), __float_as_uint(lb), 0x7632);
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
    wgmma_rs<1>(acc, h, db + mnmajor_step(kk));
  }
#pragma unroll
  for (int kk = 0; kk < kStream / 16; ++kk) {
    const uint32_t l[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3]};
    wgmma_rs<1>(acc, l, db + mnmajor_step(kk));
  }
}

// The key walk of a query-stationary block, the forward's and dQ's: block
// blockIdx.x owns query rows [q0, q0 + kRows) of query head blockIdx.y in
// batch blockIdx.z, and streams the key tiles [t_lo, t_lo + n_items) of
// that head's kv head, none wholly in the future and none wholly before
// the window.  Tile it's K and V rows sit in ring stage it & 1 at
// k_tile(it) and v_tile(it).  Under a causal mask the last query tile,
// which sees the most keys, goes first.  Warpgroup wg computes rows
// [r0, r0 + 64), this thread rows row and row + 8.  The kernels differ only
// in their stationary tiles and their per-tile body:
//
//   (load the stationary tiles)  walk.start(P, tid);
//   for (int it = 0; it < walk.n_items; ++it) {
//     walk.advance(P, it, tid);
//     const int k0 = walk.key0(it);
//     if (!walk.skip(P, k0)) { ... walk.edge(P, k0) ... }
//     __syncthreads();   // both warpgroups are done with the stage
//   }
//   cp_async_wait<0>();
template <int DP>
struct KeyWalk {
  static constexpr uint32_t kTileBytes = kStream * DP * 2;
  uint32_t sK, sV;   // [kStages] key tiles, then [kStages] value tiles
  const bf16* kb;
  const bf16* vb;
  int q0, t_lo, n_items;
  int r0, r_last, row;

  template <class Problem>
  __device__ __forceinline__ KeyWalk(const Problem& P, const bf16* k, const bf16* v, uint32_t s_kv, int tid) {
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int n_qt = (P.Sq + kRows - 1) / kRows;
    q0 = (P.causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x)) * kRows;
    const int kvh = blockIdx.y / (P.H / P.KV), b = blockIdx.z;
    kb = k + b * P.ks.b + kvh * P.ks.h;
    vb = v + b * P.vs.b + kvh * P.vs.h;
    sK = s_kv;
    sV = s_kv + kStages * kTileBytes;
    const int q_last = min(q0 + kRows, P.Sq) - 1;
    int t_hi = (P.Sk + kStream - 1) / kStream;
    if (P.causal) t_hi = min(t_hi, q_last / kStream + 1);
    t_lo = P.window > 0 ? max(0, q0 - P.window + 1) / kStream : 0;
    n_items = max(0, t_hi - t_lo);
    r0 = q0 + 64 * wg;
    r_last = min(r0 + 63, P.Sq - 1);
    row = r0 + 16 * warp + (lane >> 2);
  }

  __device__ __forceinline__ int key0(int it) const { return (t_lo + it) * kStream; }
  __device__ __forceinline__ uint32_t k_tile(int it) const { return sK + (it & 1) * kTileBytes; }
  __device__ __forceinline__ uint32_t v_tile(int it) const { return sV + (it & 1) * kTileBytes; }

  // tile it's K and V rows into its stage; rows >= Sk land as zeros
  template <class Problem>
  __device__ __forceinline__ void load(const Problem& P, int it, int tid) const {
    load_tile<kStream, DP>(k_tile(it), kb, P.ks.s, key0(it), P.Sk, P.D, tid);
    load_tile<kStream, DP>(v_tile(it), vb, P.vs.s, key0(it), P.Sk, P.D, tid);
  }
  // the first tile, in one cp.async group with the stationary tiles loaded before
  template <class Problem>
  __device__ __forceinline__ void start(const Problem& P, int tid) const {
    if (n_items > 0) load(P, 0, tid);
    cp_async_commit();
  }
  // prefetch tile it + 1 into the other stage, then wait until tile it has
  // landed and is visible to every thread and to wgmma
  template <class Problem>
  __device__ __forceinline__ void advance(const Problem& P, int it, int tid) const {
    if (it + 1 < n_items) load(P, it + 1, tid);
    cp_async_commit();
    cp_async_wait<1>();   // everything but the prefetch has landed
    fence_async_smem();
    __syncthreads();
  }
  // is the tile of keys [k0, k0 + 64) wholly masked for this warpgroup's rows?
  template <class Problem>
  __device__ __forceinline__ bool skip(const Problem& P, int k0) const {
    return r0 >= P.Sq || (P.causal && k0 > r_last) || (P.window > 0 && k0 + kStream - 1 < r0 - P.window + 1);
  }
  // does it cross the causal diagonal, the window's edge or a ragged end, so
  // that the mask is evaluated per element?
  template <class Problem>
  __device__ __forceinline__ bool edge(const Problem& P, int k0) const {
    return k0 + kStream > P.Sk || r0 + 64 > P.Sq || (P.causal && k0 + kStream - 1 > r0) ||
           (P.window > 0 && r0 + 63 - k0 >= P.window);
  }
};

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

}  // namespace tc
}  // namespace
