// Pieces shared by the two paged-attention kernels (ragged_paged_attention.cu
// and paged_decode_fused.cu): the asynchronous page-slice copy into shared
// memory, the widening of staged pool elements to bf16, the mma.sync and
// ldmatrix tiles, the JAX-exact fp8 cast, and the fixed-order merge of
// partial softmax states across key splits.
//
// Pool layout: one layer is [N, Hkv, Bk, D], so the slice of one (page, kv
// head) is Bk contiguous rows of D elements and a key j of a sequence lives
// at page table[j / Bk], slot j % Bk. A row is D * sizeof(T) bytes (32 to 512
// at D 32..256, a multiple of 16), so a chunk of keys is copied as 16-byte
// cp.async vectors, one table lookup per key row; codes of an int8/fp8 pool
// travel as codes (one byte each) and are widened to bf16 only after they
// have arrived. int8 scales ([N, Bk] bf16 per layer) are 2 bytes per key and
// need no alignment: the kernels load them per thread.
//
// Partial softmax states. A block of the fused decode kernel covers one
// split of a row's keys and writes (m, l, acc) in f32: m the running maximum of the scores in the log2
// domain (score * D^-0.5 * log2 e), l the sum of exp2(s - m) and acc the
// unnormalized P.V row. `merge_splits` combines the splits of one (query,
// head) in split order, so two calls on the same inputs give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace paged {

using bf16 = __nv_bfloat16;
using fp8 = __nv_fp8_e4m3;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr bool kIsInt8 = std::is_same<T, int8_t>::value;

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `valid` false fills the 16 bytes with zeros
// and reads nothing (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Issue the copies of the K and V rows of keys [c0, c0 + nk) of one (layer,
// kv head) into shared rows of `stride` elements: key c0 + c goes to
// dk/dv + c * stride. One table lookup serves a thread's K and V vector of
// the same row. Keys outside [klo, khi), and the key `skip`, are
// zero-filled without a read. Every thread of the block takes part
// (THREADS of them).
template <int THREADS, int D, typename T>
__device__ __forceinline__ void issue_kv(T* dk, T* dv, int stride, const T* kl, const T* vl,
                                         int c0, int nk, int klo, int khi, int skip,
                                         const int* __restrict__ table, int M, int Hkv, int g,
                                         int Bk) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int kVpr = D / kVec;         // vectors per key row (a power of two)
  for (int i = threadIdx.x; i < nk * kVpr; i += THREADS) {
    const int c = i / kVpr;
    const int v = i % kVpr;
    const int j = c0 + c;
    const bool ok = j >= klo && j < khi && j != skip;
    size_t off = 0;
    if (ok) {
      const unsigned lp = static_cast<unsigned>(j) / static_cast<unsigned>(Bk);
      const int page = __ldg(table + min(static_cast<int>(lp), M - 1));
      off = (((size_t)page * Hkv + g) * Bk + (j - static_cast<int>(lp) * Bk)) * D + v * kVec;
    }
    cp_async16(dk + (size_t)c * stride + v * kVec, kl + off, ok);
    cp_async16(dv + (size_t)c * stride + v * kVec, vl + off, ok);
  }
}

// The table slot of key j: (page, slot) with one unsigned division
__device__ __forceinline__ size_t page_slot(const int* __restrict__ table, int j, int M, int Bk) {
  const unsigned lp = static_cast<unsigned>(j) / static_cast<unsigned>(Bk);
  return (size_t)__ldg(table + min(static_cast<int>(lp), M - 1)) * Bk +
         (j - static_cast<int>(lp) * Bk);
}

// ------------------------------------------------------ tensor-core tiles

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x8, row) * b (8x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma1688(float* c, uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ------------------------------------------------- widening staged elements

// 8 pool elements at p -> 8 bf16 (one 16-byte vector) for the tensor cores:
// bf16 as is, int8 as bf16(code * scale) rounded to nearest even (the
// Pallas kernel's rounding for the MXU), fp8 by the exact upcast
__device__ __forceinline__ uint4 to_bf16x8(const bf16* p, float) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint4 to_bf16x8(const int8_t* p, float s) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = __floats2bfloat162_rn(static_cast<float>(c[2 * i]) * s,
                                 static_cast<float>(c[2 * i + 1]) * s);
  }
  return out;
}

__device__ __forceinline__ uint4 to_bf16x8(const fp8* p, float) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_fp8x2_storage_t* c = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = __float22bfloat162_rn(__half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(c[i], __NV_E4M3))));
  }
  return out;
}

// float -> e4m3 as JAX's astype: nearest even, NaN of the input's sign
// above 464 (where rounding leaves the format) instead of saturating
__device__ __forceinline__ fp8 to_fp8(float x) {
  __nv_fp8_storage_t code;
  if (isnan(x) || fabsf(x) > 464.f) {
    code = signbit(x) ? 0xFF : 0x7F;
  } else {
    code = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  }
  fp8 out;
  out.__x = code;
  return out;
}

// ------------------------------------------------------------ visibility

// the keys [lo, hi) a query at position p sees (hi <= lo: none)
__device__ __forceinline__ void visible_range(int p, int kv_len, int window, int* lo, int* hi) {
  *lo = (window > 0) ? max(0, p - window + 1) : 0;
  *hi = min(kv_len, p + 1);
}

// ------------------------------------------------- merge of partial states

// One block per (row b, query head h). ws_o is [B, Nh, S, D] and
// ws_ml [B, Nh, S, 2] (m in the log2 domain, l); split s covers keys
// [s * split_keys, (s + 1) * split_keys). Only the splits that hold some of
// the query's visible keys are read — exactly the ones a kernel block wrote
// for this row — and they are combined in split order. A query with no
// visible key (pad, inactive row, empty window) gets exact zeros.
template <int D>
__global__ void __launch_bounds__(128)
merge_splits(const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
             const int* __restrict__ positions,   // [B]
             const int* __restrict__ kv_lens,     // [B]
             bf16* __restrict__ out,              // [B, Nh, D]
             int Nh, int n_splits, int split_keys, int window) {
  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int p = positions[r];
  int lo = 0, hi = 0;
  if (p >= 0) visible_range(p, kv_lens[r], window, &lo, &hi);
  bf16* o = out + ((size_t)r * Nh + h) * D;
  if (p < 0 || hi <= lo) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) o[d] = __float2bfloat16(0.f);
    return;
  }
  const int s0 = lo / split_keys;
  const int s1 = min((hi - 1) / split_keys, n_splits - 1);
  const size_t base = ((size_t)r * Nh + h) * n_splits;
  float m = kNegInf;
  for (int s = s0; s <= s1; ++s) m = fmaxf(m, ws_ml[(base + s) * 2]);
  float l = 0.f;
  for (int s = s0; s <= s1; ++s) l += ws_ml[(base + s) * 2 + 1] * exp2f(ws_ml[(base + s) * 2] - m);
  const float inv = l > 0.f ? 1.f / l : 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int s = s0; s <= s1; ++s) {
      acc += ws_o[(base + s) * D + d] * exp2f(ws_ml[(base + s) * 2] - m);
    }
    o[d] = __float2bfloat16(acc * inv);
  }
}

template <int D>
int launch_merge(const float* ws_o, const float* ws_ml, const int* positions, const int* kv_lens,
                 bf16* out, int B, int Nh, int n_splits, int split_keys, int window,
                 cudaStream_t stream) {
  merge_splits<D><<<dim3(B, Nh), 128, 0, stream>>>(ws_o, ws_ml, positions, kv_lens, out, Nh,
                                                    n_splits, split_keys, window);
  return (int)cudaGetLastError();
}

}  // namespace paged
