// Fused decode step for Hopper (sm_90a): write this step's K/V row into its
// page slot, then attend the row's single query over the updated paged
// context — one layer of the stacked pools per launch. Queries, new rows
// and output are bf16; the pools are bf16, int8 (with scale pools) or fp8.
//
// Replaces the Pallas TPU kernel `_decode_kernel`, reached through
// `_call_decode_kernel` (entry `paged_decode_attention_fused`) in
// distributed_gpu_inference_tpu/ops/paged_attention_pallas.py.
//
// Semantics: for each row b with position p >= 0, the new K and V rows go
// to pool[layer, table[b, p / Bk], :, p % Bk, :] in place; then the row's
// query heads attend keys j with j < kv_len, j <= p and, with a window,
// j > p - window (kv_len counts the token just written, so the write is
// visible to its own query). Rows with p < 0 write nothing and output
// exact zeros. Scores, softmax and the P V sum are f32; the output is bf16.
//
// Design. Grid = (row, kv head), 128 threads. The block first writes its
// head's slice of the new row, then __syncthreads(), then reads. No
// grid-wide barrier is needed: a row writes only into its own last page,
// and a page shared between sequences through the prefix cache is never a
// write target — the block manager copies a shared tail page before a
// sequence writes into it (copy-on-write) — so no other block reads what
// this block writes. Pool pointers are deliberately neither const nor
// __restrict__: the reads after the barrier must not go through the
// read-only (non-coherent) cache path.
//
// The read splits the keys over the 4 warps (key j to warp j % 4); inside a
// warp the lanes split head_dim, each lane holding D/32 elements of every
// query head of the group, so one coalesced load brings a key row. Each warp
// keeps its own online softmax; the warps' partial states merge through
// shared memory at the end.
//
// Quantized pools (the pool element type is a template parameter):
// - fp8: the new row is written with a round-to-nearest-even cast that, like
//   JAX's astype(float8_e4m3fn), turns magnitudes above 464 into NaN
//   instead of saturating; reads upcast exactly.
// - int8: the kernel quantizes the new row itself, with the contract of
//   ops/attention.py quantize_token_rows: ONE scale per token over the whole
//   (Hkv, D) row, bf16(max(amax, 1e-6) / 127), codes round-half-even of
//   x / scale clipped to +-127. The grid is (row, kv head) but the scale
//   spans every head, so every block reads the full new row (Hkv * D bf16,
//   2 KB at llama3-8b) and computes the same scale itself; a block writes
//   only its own head's codes and exactly one block (head 0) writes the
//   scale. Each block attends to the new token with its own register copy
//   of the scale, never by reading back the one head 0 wrote (no ordering
//   between blocks is needed). amax is scaled by the f32 constant 1/127
//   (as the plain version and the JAX package's compiled graphs do), the
//   division x / scale is IEEE and the conversions round to nearest even
//   (no fast math), so codes and scales are bit-identical to the plain
//   version. Reads dequantize each code to code * scale in f32, exact, as
//   dequantize_kv does.
//
// What bounds it on the card: decode reads every live context key once per
// layer and does 4 * D flops per (query head, key), far below the H100's
// ratio of flops to bytes — it is bound by the bytes of the K/V pages.
// At serving batch 8 with 8 kv heads this grid is 64 blocks on 132 SMs;
// splitting the keys of one row across SMs (split-KV) is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 8;               // query heads per pass over the keys
constexpr float kNegInf = -1e30f;

using fp8 = __nv_fp8_e4m3;

template <int BYTES> struct Raw;
template <> struct Raw<2> { using T = uint16_t; };
template <> struct Raw<4> { using T = uint32_t; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<16> { using T = uint4; };

// E consecutive pool elements at p -> E floats; `s` is the token's int8
// scale (unused for bf16 and fp8)
template <int E>
__device__ __forceinline__ void load_kv(const bf16* p, float* f, float) {
  const typename Raw<2 * E>::T raw = *reinterpret_cast<const typename Raw<2 * E>::T*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int E>
__device__ __forceinline__ void load_kv(const int8_t* p, float* f, float s) {
  const typename Raw<E>::T raw = *reinterpret_cast<const typename Raw<E>::T*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    f[i] = static_cast<float>(c[i]) * s;   // exact: 8-bit by 8-bit significands
  }
}

template <int E>
__device__ __forceinline__ void load_kv(const fp8* p, float* f, float) {
  const typename Raw<E>::T raw = *reinterpret_cast<const typename Raw<E>::T*>(p);
  const __nv_fp8x2_storage_t* c = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 x = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(c[i], __NV_E4M3)));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
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

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();   // red may still be read from a previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
decode_fused_kernel(const bf16* __restrict__ q,        // [B, Nh, D]
                    const bf16* __restrict__ new_k,    // [B, Hkv, D]
                    const bf16* __restrict__ new_v,
                    T* kpool,                          // [L, N, Hkv, Bk, D]
                    T* vpool,
                    bf16* kscale,                      // [L, N, Bk] (int8 pools)
                    bf16* vscale,
                    const int* __restrict__ tables,    // [B, M]
                    const int* __restrict__ positions, // [B]
                    const int* __restrict__ kv_lens,   // [B]
                    bf16* __restrict__ out,            // [B, Nh, D]
                    int layer, int N, int Nh, int Hkv, int Bk, int M, int window,
                    float scale) {
  constexpr int E = D / 32;   // head_dim elements per lane
  __shared__ float sM[kWarps][kMaxQ];
  __shared__ float sL[kWarps][kMaxQ];
  __shared__ float sAcc[kWarps][kMaxQ][D];
  __shared__ float sRed[kWarps];

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qpk = Nh / Hkv;
  const int pos = positions[b];
  const int kv_len = kv_lens[b];
  const size_t layer_off = (size_t)layer * N * Hkv * Bk * D;
  T* kl = kpool + layer_off;
  T* vl = vpool + layer_off;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  bf16* ksl = kInt8 ? kscale + (size_t)layer * N * Bk : nullptr;
  bf16* vsl = kInt8 ? vscale + (size_t)layer * N * Bk : nullptr;
  float new_ks = 1.f, new_vs = 1.f;   // int8: this block's copy of the new token's scales

  // ---- 1. write the new row's K/V for this kv head into its page slot
  if (pos >= 0) {
    const int page = tables[b * M + min(pos / Bk, M - 1)];
    const size_t dst = (((size_t)page * Hkv + g) * Bk + pos % Bk) * D;
    const size_t src = ((size_t)b * Hkv + g) * D;
    if constexpr (kInt8) {
      // one scale over the token's whole (Hkv, D) row, computed by every block
      const bf16* rk = new_k + (size_t)b * Hkv * D;
      const bf16* rv = new_v + (size_t)b * Hkv * D;
      float ak = 0.f, av = 0.f;
      for (int i = tid; i < Hkv * D; i += kThreads) {
        ak = fmaxf(ak, fabsf(__bfloat162float(rk[i])));
        av = fmaxf(av, fabsf(__bfloat162float(rv[i])));
      }
      ak = block_max(ak, sRed);
      av = block_max(av, sRed);
      new_ks = __bfloat162float(__float2bfloat16_rn(fmaxf(ak, 1e-6f) * (1.0f / 127.0f)));
      new_vs = __bfloat162float(__float2bfloat16_rn(fmaxf(av, 1e-6f) * (1.0f / 127.0f)));
      for (int d = tid; d < D; d += kThreads) {
        const int ck = __float2int_rn(__bfloat162float(new_k[src + d]) / new_ks);
        const int cv = __float2int_rn(__bfloat162float(new_v[src + d]) / new_vs);
        kl[dst + d] = static_cast<int8_t>(max(-127, min(127, ck)));
        vl[dst + d] = static_cast<int8_t>(max(-127, min(127, cv)));
      }
      if (g == 0 && tid == 0) {
        ksl[(size_t)page * Bk + pos % Bk] = __float2bfloat16_rn(new_ks);
        vsl[(size_t)page * Bk + pos % Bk] = __float2bfloat16_rn(new_vs);
      }
    } else if constexpr (std::is_same<T, fp8>::value) {
      for (int d = tid; d < D; d += kThreads) {
        kl[dst + d] = to_fp8(__bfloat162float(new_k[src + d]));
        vl[dst + d] = to_fp8(__bfloat162float(new_v[src + d]));
      }
    } else {
      for (int d = tid; d < D; d += kThreads) {
        kl[dst + d] = new_k[src + d];
        vl[dst + d] = new_v[src + d];
      }
    }
  }
  __syncthreads();   // the write is visible to this block's reads below

  const int lo = (window > 0) ? max(0, pos - window + 1) : 0;
  const int hi = min(kv_len, pos + 1);
  bf16* out_row = out + ((size_t)b * Nh + g * qpk) * D;
  if (pos < 0 || hi <= lo) {
    for (int i = tid; i < qpk * D; i += kThreads) out_row[i] = __float2bfloat16(0.f);
    return;
  }

  // ---- 2. attend this head group's queries over [lo, hi)
  for (int h0 = 0; h0 < qpk; h0 += kMaxQ) {
    const int nq = min(kMaxQ, qpk - h0);
    float qr[kMaxQ][E];
    float m[kMaxQ], l[kMaxQ], acc[kMaxQ][E];
#pragma unroll
    for (int h = 0; h < kMaxQ; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[h][e] = 0.f;
        qr[h][e] = 0.f;
      }
      if (h < nq) load_kv<E>(q + ((size_t)b * Nh + g * qpk + h0 + h) * D + lane * E, qr[h], 1.f);
    }

    for (int j = lo + warp; j < hi; j += kWarps) {
      const int page = tables[b * M + min(j / Bk, M - 1)];
      const size_t off = (((size_t)page * Hkv + g) * Bk + j % Bk) * D + lane * E;
      float ks = 1.f, vs = 1.f;
      if constexpr (kInt8) {
        // the new token's scale from this block's registers; older tokens'
        // scales from the pool
        ks = (j == pos) ? new_ks : __bfloat162float(ksl[(size_t)page * Bk + j % Bk]);
        vs = (j == pos) ? new_vs : __bfloat162float(vsl[(size_t)page * Bk + j % Bk]);
      }
      float kf[E], vf[E];
      load_kv<E>(kl + off, kf, ks);
      load_kv<E>(vl + off, vf, vs);
#pragma unroll
      for (int h = 0; h < kMaxQ; ++h) {
        if (h >= nq) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qr[h][e], kf[e], s);
        s = warp_sum(s) * scale;
        const float m_new = fmaxf(m[h], s);
        const float alpha = expf(m[h] - m_new);
        const float p = expf(s - m_new);
        l[h] = l[h] * alpha + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] = fmaf(acc[h][e], alpha, p * vf[e]);
        m[h] = m_new;
      }
    }

    // ---- merge the warps' partial softmax states
#pragma unroll
    for (int h = 0; h < kMaxQ; ++h) {
      if (h >= nq) break;
#pragma unroll
      for (int e = 0; e < E; ++e) sAcc[warp][h][lane * E + e] = acc[h][e];
      if (lane == 0) {
        sM[warp][h] = m[h];
        sL[warp][h] = l[h];
      }
    }
    __syncthreads();
    for (int i = tid; i < nq * D; i += kThreads) {
      const int h = i / D;
      const int d = i % D;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sM[w][h]);
      float lsum = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(sM[w][h] - mx);
        lsum += sL[w][h] * c;
        o += sAcc[w][h][d] * c;
      }
      out_row[(size_t)(h0 + h) * D + d] = __float2bfloat16(lsum > 0.f ? o / lsum : 0.f);
    }
    __syncthreads();   // sAcc is reused by the next head group
  }
}

template <int D, typename T>
int launch(const bf16* q, const bf16* new_k, const bf16* new_v, T* kpool, T* vpool,
           bf16* kscale, bf16* vscale, const int* tables, const int* positions,
           const int* kv_lens, bf16* out, int B, int Nh, int Hkv, int N, int Bk, int M,
           int layer, int window, float scale, cudaStream_t stream) {
  dim3 grid(B, Hkv);
  decode_fused_kernel<D, T><<<grid, kThreads, 0, stream>>>(
      q, new_k, new_v, kpool, vpool, kscale, vscale, tables, positions, kv_lens, out, layer,
      N, Nh, Hkv, Bk, M, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
             void* k_scale, void* v_scale, const int32_t* tables, const int32_t* positions,
             const int32_t* kv_lens, void* out, int B, int Nh, int Hkv, int D, int L, int N,
             int Bk, int M, int layer, int window, float scale, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Nh % Hkv != 0 || layer < 0 || layer >= L) {
    return (int)cudaErrorInvalidValue;
  }
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* nk = static_cast<const bf16*>(new_k);
  const bf16* nv = static_cast<const bf16*>(new_v);
  T* kp = static_cast<T*>(k_pool);
  T* vp = static_cast<T*>(v_pool);
  bf16* ks = static_cast<bf16*>(k_scale);
  bf16* vs = static_cast<bf16*>(v_scale);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, T>(qq, nk, nv, kp, vp, ks, vs, tables, positions, kv_lens, o, B, Nh,
                           Hkv, N, Bk, M, layer, window, scale, st);
    case 128:
      return launch<128, T>(qq, nk, nv, kp, vp, ks, vs, tables, positions, kv_lens, o, B, Nh,
                            Hkv, N, Bk, M, layer, window, scale, st);
    case 256:
      return launch<256, T>(qq, nk, nv, kp, vp, ks, vs, tables, positions, kv_lens, o, B, Nh,
                            Hkv, N, Bk, M, layer, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points (loaded with ctypes), one per pool element type. All
// tensors contiguous on the current device; the stacked pools (and, for an
// int8 pool, the stacked [L, N, Bk] bf16 scale pools; null otherwise) are
// updated in place. `window` <= 0 means full causal attention. Returns the
// CUDA error code of the launch (0 = success).
#define DECODE_ENTRY(NAME, T, NEEDS_SCALE)                                                      \
  extern "C" int NAME(const void* q, const void* new_k, const void* new_v, void* k_pool,      \
                      void* v_pool, void* k_scale, void* v_scale, const int32_t* tables,      \
                      const int32_t* positions, const int32_t* kv_lens, void* out, int B,     \
                      int Nh, int Hkv, int D, int L, int N, int Bk, int M, int layer,         \
                      int window, float scale, void* stream) {                                \
    if (NEEDS_SCALE != (k_scale != nullptr && v_scale != nullptr)) {                          \
      return (int)cudaErrorInvalidValue;                                                      \
    }                                                                                         \
    return dispatch<T>(q, new_k, new_v, k_pool, v_pool, k_scale, v_scale, tables, positions,  \
                       kv_lens, out, B, Nh, Hkv, D, L, N, Bk, M, layer, window, scale,        \
                       stream);                                                               \
  }

DECODE_ENTRY(paged_decode_fused_bf16, bf16, false)
DECODE_ENTRY(paged_decode_fused_int8, int8_t, true)
DECODE_ENTRY(paged_decode_fused_fp8, fp8, false)
