// Ragged paged attention for Hopper (sm_90a): bf16 queries and output over
// a bf16, int8 or fp8 (e4m3) paged pool.
//
// Replaces the Pallas TPU kernel `_ragged_kernel`, reached through
// `ragged_paged_attention` in distributed_gpu_inference_tpu/ops/
// paged_attention_pallas.py. One call serves a whole ragged round: every
// row b carries its own query span (positions, -1 = pad), its own block-table
// row and its own kv length, so decode rows (one live query), prefill-chunk
// rows (up to the chunk width) and pad rows share one launch.
//
// Semantics (those of ops/attention.py paged_attention_ref): a key at
// context position j is visible to a query at position p iff
// j < kv_len, j <= p and, with a sliding window, j > p - window. Scores and
// the online softmax run in f32 with scale D^-0.5; a query with no visible
// key outputs exact zeros.
//
// Design. Grid = (row x query tile, kv head). A block holds the qpk * Tq
// queries that share kv head g (query head h reads kv head h / qpk) as a
// 64 x D bf16 tile in shared memory: row r is query position t0 + r / qpk of
// head g * qpk + r % qpk. It walks the row's context from the window start
// to min(max query position + 1, kv_len) in chunks of KC key positions,
// gathering each key from its page (page = table[b, j / Bk], slot j % Bk, so
// the block size is a runtime value), and keeps an online softmax per query
// row. Both products (Q K^T and P V) are bf16 wmma 16x16x16 fragments with
// f32 accumulation; each of the 4 warps owns 16 query rows. The f32 output
// accumulator lives in shared memory so that its rows can be rescaled by
// the softmax correction without relying on the fragment layout.
//
// Quantized pools. The pool element type is a template parameter; only the
// staging differs. An int8 pool carries one bf16 scale per (page, token)
// ([N, Bk] per layer, shared by the kv heads): staging turns each code into
// bf16(code * scale) — the exact product of ops/attention.py dequantize_kv
// rounded to nearest even for the bf16 tensor cores, as the Pallas kernel
// rounds it for the MXU. An fp8 pool stages by a plain upcast (e4m3 -> bf16
// is exact). Everything after
// staging is the same for all three. A byte pool halves the bytes of K/V
// pages the kernel reads.
//
// What bounds it on the card: a prefill chunk of 256 queries against a few
// hundred keys is compute-light (about 4 * D flops per visible query-key
// pair), and the whole round reads each row's pages once per query tile,
// so at serving shapes it is bound by the bytes of K/V pages and of q/out.
// This first version stages K and V through shared memory synchronously
// (no cp.async/TMA pipeline, no wgmma): each chunk's load and compute do
// not overlap. Faster variants are later work; PERF.md keeps the times.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kQRows = 64;              // query rows per block
constexpr int kWarps = 4;               // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

template <int D, int KC>
struct Layout {
  static constexpr size_t q = 0;                                   // bf16 [64, D]
  static constexpr size_t k = q + sizeof(bf16) * kQRows * D;       // bf16 [KC, D]
  static constexpr size_t v = k + sizeof(bf16) * KC * D;           // bf16 [KC, D]
  static constexpr size_t p = v + sizeof(bf16) * KC * D;           // bf16 [64, KC]
  static constexpr size_t s = p + sizeof(bf16) * kQRows * KC;      // f32 [64, KC]
  static constexpr size_t acc = s + sizeof(float) * kQRows * KC;   // f32 [64, D]
  static constexpr size_t m = acc + sizeof(float) * kQRows * D;    // f32 [64]
  static constexpr size_t l = m + sizeof(float) * kQRows;          // f32 [64]
  static constexpr size_t alpha = l + sizeof(float) * kQRows;      // f32 [64]
  static constexpr size_t pos = alpha + sizeof(float) * kQRows;    // i32 [64]
  static constexpr size_t red = pos + sizeof(int) * kQRows;        // i32 [2]
  static constexpr size_t bytes = red + sizeof(int) * 2;
};

using fp8 = __nv_fp8_e4m3;

// 8 consecutive pool elements at p + off -> 8 bf16 (one 16-byte vector);
// `s` is the token's int8 scale (unused for bf16 and fp8 pools)
__device__ __forceinline__ uint4 stage8(const bf16* p, size_t off, float) {
  return *reinterpret_cast<const uint4*>(p + off);
}

__device__ __forceinline__ uint4 stage8(const int8_t* p, size_t off, float s) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p + off);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // code * scale is exact in f32 (8-bit by 8-bit significands): one
    // rounding, to the bf16 the tensor cores take
    o[i] = __floats2bfloat162_rn(static_cast<float>(c[2 * i]) * s,
                                 static_cast<float>(c[2 * i + 1]) * s);
  }
  return out;
}

__device__ __forceinline__ uint4 stage8(const fp8* p, size_t off, float) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p + off);
  const __nv_fp8x2_storage_t* c = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = __float22bfloat162_rn(__half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(c[i], __NV_E4M3))));
  }
  return out;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, int KC, typename T>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const bf16* __restrict__ q,          // [B, S, Nh, D]
              const T* __restrict__ kpool,         // [N, Hkv, Bk, D] (one layer)
              const T* __restrict__ vpool,
              const bf16* __restrict__ kscale,     // [N, Bk] (int8 pools only)
              const bf16* __restrict__ vscale,
              const int* __restrict__ tables,      // [B, M]
              const int* __restrict__ positions,   // [B, S]
              const int* __restrict__ kv_lens,     // [B]
              bf16* __restrict__ out,              // [B, S, Nh, D]
              int S, int Nh, int Hkv, int Bk, int M, int qtiles, int Tq,
              int window, float scale) {
  using L = Layout<D, KC>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sAcc = reinterpret_cast<float*>(smem + L::acc);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);
  float* sAlpha = reinterpret_cast<float*>(smem + L::alpha);
  int* sPos = reinterpret_cast<int*>(smem + L::pos);
  int* sRed = reinterpret_cast<int*>(smem + L::red);

  const int qpk = Nh / Hkv;
  const int b = blockIdx.x / qtiles;
  const int t0 = (blockIdx.x % qtiles) * Tq;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kv_len = kv_lens[b];
  constexpr int kVecD = D / 8;   // 16-byte vectors per row

  if (tid == 0) {
    sRed[0] = 0x7fffffff;   // min valid query position
    sRed[1] = -1;           // max valid query position
  }
  __syncthreads();
  if (tid < kQRows) {
    const int t = tid / qpk;
    int p = -1;
    if (t < Tq && t0 + t < S) p = positions[b * S + t0 + t];
    sPos[tid] = p;
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
    if (p >= 0) {
      atomicMin(&sRed[0], p);
      atomicMax(&sRed[1], p);
    }
  }
  __syncthreads();
  const int qmin = sRed[0];
  const int qmax = sRed[1];
  const int lo = (window > 0) ? max(0, qmin - window + 1) : 0;
  const int hi = min(qmax + 1, kv_len);

  if (qmax >= 0 && hi > lo) {
    // ---- stage the tile's queries (pad rows as zeros) and clear the acc
    for (int i = tid; i < kQRows * kVecD; i += kThreads) {
      const int r = i / kVecD;
      const int dv = i % kVecD;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (sPos[r] >= 0) {
        const int t = r / qpk;
        const int h = g * qpk + r % qpk;
        val = reinterpret_cast<const uint4*>(
            q + ((size_t)(b * S + t0 + t) * Nh + h) * D)[dv];
      }
      reinterpret_cast<uint4*>(sQ + r * D)[dv] = val;
    }
    for (int i = tid; i < kQRows * D; i += kThreads) sAcc[i] = 0.f;

    for (int kc0 = (lo / KC) * KC; kc0 < hi; kc0 += KC) {
      __syncthreads();   // previous chunk's products are done with sK/sV
      // ---- gather KC keys from their pages (outside [lo, hi) → zeros, so
      // masked columns never carry non-finite values into P V)
      for (int i = tid; i < KC * kVecD; i += kThreads) {
        const int c = i / kVecD;
        const int dv = i % kVecD;
        const int j = kc0 + c;
        uint4 kval = make_uint4(0u, 0u, 0u, 0u);
        uint4 vval = kval;
        if (j >= lo && j < hi) {
          const int page = tables[b * M + min(j / Bk, M - 1)];
          const size_t off = (((size_t)page * Hkv + g) * Bk + j % Bk) * D + dv * 8;
          float ks = 1.f, vs = 1.f;
          if (kscale != nullptr) {
            ks = __bfloat162float(kscale[(size_t)page * Bk + j % Bk]);
            vs = __bfloat162float(vscale[(size_t)page * Bk + j % Bk]);
          }
          kval = stage8(kpool, off, ks);
          vval = stage8(vpool, off, vs);
        }
        reinterpret_cast<uint4*>(sK + c * D)[dv] = kval;
        reinterpret_cast<uint4*>(sV + c * D)[dv] = vval;
      }
      __syncthreads();

      // ---- S = Q K^T for this warp's 16 query rows
      const int r0 = warp * 16;
#pragma unroll
      for (int n = 0; n < KC / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c_frag;
        wmma::fill_fragment(c_frag, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a_frag;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b_frag;
          wmma::load_matrix_sync(a_frag, sQ + r0 * D + kk * 16, D);
          wmma::load_matrix_sync(b_frag, sK + n * 16 * D + kk * 16, D);
          wmma::mma_sync(c_frag, a_frag, b_frag, c_frag);
        }
        wmma::store_matrix_sync(sS + r0 * KC + n * 16, c_frag, KC, wmma::mem_row_major);
      }
      __syncwarp();

      // ---- online softmax over the chunk, one query row at a time
      for (int rr = 0; rr < 16; ++rr) {
        const int r = r0 + rr;
        const int p = sPos[r];
        const float m_old = sM[r];
        float sv[KC / 32];
        bool ok[KC / 32];
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < KC / 32; ++i) {
          const int c = lane + 32 * i;
          const int j = kc0 + c;
          ok[i] = p >= 0 && j < kv_len && j <= p && (window <= 0 || j > p - window);
          sv[i] = ok[i] ? sS[r * KC + c] * scale : kNegInf;
          mx = fmaxf(mx, sv[i]);
        }
        mx = warp_max(mx);
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < KC / 32; ++i) {
          const float pr = ok[i] ? expf(sv[i] - m_new) : 0.f;
          sP[r * KC + lane + 32 * i] = __float2bfloat16(pr);
          sum += pr;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          sAlpha[r] = alpha;
          sL[r] = sL[r] * alpha + sum;
          sM[r] = m_new;
        }
      }
      __syncwarp();

      // ---- rescale this warp's accumulator rows, then acc += P V
      for (int i = lane; i < 16 * D; i += 32) {
        const int r = r0 + i / D;
        sAcc[r * D + i % D] *= sAlpha[r];
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_frag;
        wmma::load_matrix_sync(o_frag, sAcc + r0 * D + n * 16, D, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a_frag;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b_frag;
          wmma::load_matrix_sync(a_frag, sP + r0 * KC + kk * 16, KC);
          wmma::load_matrix_sync(b_frag, sV + kk * 16 * D + n * 16, D);
          wmma::mma_sync(o_frag, a_frag, b_frag, o_frag);
        }
        wmma::store_matrix_sync(sAcc + r0 * D + n * 16, o_frag, D, wmma::mem_row_major);
      }
    }
    __syncthreads();
  } else {
    for (int i = tid; i < kQRows * D; i += kThreads) sAcc[i] = 0.f;
    __syncthreads();
  }

  // ---- normalize and emit every real query row of the tile (l == 0 →
  // exact zeros: pad queries and windows that exclude every key)
  for (int i = tid; i < kQRows * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int t = r / qpk;
    if (t >= Tq || t0 + t >= S) continue;
    const float l = sL[r];
    const float o = l > 0.f ? sAcc[i] / l : 0.f;
    const int h = g * qpk + r % qpk;
    out[((size_t)(b * S + t0 + t) * Nh + h) * D + d] = __float2bfloat16(o);
  }
}

template <int D, int KC, typename T>
int launch(const bf16* q, const T* kpool, const T* vpool, const bf16* kscale,
           const bf16* vscale, const int* tables, const int* positions, const int* kv_lens,
           bf16* out, int B, int S, int Nh, int Hkv, int Bk, int M, int window, float scale,
           cudaStream_t stream) {
  const int qpk = Nh / Hkv;
  const int Tq = kQRows / qpk;
  const int qtiles = (S + Tq - 1) / Tq;
  const size_t smem = Layout<D, KC>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel<D, KC, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * qtiles, Hkv);
  ragged_kernel<D, KC, T><<<grid, kThreads, smem, stream>>>(
      q, kpool, vpool, kscale, vscale, tables, positions, kv_lens, out, S, Nh, Hkv, Bk, M,
      qtiles, Tq, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
             const void* v_scale, const int32_t* tables, const int32_t* positions,
             const int32_t* kv_lens, void* out, int B, int S, int Nh, int Hkv, int D, int Bk,
             int M, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Nh % Hkv != 0 || Nh / Hkv > kQRows) return (int)cudaErrorInvalidValue;
  const bf16* qq = static_cast<const bf16*>(q);
  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);
  const bf16* ks = static_cast<const bf16*>(k_scale);
  const bf16* vs = static_cast<const bf16*>(v_scale);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, 64, T>(qq, kp, vp, ks, vs, tables, positions, kv_lens, o, B, S, Nh,
                               Hkv, Bk, M, window, scale, st);
    case 128:
      return launch<128, 64, T>(qq, kp, vp, ks, vs, tables, positions, kv_lens, o, B, S, Nh,
                                Hkv, Bk, M, window, scale, st);
    case 256:
      return launch<256, 32, T>(qq, kp, vp, ks, vs, tables, positions, kv_lens, o, B, S, Nh,
                                Hkv, Bk, M, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points (loaded with ctypes), one per pool element type. All
// tensors contiguous on the current device; `k_scale`/`v_scale` are the
// layer's [N, Bk] bf16 scale pools of an int8 pool and null otherwise;
// `window` <= 0 means full causal attention. Returns the CUDA error code of
// the launch (0 = success); the kernel runs on `stream` and does not
// synchronise.
#define RAGGED_ENTRY(NAME, T, NEEDS_SCALE)                                                     \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool,                 \
                      const void* k_scale, const void* v_scale, const int32_t* tables,       \
                      const int32_t* positions, const int32_t* kv_lens, void* out, int B,    \
                      int S, int Nh, int Hkv, int D, int Bk, int M, int window, float scale, \
                      void* stream) {                                                        \
    if (NEEDS_SCALE != (k_scale != nullptr && v_scale != nullptr)) {                         \
      return (int)cudaErrorInvalidValue;                                                     \
    }                                                                                        \
    return dispatch<T>(q, k_pool, v_pool, k_scale, v_scale, tables, positions, kv_lens, out, \
                       B, S, Nh, Hkv, D, Bk, M, window, scale, stream);                      \
  }

RAGGED_ENTRY(ragged_paged_attention_bf16, bf16, false)
RAGGED_ENTRY(ragged_paged_attention_int8, int8_t, true)
RAGGED_ENTRY(ragged_paged_attention_fp8, fp8, false)
