// Fused decode step for Hopper (sm_90a), bf16: write this step's K/V row
// into its page slot, then attend the row's single query over the updated
// paged context — one layer of the stacked pools per launch.
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
// What bounds it on the card: decode reads every live context key once per
// layer and does 4 * D flops per (query head, key), far below the H100's
// ratio of flops to bytes — it is bound by the bytes of the K/V pages.
// At serving batch 8 with 8 kv heads this grid is 64 blocks on 132 SMs;
// splitting the keys of one row across SMs (split-KV) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 8;               // query heads per pass over the keys
constexpr float kNegInf = -1e30f;

template <int E> struct Vec;
template <> struct Vec<2> { using T = uint32_t; };
template <> struct Vec<4> { using T = uint2; };
template <> struct Vec<8> { using T = uint4; };

template <int E>
__device__ __forceinline__ void load_bf16(const bf16* p, float* f) {
  const typename Vec<E>::T raw = *reinterpret_cast<const typename Vec<E>::T*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_fused_kernel(const bf16* __restrict__ q,        // [B, Nh, D]
                    const bf16* __restrict__ new_k,    // [B, Hkv, D]
                    const bf16* __restrict__ new_v,
                    bf16* kpool,                       // [L, N, Hkv, Bk, D]
                    bf16* vpool,
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

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qpk = Nh / Hkv;
  const int pos = positions[b];
  const int kv_len = kv_lens[b];
  const size_t layer_off = (size_t)layer * N * Hkv * Bk * D;
  bf16* kl = kpool + layer_off;
  bf16* vl = vpool + layer_off;

  // ---- 1. write the new row's K/V for this kv head into its page slot
  if (pos >= 0) {
    const int page = tables[b * M + min(pos / Bk, M - 1)];
    const size_t dst = (((size_t)page * Hkv + g) * Bk + pos % Bk) * D;
    const size_t src = ((size_t)b * Hkv + g) * D;
    for (int d = tid; d < D; d += kThreads) {
      kl[dst + d] = new_k[src + d];
      vl[dst + d] = new_v[src + d];
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
      if (h < nq) load_bf16<E>(q + ((size_t)b * Nh + g * qpk + h0 + h) * D + lane * E, qr[h]);
    }

    for (int j = lo + warp; j < hi; j += kWarps) {
      const int page = tables[b * M + min(j / Bk, M - 1)];
      const size_t off = (((size_t)page * Hkv + g) * Bk + j % Bk) * D + lane * E;
      float kf[E], vf[E];
      load_bf16<E>(kl + off, kf);
      load_bf16<E>(vl + off, vf);
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

template <int D>
int launch(const bf16* q, const bf16* new_k, const bf16* new_v, bf16* kpool, bf16* vpool,
           const int* tables, const int* positions, const int* kv_lens, bf16* out, int B,
           int Nh, int Hkv, int N, int Bk, int M, int layer, int window, float scale,
           cudaStream_t stream) {
  dim3 grid(B, Hkv);
  decode_fused_kernel<D><<<grid, kThreads, 0, stream>>>(
      q, new_k, new_v, kpool, vpool, tables, positions, kv_lens, out, layer, N, Nh, Hkv,
      Bk, M, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). All tensors contiguous on the current
// device; the stacked pools are updated in place. `window` <= 0 means full
// causal attention. Returns the CUDA error code of the launch (0 = success).
extern "C" int paged_decode_fused_bf16(
    const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
    const int32_t* tables, const int32_t* positions, const int32_t* kv_lens, void* out,
    int B, int Nh, int Hkv, int D, int L, int N, int Bk, int M, int layer, int window,
    float scale, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Nh % Hkv != 0 || layer < 0 || layer >= L) {
    return (int)cudaErrorInvalidValue;
  }
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* nk = static_cast<const bf16*>(new_k);
  const bf16* nv = static_cast<const bf16*>(new_v);
  bf16* kp = static_cast<bf16*>(k_pool);
  bf16* vp = static_cast<bf16*>(v_pool);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(qq, nk, nv, kp, vp, tables, positions, kv_lens, o, B, Nh, Hkv, N, Bk,
                        M, layer, window, scale, st);
    case 128:
      return launch<128>(qq, nk, nv, kp, vp, tables, positions, kv_lens, o, B, Nh, Hkv, N,
                         Bk, M, layer, window, scale, st);
    case 256:
      return launch<256>(qq, nk, nv, kp, vp, tables, positions, kv_lens, o, B, Nh, Hkv, N,
                         Bk, M, layer, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
