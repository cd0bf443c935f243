// Ragged paged attention for Hopper (sm_90a): bf16 queries and output over
// a bf16, int8 or fp8 (e4m3) paged pool, at head_dim 32, 64, 128 or 256.
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
// Design. Grid = (row x query tile, kv head). A block holds the
// qpk * Tq queries that share kv head g (query head h reads kv head h / qpk)
// as a 64 x D bf16 tile: row r is query position t0 + r / qpk of head
// g * qpk + r % qpk; each of the 4 warps owns 16 rows. A tile whose queries
// are all pads exits at once (its outputs are written as zeros), and a warp
// whose 16 rows are all pads (a decode row's tile holds qpk live rows) only
// takes part in the copies and barriers. The block walks its keys [lo, hi)
// — from the window start of its first query to min(last query + 1,
// kv_len) — in chunks of KC = 32 keys:
// - Staging: a cp.async ring of page-slice copies, 3 stages (2 at D = 256),
//   16 bytes a thread and one table lookup per (key row, thread) for both
//   K and V, so the block size is a runtime value. The copies of the next
//   chunks are in flight while this one is computed; one __syncthreads a
//   chunk (two over an int8/fp8 pool). Codes of an int8/fp8 pool travel as
//   codes and are turned into bf16 after they arrive: int8 as
//   bf16(code * scale) rounded to nearest even — the product of
//   ops/attention.py dequantize_kv rounded for the tensor cores, as the
//   Pallas kernel rounds it for the MXU — and fp8 by its exact upcast. Rows
//   in shared memory are padded by 16 bytes so that ldmatrix reads them
//   without bank conflicts.
// - Both products are mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by
//   ldmatrix, in the FlashAttention-2 register layout: S = Q K^T stays in
//   registers, the online softmax runs per row in registers with quad
//   shuffles (a chunk every row of the warp sees whole skips the mask; O is
//   rescaled only when some row's maximum moved), P is repacked from the S
//   accumulators into A fragments (rounded to bf16), and the output
//   accumulator O stays in registers for the whole walk. At D <= 128 the
//   queries' A fragments are loaded once into registers; at D = 256 they
//   are re-read from shared memory.
// - No key split: a block walks all of its tile's keys. Splitting them by
//   the decode kernel's plan (16 splits of 256 keys, each block writing its
//   partial (m, l, O) in f32 for a merge launch) was timed at the long
//   round (8 x 256, 4096-key rows) and was slower: 0.4189 / 0.4211 against
//   0.4059 / 0.4058 ms as CUDA graphs (chip_smoke.py phase 10 on that
//   version, H100 80GB HBM3 at 700 W) — the f32 partial states of every
//   64-row tile cost more than the extra parallelism gains.
// Why mma.sync and not wgmma: at the timed serving round the work is
// ~2.9 GFLOP (3 us at 989 TFLOP/s) against a 9.3 us byte bound; at the long
// round 34 GFLOP (0.034 ms) against a 0.046 ms byte bound. wgmma's 64-row
// warpgroup tile would put a whole query group's softmax across 4 warps;
// what holds this kernel back on the card is instruction issue around the
// mma (copies, masks, the softmax), not the mma rate (PERF.md).
//
// What bounds it on the card: the bytes of the K/V pages each tile reads
// (a prefill chunk's tiles re-read the same pages, mostly from L2) and of
// q/out; at long contexts the tensor-core work of the chunk rows comes
// close. Resources (`nvcc -Xptxas -v`, sm_90a, CUDA 12.8; the smoke run
// prints them): at D = 128, 166-167 registers and 70,784 bytes of shared
// memory per block over a bf16 pool (queries 17,408 + a 3-stage K/V ring
// 52,224 + scales and positions), 60,544 over an int8/fp8 pool (a 3-stage
// ring of codes 24,576 + one bf16 K/V buffer 17,408): 3 blocks an SM, no
// spills.

#include "paged_common.cuh"

namespace {

using paged::bf16;
using paged::fp8;
using paged::kNegInf;

constexpr int kQRows = 64;              // query rows per block
constexpr int kWarps = 4;               // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int KC = 32;                  // keys per chunk

template <int D, typename T>
struct Layout {
  static constexpr int DP = D + 8;                         // padded bf16 row stride
  static constexpr bool kConv = !std::is_same<T, bf16>::value;
  static constexpr int kStages = D > 128 ? 2 : 3;           // cp.async ring depth
  static constexpr int kBufs = kConv ? 1 : kStages;         // bf16 K/V buffers
  static constexpr size_t q = 0;                                         // bf16 [64][DP]
  static constexpr size_t k = q + sizeof(bf16) * kQRows * DP;            // bf16 [kBufs][KC][DP]
  static constexpr size_t v = k + sizeof(bf16) * kBufs * KC * DP;
  static constexpr size_t rk = v + sizeof(bf16) * kBufs * KC * DP;       // T [kStages][KC][D]
  static constexpr size_t rv = rk + (kConv ? sizeof(T) * kStages * KC * D : 0);
  static constexpr size_t sc = rv + (kConv ? sizeof(T) * kStages * KC * D : 0);
  static constexpr size_t pos = sc + sizeof(float) * kStages * 2 * KC;   // f32 sc [kStages][2][KC]
  static constexpr size_t red = pos + sizeof(int) * kQRows;              // i32 [2]
  static constexpr size_t bytes = (red + sizeof(int) * 4 + 127) / 128 * 128;
};

using paged::ldsm_x4;
using paged::ldsm_x4_t;
using paged::mma16816;
using paged::pack_bf16;

template <int D, typename T>
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
              int S, int Nh, int Hkv, int Bk, int M, int qtiles, int Tq, int window,
              float scale_log2) {
  using L = Layout<D, T>;
  constexpr int DP = L::DP;
  constexpr bool kConv = L::kConv;
  constexpr int kStages = L::kStages;
  constexpr bool kInt8 = paged::kIsInt8<T>;
  constexpr bool kQReg = D <= 128;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  T* rK = reinterpret_cast<T*>(smem + L::rk);
  T* rV = reinterpret_cast<T*>(smem + L::rv);
  float* sSc = reinterpret_cast<float*>(smem + L::sc);   // [stage][k|v][KC]
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
  const int* table = tables + (size_t)b * M;

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
    if (p >= 0) {
      atomicMin(&sRed[0], p);
      atomicMax(&sRed[1], p);
    }
  }
  __syncthreads();
  const int qmin = sRed[0];
  const int qmax = sRed[1];
  const int klo = (window > 0) ? max(0, qmin - window + 1) : 0;
  const int khi = min(qmax + 1, kv_len);

  if (qmax < 0 || khi <= klo) {
    // no key for the tile: every real query row of it is zero
    for (int i = tid; i < kQRows * D; i += kThreads) {
      const int r = i / D;
      const int t = r / qpk;
      if (t >= Tq || t0 + t >= S) continue;
      out[((size_t)(b * S + t0 + t) * Nh + g * qpk + r % qpk) * D + i % D] =
          __float2bfloat16(0.f);
    }
    return;
  }

  // ---- stage the tile's queries (pad rows as zeros) with chunk 0's keys
  constexpr int kVq = D / 8;
  for (int i = tid; i < kQRows * kVq; i += kThreads) {
    const int r = i / kVq;
    const int dv = i % kVq;
    const bool ok = sPos[r] >= 0;
    const bf16* src = q;
    if (ok) src = q + ((size_t)(b * S + t0 + r / qpk) * Nh + g * qpk + r % qpk) * D + dv * 8;
    paged::cp_async16(sQ + r * DP + dv * 8, src, ok);
  }
  auto issue = [&](int i) {
    const int c0 = klo + i * KC;
    const int st = i % kStages;
    if constexpr (kConv) {
      paged::issue_kv<kThreads, D, T>(rK + st * KC * D, rV + st * KC * D, D, kpool, vpool, c0,
                                      KC, klo, khi, -1, table, M, Hkv, g, Bk);
    } else {
      paged::issue_kv<kThreads, D, T>(sK + st * KC * DP, sV + st * KC * DP, DP, kpool, vpool,
                                      c0, KC, klo, khi, -1, table, M, Hkv, g, Bk);
    }
  };
  // int8: the scales of key klo + i * KC + tid (0 outside [klo, khi))
  auto scales = [&](int i, float* ks, float* vs) {
    *ks = 0.f;
    *vs = 0.f;
    const int j = klo + i * KC + tid;
    if (!kInt8 || tid >= KC || j >= khi) return;
    const size_t at = paged::page_slot(table, j, M, Bk);
    *ks = __bfloat162float(kscale[at]);
    *vs = __bfloat162float(vscale[at]);
  };

  const int gq = lane >> 2;   // this thread's rows: r0 + gq and r0 + gq + 8
  const int t4 = lane & 3;    // and columns 2 * t4, 2 * t4 + 1 of each 8-wide tile
  const int r0 = warp * 16;
  const int prow[2] = {sPos[r0 + gq], sPos[r0 + gq + 8]};
  // warp-uniform facts about the warp's 16 query rows: a warp of pad rows
  // only takes part in the copies and barriers; a chunk that every row
  // sees in full skips the per-element mask
  int pmin = min(prow[0], prow[1]);
  int pmax = max(prow[0], prow[1]);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, o));
    pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
  }
  const bool warp_live = pmax >= 0;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  uint32_t qf[kQReg ? D / 16 : 1][4];

  // the ring: chunks 0 .. kStages - 2 in flight (the queries with chunk 0)
  // before the first wait; one commit group per chunk slot, empty past the
  // last chunk
  const int nchunks = (khi - klo + KC - 1) / KC;
  float nxt_ks = 0.f, nxt_vs = 0.f;
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nchunks) {
      issue(p);
      if (kInt8 && tid < KC) {
        scales(p, &nxt_ks, &nxt_vs);
        sSc[(p * 2) * KC + tid] = nxt_ks;
        sSc[(p * 2 + 1) * KC + tid] = nxt_vs;
      }
    }
    paged::cp_async_commit();
  }
  for (int i = 0; i < nchunks; ++i) {
    const int st = i % kStages;
    paged::cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk i has landed for every thread; chunk i - 1 is consumed
    if constexpr (kQReg) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          ldsm_x4(qf[kk], sQ + (r0 + (lane & 15)) * DP + kk * 16 + (lane >> 4) * 8);
        }
      }
    }
    const int nxt = i + kStages - 1;
    if (nxt < nchunks) {
      issue(nxt);
      scales(nxt, &nxt_ks, &nxt_vs);   // stored after this chunk's compute
    }
    paged::cp_async_commit();
    const bf16* kb = sK;
    const bf16* vb = sV;
    if constexpr (kConv) {
      // codes -> bf16 for the tensor cores
      const T* ck = rK + st * KC * D;
      const T* cv = rV + st * KC * D;
      for (int e = tid; e < KC * (D / 8); e += kThreads) {
        const int c = e / (D / 8);
        const int dv = e % (D / 8);
        *reinterpret_cast<uint4*>(sK + c * DP + dv * 8) =
            paged::to_bf16x8(ck + c * D + dv * 8, sSc[(st * 2) * KC + c]);
        *reinterpret_cast<uint4*>(sV + c * DP + dv * 8) =
            paged::to_bf16x8(cv + c * D + dv * 8, sSc[(st * 2 + 1) * KC + c]);
      }
      __syncthreads();
    } else {
      kb = sK + st * KC * DP;
      vb = sV + st * KC * DP;
    }
    const int c0 = klo + i * KC;
    if (warp_live) {   // a warp of pad rows only copies and waits
      const bool full = pmin >= 0 && c0 + KC <= khi && c0 + KC - 1 <= pmin &&
                        (window <= 0 || c0 > pmax - window);

      // ---- S = Q K^T for this warp's 16 rows x KC keys, in registers
      float s[KC / 8][4];
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        if constexpr (kQReg) {
          a[0] = qf[kk][0];
          a[1] = qf[kk][1];
          a[2] = qf[kk][2];
          a[3] = qf[kk][3];
        } else {
          ldsm_x4(a, sQ + (r0 + (lane & 15)) * DP + kk * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int np = 0; np < KC / 16; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, kb + (np * 16 + (lane & 7) + (lane >> 4) * 8) * DP + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma16816(s[2 * np], a, bk[0], bk[1]);
          mma16816(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // ---- mask, online softmax per row (quad shuffles), rescale O
      float alpha[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = prow[hf];
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < KC / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = c0 + n * 8 + 2 * t4 + e;
            const bool vis = full || (p >= 0 && j < khi && j < kv_len && j <= p &&
                                      (window <= 0 || j > p - window));
            const float x = vis ? s[n][hf * 2 + e] * scale_log2 : kNegInf;
            s[n][hf * 2 + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hf], mx);
        alpha[hf] = exp2f(m[hf] - m_new);
        m[hf] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < KC / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[n][hf * 2 + e];
            const float pr = (full || x != kNegInf) ? exp2f(x - m_new) : 0.f;
            s[n][hf * 2 + e] = pr;
            sum += pr;
          }
        }
        l[hf] = l[hf] * alpha[hf] + sum;
      }
      // rescale O only when some row's maximum moved (x 1 is exact)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
      }

      // ---- O += P V (P repacked from the S accumulators as bf16 A fragments)
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
        a[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
        a[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
        a[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vb + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DP + dp * 16 +
                            (lane >> 4) * 8);
          mma16816(o[2 * dp], a, bv[0], bv[1]);
          mma16816(o[2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
    if (kInt8 && nxt < nchunks && tid < KC) {
      // chunk nxt's slot was last read converting chunk i - 1, before this
      // iteration's first barrier; it is next read after chunk nxt's
      sSc[((nxt % kStages) * 2) * KC + tid] = nxt_ks;
      sSc[((nxt % kStages) * 2 + 1) * KC + tid] = nxt_vs;
    }
  }

  // ---- emit the normalized rows
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lf = l[hf];
    lf += __shfl_xor_sync(0xffffffffu, lf, 1);
    lf += __shfl_xor_sync(0xffffffffu, lf, 2);
    const int r = r0 + gq + hf * 8;
    const int t = r / qpk;
    if (t >= Tq || t0 + t >= S) continue;
    // l == 0: pad queries and windows that exclude every key -> exact zeros
    const float inv = lf > 0.f ? 1.f / lf : 0.f;
    bf16* orow = out + ((size_t)(b * S + t0 + t) * Nh + g * qpk + r % qpk) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[n][hf * 2] * inv, o[n][hf * 2 + 1] * inv);
    }
  }
}

template <int D, typename T>
int launch(const bf16* q, const T* kpool, const T* vpool, const bf16* kscale,
           const bf16* vscale, const int* tables, const int* positions, const int* kv_lens,
           bf16* out, int B, int S, int Nh, int Hkv, int Bk, int M, int window, float scale,
           cudaStream_t stream) {
  const int qpk = Nh / Hkv;
  const int Tq = kQRows / qpk;
  const int qtiles = (S + Tq - 1) / Tq;
  const size_t smem = Layout<D, T>::bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ragged_kernel<D, T><<<dim3(B * qtiles, Hkv), kThreads, smem, stream>>>(
      q, kpool, vpool, kscale, vscale, tables, positions, kv_lens, out, S, Nh, Hkv, Bk, M, qtiles,
      Tq, window, scale * paged::kLog2e);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
             const void* v_scale, const int32_t* tables, const int32_t* positions,
             const int32_t* kv_lens, void* out, int B, int S, int Nh, int Hkv, int D, int Bk,
             int M, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Nh % Hkv != 0 || Nh / Hkv > kQRows || Bk <= 0 || M <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const bf16* qq = static_cast<const bf16*>(q);
  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);
  const bf16* ks = static_cast<const bf16*>(k_scale);
  const bf16* vs = static_cast<const bf16*>(v_scale);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32, T>(qq, kp, vp, ks, vs, tables, positions, kv_lens, o, B, S, Nh, Hkv,
                           Bk, M, window, scale, st);
    case 64:
      return launch<64, T>(qq, kp, vp, ks, vs, tables, positions, kv_lens, o, B, S, Nh, Hkv,
                           Bk, M, window, scale, st);
    case 128:
      return launch<128, T>(qq, kp, vp, ks, vs, tables, positions, kv_lens, o, B, S, Nh, Hkv,
                            Bk, M, window, scale, st);
    case 256:
      return launch<256, T>(qq, kp, vp, ks, vs, tables, positions, kv_lens, o, B, S, Nh, Hkv,
                            Bk, M, window, scale, st);
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
