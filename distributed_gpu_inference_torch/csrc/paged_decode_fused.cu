// Fused decode step for Hopper (sm_90a): write this step's K/V row into its
// page slot, then attend the row's single query over the updated paged
// context — one layer of the stacked pools per call. Queries, new rows and
// output are bf16; the pools are bf16, int8 (with scale pools) or fp8; the
// head_dim is 32, 64, 128 or 256.
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
// Design: split-KV on the tensor cores. Grid = (row, kv head x head group,
// split), 128 threads, then a second launch (`paged::merge_splits`) that
// combines the splits.
// - The split plan comes from the host (ops/paged_attention.py
//   `kv_split_plan`, from the table width M and Bk only): split s covers the
//   whole pages [s * P, (s + 1) * P), 16 splits a row of 64 to 256 keys
//   each. At the llama3-8b serving batch (8 rows x 8 kv heads) a 4096-key
//   table gives 16 splits of 256 keys: 1024 blocks on 132 SMs; a 1024-key
//   table 16 of 64, so that rows of a few hundred keys still spread over
//   the card. A split outside the row's visible range [lo, hi) exits at
//   once and the merge never reads it.
// - A block takes up to 16 query heads of its kv head's group as one m16
//   row tile (llama3-8b: 4 real rows, the rest zero); a wider group is
//   spread over grid.y.
// - Keys are staged in chunks of KC = 32 through a cp.async ring (3 stages,
//   2 at D = 256): the copies of the next chunks are in flight while the
//   block computes this one. bf16 rows land padded for ldmatrix; int8/fp8
//   codes travel as codes (half the bytes) and are widened to bf16 after
//   they arrive — exactly: an int8 code is a small integer (its scale
//   multiplies the scores in f32 and is folded into P), an e4m3 code upcasts
//   exactly.
// - Each warp takes 8 keys of every chunk for all 16 rows: S = Q K^T with
//   mma.sync m16n8k16 (queries held as A fragments in registers), its own
//   online softmax per row with quad shuffles, then O += P V with
//   m16n8k8, P rounded to bf16 — the one rounding of the read, as in the
//   ragged kernel. The 4 warps merge their (m, l, O) through shared memory
//   once, at the end, in a fixed order.
// - Why tensor cores for a step whose 4 * D flops per (head, key) are far
//   below the card's ~295 flops per byte: the first version of this design
//   did the products with CUDA-core FMAs (8 lanes a key, one softmax update
//   per chunk) and took 0.0930 ms as a CUDA graph at 4096-key rows, 43% of
//   the byte bound (chip_smoke.py phase 10 on that design, H100 80GB HBM3
//   at 700 W): bound by instruction issue, some 46 warp instructions per
//   key. The tensor cores do a warp's 8 keys in 8 + 16 mma instructions.
// - The partial states (m, l, acc) go in f32 to a workspace the wrapper
//   allocates; the merge reads them in split order, so two calls on the same
//   inputs give the same bits.
//
// The write. Only the split whose pages hold p writes the new row, and in it
// only head group 0 of each kv head writes that head's slice. Copy-on-write
// keeps this free of races between rows: a row writes only into its own last
// page, and a page shared through the prefix cache is never a write target
// (the block manager copies a shared tail page before a sequence writes into
// it). Within the row, splits are page-aligned, so no other split reads the
// written page. The blocks of the writing split (every head group) do read
// that page, maybe while head group 0 writes it, and an asynchronous copy
// gives no ordering against a store anyway: so the copy of slot p is
// zero-filled and never read, and each block puts its own shared-memory
// copy of the row, in pool format, into that slot of its staged chunk —
// exactly what the plain read sees after the write (bf16; code and the new
// scale for int8; the code for fp8).
//
// Quantized pools (the pool element type is a template parameter):
// - fp8: the new row is written with a round-to-nearest-even cast that, like
//   JAX's astype(float8_e4m3fn), turns magnitudes above 464 into NaN
//   instead of saturating; reads upcast exactly.
// - int8: the kernel quantizes the new row itself, with the contract of
//   ops/attention.py quantize_token_rows: ONE scale per token over the whole
//   (Hkv, D) row, bf16(max(amax, 1e-6) * f32(1/127)), codes round-half-even
//   of x / scale (IEEE division) clipped to +-127. Every block of the
//   writing split reads the full new row (Hkv * D bf16, 2 KB at llama3-8b)
//   and computes the same scale itself; only kv head 0's head group 0
//   writes the scale. Codes and scales are bit-identical to the plain write.
//   Reads apply code * scale in f32 (the scores) and round p * scale to
//   bf16 for P V, where the plain version (dequantize_kv) keeps the exact
//   product: the same error as P's rounding over a bf16 pool.
//
// What bounds it on the card: the bytes of the live K/V pages (plus q, out
// and the new rows), read once; at short contexts the launch and the merge.
// Resources (`nvcc -Xptxas -v`, sm_90a, CUDA 12.8; the smoke run prints
// them): at D = 128, 3 stages, 58,384 bytes of shared memory per block
// (ring 52,224 = 2 x 3 x 32 x 136 x 2, queries 4,352, scales, merge state,
// the new row); 147 registers over int8/fp8 pools, 128 over bf16 with 16
// bytes of spill; times in PERF.md.

#include "paged_common.cuh"

namespace {

using paged::bf16;
using paged::fp8;
using paged::kNegInf;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int KC = 32;                  // keys per chunk: 8 per warp

template <int D, typename T>
struct Cfg {
  static constexpr int HQ = 16;                      // query heads per block: one m16 tile
  static constexpr int DP = D + 8;                   // padded bf16 row stride (ldmatrix)
  static constexpr bool kConv = !std::is_same<T, bf16>::value;
  static constexpr int kStages = D > 128 ? 2 : 3;    // cp.async ring depth
  static constexpr int kBufs = kConv ? 1 : kStages;  // bf16 K/V buffers
  // dynamic shared memory layout (bytes)
  static constexpr size_t k = 0;                                    // bf16 [kBufs][KC][DP]
  static constexpr size_t v = k + sizeof(bf16) * kBufs * KC * DP;
  static constexpr size_t rk = v + sizeof(bf16) * kBufs * KC * DP;  // T [kStages][KC][D]
  static constexpr size_t rv = rk + (kConv ? sizeof(T) * kStages * KC * D : 0);
  static constexpr size_t ring = rv + (kConv ? sizeof(T) * kStages * KC * D : 0);
  // after the walk the ring holds the warps' outputs, f32 [kWarps][HQ][D]
  static_assert(sizeof(float) * kWarps * HQ * D <= ring, "merge buffer exceeds the ring");
  static constexpr size_t q = ring;                                 // bf16 [HQ][DP]
  static constexpr size_t sc = q + sizeof(bf16) * HQ * DP;          // f32 [kStages][2][KC]
  static constexpr size_t ml = sc + sizeof(float) * kStages * 2 * KC;   // f32 [kWarps][2][HQ]
  static constexpr size_t red = ml + sizeof(float) * kWarps * 2 * HQ;  // f32 [kWarps]
  static constexpr size_t nk = red + sizeof(float) * kWarps;       // T [D] new K row
  static constexpr size_t nv = nk + sizeof(T) * D;                  // T [D] new V row
  static constexpr size_t bytes = (nv + sizeof(T) * D + 15) / 16 * 16;
};

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

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const bf16* __restrict__ q,        // [B, Nh, D]
                    const bf16* __restrict__ new_k,    // [B, Hkv, D]
                    const bf16* __restrict__ new_v,
                    T* kpool,                          // [L, N, Hkv, Bk, D]
                    T* vpool,
                    bf16* kscale,                      // [L, N, Bk] (int8 pools)
                    bf16* vscale,
                    const int* __restrict__ tables,    // [B, M]
                    const int* __restrict__ positions, // [B]
                    const int* __restrict__ kv_lens,   // [B]
                    float* __restrict__ ws_o,          // [B, Nh, S, D]
                    float* __restrict__ ws_ml,         // [B, Nh, S, 2]
                    int layer, int N, int Nh, int Hkv, int Bk, int M, int window,
                    int pages_per_split, int n_splits, int groups, float scale_log2) {
  using C = Cfg<D, T>;
  constexpr int HQ = C::HQ, DP = C::DP, kStages = C::kStages;
  constexpr bool kConv = C::kConv;
  constexpr bool kInt8 = paged::kIsInt8<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + C::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + C::v);
  T* rK = reinterpret_cast<T*>(smem + C::rk);
  T* rV = reinterpret_cast<T*>(smem + C::rv);
  float* sO = reinterpret_cast<float*>(smem);   // the ring, once the walk is over
  bf16* sQ = reinterpret_cast<bf16*>(smem + C::q);
  float* sSc = reinterpret_cast<float*>(smem + C::sc);   // [stage][k|v][KC]
  float* sML = reinterpret_cast<float*>(smem + C::ml);
  float* sRed = reinterpret_cast<float*>(smem + C::red);
  T* sNewK = reinterpret_cast<T*>(smem + C::nk);
  T* sNewV = reinterpret_cast<T*>(smem + C::nv);

  const int b = blockIdx.x;
  const int g = blockIdx.y / groups;
  const int hg = blockIdx.y % groups;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qpk = Nh / Hkv;
  const int h0 = hg * HQ;
  const int nq = min(HQ, qpk - h0);
  const int pos = positions[b];
  const int kv_len = kv_lens[b];
  const int split_keys = pages_per_split * Bk;
  const int s_lo = split * split_keys;
  const int s_hi = (split == n_splits - 1) ? 0x7fffffff : s_lo + split_keys;
  const size_t layer_off = (size_t)layer * N * Hkv * Bk * D;
  T* kl = kpool + layer_off;
  T* vl = vpool + layer_off;
  bf16* ksl = kInt8 ? kscale + (size_t)layer * N * Bk : nullptr;
  bf16* vsl = kInt8 ? vscale + (size_t)layer * N * Bk : nullptr;
  const int* table = tables + (size_t)b * M;

  // ---- 1. the split that holds pos's page writes the new row
  const int wpage = pos >= 0 ? min(pos / Bk, M - 1) : -1;
  const bool writes = pos >= 0 && min(wpage / pages_per_split, n_splits - 1) == split;
  float new_ks = 1.f, new_vs = 1.f;   // int8: this block's copy of the new token's scales
  if (writes) {
    const int page = table[wpage];
    const size_t dst = (((size_t)page * Hkv + g) * Bk + pos % Bk) * D;
    const size_t src = ((size_t)b * Hkv + g) * D;
    const bool store = hg == 0;
    if constexpr (kInt8) {
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
        sNewK[d] = static_cast<int8_t>(max(-127, min(127, ck)));
        sNewV[d] = static_cast<int8_t>(max(-127, min(127, cv)));
        if (store) {
          kl[dst + d] = sNewK[d];
          vl[dst + d] = sNewV[d];
        }
      }
      if (store && g == 0 && tid == 0) {
        ksl[(size_t)page * Bk + pos % Bk] = __float2bfloat16_rn(new_ks);
        vsl[(size_t)page * Bk + pos % Bk] = __float2bfloat16_rn(new_vs);
      }
    } else {
      for (int d = tid; d < D; d += kThreads) {
        if constexpr (std::is_same<T, fp8>::value) {
          sNewK[d] = paged::to_fp8(__bfloat162float(new_k[src + d]));
          sNewV[d] = paged::to_fp8(__bfloat162float(new_v[src + d]));
        } else {
          sNewK[d] = new_k[src + d];
          sNewV[d] = new_v[src + d];
        }
        if (store) {
          kl[dst + d] = sNewK[d];
          vl[dst + d] = sNewV[d];
        }
      }
    }
  }

  // ---- 2. this split's share [klo, khi) of the visible keys [lo, hi)
  int lo = 0, hi = 0;
  if (pos >= 0) paged::visible_range(pos, kv_len, window, &lo, &hi);
  const int klo = max(lo, s_lo);
  const int khi = min(hi, s_hi);
  if (pos < 0 || khi <= klo || nq <= 0) return;   // the merge reads no state of this split
  const int skip = writes ? pos : -1;             // the slot taken from sNewK/sNewV

  // ---- the query tile: the group's nq heads, rows nq..15 zero
  for (int i = tid; i < HQ * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int dv = i % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nq) {
      val = *reinterpret_cast<const uint4*>(q + ((size_t)b * Nh + g * qpk + h0 + r) * D + dv * 8);
    }
    *reinterpret_cast<uint4*>(sQ + r * DP + dv * 8) = val;
  }

  const T* klc = kl;
  const T* vlc = vl;
  auto issue = [&](int i) {
    const int c0 = klo + i * KC;
    const int st = i % kStages;
    if constexpr (kConv) {
      paged::issue_kv<kThreads, D, T>(rK + st * KC * D, rV + st * KC * D, D, klc, vlc, c0, KC,
                                      klo, khi, skip, table, M, Hkv, g, Bk);
    } else {
      paged::issue_kv<kThreads, D, T>(sK + st * KC * DP, sV + st * KC * DP, DP, klc, vlc, c0,
                                      KC, klo, khi, skip, table, M, Hkv, g, Bk);
    }
  };
  // int8: the scales of key klo + i * KC + tid (0 outside the split's keys,
  // so that masked slots dequantize to exact zeros)
  auto scales = [&](int i, float* ks, float* vs) {
    *ks = 0.f;
    *vs = 0.f;
    const int j = klo + i * KC + tid;
    if (!kInt8 || tid >= KC || j >= khi) return;
    if (j == skip) {
      *ks = new_ks;
      *vs = new_vs;
      return;
    }
    const size_t at = paged::page_slot(table, j, M, Bk);
    *ks = __bfloat162float(ksl[at]);
    *vs = __bfloat162float(vsl[at]);
  };

  // each warp: 16 query rows (rows g and g + 8 of this thread) over its own
  // 8 keys of every chunk, with its own online softmax; S, P and O stay in
  // registers and the 4 warps merge once at the end
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int kw = warp * 8;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  uint32_t qf[D / 16][4];

  // the ring: chunks 0 .. kStages - 2 in flight before the first wait; one
  // commit group per chunk slot, empty past the last chunk
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
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        paged::ldsm_x4(qf[kk], sQ + (lane & 15) * DP + kk * 16 + (lane >> 4) * 8);
      }
    }
    const int nxt = i + kStages - 1;
    if (nxt < nchunks) {
      issue(nxt);
      scales(nxt, &nxt_ks, &nxt_vs);   // stored after this chunk's compute
    }
    paged::cp_async_commit();
    const int c0 = klo + i * KC;
    bf16* kb = sK;
    bf16* vb = sV;
    if constexpr (kConv) {
      // codes -> bf16 for the tensor cores, exactly: an int8 code is an
      // integer of at most 8 bits (its scale is applied to S and to P below),
      // an e4m3 code upcasts exactly; the new token's slot comes from this
      // block's own copy of the row
      const T* ck = rK + st * KC * D;
      const T* cv = rV + st * KC * D;
      for (int e = tid; e < KC * (D / 8); e += kThreads) {
        const int c = e / (D / 8);
        const int dv = e % (D / 8);
        const bool fresh = c0 + c == skip;
        *reinterpret_cast<uint4*>(sK + c * DP + dv * 8) =
            paged::to_bf16x8((fresh ? sNewK : ck + c * D) + dv * 8, 1.f);
        *reinterpret_cast<uint4*>(sV + c * DP + dv * 8) =
            paged::to_bf16x8((fresh ? sNewV : cv + c * D) + dv * 8, 1.f);
      }
      __syncthreads();
    } else {
      kb = sK + st * KC * DP;
      vb = sV + st * KC * DP;
      if (skip >= c0 && skip < c0 + KC) {   // block-uniform: the new token's slot
        const int c = skip - c0;
        for (int dv = tid; dv < D / 8; dv += kThreads) {
          *reinterpret_cast<uint4*>(kb + c * DP + dv * 8) =
              *reinterpret_cast<const uint4*>(sNewK + dv * 8);
          *reinterpret_cast<uint4*>(vb + c * DP + dv * 8) =
              *reinterpret_cast<const uint4*>(sNewV + dv * 8);
        }
        __syncthreads();
      }
    }

    // ---- S = Q K^T: 16 rows x the warp's 8 keys (two accumulation chains;
    // D is a multiple of 32: one x4 ldmatrix covers 32 columns)
    float s0[4] = {0.f, 0.f, 0.f, 0.f};
    float s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk2 = 0; kk2 < D / 32; ++kk2) {
      uint32_t bk[4];
      paged::ldsm_x4(bk, kb + (kw + (lane & 7)) * DP + kk2 * 32 + (lane >> 3) * 8);
      paged::mma16816(s0, qf[2 * kk2], bk[0], bk[1]);
      paged::mma16816(s1, qf[2 * kk2 + 1], bk[2], bk[3]);
    }

    // ---- online softmax per row over the warp's keys (quad shuffles); an
    // int8 key's scale multiplies its scores here, in f32
    float ksc[2] = {scale_log2, scale_log2};
    float vsc[2] = {1.f, 1.f};
    if constexpr (kInt8) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ksc[e] *= sSc[(st * 2) * KC + kw + 2 * t4 + e];
        vsc[e] = sSc[(st * 2 + 1) * KC + kw + 2 * t4 + e];
      }
    }
    float sv[4];
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = c0 + kw + 2 * t4 + e;
        const float x = (j < khi) ? (s0[hf * 2 + e] + s1[hf * 2 + e]) * ksc[e] : kNegInf;
        sv[hf * 2 + e] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      alpha[hf] = exp2f(m[hf] - m_new);
      m[hf] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = sv[hf * 2 + e];
        const float p = x == kNegInf ? 0.f : exp2f(x - m_new);
        sv[hf * 2 + e] = p;
        sum += p;
      }
      l[hf] = l[hf] * alpha[hf] + sum;
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {   // x 1 is exact
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // ---- O += P V over the warp's 8 keys (m16n8k8); P, times an int8
    // key's V scale, is rounded to bf16 — the only rounding of the read
    const uint32_t a0 = paged::pack_bf16(sv[0] * vsc[0], sv[1] * vsc[1]);
    const uint32_t a1 = paged::pack_bf16(sv[2] * vsc[0], sv[3] * vsc[1]);
#pragma unroll
    for (int n4 = 0; n4 < D / 32; ++n4) {
      uint32_t bv[4];
      paged::ldsm_x4_t(bv, vb + (kw + (lane & 7)) * DP + n4 * 32 + (lane >> 3) * 8);
#pragma unroll
      for (int x = 0; x < 4; ++x) paged::mma1688(o[4 * n4 + x], a0, a1, bv[x]);
    }
    if (kInt8 && nxt < nchunks && tid < KC) {
      // chunk nxt's slot was last read by chunk i - 1, before this
      // iteration's first barrier; it is next read after chunk nxt's
      sSc[((nxt % kStages) * 2) * KC + tid] = nxt_ks;
      sSc[((nxt % kStages) * 2 + 1) * KC + tid] = nxt_vs;
    }
  }

  // ---- merge the warps (fixed order) into this split's partial state
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
  }
  paged::cp_async_wait<0>();
  __syncthreads();   // the ring is free: it now holds the warps' outputs
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = gq + hf * 8;
    if (r >= nq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(sO + (warp * HQ + r) * D + n * 8 + 2 * t4) =
          make_float2(o[n][hf * 2], o[n][hf * 2 + 1]);
    }
    if (t4 == 0) {
      sML[(warp * 2) * HQ + r] = m[hf];
      sML[(warp * 2 + 1) * HQ + r] = l[hf];
    }
  }
  __syncthreads();
  const size_t row0 = (size_t)b * Nh + g * qpk + h0;
  for (int i = tid; i < nq * D; i += kThreads) {
    const int h = i / D;
    const int d = i % D;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sML[(w * 2) * HQ + h]);
    float lb = 0.f, ob = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sML[(w * 2) * HQ + h] - mb);
      lb += sML[(w * 2 + 1) * HQ + h] * f;
      ob += sO[(w * HQ + h) * D + d] * f;
    }
    const size_t at = (row0 + h) * n_splits + split;
    ws_o[at * D + d] = ob;
    if (d == 0) {
      ws_ml[at * 2] = mb;
      ws_ml[at * 2 + 1] = lb;
    }
  }
}

template <int D, typename T>
int launch(const bf16* q, const bf16* new_k, const bf16* new_v, T* kpool, T* vpool,
           bf16* kscale, bf16* vscale, const int* tables, const int* positions,
           const int* kv_lens, bf16* out, float* ws_o, float* ws_ml, int B, int Nh, int Hkv,
           int N, int Bk, int M, int layer, int window, int pages_per_split, int n_splits,
           float scale, cudaStream_t stream) {
  using C = Cfg<D, T>;
  const int qpk = Nh / Hkv;
  const int groups = (qpk + C::HQ - 1) / C::HQ;
  const size_t smem = C::bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_split_kernel<D, T><<<dim3(B, Hkv * groups, n_splits), kThreads, smem, stream>>>(
      q, new_k, new_v, kpool, vpool, kscale, vscale, tables, positions, kv_lens, ws_o, ws_ml,
      layer, N, Nh, Hkv, Bk, M, window, pages_per_split, n_splits, groups,
      scale * paged::kLog2e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return paged::launch_merge<D>(ws_o, ws_ml, positions, kv_lens, out, B, Nh, n_splits,
                                pages_per_split * Bk, window, stream);
}

template <typename T>
int dispatch(const void* q, const void* new_k, const void* new_v, void* k_pool, void* v_pool,
             void* k_scale, void* v_scale, const int32_t* tables, const int32_t* positions,
             const int32_t* kv_lens, void* out, int B, int Nh, int Hkv, int D, int L, int N,
             int Bk, int M, int layer, int window, float scale, void* ws_o, void* ws_ml,
             int pages_per_split, int n_splits, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Nh % Hkv != 0 || layer < 0 || layer >= L || Bk <= 0 || M <= 0 ||
      pages_per_split <= 0 || n_splits <= 0 || (long)pages_per_split * n_splits < M) {
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
  float* wo = static_cast<float*>(ws_o);
  float* wml = static_cast<float*>(ws_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32, T>(qq, nk, nv, kp, vp, ks, vs, tables, positions, kv_lens, o, wo, wml, B,
                           Nh, Hkv, N, Bk, M, layer, window, pages_per_split, n_splits, scale,
                           st);
    case 64:
      return launch<64, T>(qq, nk, nv, kp, vp, ks, vs, tables, positions, kv_lens, o, wo, wml, B,
                           Nh, Hkv, N, Bk, M, layer, window, pages_per_split, n_splits, scale,
                           st);
    case 128:
      return launch<128, T>(qq, nk, nv, kp, vp, ks, vs, tables, positions, kv_lens, o, wo, wml,
                            B, Nh, Hkv, N, Bk, M, layer, window, pages_per_split, n_splits,
                            scale, st);
    case 256:
      return launch<256, T>(qq, nk, nv, kp, vp, ks, vs, tables, positions, kv_lens, o, wo, wml,
                            B, Nh, Hkv, N, Bk, M, layer, window, pages_per_split, n_splits,
                            scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points (loaded with ctypes), one per pool element type. All
// tensors contiguous on the current device; the stacked pools (and, for an
// int8 pool, the stacked [L, N, Bk] bf16 scale pools; null otherwise) are
// updated in place. `window` <= 0 means full causal attention. `ws_o`
// ([B, Nh, n_splits, D] f32) and `ws_ml` ([B, Nh, n_splits, 2] f32) are the
// workspace of the split plan (`pages_per_split` pages a split, `n_splits`
// splits covering the M table entries). Two launches on `stream`, no
// synchronisation. Returns the CUDA error code of the launches (0 = success).
#define DECODE_ENTRY(NAME, T, NEEDS_SCALE)                                                      \
  extern "C" int NAME(const void* q, const void* new_k, const void* new_v, void* k_pool,      \
                      void* v_pool, void* k_scale, void* v_scale, const int32_t* tables,      \
                      const int32_t* positions, const int32_t* kv_lens, void* out, int B,     \
                      int Nh, int Hkv, int D, int L, int N, int Bk, int M, int layer,         \
                      int window, float scale, void* ws_o, void* ws_ml, int pages_per_split,  \
                      int n_splits, void* stream) {                                           \
    if (NEEDS_SCALE != (k_scale != nullptr && v_scale != nullptr)) {                          \
      return (int)cudaErrorInvalidValue;                                                      \
    }                                                                                         \
    return dispatch<T>(q, new_k, new_v, k_pool, v_pool, k_scale, v_scale, tables, positions,  \
                       kv_lens, out, B, Nh, Hkv, D, L, N, Bk, M, layer, window, scale, ws_o,  \
                       ws_ml, pages_per_split, n_splits, stream);                             \
  }

DECODE_ENTRY(paged_decode_fused_bf16, bf16, false)
DECODE_ENTRY(paged_decode_fused_int8, int8_t, true)
DECODE_ENTRY(paged_decode_fused_fp8, fp8, false)
