// Weight-only quantized matmul for Hopper (sm_90a): bf16 activations times
// int8 or fp8 (e4m3) weight codes with one f32 scale per output channel.
//
//   out[M, N] = bf16( (x[M, K] @ bf16(qw[layer][K, N])) * scale[layer][N] )
//
// Replaces the Pallas TPU kernel `_qmm_kernel`, reached through
// `qmm_stacked_pallas` in distributed_gpu_inference_tpu/ops/qmm_pallas.py.
// Like it, the kernel takes the stacked [L, K, N] codes and a layer index,
// accumulates in f32 and applies the scale once, to the finished sum.
//
// What bounds it: at decode row counts (M of 1 to a few dozen) each code is
// used M times, far below the H100's ratio of operations to bytes, so the
// kernel is bound by the bytes of the codes, one byte per weight (one
// llama3-8b layer: 218 MB, 0.0655 ms at 3.35 TB/s). At that rate an SM
// takes in 14.5 codes a clock, and whatever it does per code has to fit.
//
// - A ring of QMM_STAGES stages of QMM_BK K-rows x 128 columns in dynamic
//   shared memory, filled with cp.async (paged_common.cuh): the codes
//   travel as one byte each and are widened only after they have arrived,
//   the activations as they are. While a stage is consumed the copies of
//   the next QMM_STAGES - 1 stages stay in flight: 3 x 64 rows, 16 KB of
//   codes a block, two to three blocks an SM at the large projections
//   (32-48 KB an SM; wk/wv, 4 MB each, fill one block an SM). Each
//   thread's copy addresses are set up once a block (`Feed`); a stage only
//   moves them down. A block owns 128 output columns and one row group; K
//   is split across blocks so that the grid covers the 132 SMs, and the
//   plan (ops/qmm.py `split_plan`) gives every split at least QMM_STAGES
//   stages wherever K allows.
// - Up to 16 rows (decode), the codes go from shared memory straight into
//   mma.sync m16n8k16 fragments, one barrier a stage: the weights are the
//   16-row operand (16 output columns) and the activations the 8-wide one,
//   so M = 8 is not padded to 16. Warp w owns columns 32w..32w+31 over the
//   split's whole K range; its thread (g, t) loads 4 bytes (columns 4g..)
//   of K rows 4t..4t+3 of each 16-row step and feeds two products. The
//   mma's K slots {2t, 2t+1, 2t+8, 2t+9} are mapped to K rows 4t..4t+3 in
//   both operands, so one 8-byte load gives a thread its activations, and
//   each thread ends with whole sums for 2 rows x 4 columns, stored as two
//   float4 without passing through shared memory. Ring rows are
//   XOR-swizzled in 16-byte chunks so that these loads hit 32 distinct
//   banks. Above 16 rows, each stage is widened once into a bf16 tile that
//   wmma 16x16x16 fragments read (two barriers a stage).
// - Widening is exact and avoids the I2F and F2F conversion units (16
//   results a clock an SM): an int8 pair is built as bf16 128 + (c & 127)
//   and 128 + (c & 128) by a byte permute and a mask, and one bf16x2
//   subtraction gives both codes; e4m3 pairs take the paired e4m3 -> f16
//   conversion, then f32 to bf16. The only rounding is the last.
// - One launch a call. Each split writes its f32 partial tile to a
//   workspace; after a barrier, one thread counts the block in the tile's
//   int32 arrival counter with an acquire-release atomic (which publishes
//   the partials). The block that arrives last sums the tile's partials in
//   split order, applies the scale, rounds once to bf16 and resets the
//   counter to 0, so two calls give the same bits whichever split arrives
//   last. With one split the block finishes its tile itself.
//   The workspace and the counters are scratch that the wrapper keeps per
//   device. Calls on one stream are serialized, and the scratch assumes
//   that: two calls running at once on two streams would share it.
//
// Measured (chip_smoke.py phase 9, PERF.md): one layer's seven projections
// at M = 8 as a CUDA graph, against the first version of this kernel
// (register-staged one-stage loads and a second reduction launch), and the
// sweep of ring depths and stage heights that chose the defaults. Tried in
// development and rejected: the ring with a widened bf16 copy of every
// stage at all row counts (slower than the first version: two passes
// through shared memory per code); warps splitting K with a cross-warp sum
// in shared memory; fences in every thread around the arrival; copy
// addresses recomputed every stage (mostly integer instructions around a
// handful of mma); programmatic dependent launch warming L2 for the next
// projection (no steady gain).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "paged_common.cuh"

#ifndef QMM_STAGES
#define QMM_STAGES 3
#endif
#ifndef QMM_BK
#define QMM_BK 64
#endif

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kStages = QMM_STAGES;        // ring depth
constexpr int kBK = QMM_BK;                // K rows a stage
constexpr int kBN = 128;                   // output columns a block (8 chunks of 16 B a row)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdX = kBK + 16;             // padded activation rows (bf16 elements)
constexpr int kLdW = kBN + 8;              // padded widened rows (bf16 elements)
constexpr int kCodeVecs = kBK * kBN / 16;  // 16-byte code vectors a stage
constexpr int kMaxSmem = 232448;           // what a block may ask for on an H100
static_assert(kStages >= 2, "the ring needs two stages");
static_assert(kBK % 16 == 0, "whole 16-row K steps");

// dynamic shared memory of one block: the ring (codes, then BM activation
// rows a stage), then for the wmma path the widened stage and 4 epilogue
// tiles
template <int BM, bool DIRECT>
struct Smem {
  static constexpr size_t kCodes = (size_t)kStages * kBK * kBN;
  static constexpr size_t kX = (size_t)kStages * BM * kLdX * 2;
  static constexpr size_t kW = DIRECT ? 0 : (size_t)kBK * kLdW * 2;
  static constexpr size_t kC = DIRECT ? 0 : (size_t)kWarps * 16 * 16 * 4;
  static constexpr size_t kBytes = kCodes + kX + kW + kC;
};

// the 16-byte chunk where chunk c of ring row r is kept: rows 4 apart take
// different chunks, so the direct path's loads (rows 4t + j, words 4w + g of
// the row) hit 32 distinct banks
__device__ __forceinline__ int swz(int r, int c) { return c ^ (((r >> 2) & 3) << 1); }

struct Int8Codes {};
struct Fp8Codes {};

// pairs(lo, hi)[b] = bf16x2 {code b of lo, code b of hi}, b = 0..3
__device__ __forceinline__ void pairs(Int8Codes, uint32_t lo, uint32_t hi, uint32_t* p) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t two = __byte_perm(lo, hi, b | (b << 4) | ((4 + b) << 8) | ((4 + b) << 12));
    // 128 + (c & 127) and 128 + (c & 128) as bf16; their difference is c
    const uint32_t v = (two & 0x007F007Fu) | 0x43004300u;
    const uint32_t m = (two & 0x00800080u) | 0x43004300u;
    const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                     *reinterpret_cast<const __nv_bfloat162*>(&m));
    p[b] = *reinterpret_cast<const uint32_t*>(&d);
  }
}

__device__ __forceinline__ void pairs(Fp8Codes, uint32_t lo, uint32_t hi, uint32_t* p) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t two = __byte_perm(lo, hi, b | ((4 + b) << 4));
    const __half2 h = __half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(two & 0xFFFFu), __NV_E4M3));
    const __nv_bfloat162 d = __float22bfloat162_rn(__half22float2(h));
    p[b] = *reinterpret_cast<const uint32_t*>(&d);
  }
}

// 16 codes (one 16-byte vector) -> 16 bf16 at dst
template <typename Codes>
__device__ __forceinline__ void convert16(const uint4& raw, bf16* dst) {
  uint32_t lo[4], hi[4];
  pairs(Codes{}, raw.x, raw.y, lo);   // {c0, c4}, {c1, c5}, {c2, c6}, {c3, c7}
  pairs(Codes{}, raw.z, raw.w, hi);
  // lo[b] = {c_b, c_4+b}, hi[b] = {c_8+b, c_12+b}: regroup into element order
  uint32_t o[8];
  o[0] = __byte_perm(lo[0], lo[1], 0x5410);   // {c0, c1}
  o[1] = __byte_perm(lo[2], lo[3], 0x5410);   // {c2, c3}
  o[2] = __byte_perm(lo[0], lo[1], 0x7632);   // {c4, c5}
  o[3] = __byte_perm(lo[2], lo[3], 0x7632);   // {c6, c7}
  o[4] = __byte_perm(hi[0], hi[1], 0x5410);
  o[5] = __byte_perm(hi[2], hi[3], 0x5410);
  o[6] = __byte_perm(hi[0], hi[1], 0x7632);
  o[7] = __byte_perm(hi[2], hi[3], 0x7632);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// One thread's share of the ring's copies, fixed for the block: where its
// code and activation vectors start (stage 0) and where they land in a ring
// slot; stage j only moves the sources j * kBK rows down. Codes go into
// swizzled 128-byte rows, BM activation rows into kLdX rows; rows past the
// split's end and past M are zero-filled without a read.
template <int BM>
struct Feed {
  static constexpr int kCodeRows = kThreads / (kBN / 16);       // code rows a pass
  static constexpr int kCodePasses = kCodeVecs / kThreads;
  static constexpr int kXVecs = BM * kBK / 8;
  static constexpr int kXRows = kThreads / (kBK / 8);            // activation rows a pass
  static constexpr int kXPasses = (kXVecs + kThreads - 1) / kThreads;
  static_assert(kThreads % (kBK / 8) == 0, "whole activation rows a pass");

  const uint8_t* code_src;
  const bf16* x_src;
  int code_dst, code_row, x_dst, x_row, x_col, rows_m;
  bool col_ok;

  __device__ __forceinline__ Feed(const uint8_t* qw, const bf16* x, int k_begin, int n0, int m0,
                                  int M, int K, int N) {
    const int c = threadIdx.x % (kBN / 16);
    code_row = threadIdx.x / (kBN / 16);
    col_ok = n0 + 16 * c < N;
    code_src = qw + (size_t)(k_begin + code_row) * N + n0 + 16 * c;
    code_dst = code_row * kBN + 16 * swz(code_row, c);   // the same chunk in every pass
    x_row = threadIdx.x / (kBK / 8);
    x_col = (threadIdx.x % (kBK / 8)) * 8;
    x_src = x + (size_t)(m0 + x_row) * K + k_begin + x_col;
    x_dst = x_row * kLdX + x_col;
    rows_m = M - m0;
  }

  // stage j into a slot; rows_left = K rows from the stage's first to the
  // split's end
  __device__ __forceinline__ void issue(uint8_t* codes_slot, bf16* x_slot,
                                        const uint8_t* __restrict__ qw,
                                        const bf16* __restrict__ x, int j, int rows_left, int K,
                                        int N) const {
    const uint8_t* cs = code_src + (size_t)j * kBK * N;
#pragma unroll
    for (int p = 0; p < kCodePasses; ++p) {
      const bool ok = col_ok && code_row + p * kCodeRows < rows_left;
      paged::cp_async16(codes_slot + code_dst + p * kCodeRows * kBN,
                        ok ? cs + (size_t)p * kCodeRows * N : qw, ok);
    }
    const bf16* xs = x_src + j * kBK;
#pragma unroll
    for (int p = 0; p < kXPasses; ++p) {
      if (kXVecs % kThreads == 0 || (int)threadIdx.x + p * kThreads < kXVecs) {
        const bool ok = x_row + p * kXRows < rows_m && x_col < rows_left;
        paged::cp_async16(x_slot + x_dst + p * kXRows * kLdX,
                          ok ? xs + (size_t)p * kXRows * K : x, ok);
      }
    }
  }
};

// After every thread of the block has written its share of the split's
// partial tile (splits > 1): count the block in the tile's arrival counter;
// the last split sums the tile's partials in split order, scales, rounds
// and writes the output rows [m0, m0 + BM) x columns [n0, n0 + kBN).
template <int BM>
__device__ __forceinline__ void finish_tile(const float* __restrict__ ws,
                                            int* __restrict__ counters,
                                            const float* __restrict__ scale,
                                            bf16* __restrict__ out, int M, int N, int n0, int m0,
                                            int splits) {
  __shared__ int s_last;
  // the barrier orders the block's partial stores before thread 0's count,
  // an acquire-release atomic at GPU scope: it publishes them to the split
  // that counts last, and that split's acquire makes every split's partials
  // visible to its block past the second barrier (the split-K semaphore of
  // CUTLASS, with the fence folded into the atomic)
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(counter) : "memory");
    const int last = prev == splits - 1;
    if (last) *counter = 0;   // every split has counted: ready for the next call
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;
  // four columns a thread at a time; the loads of up to 8 splits are issued
  // together, then added in split order
  const int rows = min(BM, M - m0);
  const size_t stride = (size_t)M * N;
  for (int idx = threadIdx.x; idx < rows * (kBN / 4); idx += kThreads) {
    const int m = m0 + idx / (kBN / 4);
    const int n = n0 + (idx % (kBN / 4)) * 4;
    if (n >= N) continue;   // N is a multiple of 16: a group is all in or all out
    const float* src = ws + (size_t)m * N + n;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < splits; sp0 += 8) {
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (sp0 + j < splits) v[j] = __ldcg(reinterpret_cast<const float4*>(src + (sp0 + j) * stride));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (sp0 + j < splits) {
          s.x += v[j].x;
          s.y += v[j].y;
          s.z += v[j].z;
          s.w += v[j].w;
        }
      }
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n);
    o[0] = __floats2bfloat162_rn(s.x * __ldg(scale + n), s.y * __ldg(scale + n + 1));
    o[1] = __floats2bfloat162_rn(s.z * __ldg(scale + n + 2), s.w * __ldg(scale + n + 3));
  }
}

// ---------------------------------------------------------------- M <= 16
// MG groups of 8 rows; one row group (16 rows) a block; warp w owns columns
// [32w, 32w + 32) of the block over the split's whole K range
template <typename Codes, int MG>
__global__ void __launch_bounds__(kThreads)
qmm_direct(const bf16* __restrict__ x, const uint8_t* __restrict__ qw,
           const float* __restrict__ scale, bf16* __restrict__ out, float* __restrict__ ws,
           int* __restrict__ counters, int M, int K, int N, int k_per_split, int splits) {
  constexpr int BM = 8 * MG;
  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* ring_codes = smem;
  bf16* ring_x = reinterpret_cast<bf16*>(smem + Smem<BM, true>::kCodes);

  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_stages = (k_end - k_begin + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const Feed<BM> feed(qw, x, k_begin, n0, 0, M, K, N);
  // this thread's four columns: 32 warp + 4g + 0..3, byte 4 (g & 3) of chunk
  // 2 warp + g / 4; for K rows 4t + j of a step that chunk is swizzled by 2t
  const int code_ld = 4 * t * kBN + 16 * ((2 * warp + (g >> 2)) ^ (2 * t)) + 4 * (g & 3);
  const int x_ld = g * kLdX + 4 * t;

  // acc[mg][h] = {(2t, 2h), (2t + 1, 2h), (2t, 2h + 1), (2t + 1, 2h + 1)}: (row of
  // the group, column 4g + .) of the m16n8k16 product h
  float acc[MG][2][4];
#pragma unroll
  for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mg][h][e] = 0.f;
    }
  }

  constexpr int kSlotCodes = kBK * kBN;
  constexpr int kSlotX = BM * kLdX;
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_stages) {
      feed.issue(ring_codes + j * kSlotCodes, ring_x + j * kSlotX, qw, x, j,
                 k_end - k_begin - j * kBK, K, N);
    }
    paged::cp_async_commit();   // one group a stage, empty past the end
  }
  int rd = 0, wr = kStages - 1;   // ring slots of stage i and of stage i + kStages - 1
  for (int i = 0; i < n_stages; ++i) {
    paged::cp_async_wait<kStages - 2>();   // stage i has landed (this thread's copies)
    __syncthreads();                       // ... everyone's; slot wr (stage i - 1) is free
    const int next = i + kStages - 1;
    if (next < n_stages) {
      feed.issue(ring_codes + wr * kSlotCodes, ring_x + wr * kSlotX, qw, x, next,
                 k_end - k_begin - next * kBK, K, N);
    }
    paged::cp_async_commit();
    const uint8_t* sc = ring_codes + rd * kSlotCodes + code_ld;
    const bf16* xs = ring_x + rd * kSlotX + x_ld;
    rd = rd + 1 == kStages ? 0 : rd + 1;
    wr = wr + 1 == kStages ? 0 : wr + 1;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t L[4];   // K rows kk + 4t + j of this thread's four columns
#pragma unroll
      for (int j = 0; j < 4; ++j) L[j] = *reinterpret_cast<const uint32_t*>(sc + (kk + j) * kBN);
      uint32_t b[MG][2];
#pragma unroll
      for (int mg = 0; mg < MG; ++mg) {
        const uint2 xv = *reinterpret_cast<const uint2*>(xs + mg * 8 * kLdX + kk);
        b[mg][0] = xv.x;   // K rows 4t, 4t + 1 of row mg * 8 + g
        b[mg][1] = xv.y;   // K rows 4t + 2, 4t + 3
      }
      uint32_t p01[4], p23[4];
      pairs(Codes{}, L[0], L[1], p01);   // {K row 4t, 4t + 1} of column 4g + b
      pairs(Codes{}, L[2], L[3], p23);   // {K row 4t + 2, 4t + 3}
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // product h: A rows g / g + 8 are columns 4g + 2h / 4g + 2h + 1
        const uint32_t a[4] = {p01[2 * h], p01[2 * h + 1], p23[2 * h], p23[2 * h + 1]};
#pragma unroll
        for (int mg = 0; mg < MG; ++mg) paged::mma16816(acc[mg][h], a, b[mg][0], b[mg][1]);
      }
    }
  }

  // ---- each thread's sums: rows mg * 8 + 2t (+ 1), four columns from n
  const int n = n0 + 32 * warp + 4 * g;
  float* part = ws + (size_t)split * M * N;
#pragma unroll
  for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int m = mg * 8 + 2 * t + rr;
      if (m >= M || n >= N) continue;
      const float4 v = make_float4(acc[mg][0][rr], acc[mg][0][rr + 2], acc[mg][1][rr],
                                   acc[mg][1][rr + 2]);
      if (splits == 1) {
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n);
        o[0] = __floats2bfloat162_rn(v.x * __ldg(scale + n), v.y * __ldg(scale + n + 1));
        o[1] = __floats2bfloat162_rn(v.z * __ldg(scale + n + 2), v.w * __ldg(scale + n + 3));
      } else {
        *reinterpret_cast<float4*>(part + (size_t)m * N + n) = v;
      }
    }
  }
  if (splits > 1) finish_tile<BM>(ws, counters, scale, out, M, N, n0, 0, splits);
}

// ----------------------------------------------------------------- M > 16
// MT 16-row tiles a row group; the stage is widened into sW for wmma
template <typename Codes, int MT>
__global__ void __launch_bounds__(kThreads)
qmm_wmma(const bf16* __restrict__ x, const uint8_t* __restrict__ qw,
         const float* __restrict__ scale, bf16* __restrict__ out, float* __restrict__ ws,
         int* __restrict__ counters, int M, int K, int N, int k_per_split, int splits) {
  constexpr int BM = 16 * MT;
  using S = Smem<BM, false>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* ring_codes = smem;
  bf16* ring_x = reinterpret_cast<bf16*>(smem + S::kCodes);
  bf16* sW = reinterpret_cast<bf16*>(smem + S::kCodes + S::kX);
  float* sC = reinterpret_cast<float*>(smem + S::kCodes + S::kX + S::kW);

  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * BM;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_stages = (k_end - k_begin + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    wmma::fill_fragment(acc[mt][0], 0.f);
    wmma::fill_fragment(acc[mt][1], 0.f);
  }

  const Feed<BM> feed(qw, x, k_begin, n0, m0, M, K, N);
  // this thread's widening: code vectors of the feed's rows, into sW
  const int w_dst = feed.code_row * kLdW + 16 * (threadIdx.x % (kBN / 16));
  constexpr int kSlotCodes = kBK * kBN;
  constexpr int kSlotX = BM * kLdX;
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_stages) {
      feed.issue(ring_codes + j * kSlotCodes, ring_x + j * kSlotX, qw, x, j,
                 k_end - k_begin - j * kBK, K, N);
    }
    paged::cp_async_commit();
  }
  int rd = 0, wr = kStages - 1;
  for (int i = 0; i < n_stages; ++i) {
    paged::cp_async_wait<kStages - 2>();
    __syncthreads();   // slot wr and sW are free
    const int next = i + kStages - 1;
    if (next < n_stages) {
      feed.issue(ring_codes + wr * kSlotCodes, ring_x + wr * kSlotX, qw, x, next,
                 k_end - k_begin - next * kBK, K, N);
    }
    paged::cp_async_commit();
    const uint8_t* sc = ring_codes + rd * kSlotCodes + feed.code_dst;
    const bf16* xs = ring_x + rd * kSlotX;
    rd = rd + 1 == kStages ? 0 : rd + 1;
    wr = wr + 1 == kStages ? 0 : wr + 1;
#pragma unroll
    for (int p = 0; p < Feed<BM>::kCodePasses; ++p) {
      convert16<Codes>(*reinterpret_cast<const uint4*>(sc + p * Feed<BM>::kCodeRows * kBN),
                       sW + w_dst + p * Feed<BM>::kCodeRows * kLdW);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b0, b1;
      wmma::load_matrix_sync(b0, sW + kk * 16 * kLdW + warp * 32, kLdW);
      wmma::load_matrix_sync(b1, sW + kk * 16 * kLdW + warp * 32 + 16, kLdW);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + mt * 16 * kLdX + kk * 16, kLdX);
        wmma::mma_sync(acc[mt][0], a, b0, acc[mt][0]);
        wmma::mma_sync(acc[mt][1], a, b1, acc[mt][1]);
      }
    }
  }

  // ---- this split's tile: the output itself (one split) or its partial
  float* part = ws + (size_t)split * M * N;
  float* stage = sC + warp * 256;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      wmma::store_matrix_sync(stage, acc[mt][nt], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane + 32 * e;
        const int m = m0 + mt * 16 + idx / 16;
        const int n = n0 + warp * 32 + nt * 16 + idx % 16;
        if (m < M && n < N) {
          if (splits == 1) {
            out[(size_t)m * N + n] = __float2bfloat16_rn(stage[idx] * __ldg(scale + n));
          } else {
            part[(size_t)m * N + n] = stage[idx];
          }
        }
      }
      __syncwarp();
    }
  }
  if (splits > 1) finish_tile<BM>(ws, counters, scale, out, M, N, n0, m0, splits);
}

using Kernel = void (*)(const bf16*, const uint8_t*, const float*, bf16*, float*, int*, int, int,
                        int, int, int);

// launch one instantiation (ID: which of the four, per code type) with
// `smem` bytes of dynamic shared memory over `row_groups` groups of rows
template <typename Codes, int ID>
int launch_kernel(Kernel kernel, size_t smem, int row_groups, const bf16* x, const uint8_t* qw,
                  const float* scale, bf16* out, float* ws, int* counters, int M, int K, int N,
                  int splits, int k_per_split, cudaStream_t stream) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  // above 48 KB dynamic shared memory must be asked for, once a device
  static bool asked[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!asked[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    asked[dev] = true;
  }
  dim3 grid((N + kBN - 1) / kBN, splits, row_groups);
  kernel<<<grid, kThreads, smem, stream>>>(x, qw, scale, out, ws, counters, M, K, N, k_per_split,
                                           splits);
  return (int)cudaGetLastError();
}

template <typename Codes>
int launch(const void* x, const void* qw, const float* scale, void* out, void* ws, int M, int K,
           int N, int L, int layer, int splits, int k_per_split, void* counters, void* stream) {
  if (M <= 0) return 0;
  if (K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0 || layer < 0 || layer >= L ||
      splits < 1 || k_per_split <= 0 || k_per_split % kBK != 0 ||
      (long long)splits * k_per_split < K || (long long)(splits - 1) * k_per_split >= K ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const bf16* xx = static_cast<const bf16*>(x);
  const uint8_t* q = static_cast<const uint8_t*>(qw) + (size_t)layer * K * N;
  const float* s = scale + (size_t)layer * N;
  bf16* o = static_cast<bf16*>(out);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) {
    return launch_kernel<Codes, 0>(qmm_direct<Codes, 1>, Smem<8, true>::kBytes, 1, xx, q, s, o, w, c, M,
                            K, N, splits, k_per_split, st);
  }
  if (M <= 16) {
    return launch_kernel<Codes, 1>(qmm_direct<Codes, 2>, Smem<16, true>::kBytes, 1, xx, q, s, o, w, c,
                            M, K, N, splits, k_per_split, st);
  }
  if (M <= 32) {
    return launch_kernel<Codes, 2>(qmm_wmma<Codes, 2>, Smem<32, false>::kBytes, 1, xx, q, s, o, w, c, M,
                            K, N, splits, k_per_split, st);
  }
  return launch_kernel<Codes, 3>(qmm_wmma<Codes, 4>, Smem<64, false>::kBytes, (M + 63) / 64, xx, q, s, o,
                          w, c, M, K, N, splits, k_per_split, st);
}

}  // namespace

// C entry points (loaded with ctypes). x [M, K] bf16, qw [L, K, N] codes,
// scale [L, N] f32 (the [L, 1, N] leaf), out [M, N] bf16; all contiguous on
// the current device, x and qw 16-byte aligned. The split plan (splits,
// k_per_split, a multiple of QMM_BK, no split empty) comes from the
// caller. With splits > 1, ws holds splits * M * N f32 and counters one
// int32 for each (row group, column block), all zero before the call and
// zero again after it. Returns the CUDA error code of the launch (0 =
// success); the kernel runs on `stream` and does not synchronise.
extern "C" int qmm_w8a16_int8(const void* x, const void* qw, const float* scale, void* out,
                              void* ws, int M, int K, int N, int L, int layer, int splits,
                              int k_per_split, void* counters, void* stream) {
  return launch<Int8Codes>(x, qw, scale, out, ws, M, K, N, L, layer, splits, k_per_split,
                           counters, stream);
}

extern "C" int qmm_w8a16_fp8(const void* x, const void* qw, const float* scale, void* out,
                             void* ws, int M, int K, int N, int L, int layer, int splits,
                             int k_per_split, void* counters, void* stream) {
  return launch<Fp8Codes>(x, qw, scale, out, ws, M, K, N, L, layer, splits, k_per_split,
                          counters, stream);
}

// The compile-time geometry of this build: ring stages, K rows a stage,
// output columns a block. The wrapper's split plan is made for it.
extern "C" void qmm_w8a16_geometry(int* stages, int* stage_rows, int* block_cols) {
  *stages = kStages;
  *stage_rows = kBK;
  *block_cols = kBN;
}
