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
// What bounds it on the card: at decode row counts (M of 8 to a few dozen)
// each weight code is used M times, far below the H100's ratio of
// operations to bytes, so the kernel is bound by the bytes of the codes —
// one byte per weight, half of what a bf16 weight costs. The design keeps
// the codes compact up to shared memory and converts them there:
//
// - A block owns 128 output columns and all M rows of one row group (16,
//   32 or 64 rows, rows past M masked to zeros), so each code is read from
//   device memory once per row group.
// - The K loop moves 64 rows at a time. Each thread loads its share of the
//   next stage's codes and activations into registers as 16-byte vectors
//   (codes along N, activations along K) while the warps run the current
//   stage's products, then converts the codes to bf16 into shared memory.
//   int8 -> bf16 and e4m3 -> bf16 are exact.
// - Products are bf16 wmma 16x16x16 fragments (mma.sync) with f32
//   accumulators; warp w owns columns [32w, 32w + 32) of the block.
// - Few column blocks fill few of the 132 SMs (wk/wv have N = 1024: 8
//   blocks), so K is split across blocks: each split writes its f32 partial
//   sums to a workspace and a second kernel adds the splits in a fixed
//   order, applies the scale and rounds once, so results are the same from
//   run to run. With one split the first kernel finishes the output itself.
//
// This first version has no cp.async/TMA pipeline and no wgmma; PERF.md
// keeps its times against the byte bound.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBN = 128;                  // output columns per block
constexpr int kBK = 64;                   // K rows per stage
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdW = kBN + 8;             // padded smem row (bf16 elements)
constexpr int kLdX = kBK + 8;
constexpr int kWVecs = kBK * kBN / 16 / kThreads;   // 16-byte code vectors a thread loads

struct Int8Codes {};
struct Fp8Codes {};

// 16 codes (one 16-byte vector) -> 16 bf16 at dst
__device__ __forceinline__ void convert16(Int8Codes, const uint4& raw, bf16* dst) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  __nv_bfloat162 o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[i] = __floats2bfloat162_rn(static_cast<float>(c[2 * i]), static_cast<float>(c[2 * i + 1]));
  }
  reinterpret_cast<uint4*>(dst)[0] = *reinterpret_cast<const uint4*>(&o[0]);
  reinterpret_cast<uint4*>(dst)[1] = *reinterpret_cast<const uint4*>(&o[4]);
}

__device__ __forceinline__ void convert16(Fp8Codes, const uint4& raw, bf16* dst) {
  const __nv_fp8x2_storage_t* c = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
  __nv_bfloat162 o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __half2 h = __half2(__nv_cvt_fp8x2_to_halfraw2(c[i], __NV_E4M3));
    o[i] = __float22bfloat162_rn(__half22float2(h));
  }
  reinterpret_cast<uint4*>(dst)[0] = *reinterpret_cast<const uint4*>(&o[0]);
  reinterpret_cast<uint4*>(dst)[1] = *reinterpret_cast<const uint4*>(&o[4]);
}

template <typename Codes, int MT>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const bf16* __restrict__ x,        // [M, K]
           const uint8_t* __restrict__ qw,    // [K, N] codes of this layer
           const float* __restrict__ scale,   // [N] of this layer
           bf16* __restrict__ out,            // [M, N]          (one split)
           float* __restrict__ ws,            // [splits, M, N]  (several)
           int M, int K, int N, int k_per_split, int splits) {
  constexpr int BM = 16 * MT;
  constexpr int kXVecs = BM * kBK / 8 / kThreads;   // 16-byte x vectors a thread loads
  __shared__ __align__(128) bf16 sX[BM * kLdX];
  __shared__ __align__(128) bf16 sW[kBK * kLdW];
  __shared__ __align__(128) float sC[kWarps][16 * 16];

  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * BM;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    wmma::fill_fragment(acc[mt][0], 0.f);
    wmma::fill_fragment(acc[mt][1], 0.f);
  }

  uint4 wreg[kWVecs];
  uint4 xreg[kXVecs];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kWVecs; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBN / 16);
      const int c = (i % (kBN / 16)) * 16;
      const int k = k0 + r;
      wreg[j] = (k < k_end && n0 + c < N)
                    ? *reinterpret_cast<const uint4*>(qw + (size_t)k * N + n0 + c)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kXVecs; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      const int m = m0 + r;
      xreg[j] = (m < M && k0 + c < k_end)
                    ? *reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + c)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  if (k_begin < k_end) load_stage(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous stage's products are done with sX/sW
#pragma unroll
    for (int j = 0; j < kWVecs; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBN / 16);
      const int c = (i % (kBN / 16)) * 16;
      convert16(Codes{}, wreg[j], sW + r * kLdW + c);
    }
#pragma unroll
    for (int j = 0; j < kXVecs; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(sX + r * kLdX + c) = xreg[j];
    }
    __syncthreads();
    if (k0 + kBK < k_end) load_stage(k0 + kBK);   // in flight during the products

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b0, b1;
      wmma::load_matrix_sync(b0, sW + kk * 16 * kLdW + warp * 32, kLdW);
      wmma::load_matrix_sync(b1, sW + kk * 16 * kLdW + warp * 32 + 16, kLdW);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sX + mt * 16 * kLdX + kk * 16, kLdX);
        wmma::mma_sync(acc[mt][0], a, b0, acc[mt][0]);
        wmma::mma_sync(acc[mt][1], a, b1, acc[mt][1]);
      }
    }
  }

  // ---- epilogue: one 16x16 tile at a time through this warp's staging
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      wmma::store_matrix_sync(sC[warp], acc[mt][nt], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane + 32 * e;
        const int m = m0 + mt * 16 + idx / 16;
        const int n = n0 + warp * 32 + nt * 16 + idx % 16;
        if (m < M && n < N) {
          const float v = sC[warp][idx];
          if (splits == 1) {
            out[(size_t)m * N + n] = __float2bfloat16_rn(v * scale[n]);
          } else {
            ws[((size_t)split * M + m) * N + n] = v;
          }
        }
      }
      __syncwarp();
    }
  }
}

// sum the splits' partials in split order, scale, round once
__global__ void qmm_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                                  bf16* __restrict__ out, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[(size_t)sp * total + idx];
    out[idx] = __float2bfloat16_rn(s * scale[idx % N]);
  }
}

template <typename Codes, int MT>
int launch_mt(const bf16* x, const uint8_t* qw, const float* scale, bf16* out, float* ws, int M,
              int K, int N, int splits, int k_per_split, cudaStream_t stream) {
  constexpr int BM = 16 * MT;
  dim3 grid((N + kBN - 1) / kBN, splits, (M + BM - 1) / BM);
  qmm_kernel<Codes, MT><<<grid, kThreads, 0, stream>>>(x, qw, scale, out, ws, M, K, N,
                                                       k_per_split, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t total = (size_t)M * N;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
  qmm_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, scale, out, M, N, splits);
  return (int)cudaGetLastError();
}

template <typename Codes>
int launch(const void* x, const void* qw, const float* scale, void* out, void* ws, int M, int K,
           int N, int L, int layer, int splits, int k_per_split, void* stream) {
  if (M <= 0) return 0;
  if (K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0 || layer < 0 || layer >= L ||
      splits < 1 || k_per_split <= 0 || k_per_split % kBK != 0 ||
      (long long)splits * k_per_split < K || (splits > 1 && ws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bf16* xx = static_cast<const bf16*>(x);
  const uint8_t* q = static_cast<const uint8_t*>(qw) + (size_t)layer * K * N;
  const float* s = scale + (size_t)layer * N;
  bf16* o = static_cast<bf16*>(out);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch_mt<Codes, 1>(xx, q, s, o, w, M, K, N, splits, k_per_split, st);
  if (M <= 32) return launch_mt<Codes, 2>(xx, q, s, o, w, M, K, N, splits, k_per_split, st);
  return launch_mt<Codes, 4>(xx, q, s, o, w, M, K, N, splits, k_per_split, st);
}

}  // namespace

// C entry points (loaded with ctypes). x [M, K] bf16, qw [L, K, N] codes,
// scale [L, N] f32 (the [L, 1, N] leaf), out [M, N] bf16, ws [splits, M, N]
// f32 when splits > 1; all contiguous on the current device. The split
// plan (splits, k_per_split, a multiple of 64) comes from the caller.
// Returns the CUDA error code of the launches (0 = success); the kernels
// run on `stream` and do not synchronise.
extern "C" int qmm_w8a16_int8(const void* x, const void* qw, const float* scale, void* out,
                              void* ws, int M, int K, int N, int L, int layer, int splits,
                              int k_per_split, void* stream) {
  return launch<Int8Codes>(x, qw, scale, out, ws, M, K, N, L, layer, splits, k_per_split, stream);
}

extern "C" int qmm_w8a16_fp8(const void* x, const void* qw, const float* scale, void* out,
                             void* ws, int M, int K, int N, int L, int layer, int splits,
                             int k_per_split, void* stream) {
  return launch<Fp8Codes>(x, qw, scale, out, ws, M, K, N, L, layer, splits, k_per_split, stream);
}
