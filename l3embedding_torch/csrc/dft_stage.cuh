// The windowed-DFT stage shared by the Hopper front-end kernels
// (mel_frontend.cu, spec_frontend.cu).
//
// A block owns TM consecutive frames of one sample. It stages the waveform
// span those frames cover into shared memory once (stage_waveform), with the
// zero padding applied as it loads, and reads frame t, sample k at
// seg[t·hop + k]: frames are never materialised. dft_chunk then forms the
// product of the block's frames with one chunk of FC frequency bins' DFT
// bases (FC re columns, then FC im columns) into the f32 buffer S[TM][SLD].
// Operand type is the template parameter: bf16 operands with f32
// accumulation on the tensor cores (mma.sync m16n8k16), or f32 operands with
// f32 FMA.
//
// Per-sample dB crosses blocks: each block writes the max over its valid
// outputs (block_max), and db_finalize_kernel subtracts the sample's max and
// applies the floor.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TM = 64;         // frames per block
constexpr int FC = 64;         // frequency bins per chunk
constexpr int NCOL = 2 * FC;   // a chunk's re columns, then its im columns
constexpr int THREADS = 256;   // 8 warps
constexpr int SLD = NCOL + 4;  // row stride of the f32 chunk buffer S

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int KC = 64;       // K depth of one staged basis tile
  static constexpr int LD = KC + 8;   // 144-byte rows: 16-byte aligned, no bank conflicts
};
template <>
struct Tile<float> {
  static constexpr int KC = 32;
  static constexpr int LD = KC + 1;
};

__device__ __forceinline__ void store_operand(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_operand(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Shared memory of one block: S (f32), one staged basis tile Bs and the
// waveform span seg (both in the operand type), in that order. Each kernel
// carves the three pointers from its extern __shared__ buffer itself, so
// the compiler sees shared-memory pointers (a struct of them measured 11 %
// slower in the f32 mel kernel).
template <typename T>
size_t smem_bytes(int n_dft, int hop) {
  return TM * SLD * sizeof(float) + NCOL * Tile<T>::LD * sizeof(T) +
         ((TM - 1) * hop + n_dft) * sizeof(T);
}

// The waveform span of frames [t0, t0+TM) of one sample, zero outside
// [0, n): the padding, applied on load. (dft_chunk's first barrier orders
// these stores before any read.)
template <typename T>
__device__ __forceinline__ void stage_waveform(const float* __restrict__ xb, int n,
                                               int pad_left, int t0, int n_dft,
                                               int hop, T* seg, int tid) {
  const int seg_len = (TM - 1) * hop + n_dft;
  const long start = (long)t0 * hop - pad_left;
  for (int i = tid; i < seg_len; i += THREADS) {
    const long s = start + i;
    store_operand(seg + i, (s >= 0 && s < n) ? __ldg(xb + s) : 0.f);
  }
}

// Stage rows [0, NCOL) × columns [k0, k0+KC) of one chunk's bases
// (layout: NCOL rows of n_dft) into Bs[NCOL][LD].
template <typename T>
__device__ __forceinline__ void load_basis_tile(const T* __restrict__ wc, T* Bs,
                                                int n_dft, int k0, int tid) {
  constexpr int KC = Tile<T>::KC, LD = Tile<T>::LD;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int PER_ROW = KC / VEC;
  for (int i = tid; i < NCOL * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const uint4 v =
        __ldg(reinterpret_cast<const uint4*>(wc + (size_t)r * n_dft + k0 + c));
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      *reinterpret_cast<uint4*>(Bs + r * LD + c) = v;
    } else {
      float* d = Bs + r * LD + c;  // LD is odd: scalar stores
      d[0] = __uint_as_float(v.x);
      d[1] = __uint_as_float(v.y);
      d[2] = __uint_as_float(v.z);
      d[3] = __uint_as_float(v.w);
    }
  }
}

// DFT of the block's TM frames against one chunk's NCOL basis columns,
// bf16 on the tensor cores. Warp w owns rows 16·(w&3) and the 64 re (w<4)
// or im (w>=4) columns. Result → S[TM][SLD].
__device__ __forceinline__ void dft_chunk(const __nv_bfloat16* __restrict__ wc,
                                          __nv_bfloat16* Bs,
                                          const __nv_bfloat16* seg, float* S,
                                          int n_dft, int hop, int tid) {
  constexpr int KC = Tile<__nv_bfloat16>::KC, LD = Tile<__nv_bfloat16>::LD;
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = (warp & 3) * 16, wcol = (warp >> 2) * 64;
  const int g = lane >> 2, q = lane & 3;
  float d[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[nt][e] = 0.f;

  // Rows of A are frames: frame t starts at seg[t·hop]. hop is even, so
  // each (even k, k+1) pair is one aligned 32-bit word.
  const __nv_bfloat16* a_lo = seg + (wr + g) * hop + 2 * q;
  const __nv_bfloat16* a_hi = seg + (wr + g + 8) * hop + 2 * q;
  for (int k0 = 0; k0 < n_dft; k0 += KC) {
    load_basis_tile(wc, Bs, n_dft, k0, tid);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      const int k = k0 + ks;
      const uint32_t a0 = ld32(a_lo + k), a1 = ld32(a_hi + k);
      const uint32_t a2 = ld32(a_lo + k + 8), a3 = ld32(a_hi + k + 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* bp = Bs + (wcol + nt * 8 + g) * LD + ks + 2 * q;
        mma_bf16(d[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = wcol + nt * 8 + 2 * q;
    S[(wr + g) * SLD + col] = d[nt][0];
    S[(wr + g) * SLD + col + 1] = d[nt][1];
    S[(wr + g + 8) * SLD + col] = d[nt][2];
    S[(wr + g + 8) * SLD + col + 1] = d[nt][3];
  }
}

// The same product in f32 with FMA: thread owns rows 4·(tid/16)+i and
// columns (tid%16)+16·j.
__device__ __forceinline__ void dft_chunk(const float* __restrict__ wc, float* Bs,
                                          const float* seg, float* S, int n_dft,
                                          int hop, int tid) {
  constexpr int KC = Tile<float>::KC, LD = Tile<float>::LD;
  const int ty = tid >> 4, tx = tid & 15;
  float d[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) d[i][j] = 0.f;

  const float* a_row = seg + (ty * 4) * hop;
  for (int k0 = 0; k0 < n_dft; k0 += KC) {
    load_basis_tile(wc, Bs, n_dft, k0, tid);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_row[i * hop + k0 + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[(tx + 16 * j) * LD + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) d[i][j] = fmaf(a[i], b[j], d[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) S[(ty * 4 + i) * SLD + tx + 16 * j] = d[i][j];
}

// The block's max of vmax (one value per thread) → *dst, by thread 0.
__device__ __forceinline__ void block_max(float vmax, float* dst, int tid) {
  __shared__ float red[THREADS / 32];
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  if (lane == 0) red[warp] = vmax;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, red[w]);
    *dst = m;
  }
}

// out[b] ← max(out[b] − max_tiles(tile_max[b]), −dynamic_range).
__global__ void db_finalize_kernel(float* __restrict__ out,
                                   const float* __restrict__ tile_max, int n_tiles,
                                   int per_sample, float dynamic_range) {
  const int b = blockIdx.y;
  float ref = -INFINITY;
  for (int i = 0; i < n_tiles; ++i) ref = fmaxf(ref, tile_max[b * n_tiles + i]);
  float* o = out + (size_t)b * per_sample;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < per_sample;
       i += gridDim.x * blockDim.x)
    o[i] = fmaxf(o[i] - ref, -dynamic_range);
}

// Launch db_finalize_kernel over (batch, per_sample) outputs.
inline int launch_db_finalize(float* out, const float* tile_max, int batch,
                              int n_tiles, int per_sample, float dynamic_range,
                              cudaStream_t stream) {
  const int blocks = (per_sample + THREADS * 8 - 1) / (THREADS * 8);
  db_finalize_kernel<<<dim3(blocks, batch), THREADS, 0, stream>>>(
      out, tile_max, n_tiles, per_sample, dynamic_range);
  return (int)cudaGetLastError();
}

}  // namespace
