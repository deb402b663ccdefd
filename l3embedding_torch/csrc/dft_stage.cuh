// The windowed-DFT stage of the Hopper front-end kernels' bf16 mode
// (mel_frontend.cu, spec_frontend.cu); the f32 mode runs the real FFT of
// fft_stage.cuh instead.
//
// A block owns TM consecutive frames of one sample and stages their
// waveform span in shared memory (stage_waveform, after stage_span in
// frontend_common.cuh). dft_chunk then forms the product of the block's
// frames with one chunk of FC frequency bins' DFT bases (FC re columns, then
// FC im columns) into the f32 buffer S[TM][SLD]: bf16 operands with f32
// accumulation on the tensor cores (mma.sync m16n8k16).

#pragma once

#include "frontend_common.cuh"

namespace {

constexpr int TM = 64;         // frames per block
constexpr int FC = 64;         // frequency bins per chunk
constexpr int NCOL = 2 * FC;   // a chunk's re columns, then its im columns
constexpr int SLD = NCOL + 4;  // row stride of the f32 chunk buffer S

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int KC = 64;       // K depth of one staged basis tile
  static constexpr int LD = KC + 8;   // 144-byte rows: 16-byte aligned, no bank conflicts
};

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
// slower in a mel kernel).
template <typename T>
size_t smem_bytes(int n_dft, int hop) {
  return TM * SLD * sizeof(float) + NCOL * Tile<T>::LD * sizeof(T) +
         ((TM - 1) * hop + n_dft) * sizeof(T);
}

// The waveform span of frames [t0, t0+TM) of one sample. (dft_chunk's first
// barrier orders these stores before any read.)
template <typename T>
__device__ __forceinline__ void stage_waveform(const float* __restrict__ xb, int n,
                                               int pad_left, int t0, int n_dft,
                                               int hop, T* seg, int tid) {
  stage_span<TM>(xb, n, pad_left, t0, n_dft, hop, seg, tid);
}

// Stage rows [0, NCOL) × columns [k0, k0+KC) of one chunk's bases
// (layout: NCOL rows of n_dft) into Bs[NCOL][LD].
__device__ __forceinline__ void load_basis_tile(const __nv_bfloat16* __restrict__ wc,
                                                __nv_bfloat16* Bs, int n_dft, int k0,
                                                int tid) {
  constexpr int KC = Tile<__nv_bfloat16>::KC, LD = Tile<__nv_bfloat16>::LD;
  constexpr int VEC = 8;  // bf16 elements per 16-byte load
  constexpr int PER_ROW = KC / VEC;
  for (int i = tid; i < NCOL * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    *reinterpret_cast<uint4*>(Bs + r * LD + c) =
        __ldg(reinterpret_cast<const uint4*>(wc + (size_t)r * n_dft + k0 + c));
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

}  // namespace
