// Fused mel front-end for Hopper (sm_90a): PCM → |DFT|² → mel → sqrt → dB.
//
// Replaces the TPU kernel l3embedding_tpu/ops/pallas_frontend.py::_mel_kernel
// (driven by melspectrogram_fused). Same arithmetic: per frame, the windowed
// DFT (re, im) as a product with the DFT bases, power re²+im² in f32, the mel
// product in f32, then sqrt, and 10·log10 against the per-sample max over the
// valid frames with a floor of −dynamic_range dB (or the amplitude when
// decibel is 0).
//
// Bound at the main path's shape (B=64, T=199, n_dft=2048, 1025 bins, 256
// mels): the DFT stage is ~107 GFLOP and the mel stage ~6.7 GFLOP, against
// ~12 MB of PCM, ~10.5 MB of bf16 bases and ~13 MB of output, so it is bound
// by operations (tensor-core bf16 in the fast mode, FP32 FMA otherwise).
//
// Design. The TPU grid walked frequency tiles in order on one core, carrying
// the mel sum in VMEM, and took the dB max over the whole sample at the last
// tile. Here blocks run in parallel, so:
//   * one block per (tile of TM frames, sample); a loop inside the block walks
//     the frequency chunks and keeps the (TM × n_mels) mel sum in registers;
//   * frames are never materialised: the block stages the waveform span its
//     frames cover (≈ 2.1 frames' worth per frame tile of 64, not 64 frames)
//     into shared memory once, applying the TF-SAME zero padding as it loads;
//   * the per-sample max crosses blocks, so each block writes the max of its
//     valid frames, and a second small kernel subtracts the sample's max and
//     applies the floor.
// The DFT stage (staging, bases, bf16 mma.sync or f32 FMA) is dft_stage.cuh,
// shared with spec_frontend.cu.

#include "dft_stage.cuh"

namespace {

template <typename T, int NM>
__global__ void __launch_bounds__(THREADS, 1)
    mel_frontend_kernel(const float* __restrict__ x, int n, int pad_left,
                        const T* __restrict__ wt, const float* __restrict__ melt,
                        float* __restrict__ out, float* __restrict__ tile_max,
                        int n_dft, int hop, int n_frames, int n_chunks,
                        int decibel, float amin) {
  constexpr int MC = NM / 32;  // mel columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + TM * SLD * sizeof(float));
  T* seg = Bs + NCOL * Tile<T>::LD;

  const int b = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  const int t0 = tile * TM;
  stage_waveform(x + (size_t)b * n, n, pad_left, t0, n_dft, hop, seg, tid);

  const int rg = tid >> 5, lane = tid & 31;  // mel stage: rows 8·rg+i, cols lane+32·j
  float acc[8][MC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < MC; ++j) acc[i][j] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    dft_chunk(wt + (size_t)c * NCOL * n_dft, Bs, seg, S, n_dft, hop, tid);
    __syncthreads();
    for (int i = tid; i < TM * FC; i += THREADS) {
      float* row = S + (i / FC) * SLD;
      const int f = i % FC;
      const float re = row[f], im = row[FC + f];
      row[f] = re * re + im * im;
    }
    __syncthreads();
    const float* mc = melt + (size_t)c * FC * NM + lane;
#pragma unroll 4
    for (int f = 0; f < FC; ++f) {
      float p[8], m[MC];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = S[(rg * 8 + i) * SLD + f];
#pragma unroll
      for (int j = 0; j < MC; ++j) m[j] = __ldg(mc + f * NM + 32 * j);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j) acc[i][j] = fmaf(p[i], m[j], acc[i][j]);
    }
    __syncthreads();
  }

  float vmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + rg * 8 + i;
    if (t >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      const float amp = sqrtf(fmaxf(acc[i][j], 0.f));
      const float v = decibel ? 10.f * log10f(fmaxf(amp, amin)) : amp;
      out[((size_t)b * NM + lane + 32 * j) * n_frames + t] = v;
      vmax = fmaxf(vmax, v);
    }
  }
  if (decibel) block_max(vmax, tile_max + b * gridDim.x + tile, tid);
}

template <typename T, int NM>
int launch(const float* x, int batch, int n, int pad_left, const void* wt,
           const float* melt, float* out, float* tile_max, int n_dft, int hop,
           int n_frames, int n_chunks, int decibel, float amin,
           float dynamic_range, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(n_dft, hop);
  auto kernel = mel_frontend_kernel<T, NM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_frames + TM - 1) / TM;
  kernel<<<dim3(n_tiles, batch), THREADS, smem, stream>>>(
      x, n, pad_left, static_cast<const T*>(wt), melt, out, tile_max, n_dft, hop,
      n_frames, n_chunks, decibel, amin);
  err = cudaGetLastError();
  if (err != cudaSuccess || !decibel) return (int)err;
  return launch_db_finalize(out, tile_max, batch, n_tiles, NM * n_frames,
                            dynamic_range, stream);
}

}  // namespace

extern "C" {

// Frames per block and frequency bins per chunk: the wrapper lays out the
// bases and the tile-max scratch to match.
int l3_mel_frames_per_block() { return TM; }
int l3_mel_bins_per_chunk() { return FC; }

// x: (batch, n) f32 waveform; wt: (n_chunks, 2·FC, n_dft) bases in the
// operand type (bf16 when bf16 != 0, else f32), each chunk's FC re rows then
// its FC im rows; melt: (n_chunks·FC, n_mels) f32; out: (batch, n_mels,
// n_frames) f32; tile_max: (batch, ceil(n_frames/TM)) f32 scratch.
// Returns a cudaError_t code: 0 on success.
int l3_mel_frontend(const void* x, int batch, int n, int pad_left,
                    const void* wt, const void* melt, void* out, void* tile_max,
                    int n_dft, int hop, int n_frames, int n_chunks, int n_mels,
                    int bf16, int decibel, float amin, float dynamic_range,
                    void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(melt);
  float* of = static_cast<float*>(out);
  float* tf = static_cast<float*>(tile_max);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kc = bf16 ? Tile<__nv_bfloat16>::KC : Tile<float>::KC;
  if (n_dft % kc != 0 || hop % 2 != 0) return (int)cudaErrorInvalidValue;
#define L3_LAUNCH(T, NM)                                                       \
  return launch<T, NM>(xf, batch, n, pad_left, wt, mf, of, tf, n_dft, hop,     \
                       n_frames, n_chunks, decibel, amin, dynamic_range, s)
  if (bf16) {
    if (n_mels == 256) L3_LAUNCH(__nv_bfloat16, 256);
    if (n_mels == 128) L3_LAUNCH(__nv_bfloat16, 128);
  } else {
    if (n_mels == 256) L3_LAUNCH(float, 256);
    if (n_mels == 128) L3_LAUNCH(float, 128);
  }
#undef L3_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
