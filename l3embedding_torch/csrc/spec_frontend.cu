// Fused linear-spectrogram front-end for Hopper (sm_90a):
// PCM → |DFT|^power → (optional) dB, written straight in the model's layout.
//
// Replaces the TPU kernel l3embedding_tpu/ops/pallas_frontend.py::_spec_kernel
// (driven by spectrogram_fused). Same arithmetic: per frame, the windowed DFT
// (re, im) as a product with the DFT bases (a Hann window shorter than n_dft
// lives, centred, in the bases), power re²+im² in f32, then sqrt (power 1),
// nothing (power 2) or p^(power/2), and optionally 10·log10 against the
// per-sample max over the valid frames and the valid bins, with a floor of
// −dynamic_range dB.
//
// Bound at the main path's shape (B=64, T=197, n_dft=512, 257 bins): the DFT
// is ~6.6 GFLOP against ~26 MB of PCM, bases and output. With bf16 operands
// on the tensor cores that is bound by bytes (~7.7 µs at 3.35 TB/s); with f32
// operands on the FP32 pipes by operations (~0.1 ms at 67 TFLOP/s).
//
// Design. The TPU kernel walked 256-bin tiles in order, stored each tile into
// a (T, F_pad) VMEM buffer and transposed afterwards. Here:
//   * one block per (tile of TM frames, sample); a loop inside the block walks
//     the FC-bin chunks with the DFT stage of dft_stage.cuh (waveform span
//     staged once in shared memory, padding applied on load, bases padded to
//     a multiple of FC bins with zeros);
//   * each chunk's values go straight to out (B, n_freq, T): consecutive
//     threads take consecutive frames of one bin, so the stores coalesce, and
//     padded bins and frames past n_frames are not written;
//   * per-sample dB: each block writes the max over its valid (frame, bin)
//     values, and the shared finalize kernel subtracts the sample's max and
//     applies the floor.

#include "dft_stage.cuh"

namespace {

__device__ __forceinline__ float apply_power(float p, float power) {
  if (power == 1.f) return sqrtf(p);
  if (power == 2.f) return p;
  return powf(p, 0.5f * power);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    spec_frontend_kernel(const float* __restrict__ x, int n, int pad_left,
                         const T* __restrict__ wt, float* __restrict__ out,
                         float* __restrict__ tile_max, int n_dft, int hop,
                         int n_frames, int n_freq, int n_chunks, float power,
                         int decibel, float amin) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + TM * SLD * sizeof(float));
  T* seg = Bs + NCOL * Tile<T>::LD;

  const int b = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  const int t0 = tile * TM;
  stage_waveform(x + (size_t)b * n, n, pad_left, t0, n_dft, hop, seg, tid);

  float* ob = out + (size_t)b * n_freq * n_frames;
  float vmax = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) {
    dft_chunk(wt + (size_t)c * NCOL * n_dft, Bs, seg, S, n_dft, hop, tid);
    __syncthreads();
    for (int i = tid; i < TM * FC; i += THREADS) {
      const int r = i % TM, f = c * FC + i / TM;
      const int t = t0 + r;
      if (t >= n_frames || f >= n_freq) continue;
      const float* row = S + r * SLD + i / TM;
      const float re = row[0], im = row[FC];
      float v = apply_power(re * re + im * im, power);
      if (decibel) v = 10.f * log10f(fmaxf(v, amin));
      ob[(size_t)f * n_frames + t] = v;
      vmax = fmaxf(vmax, v);
    }
    __syncthreads();  // S is rewritten by the next chunk
  }
  if (decibel) block_max(vmax, tile_max + b * gridDim.x + tile, tid);
}

template <typename T>
int launch(const float* x, int batch, int n, int pad_left, const void* wt,
           float* out, float* tile_max, int n_dft, int hop, int n_frames,
           int n_freq, int n_chunks, float power, int decibel, float amin,
           float dynamic_range, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(n_dft, hop);
  auto kernel = spec_frontend_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_frames + TM - 1) / TM;
  kernel<<<dim3(n_tiles, batch), THREADS, smem, stream>>>(
      x, n, pad_left, static_cast<const T*>(wt), out, tile_max, n_dft, hop,
      n_frames, n_freq, n_chunks, power, decibel, amin);
  err = cudaGetLastError();
  if (err != cudaSuccess || !decibel) return (int)err;
  return launch_db_finalize(out, tile_max, batch, n_tiles, n_freq * n_frames,
                            dynamic_range, stream);
}

}  // namespace

extern "C" {

// Frames per block and frequency bins per chunk: the wrapper lays out the
// bases and the tile-max scratch to match.
int l3_spec_frames_per_block() { return TM; }
int l3_spec_bins_per_chunk() { return FC; }

// x: (batch, n) f32 waveform; wt: (n_chunks, 2·FC, n_dft) bases in the
// operand type (bf16 when bf16 != 0, else f32), each chunk's FC re rows then
// its FC im rows, zero past n_freq; out: (batch, n_freq, n_frames) f32;
// tile_max: (batch, ceil(n_frames/TM)) f32 scratch. Returns a cudaError_t
// code: 0 on success.
int l3_spec_frontend(const void* x, int batch, int n, int pad_left,
                     const void* wt, void* out, void* tile_max, int n_dft,
                     int hop, int n_frames, int n_freq, int n_chunks, int bf16,
                     float power, int decibel, float amin, float dynamic_range,
                     void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  float* tf = static_cast<float*>(tile_max);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kc = bf16 ? Tile<__nv_bfloat16>::KC : Tile<float>::KC;
  if (n_dft % kc != 0 || hop % 2 != 0 || n_chunks * FC < n_freq)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(xf, batch, n, pad_left, wt, of, tf, n_dft, hop,
                                 n_frames, n_freq, n_chunks, power, decibel,
                                 amin, dynamic_range, s);
  return launch<float>(xf, batch, n, pad_left, wt, of, tf, n_dft, hop, n_frames,
                       n_freq, n_chunks, power, decibel, amin, dynamic_range, s);
}

}  // extern "C"
