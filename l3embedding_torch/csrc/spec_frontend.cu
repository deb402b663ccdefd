// Fused linear-spectrogram front-end for Hopper (sm_90a):
// PCM → |X|^power → (optional) dB, written straight in the model's layout.
//
// Replaces the TPU kernel l3embedding_tpu/ops/pallas_frontend.py::_spec_kernel
// (driven by spectrogram_fused). Per frame: the power re²+im² in f32 of the
// frame's spectrum under a Hann window (shorter than n_dft and centred in
// it for tiny_L3), then sqrt (power 1), nothing (power 2) or p^(power/2), and
// optionally 10·log10 against the per-sample max over the valid frames and
// bins, with a floor of −dynamic_range dB. Two modes:
//
//   * bf16 (fast; the TPU kernel's numerics): the windowed DFT as a product
//     with the windowed DFT bases, bf16 operands and f32 accumulation on the
//     tensor cores (dft_stage.cuh). At the main path's shape (B=64, T=197,
//     n_dft=512, 257 bins) that is ~6.6 GFLOP against ~26 MB of PCM, bases
//     and output: bound by bytes (~7.7 µs at 3.35 TB/s).
//   * f32 (the parity configuration): a real FFT per frame in shared memory
//     (fft_stage.cuh), ~11 kflop a frame, 0.14 GFLOP in all (~2.1 µs at 67
//     TFLOP/s), against ~25 MB of PCM and output: bound by bytes (~7.5 µs).
//
// Design. The TPU kernel walked 256-bin tiles in order, stored each tile into
// a (T, F_pad) VMEM buffer and transposed afterwards. Here:
//   * one block per (tile of frames, sample), the waveform span staged once
//     in shared memory with the padding applied on load;
//   * bf16: a loop inside the block walks the FC-bin chunks of the DFT stage
//     (bases padded to a multiple of FC bins with zeros), and each chunk's
//     values go straight to out (B, n_freq, T): consecutive threads take
//     consecutive frames of one bin, so the stores coalesce, and padded bins
//     and frames past n_frames are not written;
//   * f32: each warp takes a frame at a time through the FFT, and the
//     post-pass writes its values into an (n_freq × frames) tile in shared
//     memory, which the block then stores along T;
//   * per-sample dB: each block writes the max over its valid (frame, bin)
//     values, and the shared finalize kernel subtracts the sample's max and
//     applies the floor (frontend_common.cuh).

#include "dft_stage.cuh"
#include "fft_stage.cuh"

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

// The f32 mode: FFT_FRAMES frames of one sample per block, one frame per
// warp at a time; all M + 1 bins are valid.
template <int M>
__global__ void __launch_bounds__(THREADS, 2)
    spec_fft_kernel(const float* __restrict__ x, int n, int pad_left,
                    const float* __restrict__ win, const float2* __restrict__ tw,
                    float* __restrict__ out, float* __restrict__ tile_max, int hop,
                    int n_frames, float power, int decibel, float amin) {
  constexpr int NF = M + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* bufs = reinterpret_cast<float2*>(smem);
  float* seg = reinterpret_cast<float*>(bufs + FFT_WARPS * fft_buf_len<M>());
  float* tile = seg + fft_seg_len(M, hop);  // [NF][FFT_TLD]

  const int b = blockIdx.y, t0 = blockIdx.x * FFT_FRAMES, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  stage_span<FFT_FRAMES>(x + (size_t)b * n, n, pad_left, t0, 2 * M, hop, seg, tid);
  __syncthreads();

  float2* buf = bufs + warp * fft_buf_len<M>();
  for (int f = warp; f < FFT_FRAMES && t0 + f < n_frames; f += FFT_WARPS) {
    fft_frame<M>(seg + f * hop, win, tw, buf, lane);
    real_power<M>(buf, tw + M, lane, [=](int k, float p) {
      const float v = apply_power(p, power);
      tile[k * FFT_TLD + f] = decibel ? 10.f * log10f(fmaxf(v, amin)) : v;
    });
  }
  __syncthreads();
  const float vmax = store_tile(tile, NF, out + (size_t)b * NF * n_frames + t0, n_frames, t0, tid);
  if (decibel) block_max(vmax, tile_max + b * gridDim.x + blockIdx.x, tid);
}

template <int M>
int launch_f32(const float* x, int batch, int n, int pad_left, const float* win,
               const float2* tw, float* out, float* tile_max, int hop, int n_frames,
               float power, int decibel, float amin, float dynamic_range,
               cudaStream_t stream) {
  const size_t smem = fft_smem_bytes<M>(hop, (M + 1) * FFT_TLD);
  auto kernel = spec_fft_kernel<M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_frames + FFT_FRAMES - 1) / FFT_FRAMES;
  kernel<<<dim3(n_tiles, batch), THREADS, smem, stream>>>(
      x, n, pad_left, win, tw, out, tile_max, hop, n_frames, power, decibel, amin);
  err = cudaGetLastError();
  if (err != cudaSuccess || !decibel) return (int)err;
  return launch_db_finalize(out, tile_max, batch, n_tiles, (M + 1) * n_frames,
                            dynamic_range, stream);
}

}  // namespace

extern "C" {

// Frames per block of each mode and frequency bins per chunk of the bf16
// mode: the wrapper lays out the bases and the tile-max scratch to match.
int l3_spec_frames_per_block() { return TM; }
int l3_spec_bins_per_chunk() { return FC; }
int l3_spec_fft_frames_per_block() { return FFT_FRAMES; }

// bf16 mode. x: (batch, n) f32 waveform; wt: (n_chunks, 2·FC, n_dft) bf16
// bases, each chunk's FC re rows then its FC im rows, zero past n_freq; out:
// (batch, n_freq, n_frames) f32; tile_max: (batch, ceil(n_frames/TM)) f32
// scratch. Returns a cudaError_t code: 0 on success.
int l3_spec_frontend_bf16(const void* x, int batch, int n, int pad_left,
                          const void* wt, void* out, void* tile_max, int n_dft,
                          int hop, int n_frames, int n_freq, int n_chunks,
                          float power, int decibel, float amin, float dynamic_range,
                          void* stream) {
  if (n_dft % Tile<__nv_bfloat16>::KC != 0 || hop % 2 != 0 || n_chunks * FC < n_freq)
    return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16>(static_cast<const float*>(x), batch, n, pad_left, wt,
                               static_cast<float*>(out), static_cast<float*>(tile_max),
                               n_dft, hop, n_frames, n_freq, n_chunks, power, decibel,
                               amin, dynamic_range, static_cast<cudaStream_t>(stream));
}

// f32 mode. x: (batch, n) f32 waveform; win: (n_dft,) f32 window; tw: (2,
// n_dft/2) float2 twiddles (the complex FFT's, then the post-pass's); out:
// (batch, n_dft/2 + 1, n_frames) f32; tile_max: (batch,
// ceil(n_frames/FFT_FRAMES)) f32 scratch. n_dft a power of two in [64,
// 2048], hop even. Returns a cudaError_t code: 0 on success.
int l3_spec_frontend_f32(const void* x, int batch, int n, int pad_left,
                         const void* win, const void* tw, void* out, void* tile_max,
                         int n_dft, int hop, int n_frames, float power, int decibel,
                         float amin, float dynamic_range, void* stream) {
  if (hop % 2 != 0) return (int)cudaErrorInvalidValue;
  return with_fft_size(n_dft, [&](auto m) {
    return launch_f32<decltype(m)::value>(
        static_cast<const float*>(x), batch, n, pad_left, static_cast<const float*>(win),
        static_cast<const float2*>(tw), static_cast<float*>(out),
        static_cast<float*>(tile_max), hop, n_frames, power, decibel, amin,
        dynamic_range, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
