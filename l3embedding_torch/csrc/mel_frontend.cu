// Fused mel front-end for Hopper (sm_90a): PCM → |X|² → mel → sqrt → dB.
//
// Replaces the TPU kernel l3embedding_tpu/ops/pallas_frontend.py::_mel_kernel
// (driven by melspectrogram_fused). Per frame: the windowed spectrum's
// power re²+im² in f32, the mel sum in f32, then sqrt, and 10·log10 against
// the per-sample max over the valid frames with a floor of −dynamic_range dB
// (or the amplitude when decibel is 0). Two modes:
//
//   * bf16 (fast; the TPU kernel's numerics): the windowed DFT as a product
//     with the DFT bases, bf16 operands and f32 accumulation on the tensor
//     cores (dft_stage.cuh), then a dense f32 mel product. At the main path's
//     shape (B=64, T=199, n_dft=2048, 1025 bins, 256 mels) that is ~107 GFLOP
//     of DFT and ~6.7 GFLOP of mel against ~36 MB of PCM, bases and output:
//     bound by operations, ~0.108 ms.
//   * f32 (the parity configuration): a real FFT per frame in shared memory
//     (fft_stage.cuh), then the mel sum over each filter's nonzero bins only
//     (CSR rows: 2,032 weights of the 262,400 at 256 mels). That is ~57 kflop
//     a frame, 0.73 GFLOP in all (~0.0109 ms at 67 TFLOP/s), against ~25 MB
//     of PCM and output (~0.0076 ms at 3.35 TB/s): bound by operations.
//
// Design. The TPU grid walked frequency tiles in order on one core, carrying
// the mel sum in VMEM, and took the dB max over the whole sample at the last
// tile. Here blocks run in parallel, so:
//   * one block per (tile of frames, sample); frames are never materialised:
//     the block stages the waveform span its frames cover into shared memory
//     once, applying the TF-SAME zero padding as it loads;
//   * bf16: a loop inside the block walks the frequency chunks and keeps the
//     (TM × n_mels) mel sum in registers;
//   * f32: each warp takes a frame at a time through the FFT into a power row
//     in its buffer, then its lanes take the filters; the (n_mels × frames)
//     tile is staged in shared memory so the stores into (B, n_mels, T) run
//     along T;
//   * the per-sample max crosses blocks, so each block writes the max of its
//     valid frames, and a second small kernel subtracts the sample's max and
//     applies the floor (frontend_common.cuh).

#include "dft_stage.cuh"
#include "fft_stage.cuh"

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

// The f32 mode: FFT_FRAMES frames of one sample per block, one frame per
// warp at a time. Filter m sums mel_w[mel_ptr[m] + j] · |X[mel_lo[m] + j]|²
// over its run of bins (an empty run gives 0).
template <int M>
__global__ void __launch_bounds__(THREADS, 2)
    mel_fft_kernel(const float* __restrict__ x, int n, int pad_left,
                   const float* __restrict__ win, const float2* __restrict__ tw,
                   const int* __restrict__ mel_ptr, const int* __restrict__ mel_lo,
                   const float* __restrict__ mel_w, int n_mels,
                   float* __restrict__ out, float* __restrict__ tile_max, int hop,
                   int n_frames, int decibel, float amin) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* bufs = reinterpret_cast<float2*>(smem);
  float* seg = reinterpret_cast<float*>(bufs + FFT_WARPS * fft_buf_len<M>());
  float* tile = seg + fft_seg_len(M, hop);  // [n_mels][FFT_TLD]

  const int b = blockIdx.y, t0 = blockIdx.x * FFT_FRAMES, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  stage_span<FFT_FRAMES>(x + (size_t)b * n, n, pad_left, t0, 2 * M, hop, seg, tid);
  __syncthreads();

  float2* buf = bufs + warp * fft_buf_len<M>();
  float* power = reinterpret_cast<float*>(buf);  // |X[k]|², k = 0…M, after the FFT
  for (int f = warp; f < FFT_FRAMES && t0 + f < n_frames; f += FFT_WARPS) {
    fft_frame<M>(seg + f * hop, win, tw, buf, lane);
    real_power<M>(buf, tw + M, lane, [power](int k, float p) { power[k] = p; });
    __syncwarp();
    for (int m = lane; m < n_mels; m += 32) {
      const int o0 = __ldg(mel_ptr + m), o1 = __ldg(mel_ptr + m + 1);
      const float* pm = power + __ldg(mel_lo + m);
      float acc = 0.f;
#pragma unroll 4
      for (int o = o0; o < o1; ++o) acc = fmaf(__ldg(mel_w + o), pm[o - o0], acc);
      const float amp = sqrtf(fmaxf(acc, 0.f));
      tile[m * FFT_TLD + f] = decibel ? 10.f * log10f(fmaxf(amp, amin)) : amp;
    }
  }
  __syncthreads();
  const float vmax =
      store_tile(tile, n_mels, out + (size_t)b * n_mels * n_frames + t0, n_frames, t0, tid);
  if (decibel) block_max(vmax, tile_max + b * gridDim.x + blockIdx.x, tid);
}

template <int M>
int launch_f32(const float* x, int batch, int n, int pad_left, const float* win,
               const float2* tw, const int* mel_ptr, const int* mel_lo,
               const float* mel_w, int n_mels, float* out, float* tile_max, int hop,
               int n_frames, int decibel, float amin, float dynamic_range,
               cudaStream_t stream) {
  const size_t smem = fft_smem_bytes<M>(hop, n_mels * FFT_TLD);
  auto kernel = mel_fft_kernel<M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_frames + FFT_FRAMES - 1) / FFT_FRAMES;
  kernel<<<dim3(n_tiles, batch), THREADS, smem, stream>>>(
      x, n, pad_left, win, tw, mel_ptr, mel_lo, mel_w, n_mels, out, tile_max, hop,
      n_frames, decibel, amin);
  err = cudaGetLastError();
  if (err != cudaSuccess || !decibel) return (int)err;
  return launch_db_finalize(out, tile_max, batch, n_tiles, n_mels * n_frames,
                            dynamic_range, stream);
}

}  // namespace

extern "C" {

// Frames per block of each mode and frequency bins per chunk of the bf16
// mode: the wrapper lays out the bases and the tile-max scratch to match.
int l3_mel_frames_per_block() { return TM; }
int l3_mel_bins_per_chunk() { return FC; }
int l3_mel_fft_frames_per_block() { return FFT_FRAMES; }

// bf16 mode. x: (batch, n) f32 waveform; wt: (n_chunks, 2·FC, n_dft) bf16
// bases, each chunk's FC re rows then its FC im rows; melt: (n_chunks·FC,
// n_mels) f32; out: (batch, n_mels, n_frames) f32; tile_max: (batch,
// ceil(n_frames/TM)) f32 scratch. Returns a cudaError_t code: 0 on success.
int l3_mel_frontend_bf16(const void* x, int batch, int n, int pad_left,
                         const void* wt, const void* melt, void* out, void* tile_max,
                         int n_dft, int hop, int n_frames, int n_chunks, int n_mels,
                         int decibel, float amin, float dynamic_range, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(melt);
  float* of = static_cast<float*>(out);
  float* tf = static_cast<float*>(tile_max);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_dft % Tile<__nv_bfloat16>::KC != 0 || hop % 2 != 0) return (int)cudaErrorInvalidValue;
#define L3_LAUNCH(NM)                                                          \
  return launch<__nv_bfloat16, NM>(xf, batch, n, pad_left, wt, mf, of, tf,     \
                                   n_dft, hop, n_frames, n_chunks, decibel,    \
                                   amin, dynamic_range, s)
  if (n_mels == 256) L3_LAUNCH(256);
  if (n_mels == 128) L3_LAUNCH(128);
#undef L3_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// f32 mode. x: (batch, n) f32 waveform; win: (n_dft,) f32 window; tw: (2,
// n_dft/2) float2 twiddles (the complex FFT's, then the post-pass's);
// mel_ptr (n_mels+1,), mel_lo (n_mels,) int32 and mel_w (nnz,) f32: the
// filterbank's CSR rows; out: (batch, n_mels, n_frames) f32; tile_max:
// (batch, ceil(n_frames/FFT_FRAMES)) f32 scratch. n_dft a power of two in
// [64, 2048], hop even. Returns a cudaError_t code: 0 on success.
int l3_mel_frontend_f32(const void* x, int batch, int n, int pad_left,
                        const void* win, const void* tw, const void* mel_ptr,
                        const void* mel_lo, const void* mel_w, void* out,
                        void* tile_max, int n_dft, int hop, int n_frames, int n_mels,
                        int decibel, float amin, float dynamic_range, void* stream) {
  if (hop % 2 != 0) return (int)cudaErrorInvalidValue;
  return with_fft_size(n_dft, [&](auto m) {
    return launch_f32<decltype(m)::value>(
        static_cast<const float*>(x), batch, n, pad_left, static_cast<const float*>(win),
        static_cast<const float2*>(tw), static_cast<const int*>(mel_ptr),
        static_cast<const int*>(mel_lo), static_cast<const float*>(mel_w), n_mels,
        static_cast<float*>(out), static_cast<float*>(tile_max), hop, n_frames, decibel,
        amin, dynamic_range, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
