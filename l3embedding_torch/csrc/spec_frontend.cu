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
//     tensor cores (wgmma, bases through a ring of bulk copies:
//     dft_stage.cuh). At the main path's shape (B=64, T=197, n_dft=512:
//     exactly 512 basis columns, 257 bins) that is ~6.6 GFLOP against ~26 MB
//     of PCM, bases and output: bound by bytes (~7.7 µs at 3.35 TB/s).
//   * f32 (the parity configuration): a real FFT per frame in shared memory
//     (fft_stage.cuh), ~11 kflop a frame, 0.14 GFLOP in all (~2.1 µs at 67
//     TFLOP/s), against ~25 MB of PCM and output: bound by bytes (~7.5 µs).
//
// Design. The TPU kernel walked 256-bin tiles in order, stored each tile into
// a (T, F_pad) VMEM buffer and transposed afterwards. Here:
//   * one block per (tile of frames, sample), the waveform span staged once
//     in shared memory with the padding applied on load;
//   * bf16: 128 frames per block, as in the mel kernel (64 frames took
//     ~1.9× longer at B=64 on an H100: twice the bases' L2 traffic), or 64
//     where the wrapper finds the grid small (dft_stage.frames_per_block);
//     a loop inside the block walks the 64-bin chunks of the DFT stage;
//     each chunk's values are formed in registers, staged in shared memory
//     and stored into out (B, n_freq, T) along T, so the stores coalesce;
//     bin N/2 comes out of chunk 0 (pair 0), and bins and frames past the
//     output are not written;
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

// The bf16 mode: FRAMES = 64·CWG frames of one sample per block, the DFT
// stage's consumers and producer (dft_stage.cuh). Per chunk of 64 bins the
// consumers turn their accumulators into |X|^power (+ dB) in registers,
// stage them in P[bin row][frame], and store the tile into (B, n_freq, T)
// along T (thread ctid takes frame ctid % FRAMES of rows ctid / FRAMES,
// + CONSUMERS / FRAMES, …), skipping bins ≥ n_freq and frames ≥ n_frames.
template <int CWG>
__global__ void __launch_bounds__(DftShape<CWG>::THREADS, 1)
    spec_dft_kernel(const float* __restrict__ x, int n, int pad_left,
                    const __nv_bfloat16* __restrict__ wt, float* __restrict__ out,
                    float* __restrict__ tile_max, int n_dft, int hop, int n_frames,
                    int n_freq, int n_chunks, int packed, float power, int decibel,
                    float amin) {
  using S = DftShape<CWG>;
  constexpr int FRAMES = S::FRAMES, PLD = S::PLD;
  extern __shared__ __align__(16) unsigned char smem[];
  const DftSmem<CWG> sm(smem, 0);
  float* P = sm.P;

  const int b = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  const int t0 = tile * FRAMES, lane = tid & 31, n_kt = n_dft / DFT_KT;
  dft_begin<CWG>(sm, x + (size_t)b * n, n, pad_left, t0, n_dft, hop, tid);
  if (tid >= S::CONSUMERS) {
    dft_produce(wt, sm.ring, sm.bars, n_chunks * n_kt, lane);
    return;
  }

  const int warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int r_lo = 16 * warp + g;  // this thread's rows r_lo, r_lo + 8 (warpgroup w: 64w …)
  const __nv_bfloat16* a_lo = sm.seg + r_lo * hop + 2 * q;
  const __nv_bfloat16* a_hi = a_lo + 8 * hop;
  const int f = tid % FRAMES, t = t0 + f;
  float* ob = out + (size_t)b * n_freq * n_frames + t;
  float vmax = -INFINITY;
  int it = 0;
  for (int c = 0; c < n_chunks; ++c) {
    float d[DFT_ACC];
    dft_chunk(d, a_lo, a_hi, sm.ring, sm.bars, n_kt, it, lane);
    bar_sync(1, S::CONSUMERS);  // the last chunk's stores are done with P
    dft_power(d, r_lo, q, c == 0 && packed && q == 0, [=](int row, int r, float p) {
      const float v = apply_power(p, power);
      P[row * PLD + r] = decibel ? 10.f * log10f(fmaxf(v, amin)) : v;
    });
    bar_sync(1, S::CONSUMERS);
    const int rows = (c == 0 && packed) ? P_ROWS : DFT_BINS;
    for (int i = tid / FRAMES; i < rows; i += S::CONSUMERS / FRAMES) {
      const int bin = i < DFT_BINS ? c * DFT_BINS + i : n_dft / 2;
      if (bin >= n_freq || t >= n_frames) continue;
      const float v = P[i * PLD + f];
      ob[(size_t)bin * n_frames] = v;
      vmax = fmaxf(vmax, v);
    }
  }
  if (decibel) consumers_max<CWG>(vmax, sm.red, tile_max + b * gridDim.x + tile, tid);
}

template <int CWG>
int launch_bf16(const float* x, int batch, int n, int pad_left, const void* wt, float* out,
                float* tile_max, int n_dft, int hop, int n_frames, int n_freq, int n_chunks,
                int packed, float power, int decibel, float amin, float dynamic_range,
                cudaStream_t stream) {
  using S = DftShape<CWG>;
  const size_t smem = dft_smem_bytes<CWG>(n_dft, hop, 0);
  auto kernel = spec_dft_kernel<CWG>;
  static size_t smem_set[MAX_DEVICES] = {};  // per device: see raise_smem_limit
  if (int rc = raise_smem_limit(kernel, smem, smem_set)) return rc;
  const int n_tiles = (n_frames + S::FRAMES - 1) / S::FRAMES;
  kernel<<<dim3(n_tiles, batch), S::THREADS, smem, stream>>>(
      x, n, pad_left, static_cast<const __nv_bfloat16*>(wt), out, tile_max, n_dft, hop,
      n_frames, n_freq, n_chunks, packed, power, decibel, amin);
  cudaError_t err = cudaGetLastError();
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
  static size_t smem_set[MAX_DEVICES] = {};  // per device: see raise_smem_limit
  if (int rc = raise_smem_limit(kernel, smem, smem_set)) return rc;
  const int n_tiles = (n_frames + FFT_FRAMES - 1) / FFT_FRAMES;
  kernel<<<dim3(n_tiles, batch), THREADS, smem, stream>>>(
      x, n, pad_left, win, tw, out, tile_max, hop, n_frames, power, decibel, amin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !decibel) return (int)err;
  return launch_db_finalize(out, tile_max, batch, n_tiles, (M + 1) * n_frames,
                            dynamic_range, stream);
}

}  // namespace

extern "C" {

// Basis columns per chunk of the bf16 mode and frames per block of the f32
// mode: the wrapper lays out the bases and the tile-max scratch to match.
int l3_spec_cols_per_chunk() { return DFT_COLS; }
int l3_spec_fft_frames_per_block() { return FFT_FRAMES; }

// bf16 mode. x: (batch, n) f32 waveform; wt: (n_chunks, n_dft/64, 128·64)
// bf16 basis stages (ops/dft_stage.py: interleaved columns, swizzled); out:
// (batch, n_freq, n_frames) f32; tile_max: (batch, ceil(n_frames/frames))
// f32 scratch. frames_per_block 64 or 128, n_dft a multiple of 64, hop
// even, n_freq = n_dft/2 + 1. Returns a cudaError_t code: 0 on success.
int l3_spec_frontend_bf16(const void* x, int batch, int n, int pad_left, const void* wt,
                          void* out, void* tile_max, int n_dft, int hop, int n_frames,
                          int n_freq, int n_chunks, int frames_per_block, float power,
                          int decibel, float amin, float dynamic_range, void* stream) {
  const int packed = n_dft % DFT_COLS == 0;
  if (n_dft % DFT_KT != 0 || hop % 2 != 0 || n_freq != n_dft / 2 + 1 ||
      n_chunks * DFT_COLS != n_dft + (packed ? 0 : DFT_BINS))
    return (int)cudaErrorInvalidValue;
#define L3_LAUNCH(CWG)                                                                      \
  return launch_bf16<CWG>(static_cast<const float*>(x), batch, n, pad_left, wt,             \
                          static_cast<float*>(out), static_cast<float*>(tile_max), n_dft, hop, \
                          n_frames, n_freq, n_chunks, packed, power, decibel, amin,        \
                          dynamic_range, static_cast<cudaStream_t>(stream))
  if (frames_per_block == 128) L3_LAUNCH(2);
  if (frames_per_block == 64) L3_LAUNCH(1);
#undef L3_LAUNCH
  return (int)cudaErrorInvalidValue;
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
