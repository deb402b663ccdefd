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
//     cores (wgmma, bases through a ring of bulk copies: dft_stage.cuh),
//     then the mel sum over each filter's nonzero bins only. At the main
//     path's shape (B=64, T=199, n_dft=2048: exactly 2048 basis columns,
//     256 mels) that is ~107 GFLOP of DFT and ~52 MFLOP of mel against
//     ~36 MB of PCM, bases and output: bound by operations, ~0.108 ms.
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
//   * bf16: 128 frames per block (two consumer warpgroups reading each
//     basis stage, so the bases cross L2 once per 128 frames: ~1.1 GB at
//     B=64), or 64 where the wrapper finds the grid small enough that the
//     per-block run of stages sets the time (dft_stage.frames_per_block);
//     a loop inside the block walks the 64-bin chunks, forms the
//     power in registers, stages it in shared memory and sums the filter
//     segments of the chunk, a filter cut by the chunk edge carrying its
//     partial sum into the next chunk (no filter spans more than two);
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

// The bf16 mode: FRAMES = 64·CWG frames of one sample per block, the DFT
// stage's consumers and producer (dft_stage.cuh). Per chunk of 64 bins the
// consumers write the power tile P[bin row][frame], then sum the filter
// segments that fall in the chunk (mel_segments in ops/dft_stage.py):
// thread ctid takes frame ctid % FRAMES of segments ctid / FRAMES,
// + CONSUMERS / FRAMES, …; a filter cut by a chunk edge carries its partial
// sum in carry[slot][frame] into the next chunk. Finished filters go out as
// sqrt → dB or amplitude, stored along T.
constexpr int CARRY_SLOTS = 8;
constexpr int SEG_FROM = 1, SEG_TO = 2;

template <int CWG>
__global__ void __launch_bounds__(DftShape<CWG>::THREADS, 1)
    mel_dft_kernel(const float* __restrict__ x, int n, int pad_left,
                   const __nv_bfloat16* __restrict__ wt, const int* __restrict__ seg_ptr,
                   const int4* __restrict__ segs, const float* __restrict__ mel_w,
                   int n_mels, float* __restrict__ out, float* __restrict__ tile_max,
                   int n_dft, int hop, int n_frames, int n_chunks, int packed,
                   int decibel, float amin) {
  using S = DftShape<CWG>;
  constexpr int FRAMES = S::FRAMES, PLD = S::PLD;
  extern __shared__ __align__(16) unsigned char smem[];
  const DftSmem<CWG> sm(smem, CARRY_SLOTS * FRAMES);
  float* P = sm.P;
  float* carry = sm.extra;  // [CARRY_SLOTS][FRAMES]

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
  float* ob = out + (size_t)b * n_mels * n_frames + t;
  float vmax = -INFINITY;
  int it = 0;
  for (int c = 0; c < n_chunks; ++c) {
    float d[DFT_ACC];
    dft_chunk(d, a_lo, a_hi, sm.ring, sm.bars, n_kt, it, lane);
    bar_sync(1, S::CONSUMERS);  // the last chunk's segments are done with P
    dft_power(d, r_lo, q, c == 0 && packed && q == 0,
              [P](int row, int r, float p) { P[row * PLD + r] = p; });
    bar_sync(1, S::CONSUMERS);
    for (int i = __ldg(seg_ptr + c) + tid / FRAMES; i < __ldg(seg_ptr + c + 1);
         i += S::CONSUMERS / FRAMES) {
      const int4 sg = __ldg(segs + i);
      const int m = sg.x & 0xffff, slot = (sg.x >> 16) & 0xff, flags = sg.x >> 24;
      float acc = (flags & SEG_FROM) ? carry[slot * FRAMES + f] : 0.f;
      const float* pr = P + sg.y * PLD + f;
      for (int j = 0; j < sg.z; ++j) acc = fmaf(__ldg(mel_w + sg.w + j), pr[j * PLD], acc);
      if (flags & SEG_TO) {
        carry[slot * FRAMES + f] = acc;
      } else if (t < n_frames) {
        const float amp = sqrtf(fmaxf(acc, 0.f));
        const float v = decibel ? 10.f * log10f(fmaxf(amp, amin)) : amp;
        ob[(size_t)m * n_frames] = v;
        vmax = fmaxf(vmax, v);
      }
    }
  }
  if (decibel) consumers_max<CWG>(vmax, sm.red, tile_max + b * gridDim.x + tile, tid);
}

template <int CWG>
int launch_bf16(const float* x, int batch, int n, int pad_left, const void* wt,
                const int* seg_ptr, const int4* segs, const float* mel_w, int n_mels,
                float* out, float* tile_max, int n_dft, int hop, int n_frames, int n_chunks,
                int packed, int decibel, float amin, float dynamic_range,
                cudaStream_t stream) {
  using S = DftShape<CWG>;
  const size_t smem = dft_smem_bytes<CWG>(n_dft, hop, CARRY_SLOTS * S::FRAMES);
  auto kernel = mel_dft_kernel<CWG>;
  static size_t smem_set[MAX_DEVICES] = {};  // per device: see raise_smem_limit
  if (int rc = raise_smem_limit(kernel, smem, smem_set)) return rc;
  const int n_tiles = (n_frames + S::FRAMES - 1) / S::FRAMES;
  kernel<<<dim3(n_tiles, batch), S::THREADS, smem, stream>>>(
      x, n, pad_left, static_cast<const __nv_bfloat16*>(wt), seg_ptr, segs, mel_w, n_mels, out,
      tile_max, n_dft, hop, n_frames, n_chunks, packed, decibel, amin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !decibel) return (int)err;
  return launch_db_finalize(out, tile_max, batch, n_tiles, n_mels * n_frames,
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
  static size_t smem_set[MAX_DEVICES] = {};  // per device: see raise_smem_limit
  if (int rc = raise_smem_limit(kernel, smem, smem_set)) return rc;
  const int n_tiles = (n_frames + FFT_FRAMES - 1) / FFT_FRAMES;
  kernel<<<dim3(n_tiles, batch), THREADS, smem, stream>>>(
      x, n, pad_left, win, tw, mel_ptr, mel_lo, mel_w, n_mels, out, tile_max, hop,
      n_frames, decibel, amin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !decibel) return (int)err;
  return launch_db_finalize(out, tile_max, batch, n_tiles, n_mels * n_frames,
                            dynamic_range, stream);
}

}  // namespace

extern "C" {

// Basis columns per chunk of the bf16 mode and frames per block of the f32
// mode: the wrapper lays out the bases and the tile-max scratch to match.
int l3_mel_cols_per_chunk() { return DFT_COLS; }
int l3_mel_fft_frames_per_block() { return FFT_FRAMES; }

// bf16 mode. x: (batch, n) f32 waveform; wt: (n_chunks, n_dft/64, 128·64)
// bf16 basis stages (ops/dft_stage.py: interleaved columns, swizzled);
// seg_ptr (n_chunks+1,) int32 and segs (n_segs, 4) int32: the filterbank's
// CSR rows cut at chunk edges; mel_w (nnz,) f32: their weights; out:
// (batch, n_mels, n_frames) f32; tile_max: (batch, ceil(n_frames/frames))
// f32 scratch. frames_per_block 64 or 128, n_dft a multiple of 64, hop
// even; packed: pair 0 holds bins 0 and N/2 (n_dft a multiple of 128).
// Returns a cudaError_t code: 0 on success.
int l3_mel_frontend_bf16(const void* x, int batch, int n, int pad_left, const void* wt,
                         const void* seg_ptr, const void* segs, const void* mel_w, void* out,
                         void* tile_max, int n_dft, int hop, int n_frames, int n_chunks,
                         int n_mels, int frames_per_block, int decibel, float amin,
                         float dynamic_range, void* stream) {
  if (n_dft % DFT_KT != 0 || hop % 2 != 0 || n_mels > 0xffff) return (int)cudaErrorInvalidValue;
  const int packed = n_dft % DFT_COLS == 0;
  if (n_chunks * DFT_COLS != n_dft + (packed ? 0 : DFT_BINS)) return (int)cudaErrorInvalidValue;
#define L3_LAUNCH(CWG)                                                                   \
  return launch_bf16<CWG>(static_cast<const float*>(x), batch, n, pad_left, wt,          \
                          static_cast<const int*>(seg_ptr), static_cast<const int4*>(segs), \
                          static_cast<const float*>(mel_w), n_mels, static_cast<float*>(out), \
                          static_cast<float*>(tile_max), n_dft, hop, n_frames, n_chunks,  \
                          packed, decibel, amin, dynamic_range,                          \
                          static_cast<cudaStream_t>(stream))
  if (frames_per_block == 128) L3_LAUNCH(2);
  if (frames_per_block == 64) L3_LAUNCH(1);
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
