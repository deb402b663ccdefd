// What the two stages of the Hopper front-end kernels share: the DFT
// product of dft_stage.cuh (bf16 mode) and the real FFT of fft_stage.cuh
// (f32 mode), in mel_frontend.cu and spec_frontend.cu.
//
// A block owns a tile of consecutive frames of one sample. It stages the
// waveform span those frames cover into shared memory once (stage_span),
// with the zero padding applied as it loads, and reads frame t, sample k at
// seg[t·hop + k]: frames are never materialised.
//
// Per-sample dB crosses blocks: each block writes the max over its valid
// outputs (block_max), and db_finalize_kernel subtracts the sample's max and
// applies the floor.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, in every front-end kernel

__device__ __forceinline__ void store_operand(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_operand(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The waveform span of frames [t0, t0+FRAMES) of one sample, zero outside
// [0, n): the padding, applied on load, by the block's NT threads. The
// caller orders these stores before any read with a barrier.
template <int FRAMES, typename T, int NT = THREADS>
__device__ __forceinline__ void stage_span(const float* __restrict__ xb, int n,
                                           int pad_left, int t0, int n_dft,
                                           int hop, T* seg, int tid) {
  const int seg_len = (FRAMES - 1) * hop + n_dft;
  const long start = (long)t0 * hop - pad_left;
  for (int i = tid; i < seg_len; i += NT) {
    const long s = start + i;
    store_operand(seg + i, (s >= 0 && s < n) ? __ldg(xb + s) : 0.f);
  }
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

// Raise `kernel`'s dynamic shared-memory limit to `smem` bytes where the
// current device's limit is below it. cudaFuncSetAttribute applies to the
// current device only, so each launcher keeps the size set per device
// ordinal in its own static `set` and calls the runtime once per device and
// size, not on every launch.
constexpr int MAX_DEVICES = 64;
template <typename Kernel>
inline int raise_smem_limit(Kernel kernel, size_t smem, size_t (&set)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem <= set[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) set[dev] = smem;
  return (int)err;
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
