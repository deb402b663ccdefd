// The real-FFT stage of the Hopper front-end kernels' f32 mode
// (mel_frontend.cu, spec_frontend.cu): the power spectrum |X[k]|²,
// k = 0…N/2, of each windowed frame of N = n_dft samples.
//
// A block of THREADS threads owns FFT_FRAMES consecutive frames of one
// sample and stages their waveform span in shared memory (stage_span,
// frontend_common.cuh). Each warp takes one frame at a time:
//   * window on load: the frame's samples are read from the span in pairs
//     and multiplied by an f32 window table (a Hann window of n_win centred
//     in n_dft, zero outside);
//   * a real FFT of N points through a complex FFT of M = N/2 points:
//     z[n] = xw[2n] + i·xw[2n+1];
//   * the complex FFT is a Stockham (autosort) FFT: a radix-2 pass first
//     when log2 M is odd, then radix-4 passes, in the warp's own buffer in
//     shared memory, in place (each pass reads all its inputs into
//     registers, syncs the warp, then writes). Point n is stored at
//     n + n/16, which keeps the strided stores of the early passes nearly
//     free of bank conflicts;
//   * the real post-pass, X[k] = ½(Z[k] + Z̄[M−k]) − ½·i·e^{−2πik/N}·(Z[k] −
//     Z̄[M−k]) with X[0] = Re Z0 + Im Z0 and X[M] = Re Z0 − Im Z0, then the
//     power re² + im² in f32.
// Twiddles come from f32 tables built on the host in float64 (ops/
// fft_stage.py), never from __sinf.
//
// The work per frame is O(N log N), ~53 kflop at n_dft 2048 where the DFT
// product it replaces was 2·N·(N+2) ≈ 8.4 Mflop. (Times and bounds on the
// H100: PERF.md.)

#pragma once

#include <type_traits>

#include "frontend_common.cuh"

namespace {

constexpr int FFT_FRAMES = 16;           // frames per block
constexpr int FFT_WARPS = THREADS / 32;  // frames in flight per block
constexpr int FFT_TLD = FFT_FRAMES + 1;  // row stride of a block's output tile
constexpr int FFT_MIN_N = 64, FFT_MAX_N = 2048;  // the n_dft it is built for

__host__ __device__ constexpr int fft_pad(int i) { return i + (i >> 4); }
__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v >> 1); }

// float2 slots of one warp's buffer of M points; as floats it also holds
// a power row of M + 1 values.
template <int M>
__host__ __device__ constexpr int fft_buf_len() {
  return fft_pad(M - 1) + 1;
}

// Floats of the waveform span of FFT_FRAMES frames of 2M samples.
__host__ __device__ inline int fft_seg_len(int m, int hop) {
  return (FFT_FRAMES - 1) * hop + 2 * m;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In place: the R-point DFT (R = 2 or 4) of v, with e^{−2πi/R}.
template <int R>
__device__ __forceinline__ void dft_small(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = make_float2(a.x + b.x, a.y + b.y);
    v[1] = make_float2(a.x - b.x, a.y - b.y);
  } else {
    const float2 s02 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
    const float2 d02 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
    const float2 s13 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
    const float2 d13 = make_float2(v[1].x - v[3].x, v[1].y - v[3].y);
    v[0] = make_float2(s02.x + s13.x, s02.y + s13.y);
    v[1] = make_float2(d02.x + d13.y, d02.y - d13.x);  // d02 − i·d13
    v[2] = make_float2(s02.x - s13.x, s02.y - s13.y);
    v[3] = make_float2(d02.x - d13.y, d02.y + d13.x);  // d02 + i·d13
  }
}

// One Stockham pass of radix R over M points, after passes whose radices
// multiply to P (P = 1 for the first). Butterfly i takes input i + r·M/R,
// r < R, multiplies input r by W_{P·R}^{r·k} = tw[r·k·M/(P·R)] (k = i mod P,
// tw[j] = e^{−2πij/M}), and writes its output r to point (i − k)·R + k + r·P
// of buf. Lane l takes butterflies i = l + 32·j.
//
// Each point index is split into a part that depends on the lane alone and a
// compile-time part (for j and r): k = k_lane + 32·(j mod P/32), and
// (i − k)·R + k = w_lane + 32·R·(j − j mod P/32) + 32·(j mod P/32). The low
// four bits of the two parts never carry (tests/test_torch_port_fft.py
// checks every size), so fft_pad(n) = fft_pad(lane part) + fft_pad(constant
// part): each padded address is a per-lane base plus an immediate.
// load(c) gives input lane + c.
template <int M, int R, int P, typename Load>
__device__ __forceinline__ void fft_pass(Load load, float2* buf,
                                         const float2* __restrict__ tw, int lane) {
  constexpr int NB = M / R, PER = (NB + 31) / 32, STEP = M / (P * R);
  constexpr int PJ = P > 32 ? P / 32 : 1;  // j mod PJ picks k's high part
  const int k_lane = lane & (P - 1), w_lane = R * (lane - k_lane) + k_lane;
  float2 v[PER][R];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (NB % 32 != 0 && lane + 32 * j >= NB) continue;
#pragma unroll
    for (int r = 0; r < R; ++r) v[j][r] = load(32 * j + r * NB);
    if constexpr (P > 1) {
      const int k = k_lane + 32 * (j % PJ);
#pragma unroll
      for (int r = 1; r < R; ++r) v[j][r] = cmul(v[j][r], __ldg(tw + r * k * STEP));
    }
    dft_small<R>(v[j]);
  }
  __syncwarp();
  float2* out = buf + fft_pad(w_lane);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (NB % 32 != 0 && lane + 32 * j >= NB) continue;
    const int c = 32 * R * (j - j % PJ) + 32 * (j % PJ);
#pragma unroll
    for (int r = 0; r < R; ++r) out[fft_pad(c + r * P)] = v[j][r];
  }
  __syncwarp();
}

template <int M, int P>
__device__ __forceinline__ void fft_radix4_passes(float2* buf, const float2* __restrict__ tw,
                                                  int lane) {
  if constexpr (P < M) {
    const float2* in = buf + fft_pad(lane);
    fft_pass<M, 4, P>([in](int c) { return in[fft_pad(c)]; }, buf, tw, lane);
    fft_radix4_passes<M, 4 * P>(buf, tw, lane);
  }
}

// Z = FFT_M(z) of the frame starting at `frame` in the span (2M samples,
// 8-byte aligned), windowed on load, into buf in natural order. tw holds
// the M complex-FFT twiddles.
template <int M>
__device__ __forceinline__ void fft_frame(const float* frame, const float* __restrict__ win,
                                          const float2* __restrict__ tw, float2* buf,
                                          int lane) {
  constexpr int R0 = (ilog2(M) & 1) ? 2 : 4;
  const float2* f2 = reinterpret_cast<const float2*>(frame) + lane;
  const float2* w2 = reinterpret_cast<const float2*>(win) + lane;
  fft_pass<M, R0, 1>(
      [f2, w2](int c) {
        const float2 s = f2[c], w = __ldg(w2 + c);
        return make_float2(s.x * w.x, s.y * w.y);
      },
      buf, tw, lane);
  fft_radix4_passes<M, R0>(buf, tw, lane);
}

// The real post-pass and power: emit(k, |X[k]|²) for k = 0…M, from Z in
// buf; twp holds e^{−2πik/N}, k < M. Every read of buf comes before the
// first emit, so emit may overwrite buf. Lane l takes k = l + 32·j up to
// M/2, and with each k its mirror M − k = (32 − l) + (M − 32 − 32·j), both
// split as in fft_pass.
template <int M, typename Emit>
__device__ __forceinline__ void real_power(const float2* buf, const float2* __restrict__ twp,
                                           int lane, Emit emit) {
  constexpr int NK = M / 2 + 1, PER = (NK + 31) / 32;
  const float2* zk = buf + fft_pad(lane);
  const float2* zm = buf + fft_pad(32 - lane);
  float lo[PER], hi[PER];  // |X[k]|², |X[M − k]|²
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int k = lane + 32 * j;
    if (k >= NK) continue;
    const float2 a = zk[fft_pad(32 * j)];
    if (k == 0) {
      lo[j] = (a.x + a.y) * (a.x + a.y);
      hi[j] = (a.x - a.y) * (a.x - a.y);
      continue;
    }
    const float2 b = zm[fft_pad(M - 32 - 32 * j)], w = __ldg(twp + k);
    const float er = 0.5f * (a.x + b.x), ei = 0.5f * (a.y - b.y);  // ½(Z[k] + Z̄[M−k])
    const float dr = 0.5f * (a.x - b.x), di = 0.5f * (a.y + b.y);  // ½(Z[k] − Z̄[M−k])
    const float wr = w.x * dr - w.y * di, wi = w.x * di + w.y * dr;
    const float xr = er + wi, xi = ei - wr;   // X[k] = e − i·w·d
    const float yr = er - wi, yi = -ei - wr;  // X[M−k] = ē − i·conj(w·d)
    lo[j] = xr * xr + xi * xi;
    hi[j] = yr * yr + yi * yi;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int k = lane + 32 * j;
    if (k >= NK) continue;
    emit(k, lo[j]);
    if (M - k != k) emit(M - k, hi[j]);
  }
}

// Store a block's output tile ([rows][FFT_TLD], frame f in column f) into
// ob[row · n_frames + f] for the frames f < n_frames − t0 that exist:
// consecutive threads take consecutive frames of a row, so the stores run
// along T. Returns this thread's max of what it stored.
__device__ __forceinline__ float store_tile(const float* tile, int rows, float* __restrict__ ob,
                                            int n_frames, int t0, int tid) {
  float vmax = -INFINITY;
  const int valid = min(FFT_FRAMES, n_frames - t0);
  for (int i = tid; i < rows * FFT_FRAMES; i += THREADS) {
    const int row = i / FFT_FRAMES, f = i % FFT_FRAMES;
    if (f >= valid) continue;
    const float v = tile[row * FFT_TLD + f];
    ob[(size_t)row * n_frames + f] = v;
    vmax = fmaxf(vmax, v);
  }
  return vmax;
}

// Shared memory of an f32 front-end block: the warps' FFT buffers, the
// waveform span (8-byte aligned behind them, for the paired reads), then an
// output tile of `tile_floats`.
template <int M>
size_t fft_smem_bytes(int hop, int tile_floats) {
  return FFT_WARPS * fft_buf_len<M>() * sizeof(float2) +
         (fft_seg_len(M, hop) + tile_floats) * sizeof(float);
}

// f(std::integral_constant<int, M>) for M = n_dft/2, n_dft a power of two
// in [FFT_MIN_N, FFT_MAX_N]; cudaErrorInvalidValue for any other n_dft.
template <typename F>
int with_fft_size(int n_dft, F&& f) {
  static_assert(FFT_MIN_N == 64 && FFT_MAX_N == 2048, "the cases below");
  switch (n_dft) {
    case 64: return f(std::integral_constant<int, 32>{});
    case 128: return f(std::integral_constant<int, 64>{});
    case 256: return f(std::integral_constant<int, 128>{});
    case 512: return f(std::integral_constant<int, 256>{});
    case 1024: return f(std::integral_constant<int, 512>{});
    case 2048: return f(std::integral_constant<int, 1024>{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
