// Train-mode BatchNorm for Hopper (sm_90a): flax's train mode, per channel
// over N·H·W, forward and backward in four streaming passes.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA (flax).
// Added because the port's train step spent ~80 % of its device time in the
// same function written out in tensor ops (models/towers.py::_bn_f32): each
// of its f32 elementwise kernels and casts, and autograd's backward of them,
// reads or writes a full-size tensor, ~230 bytes an element in all.
//
// Bound: bytes. Per element the work needs x read twice and y written once
// forward, dy and x read twice and dx written once backward: 16 bytes for a
// bf16 tensor (the conv BNs), ~100 GB a cnn_L3_melspec2 step at 256 pairs,
// ~30 ms at 3.35 TB/s. The arithmetic is a few flops an element.
//
// Design. Only (C,)-sized vectors pass between the passes:
//   1. bn_sums_*<In>: Σx and Σx² in f32, one partial a CTA; bn_combine adds
//      a channel's partials in a fixed order, in double, into sums (2C + 1:
//      Σx, Σx², the count M);
//   2. bn_forward_finalize gives mean, var = max(E[x²] − mean², 0) (flax's
//      fast variance), rstd = 1/sqrt(var + eps), mul = rstd·γ, a flag for a
//      variance clipped at 0, and updates the running statistics in place
//      (ra = keep·ra + take·batch, the biased variance);
//      bn_normalise_*<In, Out>: y = (x − mean)·mul + β, each step rounded to
//      f32 as the written-out tensor ops round it, stored in Out;
//   3. bn_grad_sums_*<In, Out>: Σdy and Σdy·(x − mean), partials and combine
//      as in 1;
//   4. bn_backward_finalize: dβ = Σdy, dγ = rstd·Σdy(x − mean), and the
//      coefficients of dx; bn_grad_x_*<In, Out> (only when x takes a gradient):
//      dx = mul·(dy − Σdy/M) − [not clipped]·γ·rstd³·Σdy(x − mean)·(x − mean)/M,
//      the closed form of the written-out graph's gradient (the clamp passes
//      no gradient below 0).
// Each numbered step is an entry point. Under sync BN (data parallelism) the
// caller all-reduces the sums after 1, M with them, and after 3, so that the
// statistics and dx's coefficients are the global batch's (dγ and dβ stay
// each rank's own, as the written-out graph's); outside it the sums go on
// as they are.
// Two layouts, as the towers hand them over: NCHW (`_nchw` kernels) and
// channels-last NHWC (`_nhwc`: the vision tower, whose frames arrive NHWC,
// and the audio tower, whose one-channel input is both, so cuDNN runs its
// convs NHWC; a copy to NCHW cost every conv two layout transposes). y and
// dx keep x's layout. In NCHW every pass walks the grid (slice, channel):
// blockIdx.y a channel, blockIdx.x a slice of that channel's N·H·W
// elements, so that a layer of few channels still fills the card; the
// channel's elements are walked as one index m = n·HW + j, the plane n and
// offset j carried along, so small planes (HW = 768) keep every lane busy.
// In NHWC x is N·H·W rows of C channels: blockIdx.x a slice of rows,
// blockIdx.y a group of channel vectors; a thread keeps one vector's
// channels for the CTA's life and walks rows, and the CTA's partial sums
// are reduced over its rows in shared memory. Either way a thread takes
// 16-byte vectors, UNROLL of them loaded before any is used; a tensor whose
// rows or planes do not split into whole vectors, or a pointer off the
// vectors' alignment, takes the same kernels one element a step. No float
// atomics: a channel's sums are the same bits from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr int FINALIZE_THREADS = 256;  // combine: a warp a channel; finalize: a thread

// VEC elements of T as 32-bit words (a bf16 scalar: one word, low half).
template <typename T, int VEC>
struct Raw {
  static constexpr int BYTES = VEC * (int)sizeof(T);
  static constexpr int WORDS = BYTES < 4 ? 1 : BYTES / 4;
  uint32_t w[WORDS];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_raw(const T* __restrict__ p, Raw<T, VEC>& r) {
  constexpr int BYTES = Raw<T, VEC>::BYTES;
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + k);
      r.w[4 * k] = q.x;
      r.w[4 * k + 1] = q.y;
      r.w[4 * k + 2] = q.z;
      r.w[4 * k + 3] = q.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = q.x;
    r.w[1] = q.y;
  } else if constexpr (BYTES == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// The words as floats (bf16 → f32 is exact: the high half of the word).
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& r, float (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(r.w[i]);
    } else {
      const uint32_t word = r.w[i / 2];
      v[i] = __uint_as_float(i % 2 ? (word & 0xffff0000u) : (word << 16));
    }
  }
}

// VEC floats stored as T at p (bf16: rounded to nearest even, as torch's cast).
template <typename T, int VEC>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[VEC]) {
  Raw<T, VEC> r;
#pragma unroll
  for (int i = 0; i < Raw<T, VEC>::WORDS; ++i) r.w[i] = 0;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if constexpr (sizeof(T) == 4) {
      r.w[i] = __float_as_uint(v[i]);
    } else {
      const uint32_t bits = __bfloat16_as_ushort(__float2bfloat16_rn(v[i]));
      r.w[i / 2] |= bits << (16 * (i % 2));
    }
  }
  constexpr int BYTES = Raw<T, VEC>::BYTES;
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k)
      reinterpret_cast<uint4*>(p)[k] = make_uint4(r.w[4 * k], r.w[4 * k + 1], r.w[4 * k + 2], r.w[4 * k + 3]);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<unsigned int*>(p) = r.w[0];
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)r.w[0];
  }
}

// The layer's shape and the slices' size: channel blockIdx.y, slice
// blockIdx.x of `per` vectors of VEC elements (the last slice shorter).
struct Shape {
  int c;          // channels
  long long hw;   // H·W
  long long m;    // N·H·W, a channel's element count
  long long per;  // vectors a slice
};

// A thread's walk over its channel's elements m0, m0 + stride, … < m1, with
// each position's element offset (n·C + c)·HW + j.
template <int VEC>
struct Walk {
  long long m, m1, j, off;
  long long hw, plane_step;  // HW; C·HW, from a plane of the channel to the next
  long long step_n, step_j;  // the stride THREADS·VEC = step_n·HW + step_j

  __device__ __forceinline__ explicit Walk(const Shape& s) {
    const long long m0 = (long long)blockIdx.x * s.per * VEC;
    m1 = min(m0 + s.per * VEC, s.m);
    m = m0 + (long long)threadIdx.x * VEC;
    hw = s.hw;
    plane_step = (long long)s.c * s.hw;
    const long long n = m / hw;
    j = m - n * hw;
    off = n * plane_step + (long long)blockIdx.y * hw + j;
    step_n = ((long long)THREADS * VEC) / hw;
    step_j = (long long)THREADS * VEC - step_n * hw;
  }

  __device__ __forceinline__ bool valid() const { return m < m1; }

  __device__ __forceinline__ void advance() {
    m += (long long)THREADS * VEC;
    j += step_j;
    off += step_n * plane_step + step_j;
    if (j >= hw) {
      j -= hw;
      off += plane_step - hw;
    }
  }
};

// The block's sums of a and b, in a fixed order, into *out_a and *out_b
// (thread 0 writes).
__device__ __forceinline__ void block_sum2(float a, float b, float* out_a, float* out_b) {
  __shared__ float red[2][WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      sa += red[0][w];
      sb += red[1][w];
    }
    *out_a = sa;
    *out_b = sb;
  }
}

// partials: (2, C, S) f32, S = gridDim.x; this CTA's two sums.
__device__ __forceinline__ void write_partials(float a, float b, float* __restrict__ partials) {
  const size_t s = gridDim.x, c = blockIdx.y, C = gridDim.y;
  block_sum2(a, b, partials + c * s + blockIdx.x, partials + (C + c) * s + blockIdx.x);
}

// A channel's two partial sums combined over its S slices, in double, in a
// fixed order (lane-strided, then a shuffle tree); every lane gets them.
__device__ __forceinline__ void channel_sums(const float* __restrict__ partials, int C, int S, int c,
                                             double& a, double& b) {
  const int lane = threadIdx.x % 32;
  a = 0.0;
  b = 0.0;
  for (int s = lane; s < S; s += 32) {
    a += partials[(size_t)c * S + s];
    b += partials[((size_t)C + c) * S + s];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Pass 1: Σx, Σx².
template <typename In, int VEC>
__global__ void __launch_bounds__(THREADS) bn_sums_nchw(const In* __restrict__ x, Shape s, float* __restrict__ partials) {
  Walk<VEC> w(s);
  float sx = 0.f, sxx = 0.f;
  while (w.valid()) {
    Raw<In, VEC> r[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = w.valid();
      if (ok[u]) load_raw(x + w.off, r[u]);
      w.advance();
    }
    float lx = 0.f, lxx = 0.f;  // this round's sums, added to the thread's once
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float v[VEC];
      unpack(r[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        lx += v[i];
        lxx += v[i] * v[i];
      }
    }
    sx += lx;
    sxx += lxx;
  }
  write_partials(sx, sxx, partials);
}

// partials (2, C, S) → sums (2C) f64: a channel's two sums in sums[c] and
// sums[C + c]; with count ≥ 0 also sums[2C] = count, the element count M,
// which the forward's finalize reads from there (under sync BN the sum of
// every rank's).
__global__ void __launch_bounds__(FINALIZE_THREADS)
    bn_combine(const float* __restrict__ partials, int C, int S, long long count, double* __restrict__ sums) {
  const int c = (blockIdx.x * FINALIZE_THREADS + threadIdx.x) / 32;
  if (c >= C) return;  // whole warps leave together
  double a, b;
  channel_sums(partials, C, S, c, a, b);
  if (threadIdx.x % 32 != 0) return;
  sums[c] = a;
  sums[C + c] = b;
  if (count >= 0 && c == 0) sums[2 * C] = (double)count;
}

// sums: (2C + 1) f64 — Σx, Σx², M: this batch's or, under sync BN, every
// rank's added. stats: (4, C) f32 — mean, mul, rstd, clipped (1.0 where
// E[x²] − mean² < 0). One thread a channel.
__global__ void __launch_bounds__(FINALIZE_THREADS)
    bn_forward_finalize(const double* __restrict__ sums, int C, const float* __restrict__ weight, float eps,
                        float keep, float take, float* __restrict__ running_mean, float* __restrict__ running_var,
                        float* __restrict__ stats) {
  const int c = blockIdx.x * FINALIZE_THREADS + threadIdx.x;
  if (c >= C) return;
  const double m = sums[2 * C];
  const float mean = (float)(sums[c] / m);
  const float ex2 = (float)(sums[C + c] / m);
  const float raw = __fsub_rn(ex2, __fmul_rn(mean, mean));
  const float var = fmaxf(raw, 0.f);
  const float rstd = 1.f / sqrtf(__fadd_rn(var, eps));
  stats[c] = mean;
  stats[C + c] = __fmul_rn(rstd, weight[c]);
  stats[2 * C + c] = rstd;
  stats[3 * C + c] = raw < 0.f ? 1.f : 0.f;
  running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], keep), __fmul_rn(mean, take));
  running_var[c] = __fadd_rn(__fmul_rn(running_var[c], keep), __fmul_rn(var, take));
}

// Pass 2: y = (x − mean)·mul + β.
template <typename In, typename Out, int VEC>
__global__ void __launch_bounds__(THREADS)
    bn_normalise_nchw(const In* __restrict__ x, Out* __restrict__ y, Shape s, const float* __restrict__ stats,
                 const float* __restrict__ bias) {
  const int c = blockIdx.y;
  const float mean = stats[c], mul = stats[s.c + c], beta = bias[c];
  Walk<VEC> w(s);
  while (w.valid()) {
    Raw<In, VEC> r[UNROLL];
    long long off[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = w.valid();
      off[u] = w.off;
      if (ok[u]) load_raw(x + w.off, r[u]);
      w.advance();
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float v[VEC];
      unpack(r[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i], mean), mul), beta);
      store(y + off[u], v);
    }
  }
}

// Pass 3: Σdy, Σdy·(x − mean).
template <typename In, typename Out, int VEC>
__global__ void __launch_bounds__(THREADS)
    bn_grad_sums_nchw(const Out* __restrict__ dy, const In* __restrict__ x, Shape s, const float* __restrict__ stats,
                 float* __restrict__ partials) {
  const float mean = stats[blockIdx.y];
  Walk<VEC> w(s);
  float sg = 0.f, sgx = 0.f;
  while (w.valid()) {
    Raw<Out, VEC> rg[UNROLL];
    Raw<In, VEC> rx[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = w.valid();
      if (ok[u]) {
        load_raw(dy + w.off, rg[u]);
        load_raw(x + w.off, rx[u]);
      }
      w.advance();
    }
    float lg = 0.f, lgx = 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float g[VEC], v[VEC];
      unpack(rg[u], g);
      unpack(rx[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        lg += g[i];
        lgx += g[i] * __fsub_rn(v[i], mean);
      }
    }
    sg += lg;
    sgx += lgx;
  }
  write_partials(sg, sgx, partials);
}

// local, global: (2C) f64 — Σdy, Σdy·(x − mean) over this batch and over
// every rank's (the same tensor outside sync BN); count: the forward's M.
// dweight, dbias: (C,) f32 from local, each rank's own share, as the
// written-out graph gives it; coef: (2, C) f32 from global — Σdy/M and the
// variance term's factor [not clipped]·γ·rstd³·Σdy(x − mean)/M.
__global__ void __launch_bounds__(FINALIZE_THREADS)
    bn_backward_finalize(const double* __restrict__ local, const double* __restrict__ global,
                         const double* __restrict__ count, int C, const float* __restrict__ weight,
                         const float* __restrict__ stats, float* __restrict__ dweight, float* __restrict__ dbias,
                         float* __restrict__ coef) {
  const int c = blockIdx.x * FINALIZE_THREADS + threadIdx.x;
  if (c >= C) return;
  const double m = *count;
  const double rstd = stats[2 * C + c];
  const bool clipped = stats[3 * C + c] != 0.f;
  dbias[c] = (float)local[c];
  dweight[c] = (float)(rstd * local[C + c]);
  coef[c] = (float)(global[c] / m);
  coef[C + c] = clipped ? 0.f : (float)((double)weight[c] * rstd * rstd * rstd * global[C + c] / m);
}

// Pass 4: dx = mul·(dy − Σdy/M) − k·(x − mean).
template <typename In, typename Out, int VEC>
__global__ void __launch_bounds__(THREADS)
    bn_grad_x_nchw(const Out* __restrict__ dy, const In* __restrict__ x, In* __restrict__ dx, Shape s,
              const float* __restrict__ stats, const float* __restrict__ coef) {
  const int c = blockIdx.y;
  const float mean = stats[c], mul = stats[s.c + c], b = coef[c], k = coef[s.c + c];
  Walk<VEC> w(s);
  while (w.valid()) {
    Raw<Out, VEC> rg[UNROLL];
    Raw<In, VEC> rx[UNROLL];
    long long off[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = w.valid();
      off[u] = w.off;
      if (ok[u]) {
        load_raw(dy + w.off, rg[u]);
        load_raw(x + w.off, rx[u]);
      }
      w.advance();
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float g[VEC], v[VEC];
      unpack(rg[u], g);
      unpack(rx[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = mul * (g[i] - b) - k * (v[i] - mean);
      store(dx + off[u], v);
    }
  }
}

// ---------------------------------------------------------------- NHWC

// Channels-last: R = N·H·W rows of C channels, `cv` = C / VEC vectors a row.
// A CTA: rows [blockIdx.x·per, …) of channel vectors [blockIdx.y·g, … + g);
// thread t takes vector blockIdx.y·g + t % g of rows t / g, + THREADS / g, ….
struct Rows {
  int c;           // channels
  int cv;          // channel vectors a row
  int g;           // channel vectors a CTA, min(cv, THREADS)
  long long rows;  // N·H·W
  long long per;   // rows a slice
};

template <int VEC>
struct RowWalk {
  long long r, r1, off, step;
  int lane, rlane, rp;  // vector in the group, row lane, rows a round
  bool active;
  int channel;  // this thread's first channel

  __device__ __forceinline__ explicit RowWalk(const Rows& s) {
    lane = threadIdx.x % s.g;
    rlane = threadIdx.x / s.g;
    rp = THREADS / s.g;
    const int vec = blockIdx.y * s.g + lane;
    channel = vec * VEC;
    active = rlane < rp && vec < s.cv;
    const long long r0 = (long long)blockIdx.x * s.per;
    r1 = min(r0 + s.per, s.rows);
    r = r0 + rlane;
    off = r * s.c + channel;
    step = (long long)rp * s.c;
  }

  __device__ __forceinline__ bool valid() const { return active && r < r1; }

  __device__ __forceinline__ void advance() {
    r += rp;
    off += step;
  }
};

// The CTA's per-channel sums of a and b over its row lanes, in a fixed
// order, into partials (2, C, S) at slice blockIdx.x.
template <int VEC>
__device__ __forceinline__ void write_row_partials(const RowWalk<VEC>& w, const Rows& s, const float (&a)[VEC],
                                                   const float (&b)[VEC], float* __restrict__ partials) {
  __shared__ float red[2][THREADS * VEC];
  const int width = s.g * VEC;  // channels of the group
  if (w.rlane < w.rp) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[0][w.rlane * width + w.lane * VEC + i] = a[i];
      red[1][w.rlane * width + w.lane * VEC + i] = b[i];
    }
  }
  __syncthreads();
  const size_t S = gridDim.x;
  for (int k = threadIdx.x; k < width; k += THREADS) {
    const int c = blockIdx.y * width + k;
    if (c >= s.c) break;
    float sa = 0.f, sb = 0.f;
    for (int l = 0; l < w.rp; ++l) {
      sa += red[0][l * width + k];
      sb += red[1][l * width + k];
    }
    partials[(size_t)c * S + blockIdx.x] = sa;
    partials[((size_t)s.c + c) * S + blockIdx.x] = sb;
  }
}

// Pass 1, NHWC.
template <typename In, int VEC>
__global__ void __launch_bounds__(THREADS) bn_sums_nhwc(const In* __restrict__ x, Rows s, float* __restrict__ partials) {
  RowWalk<VEC> w(s);
  float sx[VEC], sxx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sx[i] = sxx[i] = 0.f;
  while (w.valid()) {
    Raw<In, VEC> r[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = w.valid();
      if (ok[u]) load_raw(x + w.off, r[u]);
      w.advance();
    }
    float lx[VEC], lxx[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) lx[i] = lxx[i] = 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float v[VEC];
      unpack(r[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        lx[i] += v[i];
        lxx[i] += v[i] * v[i];
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sx[i] += lx[i];
      sxx[i] += lxx[i];
    }
  }
  write_row_partials(w, s, sx, sxx, partials);
}

// Pass 2, NHWC.
template <typename In, typename Out, int VEC>
__global__ void __launch_bounds__(THREADS)
    bn_normalise_nhwc(const In* __restrict__ x, Out* __restrict__ y, Rows s, const float* __restrict__ stats,
                      const float* __restrict__ bias) {
  RowWalk<VEC> w(s);
  if (!w.active) return;
  float mean[VEC], mul[VEC], beta[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mean[i] = stats[w.channel + i];
    mul[i] = stats[s.c + w.channel + i];
    beta[i] = bias[w.channel + i];
  }
  while (w.valid()) {
    Raw<In, VEC> r[UNROLL];
    long long off[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = w.valid();
      off[u] = w.off;
      if (ok[u]) load_raw(x + w.off, r[u]);
      w.advance();
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float v[VEC];
      unpack(r[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i], mean[i]), mul[i]), beta[i]);
      store(y + off[u], v);
    }
  }
}

// Pass 3, NHWC.
template <typename In, typename Out, int VEC>
__global__ void __launch_bounds__(THREADS)
    bn_grad_sums_nhwc(const Out* __restrict__ dy, const In* __restrict__ x, Rows s, const float* __restrict__ stats,
                      float* __restrict__ partials) {
  RowWalk<VEC> w(s);
  float mean[VEC], sg[VEC], sgx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mean[i] = w.active ? stats[w.channel + i] : 0.f;
    sg[i] = sgx[i] = 0.f;
  }
  while (w.valid()) {
    Raw<Out, VEC> rg[UNROLL];
    Raw<In, VEC> rx[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = w.valid();
      if (ok[u]) {
        load_raw(dy + w.off, rg[u]);
        load_raw(x + w.off, rx[u]);
      }
      w.advance();
    }
    float lg[VEC], lgx[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) lg[i] = lgx[i] = 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float g[VEC], v[VEC];
      unpack(rg[u], g);
      unpack(rx[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        lg[i] += g[i];
        lgx[i] += g[i] * __fsub_rn(v[i], mean[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sg[i] += lg[i];
      sgx[i] += lgx[i];
    }
  }
  write_row_partials(w, s, sg, sgx, partials);
}

// Pass 4, NHWC.
template <typename In, typename Out, int VEC>
__global__ void __launch_bounds__(THREADS)
    bn_grad_x_nhwc(const Out* __restrict__ dy, const In* __restrict__ x, In* __restrict__ dx, Rows s,
                   const float* __restrict__ stats, const float* __restrict__ coef) {
  RowWalk<VEC> w(s);
  if (!w.active) return;
  float mean[VEC], mul[VEC], b[VEC], k[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mean[i] = stats[w.channel + i];
    mul[i] = stats[s.c + w.channel + i];
    b[i] = coef[w.channel + i];
    k[i] = coef[s.c + w.channel + i];
  }
  while (w.valid()) {
    Raw<Out, VEC> rg[UNROLL];
    Raw<In, VEC> rx[UNROLL];
    long long off[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = w.valid();
      off[u] = w.off;
      if (ok[u]) {
        load_raw(dy + w.off, rg[u]);
        load_raw(x + w.off, rx[u]);
      }
      w.advance();
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float g[VEC], v[VEC];
      unpack(rg[u], g);
      unpack(rx[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = mul[i] * (g[i] - b[i]) - k[i] * (v[i] - mean[i]);
      store(dx + off[u], v);
    }
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// 16-byte vectors of In (VEC elements) where every plane (NCHW) or row
// (NHWC) splits into whole vectors and the pointers sit on the vectors'
// alignment; else one element a step.
template <typename In, typename Out>
struct Plan {
  static constexpr int VEC = 16 / (int)sizeof(In);
  static constexpr int OUT_ALIGN = VEC * (int)sizeof(Out) < 16 ? VEC * (int)sizeof(Out) : 16;
};

int warp_blocks(int c) { return (c * 32 + FINALIZE_THREADS - 1) / FINALIZE_THREADS; }
int thread_blocks(int c) { return (c + FINALIZE_THREADS - 1) / FINALIZE_THREADS; }

// The grid of a layout's passes: (slices, channels) over NCHW planes, or
// (slices, channel-vector groups) over NHWC rows.
struct Grid {
  dim3 grid;
  Shape planes;
  Rows rows;
};

Grid make_grid(bool channels_last, long long n, int c, long long hw, int slices, int vec) {
  Grid g{};
  const long long m = n * hw;
  if (channels_last) {
    const int cv = c / vec;
    const int group = cv < THREADS ? cv : THREADS;
    g.rows = Rows{c, cv, group, m, (m + slices - 1) / slices};
    g.grid = dim3(slices, (cv + group - 1) / group);
  } else {
    g.planes = Shape{c, hw, m, (m / vec + slices - 1) / slices};
    g.grid = dim3(slices, c);
  }
  return g;
}

// Whether whole VEC-element vectors tile the layout: the planes (NCHW) or
// the rows (NHWC).
bool tiles(bool channels_last, int c, long long hw, int vec) {
  return channels_last ? c % vec == 0 : hw % vec == 0;
}

// The combine after a sums pass: the last launch's error, else the combine's.
int combine(const float* partials, int c, int slices, long long count, double* sums, cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_combine<<<warp_blocks(c), FINALIZE_THREADS, 0, stream>>>(partials, c, slices, count, sums);
  return (int)cudaGetLastError();
}

template <typename In, int VEC>
int sums_launch(bool nhwc, const In* x, long long n, int c, long long hw, int slices, float* partials,
                double* sums, cudaStream_t stream) {
  const Grid g = make_grid(nhwc, n, c, hw, slices, VEC);
  if (nhwc)
    bn_sums_nhwc<In, VEC><<<g.grid, THREADS, 0, stream>>>(x, g.rows, partials);
  else
    bn_sums_nchw<In, VEC><<<g.grid, THREADS, 0, stream>>>(x, g.planes, partials);
  return combine(partials, c, slices, n * hw, sums, stream);
}

template <typename In>
int sums_typed(bool nhwc, const In* x, long long n, int c, long long hw, int slices, float* partials,
               double* sums, cudaStream_t stream) {
  constexpr int VEC = Plan<In, In>::VEC;
  if (tiles(nhwc, c, hw, VEC) && aligned(x, 16))
    return sums_launch<In, VEC>(nhwc, x, n, c, hw, slices, partials, sums, stream);
  return sums_launch<In, 1>(nhwc, x, n, c, hw, slices, partials, sums, stream);
}

template <typename In, typename Out, int VEC>
int normalise_launch(bool nhwc, const In* x, Out* y, long long n, int c, long long hw, int slices,
                     const double* sums, const float* weight, const float* bias, float* running_mean,
                     float* running_var, float eps, float keep, float take, float* stats, cudaStream_t stream) {
  bn_forward_finalize<<<thread_blocks(c), FINALIZE_THREADS, 0, stream>>>(sums, c, weight, eps, keep, take,
                                                                         running_mean, running_var, stats);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Grid g = make_grid(nhwc, n, c, hw, slices, VEC);
  if (nhwc)
    bn_normalise_nhwc<In, Out, VEC><<<g.grid, THREADS, 0, stream>>>(x, y, g.rows, stats, bias);
  else
    bn_normalise_nchw<In, Out, VEC><<<g.grid, THREADS, 0, stream>>>(x, y, g.planes, stats, bias);
  return (int)cudaGetLastError();
}

template <typename In, typename Out>
int normalise_typed(bool nhwc, const In* x, Out* y, long long n, int c, long long hw, int slices,
                    const double* sums, const float* weight, const float* bias, float* running_mean,
                    float* running_var, float eps, float keep, float take, float* stats, cudaStream_t stream) {
  using P = Plan<In, Out>;
  if (tiles(nhwc, c, hw, P::VEC) && aligned(x, 16) && aligned(y, P::OUT_ALIGN))
    return normalise_launch<In, Out, P::VEC>(nhwc, x, y, n, c, hw, slices, sums, weight, bias, running_mean,
                                             running_var, eps, keep, take, stats, stream);
  return normalise_launch<In, Out, 1>(nhwc, x, y, n, c, hw, slices, sums, weight, bias, running_mean, running_var,
                                      eps, keep, take, stats, stream);
}

template <typename In, typename Out, int VEC>
int grad_sums_launch(bool nhwc, const Out* dy, const In* x, long long n, int c, long long hw, int slices,
                     const float* stats, float* partials, double* sums, cudaStream_t stream) {
  const Grid g = make_grid(nhwc, n, c, hw, slices, VEC);
  if (nhwc)
    bn_grad_sums_nhwc<In, Out, VEC><<<g.grid, THREADS, 0, stream>>>(dy, x, g.rows, stats, partials);
  else
    bn_grad_sums_nchw<In, Out, VEC><<<g.grid, THREADS, 0, stream>>>(dy, x, g.planes, stats, partials);
  return combine(partials, c, slices, -1, sums, stream);
}

template <typename In, typename Out>
int grad_sums_typed(bool nhwc, const Out* dy, const In* x, long long n, int c, long long hw, int slices,
                    const float* stats, float* partials, double* sums, cudaStream_t stream) {
  using P = Plan<In, Out>;
  if (tiles(nhwc, c, hw, P::VEC) && aligned(x, 16) && aligned(dy, P::OUT_ALIGN))
    return grad_sums_launch<In, Out, P::VEC>(nhwc, dy, x, n, c, hw, slices, stats, partials, sums, stream);
  return grad_sums_launch<In, Out, 1>(nhwc, dy, x, n, c, hw, slices, stats, partials, sums, stream);
}

template <typename In, typename Out, int VEC>
int grad_x_launch(bool nhwc, const Out* dy, const In* x, In* dx, long long n, int c, long long hw, int slices,
                  const double* local, const double* global, const double* count, const float* weight,
                  const float* stats, float* dweight, float* dbias, float* coef, cudaStream_t stream) {
  bn_backward_finalize<<<thread_blocks(c), FINALIZE_THREADS, 0, stream>>>(local, global, count, c, weight, stats,
                                                                          dweight, dbias, coef);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return (int)err;
  const Grid g = make_grid(nhwc, n, c, hw, slices, VEC);
  if (nhwc)
    bn_grad_x_nhwc<In, Out, VEC><<<g.grid, THREADS, 0, stream>>>(dy, x, dx, g.rows, stats, coef);
  else
    bn_grad_x_nchw<In, Out, VEC><<<g.grid, THREADS, 0, stream>>>(dy, x, dx, g.planes, stats, coef);
  return (int)cudaGetLastError();
}

template <typename In, typename Out>
int grad_x_typed(bool nhwc, const Out* dy, const In* x, In* dx, long long n, int c, long long hw, int slices,
                 const double* local, const double* global, const double* count, const float* weight,
                 const float* stats, float* dweight, float* dbias, float* coef, cudaStream_t stream) {
  using P = Plan<In, Out>;
  if (tiles(nhwc, c, hw, P::VEC) && aligned(x, 16) && aligned(dy, P::OUT_ALIGN) &&
      (dx == nullptr || aligned(dx, 16)))
    return grad_x_launch<In, Out, P::VEC>(nhwc, dy, x, dx, n, c, hw, slices, local, global, count, weight, stats,
                                          dweight, dbias, coef, stream);
  return grad_x_launch<In, Out, 1>(nhwc, dy, x, dx, n, c, hw, slices, local, global, count, weight, stats, dweight,
                                   dbias, coef, stream);
}

bool bad_shape(long long n, int c, long long hw, int slices) {
  return n <= 0 || c <= 0 || c > 65535 || hw <= 0 || slices <= 0;
}

}  // namespace

// The four entry points, in the order a layer calls them. Common arguments:
// x (n, c, h, w) with hw = h·w, dense in NCHW or, with channels_last, in
// NHWC, bf16 (in_bf16) or f32; y, dy: the same shape and layout in bf16
// (out_bf16) or f32; dx: like x; weight, bias, running_mean, running_var:
// (c,) f32; partials: (2, c, slices) f32 scratch; stats: (4, c) f32 (mean,
// mul, rstd, clipped); stream: a cudaStream_t. Each returns a cudaError_t
// code, 0 on success. Under sync BN the caller adds the sums of every rank
// between the first two (sums, M) and between the last two (the gradient's
// sums); outside it the sums go on as they are.
extern "C" {

// Pass 1 and its combine: sums (2c + 1) f64 out — Σx, Σx², then M = n·hw.
int l3_bn_train_sums(const void* x, int in_bf16, int channels_last, long long n, int c, long long hw, int slices,
                     void* partials, void* sums, void* stream) {
  if (bad_shape(n, c, hw, slices)) return (int)cudaErrorInvalidValue;
  const bool nhwc = channels_last != 0;
  const auto part = static_cast<float*>(partials);
  const auto out = static_cast<double*>(sums);
  const auto s = static_cast<cudaStream_t>(stream);
  if (in_bf16) return sums_typed(nhwc, static_cast<const __nv_bfloat16*>(x), n, c, hw, slices, part, out, s);
  return sums_typed(nhwc, static_cast<const float*>(x), n, c, hw, slices, part, out, s);
}

// The forward's finalize and pass 2, from sums (2c + 1) f64: stats out,
// running_* updated in place, y out.
int l3_bn_train_normalise(const void* x, void* y, int in_bf16, int out_bf16, int channels_last, long long n, int c,
                          long long hw, int slices, const void* sums, const void* weight, const void* bias,
                          void* running_mean, void* running_var, float eps, float keep, float take, void* stats,
                          void* stream) {
  if (bad_shape(n, c, hw, slices)) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const bool nhwc = channels_last != 0;
  const auto su = static_cast<const double*>(sums);
  const auto w = static_cast<const float*>(weight);
  const auto b = static_cast<const float*>(bias);
  const auto rm = static_cast<float*>(running_mean);
  const auto rv = static_cast<float*>(running_var);
  const auto st = static_cast<float*>(stats);
  const auto s = static_cast<cudaStream_t>(stream);
#define L3_NORMALISE(IN, OUT)                                                                                \
  return normalise_typed<IN, OUT>(nhwc, static_cast<const IN*>(x), static_cast<OUT*>(y), n, c, hw, slices, su, \
                                  w, b, rm, rv, eps, keep, take, st, s)
  if (in_bf16 && out_bf16) L3_NORMALISE(bf16, bf16);
  if (in_bf16) L3_NORMALISE(bf16, float);
  if (out_bf16) L3_NORMALISE(float, bf16);
  L3_NORMALISE(float, float);
#undef L3_NORMALISE
}

// Pass 3 and its combine: sums (2c) f64 out — Σdy, Σdy·(x − mean).
int l3_bn_train_grad_sums(const void* dy, const void* x, int in_bf16, int out_bf16, int channels_last, long long n,
                          int c, long long hw, int slices, const void* stats, void* partials, void* sums,
                          void* stream) {
  if (bad_shape(n, c, hw, slices)) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const bool nhwc = channels_last != 0;
  const auto st = static_cast<const float*>(stats);
  const auto part = static_cast<float*>(partials);
  const auto out = static_cast<double*>(sums);
  const auto s = static_cast<cudaStream_t>(stream);
#define L3_GRAD_SUMS(IN, OUT)                                                                                  \
  return grad_sums_typed<IN, OUT>(nhwc, static_cast<const OUT*>(dy), static_cast<const IN*>(x), n, c, hw, slices, \
                                  st, part, out, s)
  if (in_bf16 && out_bf16) L3_GRAD_SUMS(bf16, bf16);
  if (in_bf16) L3_GRAD_SUMS(bf16, float);
  if (out_bf16) L3_GRAD_SUMS(float, bf16);
  L3_GRAD_SUMS(float, float);
#undef L3_GRAD_SUMS
}

// The backward's finalize and pass 4: dweight, dbias (c,) f32 out from local
// (2c) f64, this batch's gradient sums; dx from global (2c) f64, every
// rank's (local itself outside sync BN), and count, the forward's M (f64);
// dx null when x takes no gradient (then only dweight, dbias). coef: (2, c)
// f32 scratch.
int l3_bn_train_grad_x(const void* dy, const void* x, void* dx, int in_bf16, int out_bf16, int channels_last,
                       long long n, int c, long long hw, int slices, const void* local, const void* global,
                       const void* count, const void* weight, const void* stats, void* dweight, void* dbias,
                       void* coef, void* stream) {
  if (bad_shape(n, c, hw, slices)) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const bool nhwc = channels_last != 0;
  const auto lo = static_cast<const double*>(local);
  const auto gl = static_cast<const double*>(global);
  const auto m = static_cast<const double*>(count);
  const auto w = static_cast<const float*>(weight);
  const auto st = static_cast<const float*>(stats);
  const auto dw = static_cast<float*>(dweight);
  const auto db = static_cast<float*>(dbias);
  const auto cf = static_cast<float*>(coef);
  const auto s = static_cast<cudaStream_t>(stream);
#define L3_GRAD_X(IN, OUT)                                                                                     \
  return grad_x_typed<IN, OUT>(nhwc, static_cast<const OUT*>(dy), static_cast<const IN*>(x), static_cast<IN*>(dx), \
                               n, c, hw, slices, lo, gl, m, w, st, dw, db, cf, s)
  if (in_bf16 && out_bf16) L3_GRAD_X(bf16, bf16);
  if (in_bf16) L3_GRAD_X(bf16, float);
  if (out_bf16) L3_GRAD_X(float, bf16);
  L3_GRAD_X(float, float);
#undef L3_GRAD_X
}

}  // extern "C"
