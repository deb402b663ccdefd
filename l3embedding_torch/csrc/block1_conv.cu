// The block-1 probe kernels for Hopper (sm_90a): a fused 3×3 SAME conv +
// scale/shift + ReLU on 64 channels (block-1 conv1_2 with BN in eval form),
// and the "operands resident on chip" GEMM that bounds any matmul-formulated
// version of it.
//
// Replace the TPU kernels of tools/pallas_block1_spike.py:
//   * l3_block1_gemm ← bench_gemm's `kernel`: out = bf16(relu((Σ_{i<reps}
//     A·W_i)·s + b)), A (m, k) and W (k, N) bf16, f32 accumulation;
//   * l3_block1_conv ← _fused_kernel: y = bf16(relu(conv3×3_SAME(x, W)·scale
//     + shift)), x and y (B, H, W, 64) NHWC bf16, W (576, 64) bf16 with rows
//     in (dy, dx, ci) order, f32 accumulation.
//
// Bounds on an H100 (989 TFLOP/s bf16, 3.35 TB/s). The GEMM probe at
// (3584, 576, 64) × 64 reps is 16.9 GFLOP on 4.7 MB: operations bind,
// ~17 µs. The conv at (128, 224, 224, 64) is 474 GFLOP on 1.64 GB of x in
// and y out, ~0.48 ms by operations and ~0.49 ms by bytes: the two limits
// meet, so the kernel has to keep the tensor cores busy while it streams.
//
// Design, both kernels: bf16 mma.sync m16n8k16 with f32 accumulators in
// registers, fragments read with ldmatrix (A row-major; W row-major (k, n)
// read with .trans), operands staged with cp.async. A simple kernel first:
// wgmma/TMA pipelining is later work.
//
// GEMM: the TPU kept A and W whole in one core's VMEM. A (4.1 MB) does not
// fit one SM, so M is split into 32-row tiles, one CTA each (112 CTAs for
// m = 3584); each stages its A rows and all of W in shared memory once and
// runs every rep from there. Each warp takes a quarter of K for half of N
// (both m-tiles), so one ldmatrix feeds several mma; the quarters are
// summed in shared memory before the epilogue.
//
// Conv: the TPU wrapper padded x to (B, 226, 232, 128) in HBM for Mosaic's
// DMA alignment, doubling the traffic; here the 1-pixel halo is applied on
// load (cp.async with a zero source size fills zeros at the borders). An
// implicit GEMM: one persistent CTA per SM keeps W (576 × 64, 83 KB padded)
// in shared memory for its whole run and walks 16 × 16-pixel output tiles
// (sample, tile row, tile column), double-buffering each tile's 18 × 18 × 64
// input slab with cp.async so the next slab loads while this one computes.
// M = 256 pixels, K = 576 (9 taps × 64 ci), N = 64; warp w owns tile rows
// 4·(w>>1)..+4 and output channels 32·(w&1)..+32. The epilogue applies
// scale, shift and ReLU to the registers and stores bf16 pairs, edge tiles
// guarded: H and W are arguments (257 × 197 is no multiple of 16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;             // 8 warps
constexpr int C = 64;                    // block-1 channels, in and out
constexpr int KDIM = 9 * C;              // 576 rows of W, (dy, dx, ci)
constexpr int TH = 16, TW = 16;          // conv output tile
constexpr int SH = TH + 2, SW = TW + 2;  // its input slab, with the halo
constexpr int PLD = C + 8;               // slab pixel stride: 144 B, ldmatrix rows conflict-free
constexpr int SLAB = SH * SW * PLD;      // one slab buffer, bf16 elements
constexpr int LDW_CONV = C + 8;          // W row stride in shared memory
constexpr int GEMM_TM = 32;              // GEMM rows per CTA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global → shared; src_bytes = 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8×8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_relu_pair(__nv_bfloat16* dst, float v0, float v1, float s0,
                                                float s1, float b0, float b1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) =
      __floats2bfloat162_rn(fmaxf(v0 * s0 + b0, 0.f), fmaxf(v1 * s1 + b1, 0.f));
}

// The GEMM probe. The spike nudges W each rep, bf16(f32(w)·(1 + i·1e-8)),
// only so that Mosaic cannot hoist the loop-invariant dot. That nudge is the
// identity for every i below ~1.9e5: the relative change i·1e-8 stays under
// bf16's half-ulp 2^-9. So it is dropped here; what keeps every rep's
// products is that each mma is issued from fragments re-read from shared
// memory by volatile ldmatrix, which the compiler may neither hoist nor merge.
//
// Warp w owns both m-tiles, columns (w&1)·N/2.. and the K quarter w>>1: per
// k16 step 2 + N/32 ldmatrix (lane row l&15, k or column offset 8·(l>>4))
// feed N/8 mma. The four quarters' partial sums meet in shared memory before
// the epilogue.
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
    block1_gemm_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ s, const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int m, int k, int reps) {
  constexpr int LDW = N + 8;
  constexpr int P = N / 32;  // ldmatrix_x4_trans per k-step: the warp's N/2 columns
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = k + 8;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ws = As + GEMM_TM * lda;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * GEMM_TM;

  const int a_chunks = k / 8;
  for (int i = tid; i < GEMM_TM * a_chunks; i += THREADS) {
    const int r = i / a_chunks, c = (i % a_chunks) * 8;
    const bool ok = row0 + r < m;
    cp_async16(smem_addr(As + r * lda + c), a + (size_t)(ok ? row0 + r : 0) * k + c, ok ? 16 : 0);
  }
  for (int i = tid; i < k * (N / 8); i += THREADS) {
    const int r = i / (N / 8), c = (i % (N / 8)) * 8;
    cp_async16(smem_addr(Ws + r * LDW + c), w + (size_t)r * N + c, 16);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int n0 = (warp & 1) * (N / 2), kq = warp >> 1, kw = k / 4;
  const uint32_t a_addr = smem_addr(As + (lane & 15) * lda + kq * kw + (lane >> 4) * 8);
  const uint32_t b_addr = smem_addr(Ws + (kq * kw + (lane & 15)) * LDW + n0 + (lane >> 4) * 8);
  float acc0[2 * P][4] = {}, acc1[2 * P][4] = {};  // m-tiles 0 and 1
  for (int rep = 0; rep < reps; ++rep) {
    for (int kk = 0; kk < kw; kk += 16) {
      uint32_t a0[4], a1[4];
      ldmatrix_x4(a0, a_addr + kk * 2);
      ldmatrix_x4(a1, a_addr + (16 * lda + kk) * 2);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, b_addr + (kk * LDW + p * 16) * 2);
        mma_bf16(acc0[2 * p], a0, bf[0], bf[1]);
        mma_bf16(acc0[2 * p + 1], a0, bf[2], bf[3]);
        mma_bf16(acc1[2 * p], a1, bf[0], bf[1]);
        mma_bf16(acc1[2 * p + 1], a1, bf[2], bf[3]);
      }
    }
  }

  // red[kq][row][col] (f32) over the staged operands, then the sum of the
  // quarters, scale, shift and ReLU.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2 * P; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + nt * 8 + 2 * q, row = g + half * 8;
      float* r = red + (kq * GEMM_TM + row) * N + col;
      *reinterpret_cast<float2*>(r) = make_float2(acc0[nt][2 * half], acc0[nt][2 * half + 1]);
      *reinterpret_cast<float2*>(r + 16 * N) = make_float2(acc1[nt][2 * half], acc1[nt][2 * half + 1]);
    }
  __syncthreads();
  for (int i = tid; i < GEMM_TM * N / 2; i += THREADS) {
    const int row = i / (N / 2), col = (i % (N / 2)) * 2;
    if (row0 + row >= m) continue;
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(red + (j * GEMM_TM + row) * N + col);
      v0 += v.x;
      v1 += v.y;
    }
    store_relu_pair(out + (size_t)(row0 + row) * N + col, v0, v1, s[col], s[col + 1], bias[col],
                    bias[col + 1]);
  }
}

struct TileGrid {
  int h, w, tiles_h, tiles_w;
  __device__ __forceinline__ void coords(int tile, int& b, int& h0, int& w0) const {
    const int per_sample = tiles_h * tiles_w;
    b = tile / per_sample;
    const int rem = tile - b * per_sample;
    h0 = (rem / tiles_w) * TH;
    w0 = (rem % tiles_w) * TW;
  }
};

// Stage the SH × SW input slab of one output tile, zeros outside the image.
__device__ __forceinline__ void load_slab(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* dst,
                                          const TileGrid& grid, int tile, int tid) {
  int b, h0, w0;
  grid.coords(tile, b, h0, w0);
  for (int i = tid; i < SH * SW * (C / 8); i += THREADS) {
    const int p = i >> 3, c = (i & 7) * 8;
    const int ih = h0 - 1 + p / SW, iw = w0 - 1 + p % SW;
    const bool ok = ih >= 0 && ih < grid.h && iw >= 0 && iw < grid.w;
    const __nv_bfloat16* src = ok ? x + (((size_t)b * grid.h + ih) * grid.w + iw) * C + c : x;
    cp_async16(smem_addr(dst + p * PLD + c), src, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    block1_conv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ scale, const float* __restrict__ shift,
                       __nv_bfloat16* __restrict__ y, TileGrid grid, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* slabs = Ws + KDIM * LDW_CONV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;

  for (int i = tid; i < KDIM * (C / 8); i += THREADS) {
    const int r = i >> 3, c = (i & 7) * 8;
    cp_async16(smem_addr(Ws + r * LDW_CONV + c), w + (size_t)r * C + c, 16);
  }
  int tile = blockIdx.x;
  if (tile < n_tiles) load_slab(x, slabs, grid, tile, tid);
  cp_async_commit();

  const int r0 = (warp >> 1) * 4, n0 = (warp & 1) * 32;
  float sc[4][2], sh[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[nt][e] = scale[n0 + nt * 8 + 2 * q + e];
      sh[nt][e] = shift[n0 + nt * 8 + 2 * q + e];
    }
  // This lane's ldmatrix rows: output pixel (r0 + j, lane & 15) of the tile,
  // read at slab pixel (r0 + j + dy, (lane & 15) + dx); W row tap·64 + ci.
  const uint32_t a_lane = ((r0 * SW + (lane & 15)) * PLD + (lane >> 4) * 8) * 2;
  const uint32_t b_lane = smem_addr(Ws + (lane & 15) * LDW_CONV + n0 + (lane >> 4) * 8);

  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) load_slab(x, slabs + (buf ^ 1) * SLAB, grid, next, tid);
    cp_async_commit();
    cp_async_wait<1>();  // W and this tile's slab have landed
    __syncthreads();

    const uint32_t a_base = smem_addr(slabs + buf * SLAB) + a_lane;
    float acc[4][4][4] = {};  // [tile row j][n8 tile][fragment]
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        uint32_t bf[2][4];
        const uint32_t b_addr = b_lane + (tap * C + kc * 16) * LDW_CONV * 2;
        ldmatrix_x4_trans(bf[0], b_addr);
        ldmatrix_x4_trans(bf[1], b_addr + 16 * 2);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t af[4];
          ldmatrix_x4(af, a_base + (((j + dy) * SW + dx) * PLD + kc * 16) * 2);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            mma_bf16(acc[j][2 * p], af, bf[p][0], bf[p][1]);
            mma_bf16(acc[j][2 * p + 1], af, bf[p][2], bf[p][3]);
          }
        }
      }
    }

    int b, h0, w0;
    grid.coords(tile, b, h0, w0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oh = h0 + r0 + j;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ow = w0 + g + half * 8;
        if (oh >= grid.h || ow >= grid.w) continue;
        __nv_bfloat16* dst = y + (((size_t)b * grid.h + oh) * grid.w + ow) * C + n0 + 2 * q;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          store_relu_pair(dst + nt * 8, acc[j][nt][2 * half], acc[j][nt][2 * half + 1],
                          sc[nt][0], sc[nt][1], sh[nt][0], sh[nt][1]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }
}

template <int N>
int launch_gemm(const void* a, const void* w, const void* s, const void* b, void* out, int m,
                int k, int reps, cudaStream_t stream) {
  const size_t staged = (size_t)(GEMM_TM * (k + 8) + k * (N + 8)) * sizeof(__nv_bfloat16);
  const size_t reduced = (size_t)4 * GEMM_TM * N * sizeof(float);
  const size_t smem = staged > reduced ? staged : reduced;
  auto kernel = block1_gemm_kernel<N>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(m + GEMM_TM - 1) / GEMM_TM, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(out), m, k, reps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a: (m, k) bf16; w: (k, n) bf16; s, b: (n,) f32; out: (m, n) bf16, all
// contiguous. n is 64 or 128, k a multiple of 64, reps ≥ 1. Returns a
// cudaError_t code: 0 on success.
int l3_block1_gemm(const void* a, const void* w, const void* s, const void* b, void* out, int m,
                   int k, int n, int reps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || k < 64 || k % 64 != 0 || reps < 1) return (int)cudaErrorInvalidValue;
  if (n == 64) return launch_gemm<64>(a, w, s, b, out, m, k, reps, st);
  if (n == 128) return launch_gemm<128>(a, w, s, b, out, m, k, reps, st);
  return (int)cudaErrorInvalidValue;
}

// x: (batch, h, w, 64) bf16 NHWC; wt: (576, 64) bf16, rows (dy, dx, ci);
// scale, shift: (64,) f32; y: (batch, h, w, 64) bf16, all contiguous.
// Returns a cudaError_t code: 0 on success.
int l3_block1_conv(const void* x, const void* wt, const void* scale, const void* shift, void* y,
                   int batch, int h, int w, void* stream) {
  if (batch < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const TileGrid grid{h, w, (h + TH - 1) / TH, (w + TW - 1) / TW};
  const long long n_tiles = (long long)batch * grid.tiles_h * grid.tiles_w;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(KDIM * LDW_CONV + 2 * SLAB) * sizeof(__nv_bfloat16);
  err = cudaFuncSetAttribute(block1_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)(n_tiles < sms ? n_tiles : sms);
  block1_conv_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<__nv_bfloat16*>(y), grid, (int)n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
