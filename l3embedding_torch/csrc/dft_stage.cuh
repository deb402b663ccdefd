// The windowed-DFT stage of the Hopper front-end kernels' bf16 mode
// (mel_frontend.cu, spec_frontend.cu); the f32 mode runs the real FFT of
// fft_stage.cuh instead.
//
// A block owns FRAMES = 64·CWG consecutive frames of one sample (CWG = 2,
// or 1 where the wrapper's dft_stage.frames_per_block finds the grid
// small) and stages their waveform span in shared memory once
// (stage_span, bf16, padding applied on load). It then walks the bases in
// chunks of DFT_COLS = 128 basis columns (64 bins: column 2f is re_f, 2f+1
// is im_f; pair 0 may hold re_0 and re_{N/2}, see ops/dft_stage.py), and
// for each chunk forms the (FRAMES × 128) product of its frames with the
// chunk's columns over K = n_dft, bf16 operands with f32 accumulation:
//
//   * warp specialised: CWG consumer warpgroups (warps 0 … 4·CWG−1) and one
//     producer warp after them;
//   * the producer keeps bulk copies (cp.async.bulk, no tensor map) of 16 KB
//     basis stages in flight into a DFT_STAGES-deep ring in shared memory,
//     with a full and an empty mbarrier per stage. The host lays each stage
//     out in the order the wgmma B descriptor reads (K-major, 128-byte rows,
//     128-byte swizzle), so one copy fills a stage;
//   * each consumer warpgroup issues wgmma.m64n128k16 for its 64 frames:
//     A from registers (frame t starts at seg[t·hop], and hop·2 bytes is not
//     16-byte aligned, so A is read with aligned 32-bit loads, as for
//     mma.sync), B from the stage; both warpgroups read the same stage, so
//     the bases cross L2 once per FRAMES frames;
//   * the accumulator gives each thread adjacent columns (2q, 2q+1) of its
//     rows: the re and im of one bin, so the kernels form the power in
//     registers (dft_power).

#pragma once

#include "frontend_common.cuh"

namespace {

constexpr int DFT_COLS = 128;          // basis columns per chunk (64 bins)
constexpr int DFT_BINS = DFT_COLS / 2;
constexpr int DFT_KT = 64;             // K per stage: one 128-byte row per column
constexpr int DFT_STAGES = 4;
constexpr int DFT_GROUP = 2;           // stages per wgmma group and wait (≤ DFT_STAGES)
constexpr int DFT_STAGE_BYTES = DFT_COLS * DFT_KT * 2;
constexpr int DFT_ACC = DFT_COLS / 2;  // f32 accumulators per consumer thread
constexpr int P_ROWS = DFT_BINS + 1;   // a chunk's bins, and bin N/2 when packed

template <int CWG>
struct DftShape {
  static constexpr int FRAMES = 64 * CWG;
  static constexpr int CONSUMERS = 128 * CWG;
  static constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
  static constexpr int PLD = FRAMES + 8;          // power-tile row stride: no bank conflicts
};

// Shared memory of a block, in order: 1 KB of alignment slack, the ring
// (1024-byte aligned, as the swizzle needs), 2·DFT_STAGES mbarriers, the
// f32 power tile P[P_ROWS][PLD], `extra` f32 of the kernel's own, a
// 16-float reduction buffer, then the bf16 waveform span.
template <int CWG>
size_t dft_smem_bytes(int n_dft, int hop, int extra) {
  using S = DftShape<CWG>;
  return 1024 + DFT_STAGES * DFT_STAGE_BYTES + 2 * DFT_STAGES * 8 +
         (P_ROWS * S::PLD + extra + 16) * sizeof(float) +
         ((S::FRAMES - 1) * hop + n_dft) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive on `bar` expecting `bytes`, then bulk-copy them from global `src`
// to shared `dst`; the copy completes the transaction on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Threads [0, n) of the block meet at named barrier `id` (0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The wgmma B descriptor of a K-major, 128-byte-swizzled stage at shared
// address `addr`: 8-column groups SBO = 1024 bytes apart, layout SW128.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Keep the compiler from moving reads or writes of the accumulators across
// the wgmma fences and waits.
__device__ __forceinline__ void fence_acc(float (&d)[DFT_ACC]) {
#pragma unroll
  for (int i = 0; i < DFT_ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A · B for one K step of 16: A (64 × 16, bf16) from registers in
// mma.sync's fragment order, B (16 × 128) through descriptor `desc`.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[DFT_ACC], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t desc,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(accumulate), "l"(desc));
}

// The pointers of one block's shared memory (dft_smem_bytes' order).
template <int CWG>
struct DftSmem {
  unsigned char* ring;
  uint64_t* bars;  // full[DFT_STAGES], then empty[DFT_STAGES]
  float* P;        // [P_ROWS][PLD]
  float* extra;
  float* red;
  __nv_bfloat16* seg;

  // Offsets from `raw` (not casts through integers), so that the compiler
  // still sees shared-memory pointers.
  __device__ __forceinline__ DftSmem(unsigned char* raw, int extra_floats) {
    ring = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    bars = reinterpret_cast<uint64_t*>(ring + DFT_STAGES * DFT_STAGE_BYTES);
    P = reinterpret_cast<float*>(bars + 2 * DFT_STAGES);
    extra = P + P_ROWS * DftShape<CWG>::PLD;
    red = extra + extra_floats;
    seg = reinterpret_cast<__nv_bfloat16*>(red + 16);
  }
};

// Start of every bf16 kernel: barriers initialised, the span of frames
// [t0, t0+FRAMES) staged, all threads met.
template <int CWG>
__device__ __forceinline__ void dft_begin(const DftSmem<CWG>& sm, const float* __restrict__ xb,
                                          int n, int pad_left, int t0, int n_dft, int hop,
                                          int tid) {
  using S = DftShape<CWG>;
  if (tid == 0) {
    for (int s = 0; s < DFT_STAGES; ++s) {
      mbar_init(smem_u32(sm.bars + s), 1);                               // full: the producer
      mbar_init(smem_u32(sm.bars + DFT_STAGES + s), S::CONSUMERS / 32);  // empty: consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_span<S::FRAMES, __nv_bfloat16, S::THREADS>(xb, n, pad_left, t0, n_dft, hop, sm.seg, tid);
  __syncthreads();
}

// The producer warp's whole life: every (chunk, K tile) stage of `wt` in
// order, through the ring. Lane 0 issues; the copies outlive the warp.
__device__ __forceinline__ void dft_produce(const __nv_bfloat16* __restrict__ wt,
                                            unsigned char* ring, uint64_t* bars,
                                            int n_stages_total, int lane) {
  if (lane != 0) return;
  for (int it = 0; it < n_stages_total; ++it) {
    const int s = it % DFT_STAGES;
    mbar_wait(smem_u32(bars + DFT_STAGES + s), ((it / DFT_STAGES) & 1) ^ 1);
    bulk_load(smem_u32(ring + s * DFT_STAGE_BYTES), wt + (size_t)it * (DFT_STAGE_BYTES / 2),
              DFT_STAGE_BYTES, smem_u32(bars + s));
  }
}

// G stages of one chunk for one consumer warpgroup, starting at K tile kt
// and ring slot `it`: load this thread's A fragments of all G, wait for the
// stages, issue their 4·G wgmma as one group, wait for it, release them.
template <int G>
__device__ __forceinline__ void dft_group(float (&d)[DFT_ACC], const __nv_bfloat16* a_lo,
                                          const __nv_bfloat16* a_hi, unsigned char* ring,
                                          uint64_t* bars, int kt, int it, int lane) {
  uint32_t a[G][4][4];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int k = (kt + j) * DFT_KT + ks * 16;
      a[j][ks][0] = ld32(a_lo + k);
      a[j][ks][1] = ld32(a_hi + k);
      a[j][ks][2] = ld32(a_lo + k + 8);
      a[j][ks][3] = ld32(a_hi + k + 8);
    }
#pragma unroll
  for (int j = 0; j < G; ++j)
    mbar_wait(smem_u32(bars + (it + j) % DFT_STAGES), ((it + j) / DFT_STAGES) & 1);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const uint64_t desc = b_desc(smem_u32(ring + ((it + j) % DFT_STAGES) * DFT_STAGE_BYTES));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n128k16(d, a[j][ks][0], a[j][ks][1], a[j][ks][2], a[j][ks][3], desc + 2 * ks,
                       (kt + j) | ks);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) mbar_arrive(smem_u32(bars + DFT_STAGES + (it + j) % DFT_STAGES));
  }
}

// One chunk for one consumer warpgroup: d = frames × the chunk's 128
// columns over K = n_dft (n_kt stages, counted on from `it`). a_lo, a_hi:
// this thread's A rows (g and g+8 of its warp's 16) at its column pair 2q.
//
// The stages go DFT_GROUP at a time (dft_group), a last odd one alone.
// wgmma reads its A registers asynchronously, and ptxas does not keep the
// next stages' loads out of them: with a group left in flight the mel
// kernel read wrong fragments, and holding them live made ptxas serialise
// the wgmma, slower than waiting. So each group is waited for before the
// next one's fragments load; the other consumer warpgroup's products fill
// the gap, and a group of DFT_GROUP stages spreads the wait over more work.
__device__ __forceinline__ void dft_chunk(float (&d)[DFT_ACC], const __nv_bfloat16* a_lo,
                                          const __nv_bfloat16* a_hi, unsigned char* ring,
                                          uint64_t* bars, int n_kt, int& it, int lane) {
  fence_acc(d);
  int kt = 0;
  for (; kt + DFT_GROUP <= n_kt; kt += DFT_GROUP, it += DFT_GROUP)
    dft_group<DFT_GROUP>(d, a_lo, a_hi, ring, bars, kt, it, lane);
  for (; kt < n_kt; ++kt, ++it) dft_group<1>(d, a_lo, a_hi, ring, bars, kt, it, lane);
  fence_acc(d);
}

// The power of this thread's accumulators → fn(row in the chunk's power
// tile, frame row in the block, |X|²). `pair0_packed`: this thread holds
// pair 0 of chunk 0 (q = 0) and it packs (re_0, re_{N/2}); it is unpacked
// into rows 0 (bin 0) and DFT_BINS (bin N/2).
template <typename Fn>
__device__ __forceinline__ void dft_power(const float (&d)[DFT_ACC], int r_lo, int q,
                                          bool pair0_packed, Fn fn) {
#pragma unroll
  for (int j = 0; j < DFT_ACC / 4; ++j) {
    const int row = 4 * j + q;
    if (j == 0 && pair0_packed) {
      fn(0, r_lo, d[0] * d[0]);
      fn(DFT_BINS, r_lo, d[1] * d[1]);
      fn(0, r_lo + 8, d[2] * d[2]);
      fn(DFT_BINS, r_lo + 8, d[3] * d[3]);
    } else {
      fn(row, r_lo, d[4 * j] * d[4 * j] + d[4 * j + 1] * d[4 * j + 1]);
      fn(row, r_lo + 8, d[4 * j + 2] * d[4 * j + 2] + d[4 * j + 3] * d[4 * j + 3]);
    }
  }
}

// The consumers' max of vmax (one value per consumer thread) → *dst.
template <int CWG>
__device__ __forceinline__ void consumers_max(float vmax, float* red, float* dst, int tid) {
  constexpr int WARPS = DftShape<CWG>::CONSUMERS / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  if ((tid & 31) == 0) red[tid >> 5] = vmax;
  bar_sync(1, DftShape<CWG>::CONSUMERS);
  if (tid == 0) {
    float m = red[0];
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
    *dst = m;
  }
}

}  // namespace
