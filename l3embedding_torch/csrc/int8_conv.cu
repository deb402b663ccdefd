// The int8 audio tower's convolution for Hopper (sm_90a): a 3×3 SAME conv,
// stride 1, zero padding, int8 × int8 → int32, with the per-output-channel
// epilogue of the post-training-quantized tower in the same kernel, and
// optionally the 2×2 VALID max-pool that follows blocks 1, 3 and 5.
//
// Replaces l3embedding_tpu/embed/quantized.py::_conv(q, w, jnp.int32), an
// XLA conv_general_dilated with preferred_element_type=int32 (there is no
// Pallas kernel behind it; stock PyTorch has no s8 × s8 → s32 conv on
// CUDA), and what follows it (quantized.py:394-407):
//   * requant (blocks 0-6): y = max(f32(acc)·deq[c] + b[c], 0), then
//     q' = clip(round_half_even(y / s_next), −127, 127) as int8;
//   * requant + pool: the same, then the max of each 2×2 quad (floor: an odd
//     last row or column is dropped). The epilogue is monotone, so this is
//     JAX's requantize-then-reduce_window;
//   * dequant (the embedding conv): f32(acc)·deq[c] + b[c] as f32.
// The multiply and the add are __fmul_rn and __fadd_rn, not one FMA, and
// the quotient by s_next is rounded half to even as the reference's f32
// division rounds it: y·(1/s_next) decides the integer unless it lies
// within 2.5e-7 (relative) of a half-integer, where the correctly rounded
// __fdiv_rn does (`requant`).
//
// Layouts: x (B, H, W, Cin) int8 NHWC; w (Cout, Kp) int8, row c holding
// output channel c's 3×3×Cin taps in (dy, dx, ci) order, zero-padded from
// 9·Cin to Kp, a multiple of 64 (ops/int8_conv_kernel.py::pack_weights);
// deq and b (Cout,) f32; s_next one f32 on the device (read by the kernel,
// so the host never waits for it); out (B, H, W, Cout) int8 or f32, or
// (B, H/2, W/2, Cout) int8 pooled.
//
// Bound on an H100 (1979 TOP/s dense int8, 3.35 TB/s): the convs of
// cnn_L3_melspec2 at 64 windows are 0.12-0.24 TOP each on 0.02-0.42 GB, so
// all but the first (Cin 1, bound by its 208 MB int8 output) are bound by
// operations; chip_smoke.py prints each bound.
//
// Design for Cin a multiple of 64 (every conv of the tower but the first):
// wgmma.m64n208k32.s32.s8.s8 fed by TMA, after the block-1 conv
// (block1_conv.cu). The product is transposed: D (64 output channels × 208
// pixels) = W^T · X^T, both operands K-major in shared memory, as s8 wgmma
// requires: W^T is the packed weights, X^T the NHWC slab with channels
// contiguous. A tap (dy, dx) is a shift of the slab descriptor's start by
// dy·SW + dx pixels: one TMA tensor map a call (not an im2col map), since a
// tiled 4-D box already lands every tap's pixels in shared memory once, and
// TMA's zero fill outside the image is the SAME halo.
//   * Tile: TH output rows × TW columns, read from a slab of (TH + 2) ×
//     (SW = TW + 2) pixels. The accumulator's 208 columns are "wide" pixels:
//     wide pixel i is slab position i, output row i / SW, column i % SW, and
//     columns TW, TW + 1 (and whatever lies past the tile) are computed and
//     dropped. So several short rows share one wgmma: the host's plan
//     (ops/int8_conv_kernel.py::tile_plan) takes TW = W where W ≤ 206 and as
//     many rows as fit in 208 (W 199 → 2 tiles of 2 × 102 pooled; 99 → 2
//     rows; 49 → 4; 24 → 8), 92-96 % of the computed pixels kept.
//   * Stage: one 64-channel chunk: the slab's chunk (a 4-D box (64, SW,
//     TH + 2, 1) at (c, w0 − 1, h0 − 1, b)) and W^T's chunk for the tile's 64
//     output channels (9 2-D boxes of 64 × 64 bytes, one a tap), 64-byte
//     swizzle, 18 wgmma (9 taps × 2 k32 steps). A descriptor may start at any
//     64-byte row: the hardware swizzles by address bits, as TMA does.
//   * Warp specialised, one persistent CTA per SM over work items (pixel
//     tile × 64-channel slice of Cout, the slice innermost so neighbouring
//     CTAs share a slab in L2). A producer warpgroup (one issuing thread;
//     setmaxnreg 40) fills a 2-4 stage full/empty mbarrier ring; two consumer
//     warpgroups (setmaxnreg 232) take the CTA's items in turn, each with
//     its own 104-register accumulator, so one's epilogue runs under the
//     other's math. The ring is filled in the order both consume it: the
//     chunks of item pairs interleaved.
//   * Epilogue: the raw accumulators go to the shared memory of the item's
//     last stage (held until the epilogue ends), pixel-major, with 104
//     32-bit stores at fixed offsets; then a rolled loop gives each thread
//     4 channels of 4 pixels an iteration: 128-bit reads, the requantize
//     (or dequantize) of 4 values each, 16 threads writing a pixel's 64
//     channels contiguously. Pooled, a 2×2 quad's max accumulator is
//     requantized (the epilogue is monotone); the plan keeps TH even and
//     each quad inside one tile. The epilogue, not the math, bounds the
//     Cin-64 items (clock64 phase times on the card): its loop is
//     latency-bound with one warp of the warpgroup on each scheduler, so it
//     runs branch-free chains and redoes a tied iteration exactly after.
// Other Cin keep a general kernel: mma.sync.m16n8k32 s8 over gathered K
// slices (int8_conv3x3_gather_kernel), and Cin 1 (the first conv, K 9) a
// __dp4a kernel of its own; neither pools.

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

// ---- The epilogues ---------------------------------------------------------

struct Scale {
  float s, inv;
  bool slow;  // s or 1/s not finite and positive: `requant`'s shortcut does not hold
  __device__ __forceinline__ explicit Scale(const float* s_next) {
    s = s_next != nullptr ? *s_next : 1.0f;
    inv = __frcp_rn(s);
    slow = !(s > 0.0f && s < 3.0e38f && inv > 0.0f && inv < 3.0e38f);
  }
};

// clip(round_half_even(max(f32(acc)·dq + bb, 0) / s), ±127) as __fdiv_rn
// rounds the quotient.
__device__ __forceinline__ int requant_exact(int acc, float dq, float bb, float s) {
  const float y = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), dq), bb), 0.0f);
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.0f), 127.0f));
}

// The same without a division, a branch or a rounding instruction:
// t = y·(1/s) is within 1.2e-7·t of y/s and fl(y/s) within 6e-8·t of it,
// so unless t lies within 2.5e-7·t of a half-integer, fl(y/s) rounds to
// t's integer. t ≥ 0 (y is
// ReLU'd) is clipped at 127 first, and adding 1.5·2^23 rounds it half to
// even (the sum's ulp is 1), its low bits then being the integer. `tie` is
// set where the shortcut fails (or where 1/s is no use), and the caller
// redoes those values with requant_exact. Branch-free, so a loop of them
// interleaves.
__device__ __forceinline__ int requant(int acc, float dq, float bb, const Scale& sc, bool& tie) {
  constexpr float MAGIC = 12582912.0f;  // 1.5·2^23, bits 0x4B400000
  const float y = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), dq), bb), 0.0f);
  const float t = fminf(__fmul_rn(y, sc.inv), 127.0f);
  const float m = __fadd_rn(t, MAGIC);
  const float r = __fsub_rn(m, MAGIC);
  tie |= !(fabsf(fabsf(t - r) - 0.5f) > t * 2.5e-7f);
  return __float_as_int(m) - 0x4B400000;
}

__device__ __forceinline__ float dequant(int acc, float dq, float bb) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), dq), bb);
}

// ---- Shared helpers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Threads [0, n) of the block meet at named barrier `id` (0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- The wgmma kernel (Cin a multiple of 64) -------------------------------

constexpr int KC = 64;                          // channels (bytes) a stage; the swizzle span
constexpr int WIDE = 208;                       // wide pixels an accumulator covers (wgmma N)
constexpr int TAP_BYTES = 64 * KC;              // W^T's tile of one tap: 64 rows × 64 bytes
constexpr int W_STAGE = 9 * TAP_BYTES;          // 36,864
constexpr int CONSUMERS = 256;                  // two warpgroups
constexpr int WG_THREADS = CONSUMERS + 128;     // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128·40 + 256·232 ≤ 65,536
// The epilogue stages the raw accumulators pixel-major, 68 int32 a wide
// pixel (≡ 4 mod 32 words: the fragments' 32-bit stores and the 128-bit
// reads of 16 channels × 2 pixels a warp are both conflict-free), in the
// shared memory of the item's last stage.
constexpr int PIX_PITCH = 64 + 4;
constexpr int STAGING_BYTES = WIDE * PIX_PITCH * 4;  // 56,576
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;

enum Mode { REQUANT = 0, REQUANT_POOL = 1, DEQUANT = 2 };

// wgmma descriptor of a K-major operand at shared address `addr`, 64-byte
// swizzle: 8-row groups 512 bytes apart; the leading offset is unread (a
// k32 step stays inside a 64-byte row). An offset of n bytes is desc + n/16.
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving reads or writes of the accumulators across
// the wgmma fences and waits.
__device__ __forceinline__ void fence_acc(int (&d)[WIDE / 2]) {
#pragma unroll
  for (int i = 0; i < WIDE / 2; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A · B, m64n208k32 s8 × s8 → s32, both operands through
// descriptors (K-major); d is overwritten when accumulate = 0.
__device__ __forceinline__ void wgmma_s8(int (&d)[WIDE / 2], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103},"
      " %104, %105, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The host's plan for one call (ops/int8_conv_kernel.py::tile_plan gives th
// and tw; l3_int8_conv3x3 the rest).
struct Plan {
  int h, w, cin, cout;
  int th, tw, sw;             // tile rows and columns; slab columns (tw + 2)
  int tiles_w, tiles_hw;      // tiles a row of tiles, an image
  int n_m, n_items, n_chunks; // Cout / 64; tiles × n_m; Cin / 64
  int stages, stage_bytes, slab_tx;
};

__device__ __forceinline__ void item_coords(const Plan& p, int item, int& b, int& h0, int& w0, int& m) {
  m = item % p.n_m;
  const int tile = item / p.n_m;
  b = tile / p.tiles_hw;
  const int rem = tile - b * p.tiles_hw;
  h0 = (rem / p.tiles_w) * p.th;
  w0 = (rem % p.tiles_w) * p.tw;
}

template <int MODE>
__global__ void __launch_bounds__(WG_THREADS, 1)
    int8_conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                              const __grid_constant__ CUtensorMap w_map, const float* __restrict__ deq,
                              const float* __restrict__ bias, const float* __restrict__ s_next,
                              void* __restrict__ out, const Plan p) {
  extern __shared__ unsigned char raw[];
  unsigned char* stages = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + p.stages * p.stage_bytes);
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + MAX_STAGES);
  const int tid = threadIdx.x;
  const int n_local = (p.n_items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                      static_cast<int>(gridDim.x);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // The producer warpgroup: one thread issues, the copies outlive it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      int seq = 0;
      for (int pair = 0; 2 * pair < n_local; ++pair) {
        const int ps = min(2, n_local - 2 * pair);
        for (int c = 0; c < p.n_chunks; ++c) {
          for (int g = 0; g < ps; ++g, ++seq) {
            const int st = seq % p.stages;
            mbar_wait(empty + 8 * st, ((seq / p.stages) & 1) ^ 1);
            int b, h0, w0, m;
            item_coords(p, blockIdx.x + (2 * pair + g) * gridDim.x, b, h0, w0, m);
            const uint32_t dst = smem_u32(stages + st * p.stage_bytes);
            mbar_expect_tx(full + 8 * st, W_STAGE + p.slab_tx);
            for (int tap = 0; tap < 9; ++tap)
              tma_load_2d(dst + tap * TAP_BYTES, &w_map, full + 8 * st, tap * p.cin + c * KC, m * 64);
            tma_load_4d(dst + W_STAGE, &x_map, full + 8 * st, c * KC, w0 - 1, h0 - 1, b);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const Scale sc(MODE == DEQUANT ? nullptr : s_next);
  // This thread's accumulator rows (output channels of the item's slice)
  // and the wide pixel of its first column pair.
  const int c_lo = 16 * warp + (lane >> 2), q2 = 2 * (lane & 3);
  int acc[WIDE / 2];
  for (int li = wg; li < n_local; li += 2) {
    const int pair = li >> 1, ps = min(2, n_local - 2 * pair);
    int st = 0;
    // The first wgmma of the item overwrites the accumulators; zeroing them
    // here ends the previous item's values at its staging, so the epilogue
    // has the registers.
#pragma unroll
    for (int i = 0; i < WIDE / 2; ++i) acc[i] = 0;
    for (int c = 0; c < p.n_chunks; ++c) {
      const int seq = 2 * p.n_chunks * pair + c * ps + wg;
      st = seq % p.stages;
      mbar_wait(full + 8 * st, (seq / p.stages) & 1);
      const uint32_t base = smem_u32(stages + st * p.stage_bytes);
      const uint64_t a_desc = desc64(base), b_desc = desc64(base + W_STAGE);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint64_t shift = static_cast<uint64_t>(((tap / 3) * p.sw + tap % 3) * (KC >> 4));
#pragma unroll
        for (int ks = 0; ks < KC / 32; ++ks)
          wgmma_s8(acc, a_desc + ((tap * TAP_BYTES + ks * 32) >> 4), b_desc + shift + ((ks * 32) >> 4),
                   (c | tap | ks) != 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(acc);
      // The stage is read; the last one is kept for the epilogue's staging.
      if (c + 1 < p.n_chunks && wtid == 0) mbar_arrive(empty + 8 * st);
    }

    // Epilogue. The accumulators go raw, pixel-major, into the last stage's
    // shared memory: acc[4j + e] (e < 2) is channel c_lo, wide pixel
    // 8j + q2 + e; acc[4j + 2 + e] channel c_lo + 8. Fixed offsets, so the
    // unrolled part stays short.
    int* acc_s = reinterpret_cast<int*>(stages + st * p.stage_bytes);
    {
      int* col = acc_s + q2 * PIX_PITCH + c_lo;
#pragma unroll
      for (int j = 0; j < WIDE / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          col[(8 * j + e) * PIX_PITCH] = acc[4 * j + e];
          col[(8 * j + e) * PIX_PITCH + 8] = acc[4 * j + 2 + e];
        }
      }
    }
    int b, h0, w0, m;
    item_coords(p, blockIdx.x + li * gridDim.x, b, h0, w0, m);
    // Then each thread takes 4 channels (cg) of 4 pixels at a time, pixel
    // i, i + 8, i + 16, i + 24 of the tile's wide pixels (i = r·SW + col;
    // the row from a float reciprocal, exact for i < 2^8): one 128-bit read
    // and four values out each, 16 threads writing a pixel's 64 channels
    // contiguously. Four independent chains an iteration and no branch in
    // them: the loop is latency-bound, one warp of the warpgroup on each
    // scheduler. An iteration with a requantize tie is redone exactly after
    // the loop (redoing the thread's whole pass, or branching in the loop,
    // cost more than the math of a Cin-64 item).
    const int cg = wtid & 15, stream = wtid >> 4, c4 = m * 64 + 4 * cg;
    float dq[4], bb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[e] = __ldg(deq + c4 + e), bb[e] = __ldg(bias + c4 + e);
    const int* src0 = acc_s + 4 * cg;
    bar_sync(1 + wg, 128);  // the tile's accumulators are staged
    if constexpr (MODE == REQUANT_POOL) {
      // The epilogue is monotone in the accumulator (non-decreasing for
      // deq ≥ 0, every rounding step monotone), so a quad's max (its min
      // for deq < 0) requantized is the max of the requantized quad.
      const int ph = p.h / 2, pw = p.w / 2, tpw = p.tw / 2, nq = (p.th / 2) * tpw;
      const float inv_tpw = 1.0f / static_cast<float>(max(tpw, 1));
      auto quad = [&](int q, int (&acc4)[4], long long& o) {
        const int pr = __float2int_rz((static_cast<float>(q) + 0.5f) * inv_tpw), pc = q - pr * tpw;
        const int oh = h0 / 2 + pr, ow = w0 / 2 + pc;
        acc4[0] = acc4[1] = acc4[2] = acc4[3] = 0;  // what a skipped quad requantizes: no tie
        if (q >= nq || oh >= ph || ow >= pw) return false;
        const int* v = src0 + (2 * pr * p.sw + 2 * pc) * PIX_PITCH;
        const int4 a = *reinterpret_cast<const int4*>(v), c = *reinterpret_cast<const int4*>(v + PIX_PITCH);
        const int4 d = *reinterpret_cast<const int4*>(v + p.sw * PIX_PITCH);
        const int4 f = *reinterpret_cast<const int4*>(v + (p.sw + 1) * PIX_PITCH);
        const int hi[4] = {max(max(a.x, c.x), max(d.x, f.x)), max(max(a.y, c.y), max(d.y, f.y)),
                           max(max(a.z, c.z), max(d.z, f.z)), max(max(a.w, c.w), max(d.w, f.w))};
        const int lo[4] = {min(min(a.x, c.x), min(d.x, f.x)), min(min(a.y, c.y), min(d.y, f.y)),
                           min(min(a.z, c.z), min(d.z, f.z)), min(min(a.w, c.w), min(d.w, f.w))};
#pragma unroll
        for (int e = 0; e < 4; ++e) acc4[e] = dq[e] >= 0.0f ? hi[e] : lo[e];
        o = ((static_cast<long long>(b) * ph + oh) * pw + ow) * p.cout + c4;
        return true;
      };
      uint32_t ties = 0u;  // iterations with a tie (nq / 16 ≤ 7 of them)
      for (int q0 = stream, it = 0; q0 < nq; q0 += 16, ++it) {
        int v[2][4];
        long long o[2];
        bool ok[2], tie = sc.slow;
#pragma unroll
        for (int u = 0; u < 2; ++u) ok[u] = quad(q0 + 8 * u, v[u], o[u]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uint32_t word = 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e) word |= static_cast<uint32_t>(requant(v[u][e], dq[e], bb[e], sc, tie) & 0xff) << (8 * e);
          if (ok[u]) *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o[u]) = word;
        }
        ties |= static_cast<uint32_t>(tie) << it;
      }
      for (int it = 0; ties != 0u; ++it, ties >>= 1) {
        if (!(ties & 1u)) continue;
        for (int u = 0; u < 2; ++u) {
          int v[4];
          long long o;
          if (!quad(stream + 16 * it + 8 * u, v, o)) continue;
          uint32_t word = 0u;
          for (int e = 0; e < 4; ++e) word |= static_cast<uint32_t>(requant_exact(v[e], dq[e], bb[e], sc.s) & 0xff) << (8 * e);
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o) = word;
        }
      }
    } else {
      const int nw = p.th * p.sw;
      const float inv_sw = 1.0f / static_cast<float>(p.sw);
      auto pixel = [&](int i, int4& a, long long& o) {
        const int rr = __float2int_rz((static_cast<float>(i) + 0.5f) * inv_sw), cc = i - rr * p.sw;
        const int hh = h0 + rr, ww = w0 + cc;
        a = make_int4(0, 0, 0, 0);  // what a skipped pixel requantizes: no tie
        if (i >= nw || cc >= p.tw || hh >= p.h || ww >= p.w) return false;
        a = *reinterpret_cast<const int4*>(src0 + i * PIX_PITCH);
        o = ((static_cast<long long>(b) * p.h + hh) * p.w + ww) * p.cout + c4;
        return true;
      };
      if constexpr (MODE == DEQUANT) {
        for (int i0 = stream; i0 < nw; i0 += 32) {
          int4 a[4];
          long long o[4];
          bool ok[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) ok[u] = pixel(i0 + 8 * u, a[u], o[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (ok[u])
              *reinterpret_cast<float4*>(static_cast<float*>(out) + o[u]) =
                  make_float4(dequant(a[u].x, dq[0], bb[0]), dequant(a[u].y, dq[1], bb[1]),
                              dequant(a[u].z, dq[2], bb[2]), dequant(a[u].w, dq[3], bb[3]));
        }
      } else {
        uint32_t ties = 0u;  // iterations with a tie (nw / 32 ≤ 7 of them)
        for (int i0 = stream, it = 0; i0 < nw; i0 += 32, ++it) {
          int4 a[4];
          long long o[4];
          bool ok[4], tie = sc.slow;
#pragma unroll
          for (int u = 0; u < 4; ++u) ok[u] = pixel(i0 + 8 * u, a[u], o[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint32_t word = static_cast<uint32_t>(requant(a[u].x, dq[0], bb[0], sc, tie) & 0xff) |
                                  static_cast<uint32_t>(requant(a[u].y, dq[1], bb[1], sc, tie) & 0xff) << 8 |
                                  static_cast<uint32_t>(requant(a[u].z, dq[2], bb[2], sc, tie) & 0xff) << 16 |
                                  static_cast<uint32_t>(requant(a[u].w, dq[3], bb[3], sc, tie) & 0xff) << 24;
            if (ok[u]) *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o[u]) = word;
          }
          ties |= static_cast<uint32_t>(tie) << it;
        }
        for (int it = 0; ties != 0u; ++it, ties >>= 1) {
          if (!(ties & 1u)) continue;
          for (int u = 0; u < 4; ++u) {
            int4 a;
            long long o;
            if (!pixel(stream + 32 * it + 8 * u, a, o)) continue;
            *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o) =
                static_cast<uint32_t>(requant_exact(a.x, dq[0], bb[0], sc.s) & 0xff) |
                static_cast<uint32_t>(requant_exact(a.y, dq[1], bb[1], sc.s) & 0xff) << 8 |
                static_cast<uint32_t>(requant_exact(a.z, dq[2], bb[2], sc.s) & 0xff) << 16 |
                static_cast<uint32_t>(requant_exact(a.w, dq[3], bb[3], sc.s) & 0xff) << 24;
          }
        }
      }
    }
    // The staging reads (generic proxy) before the stage's next TMA write.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + wg, 128);
    if (wtid == 0) mbar_arrive(empty + 8 * st);
  }
}

// ---- The general kernel (Cin neither 1 nor a multiple of 64) ---------------
//
// Implicit GEMM, M = output pixels, N = output channels, K = 9·Cin: a block
// takes 128 pixels × 64 channels, its 4 warps 32 pixels × 64 channels each
// with mma.sync.m16n8k32 (s8, s32 accumulators in registers). K goes in
// gathered slices of 64 bytes (zeros outside the image and past 9·Cin)
// through a 3-stage ring in shared memory (rows padded to 80 bytes); the
// epilogue stages the tile in shared memory and writes 16-byte chunks.

constexpr int BM = 128;          // output pixels a block
constexpr int BN = 64;           // output channels a block
constexpr int BK = 64;           // bytes of K a stage
constexpr int GSTAGES = 3;
constexpr int LDS = BK + 16;     // shared-memory row pitch (bytes)
constexpr int THREADS = 128;     // 4 warps × (32 pixels × 64 channels)
constexpr int OUT_PITCH_S8 = BN + 16;       // staging row pitch, int8 output
constexpr int OUT_PITCH_F32 = BN * 4 + 16;  // staging row pitch, f32 output
constexpr int GSMEM_BYTES = GSTAGES * (BM + BN) * LDS;
static_assert(BM * OUT_PITCH_F32 <= GSMEM_BYTES, "output staging must fit the ring");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <bool REQ>
__global__ void __launch_bounds__(THREADS)
    int8_conv3x3_gather_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                               const float* __restrict__ deq, const float* __restrict__ bias,
                               const float* __restrict__ s_next, void* __restrict__ out, int batch, int h,
                               int wd, int cin, int cout, int kp) {
  __shared__ __align__(16) unsigned char smem[GSMEM_BYTES];
  unsigned char* a_s = smem;                           // [GSTAGES][BM][LDS]
  unsigned char* b_s = smem + GSTAGES * BM * LDS;      // [GSTAGES][BN][LDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long npix = static_cast<long long>(batch) * h * wd;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // This thread's four A rows (pixels) and its 16-byte part of each K slice.
  const int part = tid & 3;
  int pb[4], ph[4], pw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long p = m0 + (tid >> 2) + 32 * j;
    if (p < npix) {
      pw[j] = static_cast<int>(p % wd);
      const long long q = p / wd;
      ph[j] = static_cast<int>(q % h);
      pb[j] = static_cast<int>(q / h);
    } else {
      pb[j] = 0;
      ph[j] = -4;  // every tap falls outside the image
      pw[j] = 0;
    }
  }

  auto load_stage = [&](int kc, int buf) {
    unsigned char* as = a_s + buf * BM * LDS;
    unsigned char* bs = b_s + buf * BN * LDS;
    const int k_real = 9 * cin;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned words[4];
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        unsigned word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kc * BK + part * 16 + e4 * 4 + e;
          if (k < k_real) {
            const int tap = k / cin, ci = k - tap * cin;
            const int hh = ph[j] + tap / 3 - 1, ww = pw[j] + tap % 3 - 1;
            if (static_cast<unsigned>(hh) < static_cast<unsigned>(h) &&
                static_cast<unsigned>(ww) < static_cast<unsigned>(wd)) {
              const int8_t v = x[((static_cast<long long>(pb[j]) * h + hh) * wd + ww) * cin + ci];
              word |= static_cast<unsigned>(static_cast<unsigned char>(v)) << (8 * e);
            }
          }
        }
        words[e4] = word;
      }
      *reinterpret_cast<uint4*>(as + ((tid >> 2) + 32 * j) * LDS + part * 16) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = (tid >> 2) + 32 * j;
      cp_async16(bs + row * LDS + part * 16, w + static_cast<long long>(n0 + row) * kp + kc * BK + part * 16);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  const int nk = kp / BK;
#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();  // slice kc landed; every warp is done with slice kc - 1
    const int nxt = kc + GSTAGES - 1;
    if (nxt < nk) load_stage(nxt, nxt % GSTAGES);
    cp_async_commit();

    const unsigned char* as = a_s + (kc % GSTAGES) * BM * LDS + (warp * 32) * LDS;
    const unsigned char* bs = b_s + (kc % GSTAGES) * BN * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned af[2][4], bf[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const unsigned char* r0 = as + (mt * 16 + g) * LDS + ks + 4 * t;
        af[mt][0] = lds32(r0);
        af[mt][1] = lds32(r0 + 8 * LDS);
        af[mt][2] = lds32(r0 + 16);
        af[mt][3] = lds32(r0 + 8 * LDS + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const unsigned char* r0 = bs + (nt * 8 + g) * LDS + ks + 4 * t;
        bf[nt][0] = lds32(r0);
        bf[nt][1] = lds32(r0 + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the output tile in it

  const float s = REQ ? *s_next : 1.0f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = nt * 8 + 2 * t + half;
      const float dq = deq[n0 + col], bb = bias[n0 + col];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = warp * 32 + mt * 16 + g + 8 * hi;
          const int a = acc[mt][nt][2 * hi + half];
          if constexpr (REQ) {
            smem[row * OUT_PITCH_S8 + col] = static_cast<unsigned char>(requant_exact(a, dq, bb, s));
          } else {
            reinterpret_cast<float*>(smem + row * OUT_PITCH_F32)[col] = dequant(a, dq, bb);
          }
        }
      }
    }
  }
  __syncthreads();

  constexpr int ROW_BYTES = REQ ? BN : BN * 4;
  constexpr int PITCH = REQ ? OUT_PITCH_S8 : OUT_PITCH_F32;
  constexpr int CHUNKS = ROW_BYTES / 16;  // 16-byte chunks a tile row
  const int out_row_bytes = REQ ? cout : cout * 4;
  const int col0_bytes = REQ ? n0 : n0 * 4;
  unsigned char* o = static_cast<unsigned char*>(out);
  for (int i = tid; i < BM * CHUNKS; i += THREADS) {
    const int row = i / CHUNKS, chunk = i - row * CHUNKS;
    const long long p = m0 + row;
    if (p < npix) {
      *reinterpret_cast<uint4*>(o + p * out_row_bytes + col0_bytes + chunk * 16) =
          *reinterpret_cast<const uint4*>(smem + row * PITCH + chunk * 16);
    }
  }
}

// ---- Cin 1 (the tower's first conv, K = 9) ---------------------------------
//
// No tensor-core product. A thread takes one pixel, packs its 9 taps (zeros
// outside the image) into three 32-bit words and forms each channel's sum
// with three __dp4a against the first 12 bytes of that channel's packed row
// (zero past tap 9), then writes the pixel's Cout outputs 16 bytes at a
// time: the output bytes, not the 9·Cout products, bound this conv.
template <bool REQ>
__global__ void __launch_bounds__(THREADS)
    int8_conv3x3_cin1_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                             const float* __restrict__ deq, const float* __restrict__ bias,
                             const float* __restrict__ s_next, void* __restrict__ out, int batch,
                             int h, int wd, int cout, int kp) {
  extern __shared__ __align__(16) unsigned char dyn[];
  int* w3 = reinterpret_cast<int*>(dyn);  // [cout][3]
  for (int i = threadIdx.x; i < cout * 3; i += THREADS) {
    w3[i] = *reinterpret_cast<const int*>(w + static_cast<long long>(i / 3) * kp + (i % 3) * 4);
  }
  __syncthreads();
  const long long npix = static_cast<long long>(batch) * h * wd;
  const long long p = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (p >= npix) return;
  const int pw = static_cast<int>(p % wd);
  const long long q = p / wd;
  const int ph = static_cast<int>(q % h);
  const long long base = (q / h) * h;
  unsigned words[3] = {0u, 0u, 0u};
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int hh = ph + tap / 3 - 1, ww = pw + tap % 3 - 1;
    if (static_cast<unsigned>(hh) < static_cast<unsigned>(h) &&
        static_cast<unsigned>(ww) < static_cast<unsigned>(wd)) {
      const int8_t v = x[(base + hh) * wd + ww];
      words[tap / 4] |= static_cast<unsigned>(static_cast<unsigned char>(v)) << (8 * (tap % 4));
    }
  }
  const Scale sc(REQ ? s_next : nullptr);
  for (int c0 = 0; c0 < cout; c0 += 16) {
    uint4 packed[REQ ? 1 : 4];
    unsigned* lanes = reinterpret_cast<unsigned*>(packed);
    int acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j;
      acc[j] = __dp4a(static_cast<int>(words[0]), w3[3 * c], 0);
      acc[j] = __dp4a(static_cast<int>(words[1]), w3[3 * c + 1], acc[j]);
      acc[j] = __dp4a(static_cast<int>(words[2]), w3[3 * c + 2], acc[j]);
    }
    if constexpr (REQ) {
      bool tie = sc.slow;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const unsigned byte = static_cast<unsigned char>(requant(acc[j], deq[c0 + j], bias[c0 + j], sc, tie));
        if (j % 4 == 0) lanes[j / 4] = 0;
        lanes[j / 4] |= byte << (8 * (j % 4));
      }
      if (tie) {
        for (int j = 0; j < 16; ++j) {
          const unsigned byte =
              static_cast<unsigned char>(requant_exact(acc[j], deq[c0 + j], bias[c0 + j], sc.s));
          if (j % 4 == 0) lanes[j / 4] = 0;
          lanes[j / 4] |= byte << (8 * (j % 4));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) lanes[j] = __float_as_uint(dequant(acc[j], deq[c0 + j], bias[c0 + j]));
    }
    if constexpr (REQ) {
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(out) + p * cout + c0) = packed[0];
    } else {
      uint4* dst = reinterpret_cast<uint4*>(static_cast<float*>(out) + p * cout + c0);
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[k] = packed[k];
    }
  }
}

// ---- Host side -------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (the library
// does not link libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A uint8 tensor map of `rank` dims (innermost first) over contiguous memory
// with byte strides `strides` (dims 1..rank-1), 64-byte swizzle, zeros
// outside. Returns a cudaError_t code.
int make_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims, const uint64_t* strides,
             const uint32_t* box) {
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return static_cast<int>(cudaErrorInvalidValue);
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t bdim[4], estride[4] = {1, 1, 1, 1};
  for (int d = 0; d < rank; ++d) {
    gdim[d] = dims[d];
    bdim[d] = box[d];
    if (d > 0) gstride[d - 1] = strides[d - 1];
  }
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), gdim, gstride, bdim,
                        estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int launch_wgmma(const void* x, const void* w, const float* deq, const float* bias, const float* s_next,
                 void* out, int batch, int h, int wd, int cin, int cout, int kp, int th, int tw, bool pool,
                 cudaStream_t stream) {
  Plan p{};
  p.h = h, p.w = wd, p.cin = cin, p.cout = cout, p.th = th, p.tw = tw, p.sw = tw + 2;
  // The plan's invariants: the tile's last valid wide pixel fits the
  // accumulator; a pooled tile holds whole quads.
  if (th < 1 || tw < 1 || (th - 1) * p.sw + tw > WIDE || th + 2 > 256 || p.sw > 256 ||
      (pool && (th % 2 != 0 || (tw % 2 != 0 && tw < wd))))
    return static_cast<int>(cudaErrorInvalidValue);
  p.tiles_w = (wd + tw - 1) / tw;
  p.tiles_hw = p.tiles_w * ((h + th - 1) / th);
  p.n_m = cout / 64;
  const long long n_items = static_cast<long long>(batch) * p.tiles_hw * p.n_m;
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.n_items = static_cast<int>(n_items);
  p.n_chunks = cin / KC;
  // The slab is read up to wide pixel WIDE − 1 shifted by tap (2, 2); past
  // the box TMA writes lie only dropped pixels' inputs.
  const int slab_pix = std::max((th + 2) * p.sw, WIDE + 2 * p.sw + 2);
  p.slab_tx = (th + 2) * p.sw * KC;
  p.stage_bytes = (std::max(W_STAGE + slab_pix * KC, STAGING_BYTES) + 1023) / 1024 * 1024;
  const int fixed = 1024 + 2 * MAX_STAGES * 8;
  p.stages = std::min(MAX_STAGES, (SMEM_LIMIT - fixed) / p.stage_bytes);
  if (p.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(fixed) + static_cast<size_t>(p.stages) * p.stage_bytes;

  CUtensorMap x_map, w_map;
  const uint64_t x_dims[4] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(wd), static_cast<uint64_t>(h),
                              static_cast<uint64_t>(batch)};
  const uint64_t x_strides[3] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(wd) * cin,
                                 static_cast<uint64_t>(h) * wd * cin};
  const uint32_t x_box[4] = {KC, static_cast<uint32_t>(p.sw), static_cast<uint32_t>(th + 2), 1};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(kp), static_cast<uint64_t>(cout)};
  const uint64_t w_strides[1] = {static_cast<uint64_t>(kp)};
  const uint32_t w_box[2] = {KC, 64};
  int rc = make_map(&x_map, x, 4, x_dims, x_strides, x_box);
  if (rc == 0) rc = make_map(&w_map, w, 2, w_dims, w_strides, w_box);
  if (rc != 0) return rc;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = s_next == nullptr ? int8_conv3x3_wgmma_kernel<DEQUANT>
                : pool            ? int8_conv3x3_wgmma_kernel<REQUANT_POOL>
                                  : int8_conv3x3_wgmma_kernel<REQUANT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(n_items < sms ? n_items : sms);
  kernel<<<blocks, WG_THREADS, smem, stream>>>(x_map, w_map, deq, bias, s_next, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The K slice the packed weights are padded to, and the accumulator width
// the tile plan must fit (ops/int8_conv_kernel.py checks both against its
// own constants when it loads the library).
int l3_int8_conv_k_step() { return BK; }
int l3_int8_conv_wide() { return WIDE; }

// out = epilogue(conv3x3_SAME(x, w)): int8 with s_next (requant; pooled 2×2
// when pool is nonzero), f32 without it (dequant). th and tw are the tile
// plan of the wgmma kernel (Cin a multiple of 64; ignored otherwise). Returns
// a CUDA error code, 0 on success.
int l3_int8_conv3x3(const void* x, const void* w, const void* deq, const void* bias, const void* s_next,
                    void* out, int batch, int h, int wd, int cin, int cout, int kp, int pool, int th, int tw,
                    void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1 || cout % BN != 0 ||
      kp != (9 * cin + BK - 1) / BK * BK || (pool && (s_next == nullptr || cin % KC != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  const auto* d = static_cast<const float*>(deq);
  const auto* b = static_cast<const float*>(bias);
  const auto* s = static_cast<const float*>(s_next);
  auto st = static_cast<cudaStream_t>(stream);
  if (cin % KC == 0) return launch_wgmma(x, w, d, b, s, out, batch, h, wd, cin, cout, kp, th, tw, pool != 0, st);
  const long long npix = static_cast<long long>(batch) * h * wd;
  if (cin == 1) {
    const unsigned grid = static_cast<unsigned>((npix + THREADS - 1) / THREADS);
    const size_t smem = static_cast<size_t>(cout) * 3 * sizeof(int);
    if (s != nullptr) {
      int8_conv3x3_cin1_kernel<true><<<grid, THREADS, smem, st>>>(xs, ws, d, b, s, out, batch, h, wd, cout, kp);
    } else {
      int8_conv3x3_cin1_kernel<false><<<grid, THREADS, smem, st>>>(xs, ws, d, b, s, out, batch, h, wd, cout, kp);
    }
  } else {
    const dim3 grid(static_cast<unsigned>((npix + BM - 1) / BM), cout / BN);
    if (s != nullptr) {
      int8_conv3x3_gather_kernel<true><<<grid, THREADS, 0, st>>>(xs, ws, d, b, s, out, batch, h, wd, cin, cout, kp);
    } else {
      int8_conv3x3_gather_kernel<false><<<grid, THREADS, 0, st>>>(xs, ws, d, b, s, out, batch, h, wd, cin, cout, kp);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
