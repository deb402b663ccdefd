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
// meet, so loads, tensor-core math and stores all have to overlap.
//
// Both kernels run bf16 wgmma with one operand held in registers for the
// kernel's whole life and the other read from shared memory, copied there by
// TMA with the 128-byte swizzle. Every TMA box is 1024-byte aligned, so the
// swizzle puts 16-byte chunk c of 128-byte row p at p·128 + ((c ^ (p & 7))·16)
// (`swizzled`); the register operands are read once with ldmatrix through
// that formula. A wgmma descriptor may start at any 128-byte row of a
// swizzle atom with its base-offset field 0: the hardware swizzles by
// address bits, as TMA does (with the field set to the row's phase the
// results were wrong, on the card). Both kernels issue wgmma nearly back to
// back, so each descriptor is a base plus a compile-time offset.
//
// Conv. The product is taken transposed: D (64 output channels × N output
// pixels) = W^T (64 × 576) · X^T, so that the register operand is W^T,
// loaded once per CTA (36 k16 fragments, 144 registers a thread, never
// rewritten: no wgmma reads registers that change), and the shared operand
// is the input slab, K-major with ci contiguous, as TMA lays NHWC pixels
// down. A tap (dy, dx) is then only a shift of the descriptor's start by
// whole pixels. Warp specialised, one persistent CTA per SM:
//   * A producer warpgroup (one issuing thread; setmaxnreg gives its
//     registers to the consumers: 232 a consumer thread) copies W once,
//     then each of the CTA's tiles' input slab with one 4-D TMA load over x
//     (64 ch, W, H, B): a box of (64, TW + 2, TH + 2, 1) at (0, w0 − 1,
//     h0 − 1, b). TMA fills what lies outside the image with zeros, so the
//     1-pixel halo and the edge tiles need no code. Slabs go through a
//     3-stage full/empty mbarrier ring.
//   * A tile is TH = 4 output rows × TW = 56 columns (224 = 4 × 56: the
//     vision width computes no padding, 197 and 199 pad to 224; a 64-wide
//     tile would pad them to 256). Two consumer warpgroups take the CTA's
//     tiles in turn; one output row is one accumulator (64 × 56, f32) and 36
//     wgmma.m64n56k16 (9 taps × 4 steps of 16 ci), so one warpgroup's waits
//     and epilogue run under the other's math.
//   * Epilogue: scale, shift and ReLU in registers, one rounding to bf16,
//     transposed back to NHWC by stmatrix.trans into a swizzled staging tile
//     in W's shared memory (free once W is in registers), then one 4-D TMA
//     store a tile, which clips the edge tiles. The slab goes back to the
//     producer as soon as the tile's last wgmma has read it.
//
// GEMM. A 64-row tile of A and all of W are copied into shared memory by
// TMA; each consumer thread loads its A fragments once (ldmatrix; 36 k16
// steps, 144 registers) and keeps them, so each rep reads only W from shared
// memory (W (k, n) with n contiguous: an MN-major B operand, read with
// wgmma's transpose bit, so the host passes it as it is): 36
// wgmma.m64n64k16 per 64 output columns. The reps of a tile are split over
// a cluster of two CTAs (56 × 2 = 112 CTAs for m = 3584); the second sums
// into shared memory and the first reads it through the cluster's
// distributed shared memory and runs the epilogue. K is taken in passes of
// 576 (zero-filled by TMA past k), so any k that is a multiple of 64 works.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int C = 64;                          // block-1 channels, in and out
constexpr int KDIM = 9 * C;                    // 576 rows of W, (dy, dx, ci)
constexpr int ROW_BYTES = C * 2;               // a pixel or a W row: 128 B, the swizzle span
constexpr int BOX_BYTES = 64 * ROW_BYTES;      // one (64 × 64) bf16 TMA box
constexpr int TH = 4, TW = 56;                 // conv output tile: TH rows of TW (wgmma N) pixels
constexpr int SH = TH + 2, SW = TW + 2;        // its input slab, with the halo
constexpr int STAGES = 3;
constexpr int W_BYTES = KDIM * ROW_BYTES;      // 73,728
constexpr int W_FRAGS = KDIM / 16;             // W^T's k16 fragments
constexpr int CONSUMERS = 256;                 // two warpgroups
constexpr int CONV_THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128·40 + 256·232 ≤ 65,536
constexpr int GEMM_THREADS = 128;              // one warpgroup
constexpr int GEMM_SPLIT = 2;                  // CTAs (one cluster) per 64-row tile
constexpr int GEMM_KC = 576;                   // K per pass held in registers
constexpr int GEMM_KS = GEMM_KC / 16;          // its k16 steps
constexpr int GEMM_KB = GEMM_KC / 64;          // its TMA boxes along K

// The conv's shared memory: W (reused for the two consumer warpgroups'
// output tiles once W is in registers), STAGES slabs, all 1024-byte
// aligned, then full[STAGES], empty[STAGES] and the W barrier.
constexpr int SLAB_BYTES = SH * SW * ROW_BYTES;                 // 44,544
constexpr int STAGE_BYTES = (SLAB_BYTES + 1023) / 1024 * 1024;  // 45,056
constexpr int OUT_BYTES = TH * TW * ROW_BYTES;                  // 28,672
constexpr size_t CONV_SMEM = 1024 + W_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8;
static_assert(2 * OUT_BYTES <= W_BYTES, "both output tiles are staged in W's shared memory");
static_assert(CONV_SMEM <= 232448, "a block has 227 KB of shared memory");

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

// Shared → global through a tensor map, one bulk group; elements outside
// the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Threads [0, n) of the block meet at named barrier `id` (0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Four 8×8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
// With lane row l & 15 and 16-byte chunk l >> 4 of a row-major (row, k)
// tile, r[0..3] is the A fragment of mma.sync and of wgmma from registers;
// .trans reads the same fragment from a (k, row) tile.
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

// The reverse of ldmatrix .trans: matrix i (register r_i of each lane, in
// the accumulator's fragment order) goes to the 8 rows whose addresses lanes
// 8i..8i+7 give, transposed. x2 takes matrices 0 and 1 (lanes 0-15).
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ void stmatrix_x2_trans(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(addr), "r"(r0),
               "r"(r1)
               : "memory");
}

// Address of 16-byte chunk `chunk` of 128-byte row `row` in a 1024-byte
// aligned, 128-byte swizzled region at `base`.
__device__ __forceinline__ uint32_t swizzled(uint32_t base, int row, int chunk) {
  return base + row * ROW_BYTES + ((chunk ^ (row & 7)) << 4);
}

// wgmma descriptor of an operand at shared address `addr`: 128-byte swizzle,
// 8-row groups 1024 bytes apart (the stride byte offset), leading byte
// offset `lbo` (16-byte units). An offset of n bytes from `addr` is
// desc + (n >> 4) while it stays in the 256 KB the 14-bit field addresses.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the wgmma fences and waits.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A · B for one K step of 16, m64nNk16 with N = 2·(size of d): A
// (64 × 16 bf16) from registers, B (16 × N) through `desc`, MN-major when
// TRANS_B = 1, K-major when 0; d is overwritten when accumulate = 0.
template <int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}
template <int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[28], const uint32_t (&a)[4], uint64_t desc,
                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27},"
      " {%28, %29, %30, %31}, %32, p, 1, 1, %34;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}

__device__ __forceinline__ uint32_t relu_bf16x2(float v0, float v1, float s0, float s1, float b0,
                                                float b1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(fmaxf(v0 * s0 + b0, 0.f), fmaxf(v1 * s1 + b1, 0.f));
  return *reinterpret_cast<uint32_t*>(&h);
}

// The GEMM probe. The spike nudges W each rep, bf16(f32(w)·(1 + i·1e-8)),
// only so that Mosaic cannot hoist the loop-invariant dot. That nudge is the
// identity for every i below ~1.9e5: the relative change i·1e-8 stays under
// bf16's half-ulp 2^-9. So it is dropped here; what keeps every rep's
// products is that each wgmma is an asm volatile, which the compiler may
// neither hoist nor merge.
//
// Block (2·t + r) of cluster t takes rows 64·t.. and reps [r·reps/2,
// (r+1)·reps/2). Shared memory: A (64 × 576, nine 64 × 64 boxes), then W
// (N/64 halves × nine 64 × 64 boxes), then one mbarrier.
template <int N>
__global__ void __cluster_dims__(GEMM_SPLIT, 1, 1) __launch_bounds__(GEMM_THREADS, 1)
    block1_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                       const __grid_constant__ CUtensorMap w_map, const float* __restrict__ s,
                       const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int m,
                       int k, int reps) {
  constexpr int NH = N / 64;  // 64-column halves of W and of the accumulator
  extern __shared__ unsigned char raw[];
  unsigned char* a_s = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  unsigned char* w_s = a_s + GEMM_KB * BOX_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(w_s + NH * GEMM_KB * BOX_BYTES);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = (blockIdx.x / GEMM_SPLIT) * 64;
  const int rep_end = (rank + 1) * reps / GEMM_SPLIT;
  if (tid == 0) {
    mbar_init(smem_u32(bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  const int a_row = warp * 16 + (lane & 15);
  for (int k0 = 0, pass = 0; k0 < k; k0 += GEMM_KC, ++pass) {
    if (tid == 0) {
      mbar_expect_tx(smem_u32(bar), (1 + NH) * GEMM_KB * BOX_BYTES);
      for (int kb = 0; kb < GEMM_KB; ++kb) {
        tma_load_2d(smem_u32(a_s + kb * BOX_BYTES), &a_map, smem_u32(bar), k0 + kb * 64, row0);
        for (int h = 0; h < NH; ++h)
          tma_load_2d(smem_u32(w_s + (h * GEMM_KB + kb) * BOX_BYTES), &w_map, smem_u32(bar), h * 64,
                      k0 + kb * 64);
      }
    }
    mbar_wait(smem_u32(bar), pass & 1);
    uint32_t a[GEMM_KS][4];
#pragma unroll
    for (int ks = 0; ks < GEMM_KS; ++ks)
      ldmatrix_x4(a[ks], swizzled(smem_u32(a_s + (ks / 4) * BOX_BYTES), a_row, (ks % 4) * 2 + (lane >> 4)));
    const uint64_t w_desc = desc128(smem_u32(w_s), 1024 >> 4);  // one 64-wide atom: LBO unread
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_acc(acc[h]);
    for (int rep = rank * reps / GEMM_SPLIT; rep < rep_end; ++rep) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < GEMM_KS; ++ks)
#pragma unroll
        for (int h = 0; h < NH; ++h)
          wgmma<1>(acc[h], a[ks], w_desc + (((h * GEMM_KB + ks / 4) * BOX_BYTES + (ks % 4) * 16 * ROW_BYTES) >> 4), 1);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_acc(acc[h]);
    __syncthreads();  // every read of this pass's A and W is done before the next pass's copies
  }

  // The second CTA's sums, through the cluster's shared memory, into the
  // first's; then ·s + b, ReLU and bf16 by the first.
  float* red = reinterpret_cast<float*>(a_s);
  if (rank == 1) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) red[(h * 32 + i) * GEMM_THREADS + tid] = acc[h][i];
  }
  cluster.sync();
  if (rank == 0) {
    const float* other = cluster.map_shared_rank(red, 1);
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = h * 64 + j * 8 + 2 * q;
        const float s0 = s[col], s1 = s[col + 1], b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half, row = row0 + warp * 16 + g + 8 * half;
          const float v0 = acc[h][i] + other[(h * 32 + i) * GEMM_THREADS + tid];
          const float v1 = acc[h][i + 1] + other[(h * 32 + i + 1) * GEMM_THREADS + tid];
          if (row < m)
            *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) = relu_bf16x2(v0, v1, s0, s1, b0, b1);
        }
      }
  }
  cluster.sync();  // the second CTA's shared memory outlives the first's reads
}

struct ConvGrid {
  int tiles_w, tiles_hw, n_tiles;
  __device__ __forceinline__ void coords(int tile, int& b, int& h0, int& w0) const {
    b = tile / tiles_hw;
    const int rem = tile - b * tiles_hw;
    h0 = (rem / tiles_w) * TH;
    w0 = (rem % tiles_w) * TW;
  }
};

__global__ void __launch_bounds__(CONV_THREADS, 1)
    block1_conv_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map,
                       const __grid_constant__ CUtensorMap y_map, const float* __restrict__ scale,
                       const float* __restrict__ shift, ConvGrid grid) {
  constexpr int NB = TW / 8;  // 8-pixel blocks of an output row
  extern __shared__ unsigned char raw[];
  unsigned char* w_s = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  unsigned char* stages = w_s + W_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + STAGES * STAGE_BYTES);
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + STAGES);
  const uint32_t w_bar = smem_u32(bars + 2 * STAGES);
  const int tid = threadIdx.x;
  const int n_local = (grid.n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    mbar_init(w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // The producer warpgroup: one thread issues, the copies outlive it. One
    // big branch a role, so that ptxas can size both register budgets.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      mbar_expect_tx(w_bar, W_BYTES);
      for (int kb = 0; kb < KDIM / 64; ++kb)
        tma_load_2d(smem_u32(w_s + kb * BOX_BYTES), &w_map, w_bar, 0, kb * 64);
      for (int i = 0; i < n_local; ++i) {
        const int st = i % STAGES;
        mbar_wait(empty + 8 * st, ((i / STAGES) & 1) ^ 1);
        int b, h0, w0;
        grid.coords(blockIdx.x + i * gridDim.x, b, h0, w0);
        mbar_expect_tx(full + 8 * st, SLAB_BYTES);
        tma_load_4d(smem_u32(stages + st * STAGE_BYTES), &x_map, full + 8 * st, 0, w0 - 1, h0 - 1, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
    const uint32_t w_base = smem_u32(w_s);
    // W^T's fragment t (k rows 16t.., this warp's 16 output channels) from W
    // (k rows × 64 channels, swizzled): matrix i of lane group i holds
    // channels 8·(i & 1).. and k 8·(i >> 1)...
    mbar_wait(w_bar, 0);
    uint32_t wa[W_FRAGS][4];
#pragma unroll
    for (int t = 0; t < W_FRAGS; ++t)
      ldmatrix_x4_trans(wa[t], swizzled(w_base, 16 * t + (lane & 7) + 8 * (lane >> 4),
                                        2 * warp + ((lane >> 3) & 1)));
    // This thread's accumulator rows: output channels c_lo and c_lo + 8.
    const int c_lo = 16 * warp + (lane >> 2);
    const float s_lo = scale[c_lo], s_hi = scale[c_lo + 8], b_lo = shift[c_lo], b_hi = shift[c_lo + 8];
    bar_sync(3, CONSUMERS);  // W is in registers: its shared memory stages the output
    const uint32_t out_base = w_base + wg * OUT_BYTES;
    for (int i = wg; i < n_local; i += 2) {
      const int st = i % STAGES;
      const uint32_t slab = smem_u32(stages + st * STAGE_BYTES);
      mbar_wait(full + 8 * st, (i / STAGES) & 1);
#pragma unroll 1
      for (int r = 0; r < TH; ++r) {
        // Output row r: tap (dy, dx) reads slab pixels (r + dy)·SW + dx + n,
        // step kc the ci 16·kc.. of each (32 bytes into the row).
        const uint64_t row_desc = desc128(slab + r * SW * ROW_BYTES, 1);
        float acc[TW / 2];
        wgmma_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int kc = 0; kc < C / 16; ++kc)
              wgmma<0>(acc, wa[(dy * 3 + dx) * 4 + kc],
                       row_desc + ((((dy * SW + dx) * ROW_BYTES) + kc * 32) >> 4), (dy | dx | kc) != 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        if (r == TH - 1 && wtid == 0) mbar_arrive(empty + 8 * st);  // the slab is read
        if (r == 0) {  // the previous tile's store has read the staging tile
          if (wtid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          bar_sync(1 + wg, 128);
        }
        // acc[4j..4j+3]: channels c_lo, c_lo + 8 × pixels 8j + 2q, +1; as
        // bf16 pairs they are the fragments of the (channel, pixel) 8×8
        // matrices, stored transposed: pixel rows of the staging tile.
        const int mat = lane >> 3;
#pragma unroll
        for (int j = 0; j < NB; j += 2) {
          const uint32_t addr =
              swizzled(out_base, r * TW + 8 * (j + (mat >> 1)) + (lane & 7), 2 * warp + (mat & 1));
          const uint32_t lo = relu_bf16x2(acc[4 * j], acc[4 * j + 1], s_lo, s_lo, b_lo, b_lo);
          const uint32_t hi = relu_bf16x2(acc[4 * j + 2], acc[4 * j + 3], s_hi, s_hi, b_hi, b_hi);
          if (j + 1 < NB)
            stmatrix_x4_trans(addr, lo, hi, relu_bf16x2(acc[4 * j + 4], acc[4 * j + 5], s_lo, s_lo, b_lo, b_lo),
                              relu_bf16x2(acc[4 * j + 6], acc[4 * j + 7], s_hi, s_hi, b_hi, b_hi));
          else
            stmatrix_x2_trans(addr, lo, hi);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1 + wg, 128);
      if (wtid == 0) {
        int b, h0, w0;
        grid.coords(blockIdx.x + i * gridDim.x, b, h0, w0);
        tma_store_4d(&y_map, out_base, 0, w0, h0, b);
      }
    }
    if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (the
// library does not link libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first) over contiguous memory,
// 128-byte swizzle, zeros outside. Returns a cudaError_t code.
int make_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims, const uint32_t* box) {
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t bdim[4], estride[4] = {1, 1, 1, 1};
  uint64_t stride = 2;
  for (int d = 0; d < rank; ++d) {
    gdim[d] = dims[d];
    bdim[d] = box[d];
    if (d > 0) gstride[d - 1] = stride;
    stride *= dims[d];
  }
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), gdim, gstride,
                        bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int N>
int launch_gemm(const void* a, const void* w, const void* s, const void* b, void* out, int m,
                int k, int reps, cudaStream_t stream) {
  CUtensorMap a_map, w_map;
  const uint64_t a_dims[2] = {(uint64_t)k, (uint64_t)m}, w_dims[2] = {(uint64_t)N, (uint64_t)k};
  const uint32_t box[2] = {64, 64};
  int rc = make_map(&a_map, a, 2, a_dims, box);
  if (rc == 0) rc = make_map(&w_map, w, 2, w_dims, box);
  if (rc != 0) return rc;
  const size_t smem = 1024 + (size_t)(1 + N / 64) * GEMM_KB * BOX_BYTES + 8;
  auto kernel = block1_gemm_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<GEMM_SPLIT * ((m + 63) / 64), GEMM_THREADS, smem, stream>>>(
      a_map, w_map, static_cast<const float*>(s), static_cast<const float*>(b),
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
  if ((m + 63) / 64 > 0x7fffffff / GEMM_SPLIT) return (int)cudaErrorInvalidValue;
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
  const int tiles_w = (w + TW - 1) / TW, tiles_h = (h + TH - 1) / TH;
  const long long n_tiles = (long long)batch * tiles_h * tiles_w;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const ConvGrid grid{tiles_w, tiles_h * tiles_w, (int)n_tiles};
  CUtensorMap x_map, w_map, y_map;
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)w, (uint64_t)h, (uint64_t)batch};
  const uint64_t w_dims[2] = {(uint64_t)C, (uint64_t)KDIM};
  const uint32_t x_box[4] = {C, SW, SH, 1}, y_box[4] = {C, TW, TH, 1}, w_box[2] = {64, 64};
  int rc = make_map(&x_map, x, 4, dims, x_box);
  if (rc == 0) rc = make_map(&y_map, y, 4, dims, y_box);
  if (rc == 0) rc = make_map(&w_map, wt, 2, w_dims, w_box);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(block1_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CONV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)(n_tiles < sms ? n_tiles : sms);
  block1_conv_kernel<<<blocks, CONV_THREADS, CONV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, y_map, static_cast<const float*>(scale), static_cast<const float*>(shift), grid);
  return (int)cudaGetLastError();
}

}  // extern "C"
