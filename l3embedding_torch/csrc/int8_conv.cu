// The int8 audio tower's convolution for Hopper (sm_90a): a 3×3 SAME conv,
// stride 1, zero padding, int8 × int8 → int32, with the per-output-channel
// epilogue of the post-training-quantized tower in the same kernel.
//
// Replaces l3embedding_tpu/embed/quantized.py::_conv(q, w, jnp.int32), an
// XLA conv_general_dilated with preferred_element_type=int32 (there is no
// Pallas kernel behind it; stock PyTorch has no s8 × s8 → s32 conv on
// CUDA), and the epilogues that follow it (quantized.py:394-400, :405-407):
//   * requant (blocks 0-6): y = max(f32(acc)·deq[c] + b[c], 0), then
//     q' = clip(round_half_even(y / s_next), −127, 127) as int8;
//   * dequant (the embedding conv): f32(acc)·deq[c] + b[c] as f32.
// The multiply and the add are __fmul_rn and __fadd_rn, not one FMA, the
// division is __fdiv_rn by s_next (not a product with its reciprocal), and
// the rounding rintf (half to even), so that every tie lands where the
// reference's separate f32 operations put it.
//
// Layouts: x (B, H, W, Cin) int8 NHWC; w (Cout, Kp) int8, row c holding
// output channel c's 3×3×Cin taps in (dy, dx, ci) order, zero-padded from
// 9·Cin to Kp, a multiple of BK (ops/int8_conv_kernel.py::pack_weights);
// deq and b (Cout,) f32; s_next one f32 on the device (read by the kernel,
// so the host never waits for it); out (B, H, W, Cout) int8 or f32.
//
// Design (a simple one; wgmma with s8 operands and TMA are later work):
// implicit GEMM, M = output pixels, N = output channels, K = 9·Cin. A block
// takes 128 pixels × 64 channels; its 4 warps take 32 pixels × 64 channels
// each with mma.sync.m16n8k32 (s8, s32 accumulators in registers). K goes in
// slices of 64 bytes through a 3-stage cp.async ring in shared memory: with
// Cin a multiple of 64 a slice is one tap × 64 channels, 16-byte copies per
// pixel, and a pixel outside the image is a copy of 0 bytes, which fills
// the slot with zeros (the SAME padding). Other Cin gather the slice byte
// by byte; Cin 1 (the first conv, K 9) has a kernel of its own
// (int8_conv3x3_cin1_kernel, below). Shared-memory rows are padded to 80
// bytes, so the 32-bit fragment loads of a warp hit 32 different banks. The
// epilogue stages the block's output tile in shared memory and writes it
// with 16-byte stores, a row of the tile being contiguous in NHWC.
//
// Bound on an H100 (1979 TOP/s dense int8, 3.35 TB/s): the audio convs of
// cnn_L3_melspec2 at 64 windows are 0.12-0.24 TOP each and move 0.02-0.42
// GB, so the tower's convs are bound by operations except the first (Cin 1,
// bound by its 208 MB int8 output); chip_smoke.py prints the bound of each.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;          // output pixels a block
constexpr int BN = 64;           // output channels a block
constexpr int BK = 64;           // bytes of K a stage
constexpr int STAGES = 3;
constexpr int LDS = BK + 16;     // shared-memory row pitch (bytes)
constexpr int THREADS = 128;     // 4 warps × (32 pixels × 64 channels)
constexpr int OUT_PITCH_S8 = BN + 16;       // staging row pitch, int8 output
constexpr int OUT_PITCH_F32 = BN * 4 + 16;  // staging row pitch, f32 output
constexpr int SMEM_BYTES = STAGES * (BM + BN) * LDS;
static_assert(BM * OUT_PITCH_F32 <= SMEM_BYTES, "output staging must fit the ring");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
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

template <bool VEC, bool REQUANT>
__global__ void __launch_bounds__(THREADS)
    int8_conv3x3_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ deq, const float* __restrict__ bias,
                        const float* __restrict__ s_next, void* __restrict__ out, int batch, int h,
                        int wd, int cin, int cout, int kp) {
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
  unsigned char* a_s = smem;                          // [STAGES][BM][LDS]
  unsigned char* b_s = smem + STAGES * BM * LDS;      // [STAGES][BN][LDS]

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
    if constexpr (VEC) {
      const int per_tap = cin / BK;
      const int tap = kc / per_tap, c0 = (kc - tap * per_tap) * BK + part * 16;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hh = ph[j] + dy, ww = pw[j] + dx;
        const bool ok = static_cast<unsigned>(hh) < static_cast<unsigned>(h) &&
                        static_cast<unsigned>(ww) < static_cast<unsigned>(wd);
        const int8_t* src =
            ok ? x + ((static_cast<long long>(pb[j]) * h + hh) * wd + ww) * cin + c0 : x;
        cp_async16(as + ((tid >> 2) + 32 * j) * LDS + part * 16, src, ok);
      }
    } else {
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
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = (tid >> 2) + 32 * j;
      cp_async16(bs + row * LDS + part * 16,
                 w + static_cast<long long>(n0 + row) * kp + kc * BK + part * 16, true);
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
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kc landed; every warp is done with slice kc - 1
    const int nxt = kc + STAGES - 1;
    if (nxt < nk) load_stage(nxt, nxt % STAGES);
    cp_async_commit();

    const unsigned char* as = a_s + (kc % STAGES) * BM * LDS + (warp * 32) * LDS;
    const unsigned char* bs = b_s + (kc % STAGES) * BN * LDS;
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

  const float s = REQUANT ? *s_next : 1.0f;
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
          const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * hi + half]), dq), bb);
          if constexpr (REQUANT) {
            const float r = rintf(__fdiv_rn(fmaxf(y, 0.0f), s));
            smem[row * OUT_PITCH_S8 + col] =
                static_cast<unsigned char>(static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f)));
          } else {
            reinterpret_cast<float*>(smem + row * OUT_PITCH_F32)[col] = y;
          }
        }
      }
    }
  }
  __syncthreads();

  constexpr int ROW_BYTES = REQUANT ? BN : BN * 4;
  constexpr int PITCH = REQUANT ? OUT_PITCH_S8 : OUT_PITCH_F32;
  constexpr int CHUNKS = ROW_BYTES / 16;  // 16-byte chunks a tile row
  const int out_row_bytes = REQUANT ? cout : cout * 4;
  const int col0_bytes = REQUANT ? n0 : n0 * 4;
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

// Cin 1 (the tower's first conv, K = 9): no tensor-core product. A thread
// takes one pixel, packs its 9 taps (zeros outside the image) into three
// 32-bit words and forms each channel's sum with three __dp4a against the
// first 12 bytes of that channel's packed row (zero past tap 9), then
// writes the pixel's Cout outputs 16 bytes at a time: the output bytes,
// not the 9·Cout products, bound this conv.
template <bool REQUANT>
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
  const float s = REQUANT ? *s_next : 1.0f;
  for (int c0 = 0; c0 < cout; c0 += 16) {
    uint4 packed[REQUANT ? 1 : 4];
    unsigned* lanes = reinterpret_cast<unsigned*>(packed);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j;
      int acc = __dp4a(static_cast<int>(words[0]), w3[3 * c], 0);
      acc = __dp4a(static_cast<int>(words[1]), w3[3 * c + 1], acc);
      acc = __dp4a(static_cast<int>(words[2]), w3[3 * c + 2], acc);
      const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), deq[c]), bias[c]);
      if constexpr (REQUANT) {
        const float r = fminf(fmaxf(rintf(__fdiv_rn(fmaxf(y, 0.0f), s)), -127.0f), 127.0f);
        const unsigned byte = static_cast<unsigned char>(static_cast<int8_t>(r));
        if (j % 4 == 0) lanes[j / 4] = 0;
        lanes[j / 4] |= byte << (8 * (j % 4));
      } else {
        lanes[j] = __float_as_uint(y);
      }
    }
    if constexpr (REQUANT) {
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(out) + p * cout + c0) = packed[0];
    } else {
      uint4* dst = reinterpret_cast<uint4*>(static_cast<float*>(out) + p * cout + c0);
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[k] = packed[k];
    }
  }
}

template <bool VEC, bool REQUANT>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* deq, const float* bias,
                   const float* s_next, void* out, int batch, int h, int wd, int cin, int cout,
                   int kp, cudaStream_t stream) {
  const long long npix = static_cast<long long>(batch) * h * wd;
  const dim3 grid(static_cast<unsigned>((npix + BM - 1) / BM), cout / BN);
  int8_conv3x3_kernel<VEC, REQUANT><<<grid, THREADS, 0, stream>>>(x, w, deq, bias, s_next, out,
                                                                   batch, h, wd, cin, cout, kp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The K slice the packed weights are padded to (ops/int8_conv_kernel.py
// checks it against its own constant when it loads the library).
int l3_int8_conv_k_step() { return BK; }

// out = epilogue(conv3x3_SAME(x, w)): int8 with s_next (requant), f32
// without it (dequant). Returns a CUDA error code, 0 on success.
int l3_int8_conv3x3(const void* x, const void* w, const void* deq, const void* bias,
                    const void* s_next, void* out, int batch, int h, int wd, int cin, int cout,
                    int kp, void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1 || cout % BN != 0 ||
      kp != (9 * cin + BK - 1) / BK * BK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  const auto* d = static_cast<const float*>(deq);
  const auto* b = static_cast<const float*>(bias);
  const auto* s = static_cast<const float*>(s_next);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = cin % BK == 0;
  cudaError_t err;
  if (cin == 1) {
    const long long npix = static_cast<long long>(batch) * h * wd;
    const unsigned grid = static_cast<unsigned>((npix + THREADS - 1) / THREADS);
    const size_t smem = static_cast<size_t>(cout) * 3 * sizeof(int);
    if (s != nullptr) {
      int8_conv3x3_cin1_kernel<true><<<grid, THREADS, smem, st>>>(xs, ws, d, b, s, out, batch, h, wd, cout, kp);
    } else {
      int8_conv3x3_cin1_kernel<false><<<grid, THREADS, smem, st>>>(xs, ws, d, b, s, out, batch, h, wd, cout, kp);
    }
    err = cudaGetLastError();
  } else if (s != nullptr) {
    err = vec ? launch<true, true>(xs, ws, d, b, s, out, batch, h, wd, cin, cout, kp, st)
              : launch<false, true>(xs, ws, d, b, s, out, batch, h, wd, cin, cout, kp, st);
  } else {
    err = vec ? launch<true, false>(xs, ws, d, b, s, out, batch, h, wd, cin, cout, kp, st)
              : launch<false, false>(xs, ws, d, b, s, out, batch, h, wd, cin, cout, kp, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
