// K3: s8 x s8 implicit-GEMM convolution into s32 with a fused
// dequantize / bias / relu / requantize epilogue, for Hopper (sm_90a).
//
// Replaces ifcb_classifier_tpu/models/quant_graph.py:96 (_QuantCtx.conv, an
// XLA fusion on the TPU: conv_general_dilated with an int32 result, then
// the epilogue, with _q8 of models/quant_resident.py:27-28):
//
//   acc[m, co] = sum_k x_s8[gather(m, k)] * w_s8[co, k]           (exact s32)
//   y          = max(float(acc) * scale[co] + bias[co], 0)        (f32)
//   out        = clip(rint(y * inv_out), -127, 127) as s8          (emit)
//              | y rounded once to bf16 or kept f32                (emit=None)
//
// with M = B*Ho*Wo output pixels, N = Co, K = KH*KW*Ci in (kh, kw, ci)
// order. x is NHWC s8 [B,H,W,Ci]; the weights come packed once per conv
// (ops/qconv.pack_k3_weights): a K-major s8 [Co_pad, K_pad] matrix, zero
// padded, read through a TMA descriptor. Taps outside the image read as 0
// (the padding). Output row m is written at out + m*out_stride + out_off
// + co, so the branches of an inception block write straight into their
// concat buffer.
//
// The epilogue is written with __fmul_rn / __fadd_rn (no FMA contraction)
// and rintf (round half to even, as torch.round): the s32 sums are exact,
// so the output is bitwise equal to the plain version's (ops/qconv.py,
// float64 convolution, then the same f32 operations in the same order).
//
// Design:
//   * a persistent grid (one block per SM, two for BN <= 64) walks
//     128 x BN output tiles, numbered N-fastest so the blocks that share an
//     input tile run together; BN is chosen per conv from {32, 64, ...,
//     224} (widths that wgmma takes for s8) so Co = 32..448 wastes little;
//   * warp specialisation over a ring of `stages` shared-memory stages of
//     128 K-bytes each (A: 128 x 128 B, B: BN x 128 B, both K-major in the
//     128-byte swizzled layout that wgmma reads): warpgroup 2 produces,
//     warpgroups 0 and 1 consume, one mbarrier pair (full, empty) a stage;
//   * B (the packed weights) arrives by TMA (cp.async.bulk.tensor.2d) on
//     the stage's full barrier with expect-tx; K past K_pad reads as zero;
//   * A, the gathered input, is written by the producer warps: with
//     Ci % 16 == 0 a 16-byte piece never straddles a tap, so each piece is
//     one 16-byte cp.async (source size 0 for taps outside the image, rows
//     past M and K past its end: zero fill), straight into the swizzled
//     slot; 8 threads share a piece column and walk its tap without a
//     division, and signal each stage with cp.async.mbarrier.arrive (the
//     barrier counts the arrival once the copies have landed; the thread
//     never waits), so the whole ring is in flight; the consumers fence
//     each stage for the async proxy (wgmma reads through it). The stem
//     (Ci = KH = KW = 3, K = 27) gathers its three kernel rows of 9
//     contiguous bytes with compile-time offsets, four 128-row blocks side
//     by side in one stage's K; any other Ci gathers byte by byte;
//   * each consumer warpgroup issues wgmma.mma_async m64nBNk32 s8.s8.s32
//     for its 64 rows, four k-steps a stage (past K_pad on zeros: no branch,
//     so ptxas does not wait after each wgmma), one commit group a stage;
//     a stage is released to the producer once the wgmmas that read it have
//     waited (wait_group 1 one stage later);
//   * epilogue: scale and bias for all Co sit in shared memory (loaded once
//     per block); the s8 emit rounds without a conversion instruction, is
//     staged per warpgroup in shared memory and written as coalesced
//     16-byte row pieces wherever the destination is 16-byte aligned
//     (narrower stores for a ragged part); bf16 and f32 emits store pairs
//     from the registers. The producer runs ahead into the next tile while
//     the consumers finish this one.
//
// Its bound on this card: max(2*M*N*K / 1,979 TOPS (s8 dense tensor cores),
// bytes / 3.35 TB/s), bytes = input + weights + scale/bias read once and the
// output written once.

#include <cuda.h>  // CUtensorMap and its enums; the driver call is looked
                   // up at run time, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BM = 128;        // output pixels per tile (2 warpgroups x 64)
constexpr int BK = 128;        // K bytes per stage: one 128-byte swizzle row
constexpr int THREADS = 384;   // warpgroups 0, 1 consume; 2 produces
constexpr int MAX_STAGES = 8;
constexpr int PRODUCERS = 128;
constexpr int SUB = 4;         // row blocks per stage when K_pad = 32

enum OutKind { OUT_S8 = 0, OUT_BF16 = 1, OUT_F32 = 2 };
enum Gather { G_WIDE = 0, G_STEM = 1, G_BYTES = 2 };

struct FastDiv {
  unsigned mul;
  int shift;
};

struct Geom {
  const int8_t* x;
  const float* scale;
  const float* bias;
  void* out;
  long long out_stride;
  int H, W, Ci, Co, KH, KW, SH, SW, PH, PW, Ho, Wo;
  int K_pad, n_kst, M, HoWo, n_tiles_n, tiles, stages, co_pad, sub;
  int out_off, out_kind, gather;
  float inv_out;
  FastDiv div_howo, div_wo;
};

// mul = ceil(2^(31 + l) / d), l = ceil(log2 d): exact for 0 <= n < 2^31
FastDiv fast_div(int d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  const unsigned long long p = 1ULL << (31 + l);
  FastDiv f;
  f.mul = static_cast<unsigned>((p + d - 1) / d);
  f.shift = 31 + l;
  return f;
}

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared, or 16 zero bytes when !ok (nothing is read).
// No "memory" clobber: the producer never reads the ring, and the asm
// statements around it (the arrive, waits, barriers) keep their order.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(ok ? 16u : 0u));
}

// The mbarrier counts one arrival once this thread's cp.asyncs so far have
// landed (.noinc: the arrival is part of the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma reads its operands through it)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (start address, LBO 16 B, SBO 1024 B, layout 1)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// the accumulators are written asynchronously: keep the compiler from
// moving their reads across a wait
template <int R>
__device__ __forceinline__ void fence_regs(int32_t* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define K3_R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define K3_R1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define K3_R2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define K3_R3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define K3_R4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define K3_R5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define K3_R6 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define K3_D16(i)                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),              \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7]),      \
      "+r"(d[i + 8]), "+r"(d[i + 9]), "+r"(d[i + 10]), "+r"(d[i + 11]),    \
      "+r"(d[i + 12]), "+r"(d[i + 13]), "+r"(d[i + 14]), "+r"(d[i + 15])
// one m64nNk32 s8 x s8 -> s32 product of a warpgroup, A and B from shared
// memory; scale_d 0 overwrites the accumulators, 1 adds to them
#define K3_WGMMA(N, REGS, IA, IB, IS, ...)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n" #N                       \
               "k32.s32.s8.s8 {" REGS "}, %" #IA ", %" #IB ", p;\n}\n"      \
               : __VA_ARGS__                                                \
               : "l"(a), "l"(b), "r"(scale_d))

template <int BN>
__device__ void wgmma_s8(int32_t* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int32_t* d, uint64_t a,
                                             uint64_t b, int scale_d) {
  K3_WGMMA(32, K3_R0, 16, 17, 18, K3_D16(0));
}
template <>
__device__ __forceinline__ void wgmma_s8<64>(int32_t* d, uint64_t a,
                                             uint64_t b, int scale_d) {
  K3_WGMMA(64, K3_R0 ", " K3_R1, 32, 33, 34, K3_D16(0), K3_D16(16));
}
template <>
__device__ __forceinline__ void wgmma_s8<96>(int32_t* d, uint64_t a,
                                             uint64_t b, int scale_d) {
  K3_WGMMA(96, K3_R0 ", " K3_R1 ", " K3_R2, 48, 49, 50, K3_D16(0),
           K3_D16(16), K3_D16(32));
}
template <>
__device__ __forceinline__ void wgmma_s8<128>(int32_t* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  K3_WGMMA(128, K3_R0 ", " K3_R1 ", " K3_R2 ", " K3_R3, 64, 65, 66,
           K3_D16(0), K3_D16(16), K3_D16(32), K3_D16(48));
}
template <>
__device__ __forceinline__ void wgmma_s8<160>(int32_t* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  K3_WGMMA(160, K3_R0 ", " K3_R1 ", " K3_R2 ", " K3_R3 ", " K3_R4, 80, 81,
           82, K3_D16(0), K3_D16(16), K3_D16(32), K3_D16(48), K3_D16(64));
}
template <>
__device__ __forceinline__ void wgmma_s8<192>(int32_t* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  K3_WGMMA(192, K3_R0 ", " K3_R1 ", " K3_R2 ", " K3_R3 ", " K3_R4 ", " K3_R5,
           96, 97, 98, K3_D16(0), K3_D16(16), K3_D16(32), K3_D16(48),
           K3_D16(64), K3_D16(80));
}
template <>
__device__ __forceinline__ void wgmma_s8<224>(int32_t* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  K3_WGMMA(224,
           K3_R0 ", " K3_R1 ", " K3_R2 ", " K3_R3 ", " K3_R4 ", " K3_R5
                 ", " K3_R6,
           112, 113, 114, K3_D16(0), K3_D16(16), K3_D16(32), K3_D16(48),
           K3_D16(64), K3_D16(80), K3_D16(96));
}

// ---- shared-memory layout (mirrored by ops/qconv.k3_smem_bytes) ---------
//   ring: stages x (A 128 x 128 B, then B BN x 128 B), each part on a
//         1024-byte boundary (128-byte swizzle atoms)
//   staging of the s8 emit: 128 x (BN + 16) B
//   scale, bias: co_pad f32 each
//   barriers: full[MAX_STAGES], empty[MAX_STAGES]
// plus 1024 bytes to align the dynamic base.

template <int BN>
struct Layout {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE = BK * (BM + BN);
  static constexpr int SROW = BN + 16;  // staging row: 16-byte aligned,
                                        // 8 rows on distinct banks
  __host__ __device__ static int staging(int stages) { return stages * STAGE; }
  __host__ __device__ static int scale(int stages) {
    return staging(stages) + BM * SROW;
  }
  __host__ __device__ static int bars(int stages, int co_pad) {
    return scale(stages) + 8 * co_pad;
  }
  __host__ __device__ static int bytes(int stages, int co_pad) {
    return bars(stages, co_pad) + 16 * MAX_STAGES + 1024;
  }
};

// ---- the producer -------------------------------------------------------

constexpr int FAR = -(1 << 28);  // an origin no tap reaches: rows past M

// n / d for 0 <= n < 2^31 as (n * mul) >> shift (the divisor's constants
// come from the host, fast_div)
__device__ __forceinline__ int div_by(int n, FastDiv d) {
  return static_cast<int>((static_cast<unsigned long long>(n) * d.mul) >>
                          d.shift);
}

// Output pixel m's input origin: the offset of (n, ih0, iw0) in x, which
// taps add (r*W + s)*Ci to (x has fewer than 2^31 bytes), and ih0, iw0
// (FAR for rows past M).
__device__ __forceinline__ int row_offset(const Geom& g, int m, int& ih0,
                                          int& iw0) {
  const int mm = m < g.M ? m : g.M - 1;
  const int n = div_by(mm, g.div_howo), rem = mm - n * g.HoWo;
  const int oh = div_by(rem, g.div_wo), ow = rem - oh * g.Wo;
  ih0 = m < g.M ? oh * g.SH - g.PH : FAR;
  iw0 = ow * g.SW - g.PW;
  return ((n * g.H + oh * g.SH - g.PH) * g.W + iw0) * g.Ci;
}

__device__ __forceinline__ const int8_t* row_origin(const Geom& g, int m,
                                                    int& ih0, int& iw0) {
  return g.x + row_offset(g, m, ih0, iw0);
}

// Advance a (r, s, c) tap position by `bytes` of K.
__device__ __forceinline__ void tap_advance(const Geom& g, int bytes, int& r,
                                            int& s, int& c) {
  c += bytes;
  while (c >= g.Ci) {
    c -= g.Ci;
    if (++s == g.KW) {
      s = 0;
      ++r;
    }
  }
}

// The B tile of a stage: TMA onto the stage's full barrier (expect-tx).
template <int BN>
__device__ __forceinline__ void load_b(const CUtensorMap* wmap, uint32_t dst,
                                       uint32_t full, int k0, int n0) {
  mbar_expect_tx(full, BN * BK);
  tma_load_2d(dst, wmap, k0, n0, full);
}

// Ci % 16 == 0: thread t fills 16-byte column (t & 7) of rows
// (t >> 3) + 16 i, i < 8, of every stage's A with one cp.async each, then
// signals the stage with cp.async.mbarrier.arrive: the full barrier counts
// its arrival once those copies have landed, so the thread never waits for
// them and the whole ring can be in flight. B comes by TMA onto the same
// barrier.
template <int BN>
__device__ void produce_wide(const Geom& g, const CUtensorMap* wmap,
                             uint32_t ring, uint32_t full0, uint32_t empty0) {
  using L = Layout<BN>;
  const int t = threadIdx.x - 2 * 128;
  const int col = t & 7, row0 = t >> 3;
  const int8_t* const x = g.x;
  // swizzled slot of this thread's piece in row row0 (row0 + 16 i has the
  // same row & 7)
  const uint32_t slot = row0 * BK + ((col ^ (row0 & 7)) << 4);
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int tile_m = tile / g.n_tiles_n;
    const int n0 = (tile - tile_m * g.n_tiles_n) * BN;
    const int m0 = tile_m * BM + row0;
    int base[8], ih0[8], iw0[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      base[i] = row_offset(g, m0 + 16 * i, ih0[i], iw0[i]);
    int r = 0, s = 0, c = 0;
    tap_advance(g, col * 16, r, s, c);
    for (int ks = 0; ks < g.n_kst; ++ks) {
      const uint32_t full = full0 + 8 * stage;
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      const uint32_t a = ring + stage * L::STAGE;
      if (t == 0) load_b<BN>(wmap, a + L::A_BYTES, full, ks * BK, n0);
      const bool k_ok = r < g.KH;
      const int off = (r * g.W + s) * g.Ci + c;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ih = ih0[i] + r, iw = iw0[i] + s;
        const bool ok = k_ok && (unsigned)ih < (unsigned)g.H &&
                        (unsigned)iw < (unsigned)g.W;
        cp_async16(a + slot + i * 16 * BK, x + (ok ? base[i] + off : 0), ok);
      }
      tap_advance(g, BK, r, s, c);
      cp_async_arrive(full);
      if (++stage == g.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The stem (Ci = KH = KW = 3, K = 27): a row's bytes are its three kernel
// rows of 9 contiguous NHWC bytes; offsets and taps are compile-time.
__device__ __forceinline__ void gather_stem(const Geom& g, const int8_t* xrow,
                                            int ih0, int iw0, uint32_t* w) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const bool r_ok = (unsigned)(ih0 + r) < (unsigned)g.H;
    const int8_t* p = xrow + (long long)r * g.W * 3;
#pragma unroll
    for (int b = 0; b < 9; ++b) {
      const int j = r * 9 + b;
      const bool ok = r_ok && (unsigned)(iw0 + b / 3) < (unsigned)g.W;
      const uint32_t v = ok ? (uint8_t)__ldg(p + b) : 0u;
      w[j >> 2] |= v << (8 * (j & 3));
    }
  }
}

// Any other Ci: 32 bytes of a row from tap position (r, s, c) on, byte by
// byte (the loads do not depend on each other, so they are all in flight).
__device__ __forceinline__ void gather_bytes(const Geom& g,
                                             const int8_t* xrow, int ih0,
                                             int iw0, int& r, int& s, int& c,
                                             uint32_t* w) {
  auto tap = [&](const int8_t*& src) {
    const int ih = ih0 + r, iw = iw0 + s;
    src = xrow + ((long long)r * g.W + s) * g.Ci;
    return r < g.KH && (unsigned)ih < (unsigned)g.H &&
           (unsigned)iw < (unsigned)g.W;
  };
  const int8_t* src;
  bool ok = tap(src);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t v = ok ? (uint8_t)__ldg(src + c) : 0u;
    w[j >> 2] |= v << (8 * (j & 3));
    if (++c == g.Ci) {
      c = 0;
      if (++s == g.KW) {
        s = 0;
        ++r;
      }
      ok = tap(src);
    }
  }
}

// 32 gathered bytes into 16-byte columns q and q + 1 of a swizzled row.
__device__ __forceinline__ void store_32(uint8_t* arow, int row, int q,
                                         const uint32_t* w) {
  *reinterpret_cast<uint4*>(arow + ((q ^ (row & 7)) << 4)) =
      make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(arow + (((q + 1) ^ (row & 7)) << 4)) =
      make_uint4(w[4], w[5], w[6], w[7]);
}

// Ci % 16 != 0 (128-row tiles): thread t gathers row t of every stage with
// plain loads and writes it with 16-byte shared stores, then signals the
// stage. With K_pad = 32 (the stem) a stage holds SUB row blocks side by
// side in K, so each thread has SUB rows of loads in flight.
template <int BN>
__device__ void produce_bytes(const Geom& g, const CUtensorMap* wmap,
                              uint32_t ring, uint32_t full0,
                              uint32_t empty0, uint8_t* ring_ptr) {
  using L = Layout<BN>;
  const int t = threadIdx.x - 2 * 128;
  const bool stem = g.gather == G_STEM;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int tile_m = tile / g.n_tiles_n;
    const int n0 = (tile - tile_m * g.n_tiles_n) * BN;
    const int m0 = tile_m * BM * g.sub + t;
    if constexpr (BN == 32) if (g.sub == SUB) {
      uint32_t w[SUB][8];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        int ih0, iw0;
        const int8_t* xrow = row_origin(g, m0 + BM * j, ih0, iw0);
#pragma unroll
        for (int i = 0; i < 8; ++i) w[j][i] = 0;
        int r = 0, s = 0, c = 0;
        if (stem)
          gather_stem(g, xrow, ih0, iw0, w[j]);
        else
          gather_bytes(g, xrow, ih0, iw0, r, s, c, w[j]);
      }
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      const uint32_t full = full0 + 8 * stage;
      const uint32_t a = ring + stage * L::STAGE;
      if (t == 0) load_b<BN>(wmap, a + L::A_BYTES, full, 0, n0);
      uint8_t* arow = ring_ptr + stage * L::STAGE + t * BK;
#pragma unroll
      for (int j = 0; j < SUB; ++j) store_32(arow, t, 2 * j, w[j]);
      fence_proxy_async();
      mbar_arrive(full);
      if (++stage == g.stages) {
        stage = 0;
        phase ^= 1;
      }
      continue;
    }
    int ih0, iw0;
    const int8_t* xrow = row_origin(g, m0, ih0, iw0);
    int r = 0, s = 0, c = 0;
    for (int ks = 0; ks < g.n_kst; ++ks) {
      const uint32_t full = full0 + 8 * stage;
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      const uint32_t a = ring + stage * L::STAGE;
      if (t == 0) load_b<BN>(wmap, a + L::A_BYTES, full, ks * BK, n0);
      int kb = g.K_pad - ks * BK;
      if (kb > BK) kb = BK;
      uint8_t* arow = ring_ptr + stage * L::STAGE + t * BK;
      for (int j0 = 0; j0 < kb; j0 += 32) {
        uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (!stem)
          gather_bytes(g, xrow, ih0, iw0, r, s, c, w);
        else if (j0 == 0)  // K = 27: the rest of the row is zero
          gather_stem(g, xrow, ih0, iw0, w);
        store_32(arow, t, j0 >> 4, w);
      }
      fence_proxy_async();
      mbar_arrive(full);
      if (++stage == g.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// ---- the consumers ------------------------------------------------------

__device__ __forceinline__ float epilogue(int32_t acc, float scale,
                                          float bias) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return fmaxf(y, 0.0f);
}

// clip(rint(y * inv_out), -127, 127) in the low byte, without a
// conversion instruction (they run at a quarter of the FP32 rate): the
// clip commutes with rint (its bounds are integers), and adding 1.5 * 2^23
// rounds a value in [-127, 127] to an integer, half to even as torch.round,
// leaving it in the low mantissa bits
__device__ __forceinline__ uint32_t to_s8(float y, float inv_out) {
  const float v = fminf(fmaxf(__fmul_rn(y, inv_out), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// The epilogue of one warpgroup's 64 x BN accumulators, rows m0.. of the
// output: acc[4j + 2h + e] is (row + 8h, n0 + 8j + cq + e).
template <int BN>
__device__ __forceinline__ void store_tile(const Geom& g, const int32_t* acc,
                                           int m0, int n0, uint8_t* st,
                                           const float* s_scale,
                                           const float* s_bias) {
  using L = Layout<BN>;
  const int lt = threadIdx.x & 127, wg = threadIdx.x >> 7;
  const int row = (lt >> 5) * 16 + ((lt & 31) >> 2);
  const int cq = (lt & 3) * 2;
  if (g.out_kind == OUT_S8) {
    named_bar_sync(1 + wg, 128);  // last tile's reads of st are done
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = 8 * j + cq;
      const float2 sc = *reinterpret_cast<const float2*>(s_scale + n0 + cl);
      const float2 bi = *reinterpret_cast<const float2*>(s_bias + n0 + cl);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t q0 =
            to_s8(epilogue(acc[4 * j + 2 * h], sc.x, bi.x), g.inv_out);
        const uint32_t q1 =
            to_s8(epilogue(acc[4 * j + 2 * h + 1], sc.y, bi.y), g.inv_out);
        *reinterpret_cast<uint16_t*>(st + (row + 8 * h) * L::SROW + cl) =
            static_cast<uint16_t>(__byte_perm(q0, q1, 0x0040));
      }
    }
    named_bar_sync(1 + wg, 128);
    int width = g.Co - n0;
    if (width > BN) width = BN;
    constexpr int PIECES = BN / 16;
    for (int p = lt; p < 64 * PIECES; p += 128) {
      const int rr = p / PIECES, c0 = (p - rr * PIECES) * 16;
      const int m = m0 + rr;
      if (m >= g.M || c0 >= width) continue;
      int8_t* dst = static_cast<int8_t*>(g.out) + m * g.out_stride +
                    g.out_off + n0 + c0;
      const uint8_t* src = st + rr * L::SROW + c0;
      if (c0 + 16 <= width && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {  // the ragged part: byte stores
        const int nb = width - c0 < 16 ? width - c0 : 16;
        for (int b = 0; b < nb; ++b) dst[b] = static_cast<int8_t>(src[b]);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int co = n0 + 8 * j + cq;
    const float2 sc = *reinterpret_cast<const float2*>(s_scale + co);
    const float2 bi = *reinterpret_cast<const float2*>(s_bias + co);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row + 8 * h;
      if (m >= g.M || co >= g.Co) continue;
      const float y0 = epilogue(acc[4 * j + 2 * h], sc.x, bi.x);
      const float y1 = epilogue(acc[4 * j + 2 * h + 1], sc.y, bi.y);
      const long long at = m * g.out_stride + g.out_off + co;
      if (g.out_kind == OUT_BF16) {
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(g.out) + at;
        if (co + 1 < g.Co && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __nv_bfloat162(
              __float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
        } else {
          o[0] = __float2bfloat16_rn(y0);
          if (co + 1 < g.Co) o[1] = __float2bfloat16_rn(y1);
        }
      } else {
        float* o = static_cast<float*>(g.out) + at;
        if (co + 1 < g.Co && (reinterpret_cast<uintptr_t>(o) & 7) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
        } else {
          o[0] = y0;
          if (co + 1 < g.Co) o[1] = y1;
        }
      }
    }
  }
}

// Both warpgroups take every 128-row tile, 64 rows each (their A rows in
// a stage start at a_off).
template <int BN>
__device__ void consume(const Geom& g, uint32_t ring, uint32_t full0,
                        uint32_t empty0, uint8_t* staging,
                        const float* s_scale, const float* s_bias) {
  using L = Layout<BN>;
  const int wg = threadIdx.x >> 7;
  const bool lead = (threadIdx.x & 31) == 0;  // arrives for its warp
  const uint32_t a_off = wg * 64 * BK;
  uint8_t* st = staging + wg * 64 * L::SROW;
  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int tile_m = tile / g.n_tiles_n;
    const int n0 = (tile - tile_m * g.n_tiles_n) * BN;
    const int m0 = tile_m * BM * g.sub + wg * 64;
    if constexpr (BN == 32) if (g.sub == SUB) {  // SUB row blocks, one k-step each
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t a = ring + stage * L::STAGE;
      const uint64_t da = desc_sw128(a + a_off);
      const uint64_t db = desc_sw128(a + L::A_BYTES);
#pragma unroll 1
      for (int j = 0; j < SUB; ++j) {
        wgmma_fence();
        fence_regs<BN / 2>(acc);
        wgmma_s8<BN>(acc, da + 2 * j, db, 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<BN / 2>(acc);
        if (j == SUB - 1 && lead) mbar_arrive(empty0 + 8 * stage);
        store_tile<BN>(g, acc, m0 + BM * j, n0, st, s_scale, s_bias);
      }
      if (++stage == g.stages) {
        stage = 0;
        phase ^= 1;
      }
      continue;
    }
    int prev = -1;
    for (int ks = 0; ks < g.n_kst; ++ks) {
      mbar_wait(full0 + 8 * stage, phase);
      // the producer's cp.async writes (generic proxy) made visible to the
      // wgmma reads (async proxy): the stage's full barrier ordered them
      // before this fence
      fence_proxy_async();
      const uint32_t a = ring + stage * L::STAGE;
      const uint64_t da = desc_sw128(a + a_off);
      const uint64_t db = desc_sw128(a + L::A_BYTES);
      wgmma_fence();
      fence_regs<BN / 2>(acc);
      // all four k-steps, also past K_pad: B reads as zero there (the
      // pack's padding, then TMA's fill), so the sums do not change, and
      // no branch makes ptxas wait after each wgmma
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)  // +32 B of K: +2 in the address
        wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, (ks | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<BN / 2>(acc);
      if (prev >= 0 && lead) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == g.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc);
    if (lead) mbar_arrive(empty0 + 8 * prev);
    store_tile<BN>(g, acc, m0, n0, st, s_scale, s_bias);
  }
}

// narrow tiles: two blocks per SM (their registers fit), so twice the
// warps hide the gather's and the epilogue's latencies
template <int BN>
constexpr int blocks_per_sm() {
  return BN <= 64 ? 2 : 1;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, blocks_per_sm<BN>())
    qconv_s8_kernel(const __grid_constant__ CUtensorMap wmap, const Geom g) {
  using L = Layout<BN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the ring at the first 1024-byte boundary (128-byte swizzle atoms)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staging = smem + L::staging(g.stages);
  float* s_scale = reinterpret_cast<float*>(smem + L::scale(g.stages));
  float* s_bias = s_scale + g.co_pad;
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = ring + L::bars(g.stages, g.co_pad);
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full0 + 8 * s, PRODUCERS + 1);  // + the TMA's expect-tx
      mbar_init(empty0 + 8 * s, 8);             // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int c = tid; c < g.co_pad; c += blockDim.x) {
    s_scale[c] = c < g.Co ? g.scale[c] : 0.0f;
    s_bias[c] = c < g.Co ? g.bias[c] : 0.0f;
  }
  __syncthreads();
  if (tid >= 2 * 128) {
    if (g.gather == G_WIDE)
      produce_wide<BN>(g, &wmap, ring, full0, empty0);
    else
      produce_bytes<BN>(g, &wmap, ring, full0, empty0, smem);
  } else {
    consume<BN>(g, ring, full0, empty0, staging, s_scale, s_bias);
  }
}

int sm_count(int dev) {
  static int count[64];
  if (dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <int BN>
cudaError_t launch(const CUtensorMap& map, const Geom& g, int smem,
                   cudaStream_t stream) {
  // per device: the dynamic shared memory allowed so far, and the blocks
  // resident per SM at the last smem size
  static int configured[64], resident_smem[64], resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(qconv_s8_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    configured[dev] = smem;
  }
  if (resident_smem[dev] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident[dev], qconv_s8_kernel<BN>, THREADS, smem);
    if (err != cudaSuccess) return err;
    resident_smem[dev] = smem;
  }
  long long grid = (long long)sm_count(dev) * resident[dev];
  if (grid <= 0) return cudaErrorInvalidConfiguration;
  if (grid > g.tiles) grid = g.tiles;
  qconv_s8_kernel<BN><<<(unsigned)grid, THREADS, smem, stream>>>(map, g);
  return cudaGetLastError();
}

}  // namespace

// The TMA descriptor of a packed weight matrix: s8 [co_pad, k_pad]
// row-major at w (16-byte aligned, k_pad % 16 == 0), boxes of bn rows x 128
// bytes, 128-byte swizzle. Writes the 128-byte CUtensorMap to map_out.
// Returns 0, a CUresult, or -1 when the driver entry point is missing.
extern "C" int k3_weight_map(void* w, int co_pad, int k_pad, int bn,
                             void* map_out) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        fn == nullptr)
      return -1;
    encode = reinterpret_cast<Encode>(fn);
  }
  alignas(64) CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)k_pad, (cuuint64_t)co_pad};
  const cuuint64_t strides[1] = {(cuuint64_t)k_pad};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res == CUDA_SUCCESS) memcpy(map_out, &map, sizeof(map));
  return static_cast<int>(res);
}

// x s8 [B,H,W,Ci] (16-byte aligned when Ci % 16 == 0, fewer than 2^31
// bytes); map: the 128-byte descriptor of the packed weights
// (k3_weight_map with this bn); scale/bias f32 [Co]; geom: the 17 ints B,
// H, W, Ci, Co, KH, KW, SH, SW, PH, PW, Ho, Wo, k_pad, bn, stages, smem
// (PH/PW are the top/left pads, the bottom and right ones implied by
// Ho/Wo; smem is the launch plan's dynamic shared memory and must cover
// the layout); out: row m of the [B*Ho*Wo] output pixels at out +
// m*out_stride + out_off (elements of out_kind: 0 s8, 1 bf16, 2 f32).
// Returns the launch's cudaError_t (0 on success); launches on `stream`
// without synchronising.
extern "C" int k3_qconv_s8(const void* x, const void* map, const float* scale,
                           const float* bias, void* out, const int* geom,
                           long long out_stride, int out_off, int out_kind,
                           float inv_out, void* stream) {
  const int B = geom[0], H = geom[1], W = geom[2], Ci = geom[3],
            Co = geom[4], KH = geom[5], KW = geom[6], SH = geom[7],
            SW = geom[8], PH = geom[9], PW = geom[10], Ho = geom[11],
            Wo = geom[12], k_pad = geom[13], bn = geom[14],
            stages = geom[15], smem = geom[16];
  const long long M = (long long)B * Ho * Wo;
  if (M <= 0 || Co <= 0) return 0;
  const int gather = Ci % 16 == 0 ? G_WIDE
                     : (Ci == 3 && KH == 3 && KW == 3) ? G_STEM
                                                        : G_BYTES;
  const int sub = gather != G_WIDE && k_pad == 32 && bn == 32 ? SUB : 1;
  const long long tiles_m = (M + BM * sub - 1) / (BM * sub);
  const int n_tiles_n = (Co + bn - 1) / bn;
  if (M > 0x7fffffffLL || (long long)B * H * W * Ci > 0x7fffffffLL ||
      tiles_m * n_tiles_n > 0x7fffffffLL ||
      stages < 3 || stages > MAX_STAGES || k_pad % 32 ||
      k_pad < KH * KW * Ci || out_kind < 0 || out_kind > 2)
    return cudaErrorInvalidValue;
  Geom g;
  g.x = static_cast<const int8_t*>(x);
  g.scale = scale;
  g.bias = bias;
  g.out = out;
  g.out_stride = out_stride;
  g.H = H; g.W = W; g.Ci = Ci; g.Co = Co; g.KH = KH; g.KW = KW;
  g.SH = SH; g.SW = SW; g.PH = PH; g.PW = PW; g.Ho = Ho; g.Wo = Wo;
  g.K_pad = k_pad;
  g.n_kst = (k_pad + BK - 1) / BK;
  g.M = (int)M;
  g.HoWo = Ho * Wo;
  g.n_tiles_n = n_tiles_n;
  g.tiles = (int)(tiles_m * n_tiles_n);
  g.stages = stages;
  g.co_pad = n_tiles_n * bn;
  g.out_off = out_off;
  g.out_kind = out_kind;
  g.gather = gather;
  g.sub = sub;
  g.inv_out = inv_out;
  g.div_howo = fast_div(g.HoWo);
  g.div_wo = fast_div(Wo);
  alignas(64) CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3_CASE(N)                                                 \
  case N:                                                          \
    if (smem < Layout<N>::bytes(stages, g.co_pad))                 \
      return cudaErrorInvalidValue;                                \
    return launch<N>(m, g, smem, s);
  switch (bn) {
    K3_CASE(32)
    K3_CASE(64)
    K3_CASE(96)
    K3_CASE(128)
    K3_CASE(160)
    K3_CASE(192)
    K3_CASE(224)
  }
#undef K3_CASE
  return cudaErrorInvalidValue;
}
