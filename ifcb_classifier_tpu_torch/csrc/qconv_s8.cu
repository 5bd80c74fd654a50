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
// order. x is NHWC s8 [B,H,W,Ci]; w is s8 [Co,KH,KW,Ci] (K-contiguous per
// output channel); taps outside the image read as 0 (the padding). The
// output row m is written at out + m*out_stride + out_off + co, so the
// branches of an inception block write straight into their concat buffer.
//
// The epilogue is written with __fmul_rn / __fadd_rn (no FMA contraction)
// and rintf (round half to even, as torch.round): the s32 sums are exact,
// so the output is bitwise equal to the plain version's (ops/qconv.py,
// float64 convolution, then the same f32 operations in the same order).
//
// Design (simple first; making it fast is later work):
//   * one block of 128 threads (4 warps, 2 x 2) per 64 x 64 output tile,
//     K in steps of 32 bytes; each warp owns a 32 x 32 sub-tile as 2 x 4
//     mma.sync.m16n8k32 s8 products accumulated in 32 s32 registers;
//   * A (the gathered input) and B (the weights) are staged in shared
//     memory, double-buffered, the next step's 16-byte pieces held in
//     registers while the current step multiplies; rows are padded to 48
//     bytes so the 32-bit fragment loads hit 32 distinct banks;
//   * Ci % 16 == 0 (every conv but the stem): a 16-byte piece of A never
//     straddles a tap, so it is one 16-byte load (or zeros); the stem
//     (Ci = 3, K = 27) gathers byte by byte, with a zero K tail;
//   * tiles are numbered N-fastest so the blocks that share an input tile
//     run together and read it from L2 rather than from memory again.
//
// Its bound on this card: max(2*M*N*K / 1,979 TOPS (s8 dense tensor cores),
// bytes / 3.35 TB/s), bytes = input + weights + scale/bias read once and the
// output written once. What the simple design leaves on the table: wgmma
// and TMA (mma.sync reaches a fraction of the tensor-core rate), deeper
// pipelining (one step in flight, a barrier per step), larger tiles (64 x
// 64 re-reads the weights per M tile and the input per N tile), and
// coalesced output stores (each thread writes 1-4 bytes at a time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;             // output pixels per tile
constexpr int BN = 64;             // output channels per tile
constexpr int BK = 32;             // bytes of K per step (one mma depth)
constexpr int LDS = BK + 16;       // padded shared-memory row, bytes
constexpr int THREADS = 128;
constexpr int STAGE_BYTES = (BM + BN) * LDS;

enum OutKind { OUT_S8 = 0, OUT_BF16 = 1, OUT_F32 = 2 };

struct Geom {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  int H, W, Ci, Co, KH, KW, SH, SW, PH, PW, Ho, Wo, K;
  int M, out_stride, out_off, n_tiles_n;
  float inv_out;
};

// The 16 bytes of A at (row, k0..k0+15) for one thread's row.
template <bool VEC>
__device__ __forceinline__ uint4 load_a(const Geom& g, const int8_t* xrow,
                                        bool row_ok, int ih0, int iw0,
                                        int k0, int tap_r, int tap_s,
                                        int tap_c) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (!row_ok || k0 >= g.K) return v;
  if (VEC) {
    const int ih = ih0 + tap_r, iw = iw0 + tap_s;
    if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
      v = *reinterpret_cast<const uint4*>(
          xrow + ((long long)ih * g.W + iw) * g.Ci + tap_c);
    return v;
  }
  uint8_t b[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int k = k0 + j;
    uint8_t val = 0;
    if (k < g.K) {
      const int tap = k / g.Ci, c = k - tap * g.Ci;
      const int r = tap / g.KW, s = tap - r * g.KW;
      const int ih = ih0 + r, iw = iw0 + s;
      if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
        val = (uint8_t)xrow[((long long)ih * g.W + iw) * g.Ci + c];
    }
    b[j] = val;
  }
  v.x = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
  v.y = b[4] | (b[5] << 8) | (b[6] << 16) | ((uint32_t)b[7] << 24);
  v.z = b[8] | (b[9] << 8) | (b[10] << 16) | ((uint32_t)b[11] << 24);
  v.w = b[12] | (b[13] << 8) | (b[14] << 16) | ((uint32_t)b[15] << 24);
  return v;
}

// The 16 bytes of B at (co, k0..k0+15).
template <bool VEC>
__device__ __forceinline__ uint4 load_b(const Geom& g, int co, int k0) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (co >= g.Co || k0 >= g.K) return v;
  const int8_t* p = g.w + (long long)co * g.K + k0;
  if (VEC) return *reinterpret_cast<const uint4*>(p);
  uint8_t b[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) b[j] = k0 + j < g.K ? (uint8_t)p[j] : 0;
  v.x = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
  v.y = b[4] | (b[5] << 8) | (b[6] << 16) | ((uint32_t)b[7] << 24);
  v.z = b[8] | (b[9] << 8) | (b[10] << 16) | ((uint32_t)b[11] << 24);
  v.w = b[12] | (b[13] << 8) | (b[14] << 16) | ((uint32_t)b[15] << 24);
  return v;
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int OUT>
__device__ __forceinline__ void store_one(const Geom& g, int m, int co,
                                          int acc) {
  if (m >= g.M || co >= g.Co) return;
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), g.scale[co]),
                      g.bias[co]);
  y = fmaxf(y, 0.0f);
  const long long at = (long long)m * g.out_stride + g.out_off + co;
  if (OUT == OUT_S8) {
    float q = rintf(__fmul_rn(y, g.inv_out));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    static_cast<int8_t*>(g.out)[at] = (int8_t)(int)q;
  } else if (OUT == OUT_BF16) {
    static_cast<__nv_bfloat16*>(g.out)[at] = __float2bfloat16_rn(y);
  } else {
    static_cast<float*>(g.out)[at] = y;
  }
}

template <bool VEC, int OUT>
__global__ void __launch_bounds__(THREADS)
    qconv_s8_kernel(const Geom g) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int tile_n = blockIdx.x % g.n_tiles_n;
  const int tile_m = blockIdx.x / g.n_tiles_n;
  const int m0 = tile_m * BM, n0 = tile_n * BN;

  // this thread's A row (one output pixel) and B row (one out channel)
  const int lrow = tid >> 1, kc = (tid & 1) * 16;
  const int m = m0 + lrow;
  const bool row_ok = m < g.M;
  int ih0 = 0, iw0 = 0;
  const int8_t* xrow = g.x;
  if (row_ok) {
    const int hw = g.Ho * g.Wo;
    const int n = m / hw, rem = m - n * hw;
    const int oh = rem / g.Wo, ow = rem - oh * g.Wo;
    ih0 = oh * g.SH - g.PH;
    iw0 = ow * g.SW - g.PW;
    xrow = g.x + (long long)n * g.H * g.W * g.Ci;
  }
  const int co_row = n0 + lrow;

  // tap of this thread's piece (VEC: tracked step by step, no division)
  int tap_r = 0, tap_s = 0, tap_c = kc;
  if (VEC) {
    while (tap_c >= g.Ci) {
      tap_c -= g.Ci;
      if (++tap_s == g.KW) { tap_s = 0; ++tap_r; }
    }
  }

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0;

  const int n_steps = (g.K + BK - 1) / BK;
  uint4 ra = load_a<VEC>(g, xrow, row_ok, ih0, iw0, kc, tap_r, tap_s, tap_c);
  uint4 rb = load_b<VEC>(g, co_row, kc);
  {
    uint8_t* sa = smem;
    uint8_t* sb = smem + BM * LDS;
    *reinterpret_cast<uint4*>(sa + lrow * LDS + kc) = ra;
    *reinterpret_cast<uint4*>(sb + lrow * LDS + kc) = rb;
  }
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    const bool more = step + 1 < n_steps;
    if (more) {
      const int k0 = (step + 1) * BK + kc;
      if (VEC) {
        tap_c += BK;
        while (tap_c >= g.Ci) {
          tap_c -= g.Ci;
          if (++tap_s == g.KW) { tap_s = 0; ++tap_r; }
        }
      }
      ra = load_a<VEC>(g, xrow, row_ok, ih0, iw0, k0, tap_r, tap_s, tap_c);
      rb = load_b<VEC>(g, co_row, k0);
    }
    const uint8_t* sa = smem + (step & 1) * STAGE_BYTES;
    const uint8_t* sb = sa + BM * LDS;
    uint32_t bf[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* p = sb + (wn * 32 + j * 8 + grp) * LDS + tig * 4;
      bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* p = sa + (wm * 32 + i * 16 + grp) * LDS + tig * 4;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(p + 16);
      const uint32_t a3 =
          *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_s8(acc[i][j], a0, a1, a2, a3, bf[j][0], bf[j][1]);
    }
    if (more) {
      uint8_t* na = smem + ((step + 1) & 1) * STAGE_BYTES;
      uint8_t* nb = na + BM * LDS;
      *reinterpret_cast<uint4*>(na + lrow * LDS + kc) = ra;
      *reinterpret_cast<uint4*>(nb + lrow * LDS + kc) = rb;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r0 = m0 + wm * 32 + i * 16 + grp;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c0 = n0 + wn * 32 + j * 8 + tig * 2;
      store_one<OUT>(g, r0, c0, acc[i][j][0]);
      store_one<OUT>(g, r0, c0 + 1, acc[i][j][1]);
      store_one<OUT>(g, r0 + 8, c0, acc[i][j][2]);
      store_one<OUT>(g, r0 + 8, c0 + 1, acc[i][j][3]);
    }
  }
}

template <bool VEC, int OUT>
cudaError_t launch(const Geom& g, cudaStream_t stream) {
  const long long tiles_m = (g.M + BM - 1) / BM;
  const long long tiles = tiles_m * g.n_tiles_n;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  qconv_s8_kernel<VEC, OUT>
      <<<(unsigned)tiles, THREADS, 2 * STAGE_BYTES, stream>>>(g);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_kind(const Geom& g, int out_kind, cudaStream_t stream) {
  switch (out_kind) {
    case OUT_S8: return launch<VEC, OUT_S8>(g, stream);
    case OUT_BF16: return launch<VEC, OUT_BF16>(g, stream);
    case OUT_F32: return launch<VEC, OUT_F32>(g, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x s8 [B,H,W,Ci], w s8 [Co,KH,KW,Ci], scale/bias f32 [Co], out: row m of
// the [B*Ho*Wo] output pixels at out + m*out_stride + out_off (elements of
// out_kind: 0 s8, 1 bf16, 2 f32). PH/PW are the top/left pads (the bottom
// and right ones are implied by Ho/Wo). Ci % 16 == 0 takes 16-byte loads
// (x and w then 16-byte aligned); any other Ci the byte-wise gather.
// Returns the launch's cudaError_t (0 on success); launches on `stream`
// without synchronising.
extern "C" int k3_qconv_s8(const void* x, const void* w, const float* scale,
                           const float* bias, void* out, int B, int H, int W,
                           int Ci, int Co, int KH, int KW, int SH, int SW,
                           int PH, int PW, int Ho, int Wo, int out_stride,
                           int out_off, int out_kind, float inv_out,
                           void* stream) {
  const long long M = (long long)B * Ho * Wo;
  if (M <= 0 || Co <= 0) return 0;
  if (M > 0x7fffffffLL || (long long)KH * KW * Ci > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Geom g;
  g.x = static_cast<const int8_t*>(x);
  g.w = static_cast<const int8_t*>(w);
  g.scale = scale;
  g.bias = bias;
  g.out = out;
  g.H = H; g.W = W; g.Ci = Ci; g.Co = Co; g.KH = KH; g.KW = KW;
  g.SH = SH; g.SW = SW; g.PH = PH; g.PW = PW; g.Ho = Ho; g.Wo = Wo;
  g.K = KH * KW * Ci;
  g.M = (int)M;
  g.out_stride = out_stride;
  g.out_off = out_off;
  g.n_tiles_n = (Co + BN - 1) / BN;
  g.inv_out = inv_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return Ci % 16 == 0 ? launch_kind<true>(g, out_kind, s)
                      : launch_kind<false>(g, out_kind, s);
}
