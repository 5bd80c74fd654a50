// K1: fused grayscale preprocess for the RUN engine, hand-written for Hopper.
//
// Replaces the TPU kernel tools/bench_pallas.py:31-80
// (preprocess_gray_pallas_factory -> preprocess_gray_pallas), and goes on
// to the end of the gray branch of ifcb_classifier_tpu/ops/preprocess.py
// (preprocess_batch, :87-125). Per image b with true extent (h, w) inside a
// uint8 canvas [S, S]:
//
//   x   = Wh @ canvas[b] @ Ww^T           PIL-BILINEAR triangle filter, the
//                                          weights built here from (h, w)
//   x   = clip(x * (1/255), 0, 1)
//   out = (x - mean[c]) / std[c]          for c in 0..2 (gray broadcast to
//                                          RGB; mean/std optional)
//
// stored once, in the output dtype (bf16 or f32), as NHWC [B, r, r, 3].
//
// Weight formula (ops/preprocess.py:39-54): scale = src / r,
// fscale = max(scale, 1), center = (i + 0.5) * scale,
// w_j = max(0, 1 - |j + 0.5 - center| / fscale) for j < src, else 0, then
// each row divided by max(sum_j w_j, 1e-9). Only the taps where w_j can be
// non-zero are visited: a window of at most 2*ceil(fscale) + 5 indices
// around center (one index of margin at each end; extra taps carry 0).
//
// Bound on this card: bytes. At B=256, r=299 the kernel must write
// 256*299*299*3 outputs (137 MB in bf16, 275 MB in f32) and read at most
// 256*S*S canvas bytes; the filter costs a few dozen flops per output
// element, far below the card's rate. Design: one block per (image, tile
// of kRows output rows), two passes through shared memory, the separable
// order of the reference (rows of the canvas first, then columns):
//   0. the block's kRows vertical tap windows and all r horizontal tap
//      windows are built once into shared memory (weights normalised);
//   1. vertical pass: tmp[t][x] = sum_y Wh[i0+t][y] * canvas[y][x] for the
//      image's true width, consecutive threads on consecutive x (coalesced
//      byte loads, each canvas row read by about one block);
//   2. horizontal pass + epilogue: one thread per output pixel, the taps
//      read from shared memory, /255, clip, norm, one rounding, three
//      stores of the broadcast channels.
// No tensor cores, TMA or wgmma: the work is a few taps per output, and the
// output store is what bounds it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;       // output rows per block
constexpr int kThreads = 256;  // threads per block

struct Norm {
    float mean[3];
    float std[3];
    int on;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// Tap window of output index i along an axis whose true extent is src.
// Writes the normalised weights to w[k * stride] for k < n and returns
// (lo, n) through the pointers.
__device__ __forceinline__ void tap_window(int i, int src, int r,
                                           int max_taps, float* w,
                                           int stride, int* lo_out,
                                           int* n_out) {
    const float fsrc = (float)src;
    const float scale = fsrc / (float)r;
    const float fscale = fmaxf(scale, 1.0f);
    const float center = ((float)i + 0.5f) * scale;
    int lo = (int)floorf(center - fscale - 0.5f) - 1;
    int hi = (int)ceilf(center + fscale - 0.5f) + 1;
    lo = max(lo, 0);
    hi = min(hi, src - 1);
    int n = min(max(hi - lo + 1, 0), max_taps);
    float sum = 0.0f;
    for (int k = 0; k < n; ++k) {
        float jj = (float)(lo + k);
        float wk = fmaxf(0.0f, 1.0f - fabsf(jj + 0.5f - center) / fscale);
        w[k * stride] = wk;
        sum += wk;
    }
    sum = fmaxf(sum, 1e-9f);
    for (int k = 0; k < n; ++k) w[k * stride] = w[k * stride] / sum;
    *lo_out = lo;
    *n_out = n;
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
preprocess_gray_kernel(const uint8_t* __restrict__ canvas,
                       const int32_t* __restrict__ sizes,
                       OutT* __restrict__ out, int S, int r, int max_taps,
                       Norm norm) {
    extern __shared__ float smem[];
    // layout: tmp[kRows][S] | vw[kRows][max_taps] | hw[max_taps][r]
    //         | vlo[kRows] vn[kRows] hlo[r] hn[r] (ints)
    float* tmp = smem;
    float* vw = tmp + kRows * S;
    float* hw = vw + kRows * max_taps;
    int* vlo = reinterpret_cast<int*>(hw + max_taps * r);
    int* vn = vlo + kRows;
    int* hlo = vn + kRows;
    int* hn = hlo + r;

    const int b = blockIdx.y;
    const int i0 = blockIdx.x * kRows;
    const int h = sizes[2 * b];
    const int w = sizes[2 * b + 1];
    const int rows = min(kRows, r - i0);

    // 0. tap windows: kRows vertical (row-major weights), r horizontal
    //    (tap-major weights, so pass 2 reads consecutive words)
    for (int t = threadIdx.x; t < kRows + r; t += blockDim.x) {
        if (t < kRows) {
            if (t < rows) {
                tap_window(i0 + t, h, r, max_taps, vw + t * max_taps, 1,
                           &vlo[t], &vn[t]);
            } else {
                vlo[t] = 0;
                vn[t] = 0;
            }
        } else {
            const int j = t - kRows;
            tap_window(j, w, r, max_taps, hw + j, r, &hlo[j], &hn[j]);
        }
    }
    __syncthreads();

    // 1. vertical pass over the true width
    const uint8_t* img = canvas + (size_t)b * S * S;
    for (int idx = threadIdx.x; idx < rows * w; idx += blockDim.x) {
        const int t = idx / w;
        const int x = idx - t * w;
        const float* wt = vw + t * max_taps;
        const uint8_t* col = img + (size_t)vlo[t] * S + x;
        float acc = 0.0f;
        for (int k = 0; k < vn[t]; ++k) acc += wt[k] * (float)col[(size_t)k * S];
        tmp[t * S + x] = acc;
    }
    __syncthreads();

    // 2. horizontal pass + epilogue, one thread per output pixel
    OutT* dst = out + ((size_t)b * r + i0) * r * 3;
    for (int idx = threadIdx.x; idx < rows * r; idx += blockDim.x) {
        const int t = idx / r;
        const int j = idx - t * r;
        const float* row = tmp + t * S + hlo[j];
        float acc = 0.0f;
        for (int k = 0; k < hn[j]; ++k) acc += hw[k * r + j] * row[k];
        float v = acc * (1.0f / 255.0f);
        v = fminf(fmaxf(v, 0.0f), 1.0f);
        OutT* p = dst + (size_t)idx * 3;
        if (norm.on) {
#pragma unroll
            for (int c = 0; c < 3; ++c) store(p + c, (v - norm.mean[c]) / norm.std[c]);
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) store(p + c, v);
        }
    }
}

template <typename OutT>
cudaError_t launch(const uint8_t* canvas, const int32_t* sizes, void* out,
                   int B, int S, int r, const Norm& norm,
                   cudaStream_t stream) {
    const float ratio = (float)S / (float)r;
    const int max_taps = 2 * (int)ceilf(fmaxf(ratio, 1.0f)) + 5;
    const size_t smem = sizeof(float) * ((size_t)kRows * S
                                         + (size_t)kRows * max_taps
                                         + (size_t)max_taps * r)
                        + sizeof(int) * (2 * (size_t)kRows + 2 * (size_t)r);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            preprocess_gray_kernel<OutT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    dim3 grid((r + kRows - 1) / kRows, B);
    preprocess_gray_kernel<OutT><<<grid, kThreads, smem, stream>>>(
        canvas, sizes, reinterpret_cast<OutT*>(out), S, r, max_taps, norm);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// canvas: uint8 [B,S,S]; sizes: int32 [B,2] (h, w); out: [B,r,r,3] bf16
// (out_bf16 != 0) or f32. mean/std: 3 floats each, used when has_norm != 0.
// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
int k1_preprocess_gray(const void* canvas, const void* sizes, void* out,
                       int B, int S, int r, int out_bf16, int has_norm,
                       const float* mean, const float* std, void* stream) {
    Norm norm;
    norm.on = has_norm;
    for (int c = 0; c < 3; ++c) {
        norm.mean[c] = has_norm ? mean[c] : 0.0f;
        norm.std[c] = has_norm ? std[c] : 1.0f;
    }
    const uint8_t* cv = static_cast<const uint8_t*>(canvas);
    const int32_t* sz = static_cast<const int32_t*>(sizes);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (out_bf16)
        return (int)launch<__nv_bfloat16>(cv, sz, out, B, S, r, norm, st);
    return (int)launch<float>(cv, sz, out, B, S, r, norm, st);
}

}  // extern "C"
