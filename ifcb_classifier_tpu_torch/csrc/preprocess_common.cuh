// Shared by the preprocess kernels K1 (preprocess_gray.cu) and K2
// (preprocess_rgb.cu): the norm constants, exact division, the PIL-BILINEAR
// window geometry, cp.async helpers, the tap-table prologue kernel that
// builds each image's trimmed tap windows once per axis, and the host side
// of a resize kernel's launch: its occupancy, its cached launch shape and
// its launch as the taps kernel's programmatic dependent. See
// preprocess_gray.cu and preprocess_rgb.cu for the designs these serve.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kTapThreads = 256;  // threads per taps block

struct Norm {
    float mean[3];
    float std[3];
    float inv[3];  // correctly rounded 1/std
    int on;
    int uniform;   // the three channels share mean and std
};

__host__ __device__ __forceinline__ size_t align16(size_t x) {
    return (x + 15) & ~static_cast<size_t>(15);
}

// a / b correctly rounded, given inv = RN(1/b): q = RN(a*inv) is within an
// ulp, the remainder a - q*b is exact in one FMA, and one more FMA rounds
// q + rem*inv to RN(a/b) (Markstein). a, b finite and normal or zero.
__device__ __forceinline__ float div_rn(float a, float b, float inv) {
    const float q = a * inv;
    return fmaf(fmaf(-q, b, a), inv, q);
}

__device__ __forceinline__ int clamp_size(int v, int S) {
    return min(max(v, 0), S);
}

// An axis of true extent src resampled to r, and the untrimmed window
// [lo, hi] of its output index i (one index of margin at each end). The
// taps kernel and the resize kernel's canvas prefetch use the same float
// operations, so the trimmed taps always lie inside the window.
struct Axis {
    int src;
    float scale, fscale;
};

__device__ __forceinline__ Axis axis_of(int src, int r) {
    Axis a;
    a.src = src;
    a.scale = (float)src / (float)r;
    a.fscale = fmaxf(a.scale, 1.0f);
    return a;
}

struct Window {
    float center;
    int lo, hi;
};

__device__ __forceinline__ Window window(int i, const Axis& a) {
    Window win;
    win.center = ((float)i + 0.5f) * a.scale;
    win.lo = max((int)floorf(win.center - a.fscale - 0.5f) - 1, 0);
    win.hi = min((int)ceilf(win.center + a.fscale - 0.5f) + 1, a.src - 1);
    return win;
}

// Weight of canvas index j before the row is normalised. |d| >= fscale
// gives 1 - |d|/fscale <= 0, so no division is needed there; fscale = 1
// (upsampling) divides exactly by nothing.
__device__ __forceinline__ float tap_weight(int j, const Window& win,
                                            const Axis& a, float inv_f) {
    const float d = fabsf((float)j + 0.5f - win.center);
    if (!(d < a.fscale)) return 0.0f;
    const float q = a.fscale == 1.0f ? d : div_rn(d, a.fscale, inv_f);
    return fmaxf(0.0f, 1.0f - q);
}

// byte k of v as a float, exactly: 2^23 + byte, minus 2^23
__device__ __forceinline__ float byte_to_float(uint32_t v, int k) {
    return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540u | k))
           - 8388608.0f;
}

__device__ __forceinline__ float normalise(float v, const Norm& nm, int c) {
    return div_rn(v - nm.mean[c], nm.std[c], nm.inv[c]);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem));
}

template <int kBytes>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(gmem), "n"(kBytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 1. one thread per window (b, axis, i); g = (b*2 + axis)*r + i. With
//    kZero it also zeroes *counter, by which K2's resize kernel hands out
//    its work once this grid is done (K1 passes none).
template <bool kZero>
__global__ void __launch_bounds__(kTapThreads)
preprocess_gray_taps(const int32_t* __restrict__ sizes,
                     int2* __restrict__ lo_n, float* __restrict__ wt,
                     int B, int S, int r, int T, int* counter) {
    // the resize kernel may launch now; it waits for this grid's tables
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    if (kZero && blockIdx.x == 0 && threadIdx.x == 0) *counter = 0;
    const unsigned nwin = (unsigned)B * 2u * (unsigned)r;
    const unsigned g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= nwin) return;
    const unsigned ba = g / r;  // b*2 + axis
    const int i = (int)(g - ba * r);
    const Axis ax = axis_of(clamp_size(sizes[ba], S), r);
    const Window win = window(i, ax);
    const float inv_f = 1.0f / ax.fscale;
    const int n = min(max(win.hi - win.lo + 1, 0), T + 5);
    float sum = 0.0f;
    for (int k = 0; k < n; ++k) sum += tap_weight(win.lo + k, win, ax, inv_f);
    sum = fmaxf(sum, 1e-9f);
    const float inv_sum = 1.0f / sum;
    float* w = wt + (size_t)ba * T * r + i;  // tap k at w[k * r]
    int first = 0, kept = 0;
    for (int k = 0; k < n; ++k) {
        const float wk = tap_weight(win.lo + k, win, ax, inv_f);
        const float wn = wk > 0.0f ? div_rn(wk, sum, inv_sum) : 0.0f;
        if (wn != 0.0f) {  // the positive taps are contiguous
            if (kept == 0) first = win.lo + k;
            if (kept < T) w[(size_t)kept * r] = wn;
            ++kept;
        }
    }
    for (int k = kept; k < T; ++k) w[(size_t)k * r] = 0.0f;
    lo_n[g] = make_int2(first, min(kept, T));
}

// Canvas rows that kStep consecutive untrimmed windows span: from
// floor(c0 - f - 0.5) - 1 to ceil(c1 + f - 0.5) + 1 with
// c1 - c0 = (kStep-1)*scale, i.e. at most (kStep-1)*scale + 2*fscale + 5
// rows, plus one for the rounding of the centers.
int rows_capacity(int kStep, int S, int r) {
    const float smax = (float)S / (float)r;
    return (int)ceilf((float)(kStep - 1) * smax + 2.0f * fmaxf(smax, 1.0f))
           + 6;
}

template <bool kZero>
cudaError_t launch_taps(const int32_t* sizes, int2* lo_n, float* wt, int B,
                        int S, int r, int T, cudaStream_t stream,
                        int* counter) {
    const long long nwin = (long long)B * 2 * r;
    if (nwin >= (1LL << 31)) return cudaErrorInvalidValue;
    const long long blocks = (nwin + kTapThreads - 1) / kTapThreads;
    preprocess_gray_taps<kZero><<<(unsigned)blocks, kTapThreads, 0, stream>>>(
        sizes, lo_n, wt, B, S, r, T, counter);
    return cudaGetLastError();
}

// The SMs, and the blocks of `kernel` resident on one at `threads` threads
// and `smem` bytes of dynamic shared memory (which must fit one block).
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int dev, int threads, size_t smem,
                      int* sms, int* per_sm) {
    int optin = 0;
    cudaError_t e;
    if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
        != cudaSuccess) return e;
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    // the card's largest, so that no other cached shape of this kernel on
    // this device needs it set again
    if ((e = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin))
        != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                         threads, smem);
}

// one wave of persistent blocks, and no more blocks than work items
long long one_wave(int sms, int per_sm, long long items) {
    const long long wave = (long long)sms * max(per_sm, 1);
    return wave < items ? wave : items;
}

// make(dev, &shape) once per (device, S, r, T), then from a cache: one
// cache per instantiation, i.e. per kernel family and output type. A
// resize kernel's launch shape depends on those alone; its grid follows
// from B.
template <typename OutT, typename ShapeT, typename Make>
cudaError_t cached_shape(int S, int r, int T, ShapeT* sh, Make make) {
    static std::mutex mu;
    static std::map<std::tuple<int, int, int, int>, ShapeT> cache;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const auto key = std::make_tuple(dev, S, r, T);
    std::lock_guard<std::mutex> lock(mu);
    const auto it = cache.find(key);
    if (it != cache.end()) {
        *sh = it->second;
        return cudaSuccess;
    }
    e = make(dev, sh);
    if (e == cudaSuccess) cache.emplace(key, *sh);
    return e;
}

// A resize kernel as a programmatic dependent of the taps kernel before
// it on `stream`.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), long long grid,
                             int threads, size_t smem, cudaStream_t stream,
                             Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
