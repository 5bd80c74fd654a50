// K2: fused RGB preprocess with flips for TRAIN, hand-written for Hopper.
//
// Replaces the RGB branch of ifcb_classifier_tpu/ops/preprocess.py, which
// XLA fuses on the TPU (no pallas_call): resize_bilinear_matmul (:57-70),
// preprocess_batch's /255, clip and norm (:110-121) and _flip_batch
// (:73-84). Per image b with true extent (h, w) inside a uint8 canvas
// [S, S, 3] (channels interleaved, as decoded):
//
//   x[c]  = Wh @ canvas[b, :, :, c] @ Ww^T   PIL-BILINEAR triangle filter,
//                                             the weights built from (h, w)
//   x[c]  = clip(x[c] * (1/255), 0, 1)
//   out   = (x[c] - mean[c]) / std[c]        (mean/std optional)
//   out   = out[::-1, :] if flips[b, 0]      (--flip x: rows, the
//   out   = out[:, ::-1] if flips[b, 1]       reference's quirk: y = cols)
//
// stored once, in the output dtype (bf16 or f32), as NHWC [B, r, r, 3].
//
// Built from K1 (preprocess_gray.cu), whose design notes hold here too:
// the same tap-table prologue (preprocess_common.cuh: one thread per
// (image, axis, output index) builds the trimmed window once), the same
// exact divisions, so the weights equal the plain version's, and a
// resize kernel of persistent blocks over (image, kStep output rows)
// items with cp.async staging one item ahead and 16-byte output stores.
// What differs for three channels:
//   * the vertical pass is channel-blind: an interleaved canvas row of
//     width w is 3w bytes of which every byte is resampled alike, so it is
//     K1's vertical pass over rows of 3w bytes (rounded up to 16);
//   * the horizontal pass keeps 3 x kStep sums per thread (one output
//     column), reading the tap's three interleaved channels;
//   * each channel has its own mean and std: there is no broadcast store;
//   * flips are a permutation of the store: a flipped item's rows are
//     staged bottom-up into the image's mirrored span of rows, and a
//     flipped column j is staged at r-1-j, so the 16-byte span store is
//     unchanged;
//   * shared memory per row is three times K1's, so an item holds fewer
//     rows: kStep = 16 at S <= 256, 8 at S = 512, 4 at S = 1024 (about
//     150 KB per block at S = 1024 in f32, under the 227 KB limit).
// Bound on this card: bytes (each image's true h*w*3 canvas bytes read
// once, the [B, r, r, 3] output written once); a few flops per output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "preprocess_common.cuh"

namespace {

// kStep output rows from i0 of image b; the canvas rows [ymin, ymin +
// nrows) their vertical windows touch, each staged as wpad bytes (3w
// rounded up to 16); the image's flips.
struct RgbItem {
    int b, w, wpad, fx, fy;
    Axis v;
    int i0, rows, ymin, nrows;
};

__device__ __forceinline__ void set_rgb_image(RgbItem& m, int b,
                                              const int32_t* sizes,
                                              const uint8_t* flips, int S,
                                              int r) {
    m.b = b;
    m.v = axis_of(clamp_size(sizes[2 * b], S), r);
    m.w = clamp_size(sizes[2 * b + 1], S);
    m.wpad = (3 * m.w + 15) & ~15;
    m.fx = flips != nullptr && flips[2 * b] != 0;
    m.fy = flips != nullptr && flips[2 * b + 1] != 0;
}

__device__ __forceinline__ void set_rgb_rows(RgbItem& m, int i0, int kStep,
                                             int r, int rows_cap) {
    m.i0 = i0;
    m.rows = min(kStep, r - i0);
    m.ymin = window(i0, m.v).lo;
    m.nrows = max(0, min(window(i0 + m.rows - 1, m.v).hi - m.ymin + 1,
                         rows_cap));
}

template <typename OutT, int kStep>
__global__ void __launch_bounds__(kMaxThreads)
preprocess_rgb_resize(const uint8_t* __restrict__ canvas,
                      const int32_t* __restrict__ sizes,
                      const uint8_t* __restrict__ flips,
                      const int2* __restrict__ lo_n,
                      const float* __restrict__ wt,
                      OutT* __restrict__ out, int B, int S, int r, int T,
                      int rows_cap, Norm nm) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int row_bytes = 3 * S;  // S % 16 == 0, checked by the caller
    const Smem L = smem_layout(kStep, row_bytes, r, T, rows_cap,
                               (int)sizeof(OutT));
    OutT* stage = reinterpret_cast<OutT*>(smem + L.stage);
    float* tmp = reinterpret_cast<float*>(smem + L.tmp);
    uint8_t* cs = smem + L.canvas;
    float* hw = reinterpret_cast<float*>(smem + L.hw);   // [T][r]
    int2* hln = reinterpret_cast<int2*>(smem + L.hln);   // [r] (lo, n)
    float* vw = reinterpret_cast<float*>(smem + L.vw);   // [kStep][T]
    int2* vln = reinterpret_cast<int2*>(smem + L.vln);   // [kStep] (lo, n)

    const int tid = threadIdx.x, nt = blockDim.x;
    const int steps = (r + kStep - 1) / kStep;
    const long long items = (long long)B * steps;
    const long long it0 = items * blockIdx.x / gridDim.x;
    const long long it1 = items * (blockIdx.x + 1) / gridDim.x;

    auto fetch_canvas = [&](const RgbItem& m) {
        const uint8_t* src = canvas + (size_t)m.b * S * row_bytes
                             + (size_t)m.ymin * row_bytes;
        const int cpr = m.wpad >> 4;
        for (int c = tid; c < m.nrows * cpr; c += nt) {
            const int y = c / cpr;
            const int x = (c - y * cpr) << 4;
            cp_async16(cs + y * m.wpad + x, src + (size_t)y * row_bytes + x);
        }
    };
    auto fetch_table = [&](const RgbItem& m) {
        const float* wv = wt + (size_t)(2 * m.b) * T * r + m.i0;
        for (int e = tid; e < m.rows * T; e += nt) {
            const int k = e / m.rows, t = e - k * m.rows;
            cp_async_small<4>(vw + t * T + k, wv + (size_t)k * r + t);
        }
        const size_t vb = (size_t)(2 * m.b) * r + m.i0;
        for (int t = tid; t < m.rows; t += nt)
            cp_async_small<8>(vln + t, lo_n + vb + t);
    };

    if (it0 >= it1) return;
    RgbItem cur;
    set_rgb_image(cur, (int)(it0 / steps), sizes, flips, S, r);
    set_rgb_rows(cur, (int)(it0 - (long long)cur.b * steps) * kStep, kStep,
                 r, rows_cap);
    fetch_canvas(cur);
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    fetch_table(cur);
    int table_b = -1;
    for (long long it = it0; it < it1; ++it) {
        if (cur.b != table_b) {
            table_b = cur.b;
            const size_t hb = (size_t)(2 * cur.b + 1) * r;
            for (int j = tid; j < r; j += nt) {
                hln[j] = lo_n[hb + j];
                for (int k = 0; k < T; ++k)
                    hw[k * r + j] = wt[(hb * T) + (size_t)k * r + j];
            }
        }
        cp_async_wait_all();
        __syncthreads();  // tables and canvas rows in; the last span written

        // vertical pass over the interleaved bytes: a warp per output row
        const int wpad = cur.wpad;
        for (int t = tid >> 5; t < cur.rows; t += nt >> 5) {
            const int lo = vln[t].x - cur.ymin;
            const int n = min(vln[t].y, cur.nrows - lo);
            const float* wk = vw + t * T;
            for (int x = (tid & 31) << 2; x < wpad; x += 128) {
                const uint8_t* col = cs + lo * wpad + x;
                float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
                for (int k = 0; k < n; ++k) {
                    const uint32_t v =
                        *reinterpret_cast<const uint32_t*>(col + k * wpad);
                    const float c = wk[k];
                    a0 = fmaf(c, byte_to_float(v, 0), a0);
                    a1 = fmaf(c, byte_to_float(v, 1), a1);
                    a2 = fmaf(c, byte_to_float(v, 2), a2);
                    a3 = fmaf(c, byte_to_float(v, 3), a3);
                }
                *reinterpret_cast<float4*>(tmp + t * wpad + x) =
                    make_float4(a0, a1, a2, a3);
            }
        }
        __syncthreads();  // tmp ready; canvas rows and vertical table free

        RgbItem nxt = cur;
        if (it + 1 < it1) {
            if (cur.i0 + kStep < r) {
                set_rgb_rows(nxt, cur.i0 + kStep, kStep, r, rows_cap);
            } else {
                set_rgb_image(nxt, cur.b + 1, sizes, flips, S, r);
                set_rgb_rows(nxt, 0, kStep, r, rows_cap);
            }
            fetch_canvas(nxt);
            fetch_table(nxt);
        }

        // horizontal pass + epilogue into the staging buffer; a flipped
        // image's item fills the mirrored span of rows, bottom-up
        const int row0 = cur.fx ? r - cur.i0 - cur.rows : cur.i0;
        OutT* dst = out + ((size_t)cur.b * r + row0) * r * 3;
        const int mis = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
        OutT* sp = stage + mis / (int)sizeof(OutT);
        for (int j = tid; j < r; j += nt) {
            const int2 ln = hln[j];
            const float* col = tmp + 3 * ln.x;
            float acc[3][kStep];
#pragma unroll
            for (int t = 0; t < kStep; ++t)
                acc[0][t] = acc[1][t] = acc[2][t] = 0.0f;
            for (int k = 0; k < ln.y; ++k) {
                const float wk = hw[k * r + j];
#pragma unroll
                for (int t = 0; t < kStep; ++t) {
                    const float* px = col + t * wpad + 3 * k;
                    acc[0][t] = fmaf(wk, px[0], acc[0][t]);
                    acc[1][t] = fmaf(wk, px[1], acc[1][t]);
                    acc[2][t] = fmaf(wk, px[2], acc[2][t]);
                }
            }
            const int jj = cur.fy ? r - 1 - j : j;
#pragma unroll
            for (int t = 0; t < kStep; ++t) {
                if (t < cur.rows) {
                    const int ts = cur.fx ? cur.rows - 1 - t : t;
                    OutT* p = sp + (ts * r + jj) * 3;
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const float v = fminf(
                            fmaxf(acc[c][t] * (1.0f / 255.0f), 0.0f), 1.0f);
                        put(p + c, nm.on ? normalise(v, nm, c) : v);
                    }
                }
            }
        }
        __syncthreads();  // the staged span is complete

        // the item's contiguous span of out: scalar head, 16-byte middle,
        // scalar tail
        constexpr int kVec = 16 / (int)sizeof(OutT);
        const int n_el = cur.rows * r * 3;
        const int head = min(n_el, ((16 - mis) & 15) / (int)sizeof(OutT));
        const int nvec = (n_el - head) / kVec;
        for (int e = tid; e < head; e += nt) dst[e] = sp[e];
        const uint4* sv = reinterpret_cast<const uint4*>(sp + head);
        uint4* gv = reinterpret_cast<uint4*>(dst + head);
        for (int v = tid; v < nvec; v += nt) gv[v] = sv[v];
        for (int e = head + nvec * kVec + tid; e < n_el; e += nt)
            dst[e] = sp[e];
        cur = nxt;
    }
}

template <typename OutT, int kStep>
cudaError_t rgb_resize_shape(int dev, int S, int r, int T, Shape* sh) {
    sh->step = kStep;
    sh->rows_cap = rows_capacity(kStep, S, r);
    sh->smem = smem_layout(kStep, 3 * S, r, T, sh->rows_cap,
                           (int)sizeof(OutT)).total;
    return fill_shape(preprocess_rgb_resize<OutT, kStep>, dev, r, sh);
}

// rows per item: 16 at S <= 256, 8 at S <= 512, 4 above
template <typename OutT>
cudaError_t rgb_shape_for(int S, int r, int T, Shape* sh) {
    return cached_shape<OutT>(S, r, T, sh, [&](int dev, Shape* out) {
        return S <= 256 ? rgb_resize_shape<OutT, 16>(dev, S, r, T, out)
             : S <= 512 ? rgb_resize_shape<OutT, 8>(dev, S, r, T, out)
                        : rgb_resize_shape<OutT, 4>(dev, S, r, T, out);
    });
}

template <typename OutT>
cudaError_t launch_rgb(const uint8_t* canvas, const int32_t* sizes,
                       const uint8_t* flips, const int2* lo_n,
                       const float* wt, void* out, int B, int S, int r,
                       int T, const Norm& nm, cudaStream_t stream) {
    Shape sh;
    cudaError_t e = rgb_shape_for<OutT>(S, r, T, &sh);
    if (e != cudaSuccess) return e;
    OutT* o = reinterpret_cast<OutT*>(out);
    switch (sh.step) {
    case 16:
        return launch_dependent(preprocess_rgb_resize<OutT, 16>, sh, B, r,
                                stream, canvas, sizes, flips, lo_n, wt, o, B,
                                S, r, T, sh.rows_cap, nm);
    case 8:
        return launch_dependent(preprocess_rgb_resize<OutT, 8>, sh, B, r,
                                stream, canvas, sizes, flips, lo_n, wt, o, B,
                                S, r, T, sh.rows_cap, nm);
    default:
        return launch_dependent(preprocess_rgb_resize<OutT, 4>, sh, B, r,
                                stream, canvas, sizes, flips, lo_n, wt, o, B,
                                S, r, T, sh.rows_cap, nm);
    }
}

}  // namespace

extern "C" {

// The resize kernel's launch shape, for reports: shape = {dynamic shared
// memory per block (bytes), blocks resident per SM, grid, threads per
// block, output rows per item}. Returns a cudaError_t (0 = ok).
int k2_resize_shape(int B, int S, int r, int T, int out_bf16, int* shape) {
    Shape sh = {};
    cudaError_t e = out_bf16 ? rgb_shape_for<__nv_bfloat16>(S, r, T, &sh)
                             : rgb_shape_for<float>(S, r, T, &sh);
    if (e != cudaSuccess) return (int)e;
    shape[0] = (int)sh.smem;
    shape[1] = sh.per_sm;
    shape[2] = (int)grid_of(sh, B, r);
    shape[3] = sh.threads;
    shape[4] = sh.step;
    return 0;
}

// canvas: uint8 [B,S,S,3], S a multiple of 16, 16-byte aligned; sizes:
// int32 [B,2] (h, w); flips: uint8 [B,2] (rows, columns) or null; out:
// [B,r,r,3] bf16 (out_bf16 != 0) or f32. mean/std: 3 floats each, used
// when has_norm != 0. lo_n, wt: tap-table scratch as for K1
// (int32 [B,2,r,2] and f32 [B,2,T,r], T = 2*ceil(max(S/r, 1)) in float32).
// Launches the taps and the resize kernel on `stream` and returns the
// first cudaError_t (0 = ok).
int k2_preprocess_rgb(const void* canvas, const void* sizes,
                      const void* flips, void* out, int B, int S, int r,
                      int out_bf16, int has_norm, const float* mean,
                      const float* std, void* lo_n, void* wt, int T,
                      void* stream) {
    if (S % 16 != 0 || reinterpret_cast<uintptr_t>(canvas) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    Norm nm;
    nm.on = has_norm;
    for (int c = 0; c < 3; ++c) {
        nm.mean[c] = has_norm ? mean[c] : 0.0f;
        nm.std[c] = has_norm ? std[c] : 1.0f;
        nm.inv[c] = 1.0f / nm.std[c];
    }
    nm.uniform = 0;  // not read here: every channel is normalised alone
    const uint8_t* cv = static_cast<const uint8_t*>(canvas);
    const int32_t* sz = static_cast<const int32_t*>(sizes);
    const uint8_t* fl = static_cast<const uint8_t*>(flips);
    int2* ln = static_cast<int2*>(lo_n);
    float* w = static_cast<float*>(wt);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = launch_taps(sz, ln, w, B, S, r, T, st);
    if (e != cudaSuccess) return (int)e;
    if (out_bf16)
        return (int)launch_rgb<__nv_bfloat16>(cv, sz, fl, ln, w, out, B, S,
                                              r, T, nm, st);
    return (int)launch_rgb<float>(cv, sz, fl, ln, w, out, B, S, r, T, nm,
                                  st);
}

}  // extern "C"
