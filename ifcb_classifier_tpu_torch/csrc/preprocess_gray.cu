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
// Sizes outside [0, S] are outside the contract (the engine never sends
// them); the kernels clamp h and w to [0, S] so that such a size can never
// make them read or write outside their buffers.
//
// Weight formula (ops/preprocess.py:39-54): scale = src / r,
// fscale = max(scale, 1), center = (i + 0.5) * scale,
// w_j = max(0, 1 - |j + 0.5 - center| / fscale) for j < src, else 0, then
// each row divided by max(sum_j w_j, 1e-9).
//
// Bound on this card: bytes. At B=256, r=299 the kernel must write
// 256*299*299*3 outputs (137 MB in bf16, 275 MB in f32) and read the
// images' h*w canvas bytes (about 4 MB at S=128); the filter costs a few
// flops per output element, far below the card's rate. So the design is
// about the store stream, and about keeping the work per output byte small
// and its latency hidden. One call launches two kernels:
//
//   1. preprocess_gray_taps: one thread per (image, axis, output index)
//      builds that tap window once: the weights summed in index order over
//      the window with a +-1 index margin, each divided by the sum, then
//      the margin taps whose weight came out exactly 0 trimmed. The
//      positive taps of a window lie strictly within fscale of its center,
//      so at most T = 2*ceil(max(S/r, 1)) of them (2 at S <= 256, 8 at
//      S = 1024 for r = 299). Tables, in a scratch the caller allocates:
//      (lo, n) pairs int32 [B][2][r][2], weights f32 [B][2][T][r] (tap
//      major, so that both kernels touch them with coalesced accesses).
//   2. preprocess_gray_resize, launched as a programmatic dependent of the
//      taps (its blocks start and fetch their first canvas rows while the
//      taps finish, then wait for the tables). Persistent blocks (one wave
//      of them) each walk a contiguous range of work items (image, kStep
//      output rows), so a block meets few images and loads an image's
//      horizontal table into shared memory once. Per item:
//        a. the canvas rows its vertical windows touch, over the image's
//           true width rounded up to 16, and its vertical table are copied
//           into shared memory with cp.async (16 bytes for the canvas: the
//           caller guarantees S % 16 == 0 and a 16-byte aligned canvas,
//           true of every rung of the engine's ladder); the copy for item
//           k+1 is issued before item k's horizontal pass, so it lands
//           while that pass runs;
//        b. vertical pass from shared memory: tmp[t][x] = sum_k wv * row,
//           a warp per output row, 4 columns per lane;
//        c. horizontal pass + epilogue: a thread per output column j holds
//           the kStep rows' sums in registers (kStep independent FMA
//           chains), then /255, clip, norm, one rounding, the three
//           channels written into a shared staging buffer laid out at the
//           same offset modulo 16 as the item's span of `out`;
//        d. the span (kStep*r*3 contiguous elements) is written with
//           16-byte stores; scalar stores for its unaligned head and tail.
//      kStep = 16 rows at S <= 512, 8 at S = 1024, where the vertical pass
//      and its canvas rows take more shared memory per row.
// Divisions by a value that a whole window or the whole call shares (the
// window's fscale and sum, std) are a multiply by the correctly rounded
// reciprocal and one FMA correction (Markstein), which yields the
// correctly rounded quotient, so every value equals an IEEE division's.
// The sums run in the order of the reference's separable form (rows of the
// canvas first, then columns) with one FMA per tap.
// No tensor cores, TMA or wgmma: the work is a few taps per output, and the
// output store is what bounds it.
// Host side: the resize kernel's launch shape (shared memory, occupancy) is
// computed once per (device, dtype, S, r) and cached, so a call costs two
// launches and no other CUDA API calls.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "preprocess_common.cuh"

namespace {

constexpr int kMaxThreads = 512;  // threads per resize block, at most

// Byte offsets of the resize kernel's dynamic shared memory, the same on
// the host (to size it) and on the device. Sp = bytes of one staged canvas
// row: S rounded up to 16.
struct Smem {
    size_t stage, tmp, canvas, hw, hln, vw, vln, total;
};

__host__ __device__ __forceinline__ Smem smem_layout(int kStep, int Sp,
                                                     int r, int T,
                                                     int rows_cap,
                                                     int out_bytes) {
    Smem m;
    size_t o = 0;
    m.stage = o;  o = align16(o + (size_t)kStep * r * 3 * out_bytes + 16);
    m.tmp = o;    o = align16(o + (size_t)kStep * Sp * sizeof(float));
    m.canvas = o; o = align16(o + (size_t)rows_cap * Sp);
    m.hw = o;     o = align16(o + (size_t)T * r * sizeof(float));
    m.hln = o;    o = align16(o + (size_t)r * sizeof(int2));
    m.vw = o;     o = align16(o + (size_t)kStep * T * sizeof(float));
    m.vln = o;    o = align16(o + (size_t)kStep * sizeof(int2));
    m.total = o;
    return m;
}

// A work item of the resize kernel: kStep output rows from i0 of image b,
// and the canvas rows [ymin, ymin + nrows) that their vertical windows
// touch. Items are walked in order, so the image's geometry is computed
// when the image changes and not per item.
struct Item {
    int b, w, wpad;
    Axis v;
    int i0, rows, ymin, nrows;
};

__device__ __forceinline__ void set_image(Item& m, int b,
                                          const int32_t* sizes, int S,
                                          int r) {
    m.b = b;
    m.v = axis_of(clamp_size(sizes[2 * b], S), r);
    m.w = clamp_size(sizes[2 * b + 1], S);
    m.wpad = (m.w + 15) & ~15;
}

__device__ __forceinline__ void set_rows(Item& m, int i0, int kStep, int r,
                                         int rows_cap) {
    m.i0 = i0;
    m.rows = min(kStep, r - i0);
    m.ymin = window(i0, m.v).lo;
    m.nrows = max(0, min(window(i0 + m.rows - 1, m.v).hi - m.ymin + 1,
                         rows_cap));
}

// 2. persistent blocks over work items (image, kStep rows)
template <typename OutT, int kStep>
__global__ void __launch_bounds__(kMaxThreads)
preprocess_gray_resize(const uint8_t* __restrict__ canvas,
                       const int32_t* __restrict__ sizes,
                       const int2* __restrict__ lo_n,
                       const float* __restrict__ wt,
                       OutT* __restrict__ out, int B, int S, int r, int T,
                       int rows_cap, Norm nm) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Smem L = smem_layout(kStep, (S + 15) & ~15, r, T, rows_cap,
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

    // a. an item's canvas rows (true width rounded up to 16) and its
    //    vertical windows, into shared memory, asynchronously
    auto fetch_canvas = [&](const Item& m) {
        const uint8_t* src =
            canvas + (size_t)m.b * S * S + (size_t)m.ymin * S;
        const int cpr = m.wpad >> 4;
        for (int c = tid; c < m.nrows * cpr; c += nt) {
            const int y = c / cpr;
            const int x = (c - y * cpr) << 4;
            cp_async16(cs + y * m.wpad + x, src + (size_t)y * S + x);
        }
    };
    auto fetch_table = [&](const Item& m) {
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
    Item cur;
    set_image(cur, (int)(it0 / steps), sizes, S, r);
    set_rows(cur, (int)(it0 - (long long)cur.b * steps) * kStep, kStep, r,
             rows_cap);
    fetch_canvas(cur);
    // the tap tables come from the preceding kernel
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    fetch_table(cur);
    int table_b = -1;
    for (long long it = it0; it < it1; ++it) {
        // the image's horizontal windows, when the image changes (the
        // previous horizontal pass ended before the last barrier)
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

        // b. vertical pass: a warp per output row, 4 columns per lane
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

        Item nxt = cur;
        if (it + 1 < it1) {
            if (cur.i0 + kStep < r) {
                set_rows(nxt, cur.i0 + kStep, kStep, r, rows_cap);
            } else {
                set_image(nxt, cur.b + 1, sizes, S, r);
                set_rows(nxt, 0, kStep, r, rows_cap);
            }
            fetch_canvas(nxt);
            fetch_table(nxt);
        }

        // c. horizontal pass + epilogue into the staging buffer (rows past
        //    `rows` in an image's last item are computed on stale data and
        //    not kept)
        OutT* dst = out + ((size_t)cur.b * r + cur.i0) * r * 3;
        const int mis = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
        OutT* sp = stage + mis / (int)sizeof(OutT);
        for (int j = tid; j < r; j += nt) {
            const int2 ln = hln[j];
            const float* col = tmp + ln.x;
            float acc[kStep];
#pragma unroll
            for (int t = 0; t < kStep; ++t) acc[t] = 0.0f;
            for (int k = 0; k < ln.y; ++k) {
                const float wk = hw[k * r + j];
#pragma unroll
                for (int t = 0; t < kStep; ++t)
                    acc[t] = fmaf(wk, col[t * wpad + k], acc[t]);
            }
#pragma unroll
            for (int t = 0; t < kStep; ++t) {
                if (t < cur.rows) {
                    const float v =
                        fminf(fmaxf(acc[t] * (1.0f / 255.0f), 0.0f), 1.0f);
                    OutT* p = sp + (t * r + j) * 3;
                    if (nm.on) {
                        const float y0 = normalise(v, nm, 0);
                        put(p, y0);
                        put(p + 1, nm.uniform ? y0 : normalise(v, nm, 1));
                        put(p + 2, nm.uniform ? y0 : normalise(v, nm, 2));
                    } else {
                        put(p, v);
                        put(p + 1, v);
                        put(p + 2, v);
                    }
                }
            }
        }
        __syncthreads();  // the staged span is complete

        // d. the item's contiguous span of out: scalar head, 16-byte
        //    middle, scalar tail
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

// The resize kernel's launch shape: rows per item, dynamic shared memory
// per block, threads (one per output column, r rounded up to whole warps),
// the blocks that fit on one SM at once, and the SMs. It depends on the
// device, the output dtype, S, r and T only, so it is computed once per
// such key and cached; the grid follows from B.
struct Shape {
    int step, rows_cap, threads, per_sm, sms;
    size_t smem;
};

// one wave of blocks, and no more blocks than work items
long long grid_of(const Shape& sh, int B, int r) {
    return one_wave(sh.sms, sh.per_sm,
                    (long long)B * ((r + sh.step - 1) / sh.step));
}

template <typename OutT, int kStep>
cudaError_t resize_shape(int dev, int S, int r, int T, Shape* sh) {
    sh->step = kStep;
    sh->rows_cap = rows_capacity(kStep, S, r);
    sh->smem = smem_layout(kStep, (S + 15) & ~15, r, T, sh->rows_cap,
                           (int)sizeof(OutT)).total;
    sh->threads = min(kMaxThreads, max(64, (r + 31) / 32 * 32));
    return occupancy(preprocess_gray_resize<OutT, kStep>, dev, sh->threads,
                     sh->smem, &sh->sms, &sh->per_sm);
}

// 16 rows per item at S <= 512, 8 above
template <typename OutT>
cudaError_t shape_for(int S, int r, int T, Shape* sh) {
    return cached_shape<OutT>(S, r, T, sh, [&](int dev, Shape* out) {
        return S <= 512 ? resize_shape<OutT, 16>(dev, S, r, T, out)
                        : resize_shape<OutT, 8>(dev, S, r, T, out);
    });
}

template <typename OutT>
cudaError_t launch_resize(const uint8_t* canvas, const int32_t* sizes,
                          const int2* lo_n, const float* wt, void* out,
                          int B, int S, int r, int T, const Norm& nm,
                          cudaStream_t stream) {
    Shape sh;
    cudaError_t e = shape_for<OutT>(S, r, T, &sh);
    if (e != cudaSuccess) return e;
    OutT* o = reinterpret_cast<OutT*>(out);
    const long long grid = grid_of(sh, B, r);
    return sh.step == 16
        ? launch_dependent(preprocess_gray_resize<OutT, 16>, grid,
                           sh.threads, sh.smem, stream, canvas, sizes, lo_n,
                           wt, o, B, S, r, T, sh.rows_cap, nm)
        : launch_dependent(preprocess_gray_resize<OutT, 8>, grid,
                           sh.threads, sh.smem, stream, canvas, sizes, lo_n,
                           wt, o, B, S, r, T, sh.rows_cap, nm);
}

}  // namespace

extern "C" {

// Tap tables alone (K1's first kernel), for checks against their plain
// twin. sizes: int32 [B,2] (h, w); lo_n: int32 [B,2,r,2] (lo, n);
// wt: f32 [B,2,T,r]. Returns the cudaError_t of the launch (0 = ok).
int k1_tap_tables(const void* sizes, void* lo_n, void* wt, int B, int S,
                  int r, int T, void* stream) {
    return (int)launch_taps<false>(static_cast<const int32_t*>(sizes),
                                   static_cast<int2*>(lo_n),
                                   static_cast<float*>(wt), B, S, r, T,
                                   static_cast<cudaStream_t>(stream),
                                   nullptr);
}

// The resize kernel's launch shape for these arguments, for reports:
// shape = {dynamic shared memory per block (bytes), blocks resident per
// SM, grid, threads per block, output rows per item}. Returns a
// cudaError_t (0 = ok).
int k1_resize_shape(int B, int S, int r, int T, int out_bf16, int* shape) {
    Shape sh = {};
    cudaError_t e = out_bf16 ? shape_for<__nv_bfloat16>(S, r, T, &sh)
                             : shape_for<float>(S, r, T, &sh);
    if (e != cudaSuccess) return (int)e;
    shape[0] = (int)sh.smem;
    shape[1] = sh.per_sm;
    shape[2] = (int)grid_of(sh, B, r);
    shape[3] = sh.threads;
    shape[4] = sh.step;
    return 0;
}

// canvas: uint8 [B,S,S], S a multiple of 16, 16-byte aligned; sizes: int32
// [B,2] (h, w); out: [B,r,r,3] bf16 (out_bf16 != 0) or f32. mean/std: 3
// floats each, used when has_norm != 0.
// lo_n, wt: scratch for the tap tables, shaped as for k1_tap_tables, with
// T = 2*ceil(max(S/r, 1)) computed in float32. Launches both kernels on
// `stream` and returns the first cudaError_t (0 = ok).
int k1_preprocess_gray(const void* canvas, const void* sizes, void* out,
                       int B, int S, int r, int out_bf16, int has_norm,
                       const float* mean, const float* std, void* lo_n,
                       void* wt, int T, void* stream) {
    if (S % 16 != 0 || reinterpret_cast<uintptr_t>(canvas) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    Norm nm;
    nm.on = has_norm;
    for (int c = 0; c < 3; ++c) {
        nm.mean[c] = has_norm ? mean[c] : 0.0f;
        nm.std[c] = has_norm ? std[c] : 1.0f;
        nm.inv[c] = 1.0f / nm.std[c];
    }
    nm.uniform = nm.mean[1] == nm.mean[0] && nm.mean[2] == nm.mean[0]
                 && nm.std[1] == nm.std[0] && nm.std[2] == nm.std[0];
    const uint8_t* cv = static_cast<const uint8_t*>(canvas);
    const int32_t* sz = static_cast<const int32_t*>(sizes);
    int2* ln = static_cast<int2*>(lo_n);
    float* w = static_cast<float*>(wt);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = launch_taps<false>(sz, ln, w, B, S, r, T, st, nullptr);
    if (e != cudaSuccess) return (int)e;
    if (out_bf16)
        return (int)launch_resize<__nv_bfloat16>(cv, sz, ln, w, out, B, S, r,
                                                 T, nm, st);
    return (int)launch_resize<float>(cv, sz, ln, w, out, B, S, r, T, nm, st);
}

}  // extern "C"
