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
// Bound on this card: bytes. Each image's true h*w*3 canvas bytes are read
// once and the [B, r, r, 3] output is written once (68.7 MB in bf16 at
// B=128, r=299); the filter costs a few flops per output. TRAIN's batches
// land on the 512 and 1024 rungs (the rung follows the batch's largest
// image) while most of their images are under 100 px, so there the bound
// is almost all output.
//
// It replaces a design that walked (image, 4..16 output rows) items over
// the whole canvas width: shared memory sized by 3*S bytes a row (4 rows
// an item and 142 KB a block at S = 1024), 3 x 16 sums a thread (128
// registers), one block an SM, static ranges of items. One call still
// launches two kernels: the tap-table prologue shared with K1
// (preprocess_common.cuh: each image's trimmed windows, once per axis),
// then this resize kernel as its programmatic dependent, now built around
// output tiles so that shared memory follows what a tile reads:
//
//   * A tile is (image, 16 output rows, J output columns). J comes from a
//     plan per (S, r, output type) (k2_plan below): whole or half rows
//     where they leave room for three blocks an SM (S <= 256 in bf16),
//     else the widest balanced width ceil(r/n) that leaves room for two
//     (150 columns at S = 512, 60 at 1024). A tile's canvas window is at
//     most rows_capacity(16) rows by 3*rows_capacity(J) + 30 bytes
//     (16-byte aligned at both ends), and `tmp` holds 16 f32 row sums for
//     each of its bytes: 59-111 KB a block in bf16. An image whose whole
//     row fits the window (up to 277 px wide at S = 512, 229 at 1024) is
//     one tile wide.
//   * 80 registers a thread (ptxas; 16 live sums in the horizontal pass),
//     so the registers allow 768 threads an SM: three blocks of 256
//     threads where the plan's shared memory leaves room for three (S <=
//     256 in bf16), else two of 384.
//   * Work is handed out in units (image, row step), row step by row step
//     across the batch, so a large image's units spread over the call. A
//     block's first two units are fixed (blockIdx.x, then one grid
//     further); each later one comes from a counter, one unit ahead, so
//     that blocks stay busy whatever mix of image sizes a batch holds. The
//     taps kernel zeroes the counter (it lives after the tap weights in
//     the scratch), and the resize kernel asks it only after waiting for
//     that grid, so a call is still two kernels. (k2_in_turns.py
//     --options times it against equal static ranges of units, slower
//     where image sizes vary, and against a counter zeroed by a memset
//     of its own, a third device operation a call.)
//   * A tile's window rows and its taps (16 rows of vertical taps, its
//     columns' horizontal taps, only as many taps as the image's scale
//     needs) come by cp.async one tile ahead: issued after the barrier
//     that starts tile k with two canvas buffers, after its vertical pass
//     with one. Canvas rows in shared memory are padded so that the 16
//     rows the vertical pass reads at once spread over the banks.
//   * Vertical pass (channel-blind over the window's interleaved bytes): a
//     thread per (output row, 4 bytes), rows fastest; each byte's 16 row
//     sums are stored together in tmp (20 floats apart, conflict-free).
//   * Horizontal pass: a thread per (output column, channel) reads a tap's
//     16 rows with 16-byte loads and keeps 16 FMA chains; then /255, clip,
//     norm and one rounding. A whole-row plan (S <= 128 in bf16) stages
//     the tile's 16 rows, one contiguous span of `out`, at the span's
//     offset modulo 16 and stores it with 16-byte stores (scalar head and
//     tail).
//     A narrower tile stores from registers: a warp's threads hold
//     neighbouring (column, channel) pairs, so each store instruction
//     writes one contiguous run of a row. (Staging narrower tiles too, in
//     chunks of the tile's width, was slower when tried.)
//   * Flips are a permutation of the stores: a row-flipped tile writes its
//     rows bottom-up into the mirrored rows, a column-flipped one its
//     columns reversed into the mirrored columns. Nothing is re-read.
//
// Exactness: each output's taps are summed with one fmaf per tap in tap
// order, vertical pass first, and the epilogue is clip(x * (1/255)) then
// div_rn, as in the canvas-wide design, so the f32 output is bitwise that
// design's: tiling changes which thread sums an output, not the order of
// its sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "preprocess_common.cuh"

namespace {

constexpr int kRows = 16;            // output rows per tile
constexpr int kTmpStride = 20;       // floats per window byte in tmp
constexpr int kK2SmThreads = 768;    // resize threads an SM holds (24 warps)
constexpr int kK2RegBlocks = 3;      // blocks of 256 its registers allow
constexpr int kK2MinBlocks = 2;      // blocks per SM the plan leaves room for
constexpr int kSmemPerSm = 233472;   // shared memory per SM (H100: 228 KB)
constexpr int kSmemReserved = 1024;  // taken by the runtime per block

// Bytes between two staged canvas rows: the window's bytes, plus 16 when
// that would put every row on the same four banks (the vertical pass
// reads 16 rows at one column at once).
__host__ __device__ __forceinline__ int canvas_pitch(int wb) {
    return ((wb >> 4) & 1) ? wb : wb + 16;
}

// Byte offsets of the resize kernel's dynamic shared memory, the same on
// the host (to size it) and on the device: the staging buffer (a whole-row
// plan's 16 rows, one contiguous span of `out`), tmp, the canvas buffers,
// two slots of tables, the units handed to the block. A slot's horizontal
// weights hold T taps of the plan's tile width, or the two taps a column
// of an upscaled image has across a whole row.
struct K2Layout {
    size_t stage, tmp, canvas, tables, slot, hw, hln, vw, vln, unit, total;
    int hw_cap;  // floats of horizontal weights a slot holds
};

__host__ __device__ __forceinline__ K2Layout k2_layout(int r, int T,
                                                       int cols, int nbuf,
                                                       int rows_cap,
                                                       int wb_cap, int ob) {
    K2Layout m;
    m.hw_cap = max(T * cols, 2 * r);
    size_t o = 0;
    m.stage = o;
    if (cols == r) o = align16(o + (size_t)kRows * r * 3 * ob + 16);
    m.tmp = o;
    o = align16(o + (size_t)wb_cap * kTmpStride * sizeof(float));
    m.canvas = o;
    o = align16(o + (size_t)nbuf * rows_cap * canvas_pitch(wb_cap));
    size_t s = 0;
    m.hw = s;  s = align16(s + (size_t)m.hw_cap * sizeof(float));
    m.hln = s; s = align16(s + (size_t)r * sizeof(int2));
    m.vw = s;  s = align16(s + (size_t)T * kRows * sizeof(float));
    m.vln = s; s = align16(s + (size_t)kRows * sizeof(int2));
    m.slot = s;
    m.tables = o;
    m.unit = o + 2 * s;
    m.total = m.unit + 16;
    return m;
}

// A tile: output rows [i0, i0 + rows) and columns [j0, j0 + cols) of image
// b; the canvas rows [ymin, ymin + nrows) and bytes [xb0, xb0 + wb) of a
// row that its untrimmed windows touch; the image's flips and its taps per
// output index at most (tv, th: 2*ceil(fscale) of each axis). An image
// whose whole row fits the window (and its weights a table slot) is one
// tile wide. A block walks the column tiles of each unit (image, row step)
// it is given in order; an image's axes are computed when a unit starts.
struct Tile {
    int b, rs, ct;
    Axis v, h;
    int fx, fy, tv, th, whole;
    int i0, rows, j0, cols, ymin, nrows, xb0, wb;
};

__device__ __forceinline__ void set_image(Tile& t, int b,
                                          const int32_t* sizes,
                                          const uint8_t* flips, int S, int r,
                                          int cols, int wb_cap, int hw_cap) {
    t.b = b;
    t.v = axis_of(clamp_size(sizes[2 * b], S), r);
    t.h = axis_of(clamp_size(sizes[2 * b + 1], S), r);
    t.fx = flips != nullptr && flips[2 * b] != 0;
    t.fy = flips != nullptr && flips[2 * b + 1] != 0;
    t.tv = 2 * (int)ceilf(t.v.fscale);
    t.th = 2 * (int)ceilf(t.h.fscale);
    t.whole = cols == r || (((3 * t.h.src + 15) & ~15) <= wb_cap
                            && t.th * r <= hw_cap);
}

__device__ __forceinline__ void set_window(Tile& t, int r, int cols,
                                           int rows_cap, int wb_cap) {
    t.i0 = t.rs * kRows;
    t.rows = min(kRows, r - t.i0);
    t.ymin = window(t.i0, t.v).lo;
    t.nrows = max(0, min(window(t.i0 + t.rows - 1, t.v).hi - t.ymin + 1,
                         rows_cap));
    t.j0 = t.whole ? 0 : t.ct * cols;
    t.cols = t.whole ? r : min(cols, r - t.j0);
    const int c0 = window(t.j0, t.h).lo;
    const int c1 = window(t.j0 + t.cols - 1, t.h).hi;
    t.xb0 = (3 * c0) & ~15;
    t.wb = c1 < c0 ? 0 : min(((3 * (c1 + 1) + 15) & ~15) - t.xb0, wb_cap);
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_group0() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows i < nr of a thread's sums: /255, clip, the norm, one rounding,
// stored at p + i * step
template <bool kNorm, typename OutT>
__device__ __forceinline__ void store_rows(OutT* p, int step,
                                           const float* acc, int nr,
                                           float mean, float sd, float inv) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        if (i < nr) {
            const float v = fminf(fmaxf(acc[i] * (1.0f / 255.0f), 0.0f),
                                  1.0f);
            put(p + i * step, kNorm ? div_rn(v - mean, sd, inv) : v);
        }
    }
}

// Horizontal pass + epilogue of one tile: a thread per (output column,
// channel) sums the tile's 16 rows (tmp holds each window byte's 16 row
// values together, so a tap is four 16-byte loads), then /255, clip,
// norm, one rounding. Output row ts of the tile in memory order starts at
// base + ts * 3r: the staging buffer for a whole-row tile, else the tile's
// place in `out`, where a warp's threads (neighbouring column, channel
// pairs) write one contiguous run of a row per store. A flipped tile
// writes its rows bottom-up and each row from its end.
template <typename OutT>
__device__ __forceinline__ void horizontal(
    const Tile& t, const float* tmp, const float* hw, const int2* hln,
    OutT* base, int r, const Norm& nm, int tid, int nt) {
    for (int e = tid; e < 3 * t.cols; e += nt) {
        const int jj = e / 3, c = e - 3 * jj;
        const int2 ln = hln[jj];
        const float* px = tmp + (3 * ln.x - t.xb0 + c) * kTmpStride;
        float acc[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
        for (int k = 0; k < ln.y; ++k) {
            const float wk = hw[k * t.cols + jj];
            const float* q = px + 3 * k * kTmpStride;
#pragma unroll
            for (int i = 0; i < kRows; i += 4) {
                const float4 v = *reinterpret_cast<const float4*>(q + i);
                acc[i] = fmaf(wk, v.x, acc[i]);
                acc[i + 1] = fmaf(wk, v.y, acc[i + 1]);
                acc[i + 2] = fmaf(wk, v.z, acc[i + 2]);
                acc[i + 3] = fmaf(wk, v.w, acc[i + 3]);
            }
        }
        const float mean = c == 0 ? nm.mean[0]
                         : c == 1 ? nm.mean[1] : nm.mean[2];
        const float sd = c == 0 ? nm.std[0] : c == 1 ? nm.std[1]
                                                     : nm.std[2];
        const float inv = c == 0 ? nm.inv[0] : c == 1 ? nm.inv[1]
                                                      : nm.inv[2];
        const int pitch = 3 * r;
        OutT* p = base + (size_t)(t.fx ? t.rows - 1 : 0) * pitch
                  + (t.fy ? t.cols - 1 - jj : jj) * 3 + c;
        const int step = t.fx ? -pitch : pitch;
        // every row step but an image's last has all 16 rows
        if (t.rows == kRows) {
            if (nm.on) store_rows<true>(p, step, acc, kRows, mean, sd, inv);
            else store_rows<false>(p, step, acc, kRows, mean, sd, inv);
        } else {
            if (nm.on) store_rows<true>(p, step, acc, t.rows, mean, sd, inv);
            else store_rows<false>(p, step, acc, t.rows, mean, sd, inv);
        }
    }
}

// dst[0, n) = sp[0, n) by the block; sp sits at dst's offset modulo 16,
// so the middle goes in 16-byte pieces
template <typename OutT>
__device__ __forceinline__ void store_span(OutT* dst, const OutT* sp,
                                           int n, int tid, int nt) {
    constexpr int kVec = 16 / (int)sizeof(OutT);
    const int mis = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
    const int head = min(n, ((16 - mis) & 15) / (int)sizeof(OutT));
    const int nvec = (n - head) / kVec;
    for (int e = tid; e < head; e += nt) dst[e] = sp[e];
    const uint4* sv = reinterpret_cast<const uint4*>(sp + head);
    uint4* gv = reinterpret_cast<uint4*>(dst + head);
    for (int v = tid; v < nvec; v += nt) gv[v] = sv[v];
    for (int e = head + nvec * kVec + tid; e < n; e += nt) dst[e] = sp[e];
}

template <typename OutT>
__global__ void __launch_bounds__(kK2SmThreads / kK2MinBlocks,
                                   kK2MinBlocks)
preprocess_rgb_resize(const uint8_t* __restrict__ canvas,
                      const int32_t* __restrict__ sizes,
                      const uint8_t* __restrict__ flips,
                      const int2* __restrict__ lo_n,
                      const float* __restrict__ wt,
                      int* __restrict__ work,
                      OutT* __restrict__ out, int B, int S, int r, int T,
                      int cols, int nbuf, int rows_cap, int wb_cap,
                      Norm nm) {
    extern __shared__ __align__(16) unsigned char smem[];
    const K2Layout L = k2_layout(r, T, cols, nbuf, rows_cap, wb_cap,
                                 (int)sizeof(OutT));
    OutT* stage = reinterpret_cast<OutT*>(smem + L.stage);
    float* tmp = reinterpret_cast<float*>(smem + L.tmp);
    const int tid = threadIdx.x, nt = blockDim.x;
    const int row_bytes = 3 * S;  // S % 16 == 0, checked by the caller
    const int steps = (r + kRows - 1) / kRows;
    const int ncol = (r + cols - 1) / cols;
    const int units = B * steps;  // < 2^31, checked by the caller
    int* s_unit = reinterpret_cast<int*>(smem + L.unit);

    auto canvas_buf = [&](int q) {
        return smem + L.canvas + (size_t)(nbuf == 2 ? q : 0) * rows_cap
               * canvas_pitch(wb_cap);
    };
    auto fetch_canvas = [&](const Tile& t, int q) {
        // the window's rows, 16 bytes a copy
        uint8_t* cs = canvas_buf(q);
        const int cpr = t.wb >> 4;
        if (cpr > 0) {
            const int cp = canvas_pitch(t.wb);
            const uint8_t* src = canvas + ((size_t)t.b * S + t.ymin)
                                 * row_bytes + t.xb0;
            const int dy = nt / cpr, dx = nt - dy * cpr;
            int y = tid / cpr, x = tid - y * cpr;
            for (; y < t.nrows; y += dy) {
                cp_async16(cs + y * cp + (x << 4),
                           src + (size_t)y * row_bytes + (x << 4));
                x += dx;
                if (x >= cpr) { x -= cpr; ++y; }
            }
        }
    };
    auto fetch_tables = [&](const Tile& t, int q) {
        // the tile's taps: rows' [tv][kRows], columns' [th][cols]
        unsigned char* base = smem + L.tables + (size_t)q * L.slot;
        float* hw = reinterpret_cast<float*>(base + L.hw);
        int2* hln = reinterpret_cast<int2*>(base + L.hln);
        float* vw = reinterpret_cast<float*>(base + L.vw);
        int2* vln = reinterpret_cast<int2*>(base + L.vln);
        const float* wv = wt + (size_t)(2 * t.b) * T * r + t.i0;
        for (int e = tid; e < t.tv * kRows; e += nt) {
            const int k = e >> 4, u = e & (kRows - 1);
            if (u < t.rows)
                cp_async_small<4>(vw + e, wv + (size_t)k * r + u);
        }
        const int2* lv = lo_n + (size_t)(2 * t.b) * r + t.i0;
        if (tid < t.rows) cp_async_small<8>(vln + tid, lv + tid);
        const float* wh = wt + (size_t)(2 * t.b + 1) * T * r + t.j0;
        for (int k = 0; k < t.th; ++k)
            for (int jj = tid; jj < t.cols; jj += nt)
                cp_async_small<4>(hw + k * t.cols + jj,
                                  wh + (size_t)k * r + jj);
        const int2* lh = lo_n + (size_t)(2 * t.b + 1) * r + t.j0;
        for (int jj = tid; jj < t.cols; jj += nt)
            cp_async_small<8>(hln + jj, lh + jj);
    };
    auto fetch = [&](const Tile& t, int q) {
        fetch_canvas(t, q);
        fetch_tables(t, q);
        cp_async_commit();
    };
    // the first tile of unit u: row step u / B of image u % B (every
    // image's first row step, then every image's second, ...)
    auto start_unit = [&](Tile& t, int u) {
        const int rs = u / B;
        set_image(t, u - rs * B, sizes, flips, S, r, cols, wb_cap, L.hw_cap);
        t.rs = rs;
        t.ct = 0;
        set_window(t, r, cols, rows_cap, wb_cap);
    };

    // A block's first two units are its own (blockIdx.x, then one grid
    // further); the rest come in order from a counter that the taps kernel
    // zeroes, asked only after griddepcontrol.wait, so that the blocks
    // stay busy whatever the images' sizes. A block holds the unit it
    // works on and the one after; thread 0 asks for the next during each
    // unit's first tile, and the answer is read once the block reaches
    // that unit.
    if ((int)blockIdx.x >= units) return;  // the grid is at most units
    Tile cur;
    start_unit(cur, blockIdx.x);
    int nu = blockIdx.x + gridDim.x;
    fetch_canvas(cur, 0);
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    fetch_tables(cur, 0);
    cp_async_commit();
    for (int q = 0, first = 1;; q ^= 1, first = 0) {
        cp_async_wait_group0();
        __syncthreads();  // tile in; the last tile's tmp and tables free
        if (cur.ct == 0 && !first) nu = s_unit[0];
        Tile nxt = cur;
        bool more = true;
        if (!cur.whole && cur.ct + 1 < ncol) {
            ++nxt.ct;
            set_window(nxt, r, cols, rows_cap, wb_cap);
        } else if (nu < units) {
            start_unit(nxt, nu);
        } else {
            more = false;
        }
        if (nbuf == 2 && more) fetch(nxt, q ^ 1);

        const unsigned char* base = smem + L.tables + (size_t)q * L.slot;
        const float* hw = reinterpret_cast<const float*>(base + L.hw);
        const int2* hln = reinterpret_cast<const int2*>(base + L.hln);
        const float* vw = reinterpret_cast<const float*>(base + L.vw);
        const int2* vln = reinterpret_cast<const int2*>(base + L.vln);
        const uint8_t* cs = canvas_buf(q);
        const int cp = canvas_pitch(cur.wb);

        // vertical pass over the window's interleaved bytes: a thread per
        // (output row, 4 bytes), rows fastest, each byte's 16 row values
        // stored together in tmp
        for (int u = tid; u < (cur.wb >> 2) * kRows; u += nt) {
            const int t = u & (kRows - 1);
            const int x = (u >> 4) << 2;
            if (t >= cur.rows) continue;
            const int lo = vln[t].x - cur.ymin;
            const int n = min(vln[t].y, cur.nrows - lo);
            const uint8_t* col = cs + lo * cp + x;
            float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
            for (int k = 0; k < n; ++k) {
                const uint32_t v =
                    *reinterpret_cast<const uint32_t*>(col + k * cp);
                const float c = vw[k * kRows + t];
                a0 = fmaf(c, byte_to_float(v, 0), a0);
                a1 = fmaf(c, byte_to_float(v, 1), a1);
                a2 = fmaf(c, byte_to_float(v, 2), a2);
                a3 = fmaf(c, byte_to_float(v, 3), a3);
            }
            float* o = tmp + x * kTmpStride + t;
            o[0] = a0;
            o[kTmpStride] = a1;
            o[2 * kTmpStride] = a2;
            o[3 * kTmpStride] = a3;
        }
        __syncthreads();  // tmp ready; the canvas buffer free
        if (nbuf == 1 && more) fetch(nxt, q ^ 1);
        const bool ask = tid == 0 && cur.ct == 0;
        int asked = 0;
        if (ask) asked = 2 * (int)gridDim.x + atomicAdd(work, 1);

        // a whole-row plan stages the tile, which is one contiguous span
        // of `out` (16-byte stores); a narrower tile stores straight
        OutT* dst = out + (((size_t)cur.b * r
                            + (cur.fx ? r - cur.i0 - cur.rows : cur.i0)) * r
                           + (cur.fy ? r - cur.j0 - cur.cols : cur.j0)) * 3;
        OutT* sp = stage + (int)(reinterpret_cast<uintptr_t>(dst) & 15)
                           / (int)sizeof(OutT);
        // (one call site per destination, so that the stores are known to
        // be shared or global)
        if (cols == r) {
            horizontal(cur, tmp, hw, hln, sp, r, nm, tid, nt);
            __syncthreads();  // the tile is staged
            store_span(dst, sp, cur.rows * r * 3, tid, nt);
        } else {
            horizontal(cur, tmp, hw, hln, dst, r, nm, tid, nt);
        }
        if (ask) s_unit[0] = asked;  // read after the next barrier
        if (!more) break;
        cur = nxt;
    }
}

// The resize kernel's launch shape: the tile's columns, the canvas
// buffers, the window's rows and bytes, dynamic shared memory per block,
// threads, the blocks resident per SM and the SMs.
struct K2Shape {
    int cols, nbuf, rows_cap, wb_cap, threads, per_sm, sms;
    size_t smem;
};

// bytes of a window row that J consecutive untrimmed column windows span:
// 3 bytes a column, 16-byte aligned at both ends, never past a canvas row
int window_bytes(int cols, int S, int r) {
    const size_t wb = align16((size_t)3 * rows_capacity(cols, S, r) + 30);
    return (int)(wb < (size_t)3 * S ? wb : (size_t)3 * S);
}

size_t k2_smem(int S, int r, int T, int cols, int nbuf, int ob) {
    return k2_layout(r, T, cols, nbuf, rows_capacity(kRows, S, r),
                     window_bytes(cols, S, r), ob).total;
}

// The plan: a tile of whole or half rows if one leaves room for
// kK2RegBlocks blocks on an SM, else the widest balanced tile ceil(r/n)
// that leaves room for kK2MinBlocks (wide tiles stage fewer overlapping
// window columns and leave more images one tile wide); two canvas buffers
// if they fit as many blocks, else one; threads that fill the SM's
// kK2SmThreads with those blocks (256 a block with three, 384 with two).
void k2_plan(int S, int r, int T, int ob, K2Shape* sh) {
    int cols = 0, nbuf = 1, blocks = kK2MinBlocks;
    for (int pass = 0; cols == 0 && pass < 2; ++pass) {
        blocks = pass == 0 ? kK2RegBlocks : kK2MinBlocks;
        for (int n = 1, prev = 0; cols == 0 && n <= (pass == 0 ? 2 : r);
             ++n) {
            const int J = (r + n - 1) / n;
            if (J == prev) continue;
            prev = J;
            for (int nb = 2; nb >= 1 && cols == 0; --nb) {
                const size_t need = k2_smem(S, r, T, J, nb, ob);
                if (kSmemPerSm / (need + kSmemReserved) >= (size_t)blocks) {
                    cols = J;
                    nbuf = nb;
                }
            }
        }
    }
    sh->cols = cols > 0 ? cols : 1;  // else the narrowest, one buffer
    sh->nbuf = nbuf;
    sh->rows_cap = rows_capacity(kRows, S, r);
    sh->wb_cap = window_bytes(sh->cols, S, r);
    sh->smem = k2_layout(r, T, sh->cols, sh->nbuf, sh->rows_cap, sh->wb_cap,
                         ob).total;
    sh->threads = kK2SmThreads / blocks;
}

template <typename OutT>
cudaError_t rgb_shape_for(int S, int r, int T, K2Shape* sh) {
    return cached_shape<OutT>(S, r, T, sh, [&](int dev, K2Shape* out) {
        k2_plan(S, r, T, (int)sizeof(OutT), out);
        return occupancy(preprocess_rgb_resize<OutT>, dev, out->threads,
                         out->smem, &out->sms, &out->per_sm);
    });
}

// one wave of blocks, and no more blocks than units (image, row step)
long long rgb_grid(const K2Shape& sh, int B, int r) {
    return one_wave(sh.sms, sh.per_sm,
                    (long long)B * ((r + kRows - 1) / kRows));
}

template <typename OutT>
cudaError_t launch_rgb(const uint8_t* canvas, const int32_t* sizes,
                       const uint8_t* flips, const int2* lo_n,
                       const float* wt, int* work, void* out, int B, int S,
                       int r, int T, const Norm& nm, cudaStream_t stream) {
    K2Shape sh;
    cudaError_t e = rgb_shape_for<OutT>(S, r, T, &sh);
    if (e != cudaSuccess) return e;
    return launch_dependent(preprocess_rgb_resize<OutT>, rgb_grid(sh, B, r),
                            sh.threads, sh.smem, stream, canvas, sizes,
                            flips, lo_n, wt, work,
                            reinterpret_cast<OutT*>(out), B, S, r, T,
                            sh.cols, sh.nbuf, sh.rows_cap, sh.wb_cap, nm);
}

}  // namespace

extern "C" {

// The resize kernel's plan and launch shape, for reports: shape =
// {dynamic shared memory per block (bytes), blocks resident per SM, grid,
// threads per block, output rows per tile, output columns per tile,
// canvas buffers, window rows, window bytes per row}. Returns a
// cudaError_t (0 = ok).
int k2_resize_shape(int B, int S, int r, int T, int out_bf16, int* shape) {
    K2Shape sh = {};
    cudaError_t e = out_bf16 ? rgb_shape_for<__nv_bfloat16>(S, r, T, &sh)
                             : rgb_shape_for<float>(S, r, T, &sh);
    if (e != cudaSuccess) return (int)e;
    shape[0] = (int)sh.smem;
    shape[1] = sh.per_sm;
    shape[2] = (int)rgb_grid(sh, B, r);
    shape[3] = sh.threads;
    shape[4] = kRows;
    shape[5] = sh.cols;
    shape[6] = sh.nbuf;
    shape[7] = sh.rows_cap;
    shape[8] = sh.wb_cap;
    return 0;
}

// canvas: uint8 [B,S,S,3], S a multiple of 16, 16-byte aligned; sizes:
// int32 [B,2] (h, w); flips: uint8 [B,2] (rows, columns) or null; out:
// [B,r,r,3] bf16 (out_bf16 != 0) or f32. mean/std: 3 floats each, used
// when has_norm != 0. lo_n, wt: tap-table scratch as for K1
// (int32 [B,2,r,2] and f32 [B,2,T,r], T = 2*ceil(max(S/r, 1)) in float32),
// wt followed by 16 bytes more for the resize's work counter (zeroed by
// the taps kernel). Launches the taps and the resize kernel on `stream`
// and returns the first cudaError_t (0 = ok).
int k2_preprocess_rgb(const void* canvas, const void* sizes,
                      const void* flips, void* out, int B, int S, int r,
                      int out_bf16, int has_norm, const float* mean,
                      const float* std, void* lo_n, void* wt, int T,
                      void* stream) {
    if (S % 16 != 0 || reinterpret_cast<uintptr_t>(canvas) % 16 != 0
        || (long long)B * ((r + kRows - 1) / kRows) >= (1LL << 30))
        return (int)cudaErrorInvalidValue;  // the kernel counts units in int
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
    // the counter that hands out the resize's units, after the weights
    int* work = reinterpret_cast<int*>(w + (size_t)B * 2 * T * r);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = launch_taps<true>(sz, ln, w, B, S, r, T, st, work);
    if (e != cudaSuccess) return (int)e;
    if (out_bf16)
        return (int)launch_rgb<__nv_bfloat16>(cv, sz, fl, ln, w, work, out,
                                              B, S, r, T, nm, st);
    return (int)launch_rgb<float>(cv, sz, fl, ln, w, work, out, B, S, r, T,
                                  nm, st);
}

}  // extern "C"
