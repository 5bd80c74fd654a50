// Native ROI canvas packer — the deployment-inference hot loop.
//
// The input path is: raw .roi bytes -> packed uint8 canvas batch -> device.
// This file is the native middle step: gather N variable-size ROIs (byte
// offsets from the .adc table) from the .roi buffer into a zeroed [B,S,S]
// canvas, multithreaded, with no Python per-image overhead. At deployment
// scale (millions of ROIs per run) the Python slicing loop is measurable;
// this keeps the host side ahead of the device.
//
// Exposed as plain C symbols; loaded via ctypes (native/__init__.py).
// Build: g++ -O3 -shared -fPIC -o libroipack.so roipack.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Pack n ROIs into canvas[b, S, S] (pre-zeroed by caller or zeroed here).
// roi:     base of the .roi byte buffer (size roi_len)
// start/h/w: per-ROI byte offset and dims (int64, from the ADC table)
// canvas:  out, B*S*S uint8 (B >= n); rows beyond n left zero
// sizes:   out, B*2 int32 (h,w), clamped to S; pad rows get (1,1)
// Returns 0 on success, -1 if any ROI would read past roi_len (that ROI is
// skipped and its sizes row set to (0,0) so the caller can flag it).
int roipack_pack(const uint8_t* roi, int64_t roi_len,
                 const int64_t* start, const int64_t* hs, const int64_t* ws,
                 int32_t n, int32_t batch, int32_t S,
                 uint8_t* canvas, int32_t* sizes, int32_t nthreads) {
    std::memset(canvas, 0, (size_t)batch * S * S);
    for (int32_t b = 0; b < batch; b++) { sizes[2 * b] = 1; sizes[2 * b + 1] = 1; }

    std::atomic<int> bad{0};  // written from worker threads
    auto work = [&](int32_t lo, int32_t hi) {
        for (int32_t i = lo; i < hi; i++) {
            int64_t h = hs[i], w = ws[i], s0 = start[i];
            // overflow-safe range check: h*w can wrap int64 for corrupt
            // ADC dims (parsed float64->int64), which would bypass a
            // naive `s0 + h*w > roi_len` and memcpy out of bounds.
            // h > (roi_len - s0) / w  <=>  h*w > roi_len - s0, no overflow.
            if (h <= 0 || w <= 0 || s0 < 0 || s0 > roi_len ||
                h > (roi_len - s0) / w) {
                sizes[2 * i] = 0; sizes[2 * i + 1] = 0;
                bad.store(1, std::memory_order_relaxed); continue;
            }
            int64_t ch = std::min<int64_t>(h, S);
            int64_t cw = std::min<int64_t>(w, S);
            uint8_t* dst = canvas + (size_t)i * S * S;
            const uint8_t* src = roi + s0;
            for (int64_t r = 0; r < ch; r++)
                std::memcpy(dst + r * S, src + r * w, (size_t)cw);
            sizes[2 * i] = (int32_t)ch; sizes[2 * i + 1] = (int32_t)cw;
        }
    };

    if (nthreads <= 1 || n < 64) {
        work(0, n);
    } else {
        int32_t t = std::min<int32_t>(nthreads, 16);
        std::vector<std::thread> pool;
        int32_t chunk = (n + t - 1) / t;
        for (int32_t k = 0; k < t; k++) {
            int32_t lo = k * chunk, hi = std::min(n, lo + chunk);
            if (lo < hi) pool.emplace_back(work, lo, hi);
        }
        for (auto& th : pool) th.join();
    }
    return bad ? -1 : 0;
}

}  // extern "C"
