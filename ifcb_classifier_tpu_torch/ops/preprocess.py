"""Device preprocessing of grayscale ROI canvases (the gray branch of
ifcb_classifier_tpu/ops/preprocess.py) and of RGB image canvases (its RGB
branch, below).

  uint8 canvas [B,S,S] + per-image true (h, w)
    → per-image separable PIL-BILINEAR resize to (r, r)
    → /255, clip to [0, 1], gray broadcast to RGB, optional (x-mean)/std
    → [B, r, r, 3] in the model's dtype (NHWC, as in the JAX package)

An NHWC-contiguous tensor is the ``channels_last`` form of NCHW, so the
model takes the result with a ``permute`` and no copy.

Two versions compute it:

* ``preprocess_gray_cuda`` — kernel K1 (``csrc/preprocess_gray.cu``),
  written by hand for Hopper, built at first use with nvcc and called
  through ctypes: one call launches a prologue that builds each image's tap
  tables once per axis, then the fused resize. It counts its launches in
  ``preprocess_gray_cuda.launches``.
* ``preprocess_gray_plain`` — the same arithmetic in plain PyTorch (two
  batched matmuls over the full weight matrices, like the JAX package).
  It is the CPU path and the kernel's oracle.

``tap_tables_plain`` is the plain twin of K1's prologue (the compact tap
tables), and ``tap_tables_cuda`` runs that prologue alone on the card, so
the two can be held against each other.

``preprocess_gray`` picks by where the canvas lies: the plain version for a
CPU tensor, the kernel for any other; it never falls back from one to the
other.

The RGB branch (TRAIN's decoded images) is the same function over a
uint8 [B,S,S,3] canvas with per-channel norm and per-image flips (an
explicit [B,2] mask, drawn by the caller): ``preprocess_rgb_cuda`` is
kernel K2 (``csrc/preprocess_rgb.cu``: output tiles of 16 rows by J
columns), ``preprocess_rgb_plain`` its plain version, ``preprocess_rgb``
the dispatcher, with the same rules. ``k2_plan`` mirrors K2's launch plan
(J, its canvas buffers, the window it stages, its shared memory),
``k2_tile_walk`` its walk over tiles and ``k2_tiles_plain`` computes the
output tile by tile in the kernel's pass order.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import shutil

import numpy as np
import torch

from .._build import build_shared_library

__all__ = ["resize_weights", "tap_count", "tap_tables_plain",
           "tap_tables_cuda", "preprocess_gray", "preprocess_gray_plain",
           "preprocess_gray_cuda", "build_k1", "k1_resize_shape",
           "preprocess_rgb", "preprocess_rgb_plain", "preprocess_rgb_cuda",
           "build_k2", "k2_resize_shape", "k2_plan", "k2_tile_walk",
           "k2_tiles_plain"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_K1_SRC = os.path.join(_CSRC, "preprocess_gray.cu")
_K2_SRC = os.path.join(_CSRC, "preprocess_rgb.cu")
_COMMON_H = os.path.join(_CSRC, "preprocess_common.cuh")


def resize_weights(src_size, canvas_size: int, out_size: int, device=None):
    """[..., out_size, canvas_size] PIL-BILINEAR resampling matrices, one
    per entry of ``src_size`` (the true extent within the canvas).

    Rows are normalised over the in-bounds taps, so canvas padding beyond
    src_size never leaks in (ops/preprocess.py:39-54 of the JAX package)."""
    src = torch.as_tensor(src_size, dtype=torch.float32, device=device)
    src = src[..., None, None]
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, one ulp off IEEE division — and the centers below
    # multiply that error by up to r
    scale = src / torch.full_like(src, float(out_size))
    fscale = torch.clamp(scale, min=1.0)  # antialias: widen when downscaling
    i = torch.arange(out_size, dtype=torch.float32, device=src.device)[:, None]
    j = torch.arange(canvas_size, dtype=torch.float32,
                     device=src.device)[None, :]
    center = (i + 0.5) * scale
    w = torch.clamp(1.0 - torch.abs(j + 0.5 - center) / fscale, min=0.0)
    w = torch.where(j < src, w, 0.0)
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)


@functools.lru_cache(maxsize=None)
def tap_count(canvas_size: int, out_size: int) -> int:
    """T, the taps a trimmed window holds for any true extent within the
    canvas: a window's positive weights lie strictly within fscale of its
    center, so there are at most 2*ceil(fscale) of them, and fscale is at
    most max(S/r, 1) (computed in float32, as K1 computes it)."""
    scale = float(np.float32(canvas_size) / np.float32(out_size))
    return 2 * math.ceil(max(scale, 1.0))


def _untrimmed_windows(sizes, canvas_size: int, out_size: int):
    """(center, fscale, lo, hi) of every window (b, axis, i) before
    trimming, [B,2,r] (fscale [B,2,1]), with the float32 operations of
    ``window()`` in csrc/preprocess_common.cuh: one index of margin at each
    end, clipped to [0, src-1] (hi < lo for an empty axis)."""
    src_i = torch.as_tensor(sizes, dtype=torch.int32).clamp(
        0, canvas_size)[..., None]
    src = src_i.to(torch.float32)                              # [B,2,1]
    scale = src / torch.full_like(src, float(out_size))
    fscale = torch.clamp(scale, min=1.0)
    i = torch.arange(out_size, dtype=torch.float32)
    center = (i + 0.5) * scale                                 # [B,2,r]
    lo = torch.clamp(torch.floor(center - fscale - 0.5).to(torch.int32) - 1,
                     min=0)
    hi = torch.minimum(torch.ceil(center + fscale - 0.5).to(torch.int32) + 1,
                       src_i - 1)
    return center, fscale, lo, hi


def tap_tables_plain(sizes, canvas_size: int, out_size: int):
    """Plain twin of K1's prologue: sizes int32 [B,2] (h, w) → (lo, n,
    weights) with lo and n int32 [B,2,r] and weights float32 [B,2,r,T]
    (zero past n). Window (b, axis, i) has the normalised PIL-BILINEAR
    weights of output index i at canvas indices lo..lo+n-1, with the same
    float32 operations in the same order as the kernel: the weights over
    a window with one index of margin at each end, summed in index order,
    each divided by the sum, then the margin taps that came out exactly 0
    trimmed. Sizes are clamped to [0, S] as the kernel clamps them."""
    S, r = canvas_size, out_size
    T = tap_count(S, r)
    width = T + 5  # the window before trimming
    center, fscale, lo, hi = _untrimmed_windows(sizes, S, r)
    n = torch.clamp(hi - lo + 1, min=0, max=width)
    k = torch.arange(width, dtype=torch.int32)
    jj = (lo[..., None] + k).to(torch.float32)
    w = torch.clamp(1.0 - torch.abs(jj + 0.5 - center[..., None])
                    / fscale[..., None], min=0.0)
    w = torch.where(k < n[..., None], w, 0.0)
    total = torch.zeros_like(center)
    for kk in range(width):  # index order, as the kernel sums
        total = total + w[..., kk]
    w = w / torch.clamp(total, min=1e-9)[..., None]
    pos = w > 0
    kept = pos.sum(dim=-1).to(torch.int32)
    first = torch.where(kept > 0, pos.to(torch.int8).argmax(dim=-1), 0)
    idx = (first[..., None] + torch.arange(T)).clamp(max=width - 1)
    taps = torch.gather(w, -1, idx)
    taps = torch.where(torch.arange(T) < kept[..., None], taps, 0.0)
    return ((lo + first).to(torch.int32) * (kept > 0),
            torch.clamp(kept, max=T), taps.contiguous())


def _check_norm(mean, std):
    if (mean is None) != (std is None):
        raise ValueError("mean and std go together")
    if mean is not None and not (len(mean) == len(std) == 3):
        raise ValueError("mean and std need 3 values each")


def preprocess_gray_plain(canvas, sizes, *, out_size, mean=None, std=None,
                          dtype=torch.float32):
    """Plain PyTorch version of K1: canvas uint8 [B,S,S], sizes int32
    [B,2] → [B,out_size,out_size,3] in ``dtype``. Sizes outside [0, S]
    are outside the contract (the engine never sends them)."""
    _check_norm(mean, std)
    B, S, _ = canvas.shape
    r = out_size
    wh = resize_weights(sizes[:, 0], S, r, device=canvas.device)  # [B,r,S]
    ww = resize_weights(sizes[:, 1], S, r, device=canvas.device)  # [B,r,S]
    x = torch.matmul(wh, canvas.to(torch.float32))
    x = torch.matmul(x, ww.transpose(1, 2))
    x = torch.clamp(x * (1.0 / 255.0), 0.0, 1.0)
    x = x[..., None].expand(B, r, r, 3)
    if mean is not None:
        m = torch.tensor(mean, dtype=torch.float32, device=canvas.device)
        s = torch.tensor(std, dtype=torch.float32, device=canvas.device)
        x = (x - m) / s
    return x.to(dtype).contiguous()


_k1 = None  # (ctypes library, compiler output), built at first launch


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): K1 is built from csrc/ at first use")
    return found


def _nvcc_command():
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v"]


def build_k1():
    """Build (once) and load K1; returns (ctypes library, compiler output,
    which holds ptxas's register and shared-memory report)."""
    global _k1
    if _k1 is None:
        so, log = build_shared_library(
            "k1_preprocess_gray", [_K1_SRC], _nvcc_command(),
            headers=[_COMMON_H])
        lib = ctypes.CDLL(so)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.k1_preprocess_gray.restype = i32
        lib.k1_preprocess_gray.argtypes = [
            ptr, ptr, ptr, i32, i32, i32, i32, i32, f32p, f32p, ptr, ptr,
            i32, ptr]
        lib.k1_tap_tables.restype = i32
        lib.k1_tap_tables.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.k1_resize_shape.restype = i32
        lib.k1_resize_shape.argtypes = [i32, i32, i32, i32, i32,
                                        ctypes.POINTER(ctypes.c_int)]
        _k1 = (lib, log)
    return _k1


def k1_resize_shape(B, canvas_size, out_size, dtype=torch.bfloat16):
    """(dynamic shared memory per block in bytes, blocks resident per SM,
    grid, threads per block, output rows per work item) of K1's resize
    kernel for these arguments on the current card; for reports."""
    lib, _ = build_k1()
    shape = (ctypes.c_int * 5)()
    err = lib.k1_resize_shape(B, canvas_size, out_size,
                              tap_count(canvas_size, out_size),
                              int(dtype == torch.bfloat16), shape)
    if err != 0:
        raise RuntimeError(f"K1 resize shape failed with cudaError_t {err}")
    return tuple(shape)


def _check_sizes(sizes, B, device):
    if not (sizes.is_cuda and sizes.device == device):
        raise ValueError("K1/K2 need canvas and sizes on one CUDA device "
                         f"(got {device} and {sizes.device})")
    if sizes.dtype != torch.int32 or tuple(sizes.shape) != (B, 2) \
            or not sizes.is_contiguous():
        raise ValueError(f"K1/K2 need contiguous int32 sizes [{B},2] (got "
                         f"{sizes.dtype} {tuple(sizes.shape)})")


def _check_launch(name, canvas, channels, sizes, out_size, dtype, mean,
                  std):
    """What K1 (channels ()) and K2 (channels (3,)) take: a contiguous
    uint8 [B,S,S,*channels] CUDA canvas with S a multiple of 16 and 16-byte
    aligned data (they load it in 16-byte pieces), contiguous int32 sizes
    [B,2] on its device, bf16 or f32 output, a positive out_size."""
    if not canvas.is_cuda:
        raise ValueError(f"{name} needs canvas and sizes on one CUDA device "
                         f"(got {canvas.device} and {sizes.device})")
    shape = "[B,S,S{}]".format("".join(f",{c}" for c in channels))
    if canvas.dtype != torch.uint8 or canvas.ndim != 3 + len(channels) \
            or canvas.shape[1] != canvas.shape[2] \
            or tuple(canvas.shape[3:]) != channels:
        raise ValueError(f"{name} needs a uint8 {shape} canvas (got "
                         f"{canvas.dtype} {tuple(canvas.shape)})")
    S = canvas.shape[1]
    _check_sizes(sizes, canvas.shape[0], canvas.device)
    if not canvas.is_contiguous():
        raise ValueError(f"{name} needs contiguous canvas and sizes")
    if S % 16 or canvas.data_ptr() % 16:
        raise ValueError(f"{name} loads the canvas in 16-byte pieces: it "
                         f"needs S a multiple of 16 (got {S}) and a 16-byte "
                         "aligned canvas (got address "
                         f"{canvas.data_ptr():#x})")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} writes bf16 or f32, not {dtype}")
    if out_size < 1:
        raise ValueError(f"out_size must be positive (got {out_size})")
    _check_norm(mean, std)


def _tap_scratch(B, S, r, device, extra=0):
    """K1's tap tables in one allocation: (buffer, its data pointers for
    the (lo, n) pairs int32 [B,2,r,2] and for the weights float32
    [B,2,T,r] (tap-major) after them, T); ``extra`` int32 words more after
    the weights (K2's work counter)."""
    T = tap_count(S, r)
    buf = torch.empty(B * 2 * r * (2 + T) + extra, dtype=torch.int32,
                      device=device)
    ptr = buf.data_ptr()
    return buf, ptr, ptr + B * 2 * r * 2 * 4, T


def _stream(device):
    """The current CUDA stream of ``device`` (a CUDA device with its index)
    as an int, from PyTorch's raw-stream query: a Stream object would cost
    microseconds a launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def tap_tables_cuda(sizes, canvas_size: int, out_size: int):
    """K1's prologue alone on the card (for checks; not counted in K1's
    launches): the same (lo, n, weights) as ``tap_tables_plain``."""
    B = sizes.shape[0]
    _check_sizes(sizes, B, sizes.device)
    r = out_size
    buf, lo_n, wt, T = _tap_scratch(B, canvas_size, r, sizes.device)
    if B:
        lib, _ = build_k1()
        with torch.cuda.device(sizes.device):
            err = lib.k1_tap_tables(sizes.data_ptr(), lo_n, wt, B,
                                    canvas_size, r, T,
                                    _stream(sizes.device))
        if err != 0:
            raise RuntimeError(f"K1 taps launch failed with cudaError_t "
                               f"{err}")
    n_ln = B * 2 * r * 2
    lo_n = buf[:n_ln].view(B, 2, r, 2)
    wt = buf[n_ln:].view(torch.float32).view(B, 2, T, r)
    return lo_n[..., 0], lo_n[..., 1], wt.transpose(2, 3)


def preprocess_gray_cuda(canvas, sizes, *, out_size, mean=None, std=None,
                         dtype=torch.bfloat16):
    """K1 on the card: same contract as ``preprocess_gray_plain``, for a
    canvas whose S is a multiple of 16 (every rung of the engine's ladder)
    and whose data is 16-byte aligned; the output and the tap-table
    scratch are allocated here and both kernels launch on the current
    stream without synchronising. Sizes outside [0, S] are outside the
    contract (the engine never sends them); the kernel clamps them, so
    they cannot make it leave its buffers."""
    _check_launch("K1", canvas, (), sizes, out_size, dtype, mean, std)
    B, S = canvas.shape[0], canvas.shape[1]
    out = torch.empty((B, out_size, out_size, 3), dtype=dtype,
                      device=canvas.device)
    if B == 0:
        return out
    lib, _ = build_k1()
    scratch, lo_n, wt, T = _tap_scratch(B, S, out_size, canvas.device)
    has_norm = mean is not None
    c_mean = (ctypes.c_float * 3)(*(mean if has_norm else (0.0,) * 3))
    c_std = (ctypes.c_float * 3)(*(std if has_norm else (1.0,) * 3))
    with torch.cuda.device(canvas.device):
        err = lib.k1_preprocess_gray(
            canvas.data_ptr(), sizes.data_ptr(), out.data_ptr(), B, S,
            out_size, int(dtype == torch.bfloat16), int(has_norm),
            c_mean, c_std, lo_n, wt, T, _stream(canvas.device))
    del scratch  # freed after the launch: the allocator orders its reuse
    if err != 0:
        raise RuntimeError(f"K1 launch failed with cudaError_t {err}")
    preprocess_gray_cuda.launches += 1
    return out


preprocess_gray_cuda.launches = 0


def preprocess_gray(canvas, sizes, *, out_size, mean=None, std=None,
                    dtype=torch.float32):
    """The plain version for a CPU canvas, K1 for any other."""
    fn = preprocess_gray_plain if canvas.device.type == "cpu" \
        else preprocess_gray_cuda
    return fn(canvas, sizes, out_size=out_size, mean=mean, std=std,
              dtype=dtype)


# ------------------------------------------------------------------ K2 ---

def _flip_mask_or_none(flips, B):
    """flips: None or a bool/uint8 [B,2] mask (rows, columns). Returns a
    uint8 mask or None when nothing flips."""
    if flips is None:
        return None
    if tuple(flips.shape) != (B, 2):
        raise ValueError(f"flips must be [{B},2] (got {tuple(flips.shape)})")
    return flips.to(torch.uint8)


def preprocess_rgb_plain(canvas, sizes, *, out_size, mean=None, std=None,
                         flips=None, dtype=torch.float32):
    """Plain PyTorch version of K2 (the RGB branch of the JAX package's
    preprocess_batch, ops/preprocess.py:57-84, :110-121): canvas uint8
    [B,S,S,3], sizes int32 [B,2], flips None or a [B,2] mask (column 0
    flips rows — the reference's --flip x —, column 1 columns) →
    [B,out_size,out_size,3] in ``dtype``. It is the CPU path and K2's
    oracle."""
    _check_norm(mean, std)
    B, S = canvas.shape[0], canvas.shape[1]
    r = out_size
    wh = resize_weights(sizes[:, 0], S, r, device=canvas.device)  # [B,r,S]
    ww = resize_weights(sizes[:, 1], S, r, device=canvas.device)  # [B,r,S]
    x = torch.matmul(wh, canvas.to(torch.float32).reshape(B, S, S * 3))
    x = x.reshape(B, r, S, 3).transpose(2, 3).reshape(B, r * 3, S)
    x = torch.matmul(x, ww.transpose(1, 2))                    # [B,3r,r]
    x = x.reshape(B, r, 3, r).transpose(2, 3)                  # [B,r,r,3]
    x = torch.clamp(x * (1.0 / 255.0), 0.0, 1.0)
    if mean is not None:
        m = torch.tensor(mean, dtype=torch.float32, device=canvas.device)
        s = torch.tensor(std, dtype=torch.float32, device=canvas.device)
        x = (x - m) / s
    flips = _flip_mask_or_none(flips, B)
    if flips is not None:
        fx = flips[:, 0].bool()[:, None, None, None]
        fy = flips[:, 1].bool()[:, None, None, None]
        x = torch.where(fx, x.flip(1), x)
        x = torch.where(fy, x.flip(2), x)
    return x.to(dtype).contiguous()


# K2's launch plan (csrc/preprocess_rgb.cu, k2_plan and k2_layout): tiles
# of K2_ROWS output rows by J output columns: whole or half rows if they
# leave room for K2_REG_BLOCKS blocks on an SM (what the registers allow),
# else the widest balanced width ceil(r/n) that leaves room for
# K2_MIN_BLOCKS; two canvas buffers if they fit as many blocks, else one;
# threads that fill the SM's K2_SM_THREADS with those blocks.
K2_ROWS = 16
K2_SM_THREADS = 768      # resize threads an SM holds (80 registers each)
K2_REG_BLOCKS = 3
K2_MIN_BLOCKS = 2
K2_TMP_STRIDE = 20       # floats of tmp per window byte (16 rows + pad)
K2_SCRATCH_EXTRA = 4     # int32 words after the tap weights: the counter
                         # that hands the resize's units to its blocks
SMEM_PER_SM = 233472     # an H100 SM's shared memory (228 KB)
SMEM_PER_BLOCK = 232448  # the most one block may take (227 KB)
_SMEM_RESERVED = 1024    # the runtime's own share per block


def _a16(x):
    return (x + 15) // 16 * 16


def rows_capacity(k, canvas_size, out_size):
    """Canvas indices that k consecutive untrimmed windows span, at most
    (``rows_capacity`` of csrc/preprocess_common.cuh, in its float32
    operations)."""
    smax = np.float32(canvas_size) / np.float32(out_size)
    span = np.float32(k - 1) * smax \
        + np.float32(2.0) * max(smax, np.float32(1.0))
    return math.ceil(float(span)) + 6


def _k2_window_bytes(cols, S, r):
    return min(_a16(3 * rows_capacity(cols, S, r) + 30), 3 * S)


def _k2_canvas_pitch(wb):
    return wb if (wb >> 4) & 1 else wb + 16


def _k2_hw_cap(T, cols, r):
    """Horizontal weights a table slot holds: T taps of a tile, or the two
    taps a column of an upscaled image has across a whole row."""
    return max(T * cols, 2 * r)


def _k2_smem(r, T, cols, nbuf, rows_cap, wb_cap, out_bytes):
    """Dynamic shared memory of K2's resize block (k2_layout): the staging
    buffer of a whole-row plan (16 output rows), tmp (20 floats a window
    byte), the canvas buffers (rows padded so that 16 of them spread over
    the banks), two table slots, the units handed to the block."""
    o = _a16(K2_ROWS * r * 3 * out_bytes + 16) if cols == r else 0
    o = _a16(o + wb_cap * K2_TMP_STRIDE * 4)
    o = _a16(o + nbuf * rows_cap * _k2_canvas_pitch(wb_cap))
    slot = (_a16(_k2_hw_cap(T, cols, r) * 4) + _a16(r * 8)
            + _a16(T * K2_ROWS * 4) + _a16(K2_ROWS * 8))
    return o + 2 * slot + 16


def k2_plan(canvas_size, out_size, dtype=torch.bfloat16):
    """K2's resize plan for a canvas rung and output type (the Python
    mirror of k2_plan in csrc/preprocess_rgb.cu, which ``k2_resize_shape``
    reports on the card): the tile's rows and columns, the column tiles per
    row step, the canvas buffers, the window a tile stages (rows and bytes
    per row), the dynamic shared memory per block, the threads and the
    blocks an SM's shared memory holds."""
    S, r = canvas_size, out_size
    T = tap_count(S, r)
    ob = 2 if dtype == torch.bfloat16 else 4
    rows_cap = rows_capacity(K2_ROWS, S, r)

    def smem(J, nb):
        return _k2_smem(r, T, J, nb, rows_cap, _k2_window_bytes(J, S, r), ob)

    def fits(widths, blocks):
        return ((J, nb) for J in sorted(set(widths), reverse=True)
                for nb in (2, 1)
                if SMEM_PER_SM // (smem(J, nb) + _SMEM_RESERVED) >= blocks)
    wide = fits((-(-r // n) for n in (1, 2)), K2_REG_BLOCKS)
    any_width = fits((-(-r // n) for n in range(1, r + 1)), K2_MIN_BLOCKS)
    plan = next(wide, None)
    blocks = K2_REG_BLOCKS if plan else K2_MIN_BLOCKS
    cols, nbuf = plan or next(any_width, (1, 1))
    total = smem(cols, nbuf)
    return dict(rows=K2_ROWS, cols=cols, ncol=-(-r // cols), nbuf=nbuf,
                window_rows=rows_cap,
                window_bytes=_k2_window_bytes(cols, S, r), smem=total,
                threads=K2_SM_THREADS // blocks,
                blocks_by_smem=SMEM_PER_SM // (total + _SMEM_RESERVED))


def k2_tile_walk(sizes, canvas_size, out_size, cols):
    """K2's resize tiles with work, in the kernel's order (image, row step,
    column tile), as set_image/set_window in csrc/preprocess_rgb.cu build
    them: dicts of the image b, output rows [i0, i0+rows) and columns
    [j0, j0+cols), the canvas rows [ymin, ymin+nrows) and row bytes
    [xb0, xb0+wb) that their untrimmed windows touch (before the kernel
    caps them at the plan's window, which they never reach). An image
    whose whole row fits the window (and its two taps a column a table
    slot) is one tile of r columns per row step."""
    S, r = canvas_size, out_size
    T = tap_count(S, r)
    wb_cap = _k2_window_bytes(cols, S, r)
    hw_cap = _k2_hw_cap(T, cols, r)
    _, fscale, lo, hi = _untrimmed_windows(sizes, S, r)
    lo, hi = lo.numpy(), hi.numpy()
    w = torch.as_tensor(sizes, dtype=torch.int32).clamp(0, S)[:, 1].numpy()
    th = 2 * np.ceil(fscale[:, 1, 0].numpy()).astype(int)
    for b in range(lo.shape[0]):
        whole = cols == r or (_a16(3 * int(w[b])) <= wb_cap
                              and th[b] * r <= hw_cap)
        for i0 in range(0, r, K2_ROWS):
            rows = min(K2_ROWS, r - i0)
            ymin = int(lo[b, 0, i0])
            nrows = max(0, int(hi[b, 0, i0 + rows - 1]) - ymin + 1)
            for j0 in (0,) if whole else range(0, r, cols):
                n = r if whole else min(cols, r - j0)
                c0, c1 = int(lo[b, 1, j0]), int(hi[b, 1, j0 + n - 1])
                xb0 = (3 * c0) & ~15
                wb = 0 if c1 < c0 else _a16(3 * (c1 + 1)) - xb0
                yield dict(b=b, i0=i0, rows=rows, j0=j0, cols=n, ymin=ymin,
                           nrows=nrows, xb0=xb0, wb=wb)


def k2_tile_dest(tile, out_size, fx, fy):
    """(output rows, output columns) that a tile's rows and columns land
    on, in tile order: the mirrored ones when the image flips."""
    r = out_size
    rows = torch.arange(tile["i0"], tile["i0"] + tile["rows"])
    cols = torch.arange(tile["j0"], tile["j0"] + tile["cols"])
    return (r - 1 - rows if fx else rows), (r - 1 - cols if fy else cols)


def k2_tiles_plain(canvas, sizes, *, out_size, mean=None, std=None,
                   flips=None, dtype=torch.float32, cols=None):
    """K2's output computed tile by tile in the kernel's pass order (the
    plain mirror of its walk, for the CPU): per tile the vertical pass over
    the staged window's bytes, then the horizontal pass over its columns,
    each tap in order, then /255, clip, the norm and the flips placed by
    the tile's destination. Same contract as ``preprocess_rgb_plain``;
    ``cols`` imposes a tile width (default: the plan's)."""
    _check_norm(mean, std)
    B, S = canvas.shape[0], canvas.shape[1]
    r = out_size
    if cols is None:
        cols = k2_plan(S, r, dtype)["cols"]
    lo, n, w = tap_tables_plain(sizes.cpu(), S, r)  # [B,2,r], [B,2,r,T]
    flips = _flip_mask_or_none(flips, B)
    x = canvas.cpu().to(torch.float32).reshape(B, S, 3 * S)
    out = torch.zeros((B, r, r, 3), dtype=torch.float32)
    rgb = torch.arange(3)
    for t in k2_tile_walk(sizes.cpu(), S, r, cols):
        b, i0, j0 = t["b"], t["i0"], t["j0"]
        rs, cs = slice(i0, i0 + t["rows"]), slice(j0, j0 + t["cols"])
        acc = torch.zeros((t["rows"], t["cols"], 3))
        if t["nrows"] and t["wb"]:
            win = x[b, t["ymin"]:t["ymin"] + t["nrows"],
                    t["xb0"]:t["xb0"] + t["wb"]]
            tmp = torch.zeros((t["rows"], t["wb"]))
            for k in range(w.shape[-1]):  # vertical taps, in order
                on = k < n[b, 0, rs]
                y = (lo[b, 0, rs] - t["ymin"] + k).clamp(0, t["nrows"] - 1)
                tmp = tmp + torch.where(on[:, None],
                                        w[b, 0, rs, k, None] * win[y], 0.0)
            for k in range(w.shape[-1]):  # horizontal taps, in order
                on = k < n[b, 1, cs]
                px = (3 * (lo[b, 1, cs] + k) - t["xb0"])[:, None] + rgb
                vals = tmp[:, px.clamp(0, t["wb"] - 1)]
                acc = acc + torch.where(on[None, :, None],
                                        w[b, 1, cs, k, None] * vals, 0.0)
        v = torch.clamp(acc * (1.0 / 255.0), 0.0, 1.0)
        if mean is not None:
            v = (v - torch.tensor(mean)) / torch.tensor(std)
        fx = flips is not None and bool(flips[b, 0])
        fy = flips is not None and bool(flips[b, 1])
        orows, ocols = k2_tile_dest(t, r, fx, fy)
        out[b, orows[:, None], ocols[None, :]] = v
    return out.to(dtype).to(canvas.device)


_k2 = None  # (ctypes library, compiler output), built at first launch


def build_k2():
    """Build (once) and load K2; returns (ctypes library, compiler
    output)."""
    global _k2
    if _k2 is None:
        so, log = build_shared_library(
            "k2_preprocess_rgb", [_K2_SRC], _nvcc_command(),
            headers=[_COMMON_H])
        _k2 = (_bind_k2(ctypes.CDLL(so)), log)
    return _k2


def _bind_k2(lib):
    """Argument types of K2's C entry points (a library built from the
    current source)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.k2_preprocess_rgb.restype = i32
    lib.k2_preprocess_rgb.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, f32p, f32p, ptr, ptr,
        i32, ptr]
    lib.k2_resize_shape.restype = i32
    lib.k2_resize_shape.argtypes = [i32] * 5 + [ctypes.POINTER(ctypes.c_int)]
    return lib


def k2_resize_shape(B, canvas_size, out_size, dtype=torch.bfloat16):
    """K2's resize plan and launch shape on the current card: a dict of
    the dynamic shared memory per block (bytes), the blocks resident per
    SM, the grid, the threads per block, the tile's rows and columns, the
    canvas buffers and the window's rows and bytes per row."""
    return _k2_shape(build_k2()[0], B, canvas_size, out_size, dtype)


def _k2_shape(lib, B, canvas_size, out_size, dtype):
    """``k2_resize_shape`` of a K2 library bound by ``_bind_k2``."""
    shape = (ctypes.c_int * 9)()
    err = lib.k2_resize_shape(B, canvas_size, out_size,
                              tap_count(canvas_size, out_size),
                              int(dtype == torch.bfloat16), shape)
    if err != 0:
        raise RuntimeError(f"K2 resize shape failed with cudaError_t {err}")
    return dict(zip(("smem", "per_sm", "grid", "threads", "rows", "cols",
                     "nbuf", "window_rows", "window_bytes"), shape))


@functools.lru_cache(maxsize=16)
def _c_norm(mean, std):
    """The 3-float ctypes arrays of a (mean, std) pair, built once."""
    on = mean is not None
    return ((ctypes.c_float * 3)(*(mean if on else (0.0,) * 3)),
            (ctypes.c_float * 3)(*(std if on else (1.0,) * 3)))


def preprocess_rgb_cuda(canvas, sizes, *, out_size, mean=None, std=None,
                        flips=None, dtype=torch.bfloat16):
    """K2 on the card: same contract as ``preprocess_rgb_plain``, for a
    uint8 [B,S,S,3] canvas whose S is a multiple of 16 and whose data is
    16-byte aligned (every rung of the ladder, from the allocator). The
    output and the tap-table scratch are allocated here; both kernels
    launch on the current stream without synchronising. Counts its calls
    in ``preprocess_rgb_cuda.launches``."""
    _check_launch("K2", canvas, (3,), sizes, out_size, dtype, mean, std)
    B, S = canvas.shape[0], canvas.shape[1]
    if flips is not None:
        if tuple(flips.shape) != (B, 2):
            raise ValueError(f"flips must be [{B},2] (got "
                             f"{tuple(flips.shape)})")
        if flips.device != canvas.device:
            raise ValueError(f"K2 needs flips on {canvas.device} (got "
                             f"{flips.device})")
        if flips.dtype != torch.uint8 or not flips.is_contiguous():
            flips = flips.to(torch.uint8).contiguous()
    out = torch.empty((B, out_size, out_size, 3), dtype=dtype,
                      device=canvas.device)
    if B == 0:
        return out
    lib, _ = build_k2()
    scratch, lo_n, wt, T = _tap_scratch(B, S, out_size, canvas.device,
                                        extra=K2_SCRATCH_EXTRA)
    has_norm = mean is not None
    c_mean, c_std = _c_norm(tuple(mean) if has_norm else None,
                            tuple(std) if has_norm else None)
    with torch.cuda.device(canvas.device):
        err = lib.k2_preprocess_rgb(
            canvas.data_ptr(), sizes.data_ptr(),
            None if flips is None else flips.data_ptr(), out.data_ptr(), B,
            S, out_size, int(dtype == torch.bfloat16), int(has_norm),
            c_mean, c_std, lo_n, wt, T, _stream(canvas.device))
    del scratch, flips  # freed after the launch: the allocator orders reuse
    if err != 0:
        raise RuntimeError(f"K2 launch failed with cudaError_t {err}")
    preprocess_rgb_cuda.launches += 1
    return out


preprocess_rgb_cuda.launches = 0


def preprocess_rgb(canvas, sizes, *, out_size, mean=None, std=None,
                   flips=None, dtype=torch.float32):
    """The plain version for a CPU canvas, K2 for any other."""
    fn = preprocess_rgb_plain if canvas.device.type == "cpu" \
        else preprocess_rgb_cuda
    return fn(canvas, sizes, out_size=out_size, mean=mean, std=std,
              flips=flips, dtype=dtype)
