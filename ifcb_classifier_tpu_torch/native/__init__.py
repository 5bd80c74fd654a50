"""Native (C++) ROI canvas packer, loaded through ctypes.

The port's own copy of the JAX package's packer (roipack.cpp). It is built
with the host compiler at first use into the package's ``_build/``
directory; where no compiler is available the numpy path below gives the
same result.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .._build import build_shared_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "roipack.cpp")

_lib = None
_build_error = None


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        so, _ = build_shared_library(
            "roipack", [_SRC],
            ["g++", "-O3", "-shared", "-fPIC"], libs=["-lpthread"])
        lib = ctypes.CDLL(so)
        lib.roipack_pack.restype = ctypes.c_int
        lib.roipack_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        _lib = lib
    except (OSError, RuntimeError) as e:  # no compiler -> numpy path
        _build_error = e
    return _lib


def available() -> bool:
    return _load() is not None


def pack_rois_native(roi_bytes: np.ndarray, starts, heights, widths,
                     batch_size: int, canvas_size: int, nthreads: int = 8,
                     out=None):
    """Pack ROIs straight from the .roi buffer into a canvas batch.

    roi_bytes: uint8 1-D array (the whole .roi file)
    starts/heights/widths: int64 arrays, one entry per ROI to pack
    out: optional (canvas, sizes) C-contiguous arrays to pack into (e.g.
      views of page-locked memory); allocated here when None
    Returns (canvas uint8 [B,S,S], sizes int32 [B,2]); pad rows get (1,1)
    and an ROI whose byte range lies outside the buffer gets (0,0).
    """
    lib = _load()
    n = len(starts)
    if n > batch_size:
        raise ValueError(
            "pack_rois_native: {} ROIs exceed batch_size {}".format(
                n, batch_size))
    starts = np.ascontiguousarray(starts, np.int64)
    heights = np.ascontiguousarray(heights, np.int64)
    widths = np.ascontiguousarray(widths, np.int64)
    B, S = batch_size, canvas_size
    if out is None:
        out = np.empty((B, S, S), np.uint8), np.empty((B, 2), np.int32)
    canvas, sizes = out
    if (canvas.shape != (B, S, S) or canvas.dtype != np.uint8
            or sizes.shape != (B, 2) or sizes.dtype != np.int32
            or not (canvas.flags.c_contiguous and sizes.flags.c_contiguous)):
        raise ValueError("pack_rois_native: out must be C-contiguous uint8 "
                         "[{0},{1},{1}] and int32 [{0},2]".format(B, S))

    if lib is not None:
        roi_bytes = np.ascontiguousarray(roi_bytes, np.uint8)
        lib.roipack_pack(
            roi_bytes.ctypes.data, np.int64(roi_bytes.size),
            starts.ctypes.data, heights.ctypes.data, widths.ctypes.data,
            np.int32(n), np.int32(B), np.int32(S),
            canvas.ctypes.data, sizes.ctypes.data, np.int32(nthreads))
        return canvas, sizes

    # numpy path — same semantics
    canvas[:] = 0
    sizes[:] = 1
    total = roi_bytes.size
    for i in range(n):
        h, w, s0 = int(heights[i]), int(widths[i]), int(starts[i])
        if h <= 0 or w <= 0 or s0 < 0 or s0 + h * w > total:
            sizes[i] = (0, 0)
            continue
        ch, cw = min(h, S), min(w, S)
        img = roi_bytes[s0:s0 + h * w].reshape(h, w)
        canvas[i, :ch, :cw] = img[:ch, :cw]
        sizes[i] = (ch, cw)
    return canvas, sizes
