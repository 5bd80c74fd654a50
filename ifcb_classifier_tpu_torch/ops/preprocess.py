"""Device preprocessing of grayscale ROI canvases (the gray branch of
ifcb_classifier_tpu/ops/preprocess.py).

  uint8 canvas [B,S,S] + per-image true (h, w)
    → per-image separable PIL-BILINEAR resize to (r, r)
    → /255, clip to [0, 1], gray broadcast to RGB, optional (x-mean)/std
    → [B, r, r, 3] in the model's dtype (NHWC, as in the JAX package)

An NHWC-contiguous tensor is the ``channels_last`` form of NCHW, so the
model takes the result with a ``permute`` and no copy.

Two versions compute it:

* ``preprocess_gray_cuda`` — kernel K1 (``csrc/preprocess_gray.cu``), one
  fused pass written by hand for Hopper, built at first use with nvcc and
  called through ctypes. It counts its launches in
  ``preprocess_gray_cuda.launches``.
* ``preprocess_gray_plain`` — the same arithmetic in plain PyTorch (two
  batched matmuls over the full weight matrices, like the JAX package).
  It is the CPU path and the kernel's oracle.

``preprocess_gray`` picks by where the canvas lies: the plain version for a
CPU tensor, the kernel for any other; it never falls back from one to the
other.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import torch

from .._build import build_shared_library

__all__ = ["resize_weights", "preprocess_gray", "preprocess_gray_plain",
           "preprocess_gray_cuda", "build_k1"]

_K1_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "preprocess_gray.cu")


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


def _check_norm(mean, std):
    if (mean is None) != (std is None):
        raise ValueError("mean and std go together")
    if mean is not None and not (len(mean) == len(std) == 3):
        raise ValueError("mean and std need 3 values each")


def preprocess_gray_plain(canvas, sizes, *, out_size, mean=None, std=None,
                          dtype=torch.float32):
    """Plain PyTorch version of K1: canvas uint8 [B,S,S], sizes int32
    [B,2] → [B,out_size,out_size,3] in ``dtype``."""
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


def build_k1():
    """Build (once) and load K1; returns (ctypes library, compiler output,
    which holds ptxas's register and shared-memory report)."""
    global _k1
    if _k1 is None:
        so, log = build_shared_library(
            "k1_preprocess_gray", [_K1_SRC],
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v"])
        lib = ctypes.CDLL(so)
        fn = lib.k1_preprocess_gray
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
        _k1 = (lib, log)
    return _k1


def preprocess_gray_cuda(canvas, sizes, *, out_size, mean=None, std=None,
                         dtype=torch.bfloat16):
    """K1 on the card: same contract as ``preprocess_gray_plain``; the
    output is allocated here and the kernel launches on the current
    stream without synchronising."""
    if not (canvas.is_cuda and sizes.is_cuda
            and canvas.device == sizes.device):
        raise ValueError("K1 needs canvas and sizes on one CUDA device "
                         f"(got {canvas.device} and {sizes.device})")
    if canvas.dtype != torch.uint8 or canvas.ndim != 3 \
            or canvas.shape[1] != canvas.shape[2]:
        raise ValueError("K1 needs a uint8 [B,S,S] canvas (got "
                         f"{canvas.dtype} {tuple(canvas.shape)})")
    B, S = canvas.shape[0], canvas.shape[1]
    if sizes.dtype != torch.int32 or tuple(sizes.shape) != (B, 2):
        raise ValueError(f"K1 needs int32 sizes [{B},2] (got {sizes.dtype} "
                         f"{tuple(sizes.shape)})")
    if not (canvas.is_contiguous() and sizes.is_contiguous()):
        raise ValueError("K1 needs contiguous canvas and sizes")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K1 writes bf16 or f32, not {dtype}")
    if out_size < 1:
        raise ValueError(f"out_size must be positive (got {out_size})")
    _check_norm(mean, std)
    out = torch.empty((B, out_size, out_size, 3), dtype=dtype,
                      device=canvas.device)
    if B == 0:
        return out
    lib, _ = build_k1()
    has_norm = mean is not None
    c_mean = (ctypes.c_float * 3)(*(mean if has_norm else (0.0,) * 3))
    c_std = (ctypes.c_float * 3)(*(std if has_norm else (1.0,) * 3))
    with torch.cuda.device(canvas.device):
        stream = torch.cuda.current_stream(canvas.device).cuda_stream
        err = lib.k1_preprocess_gray(
            canvas.data_ptr(), sizes.data_ptr(), out.data_ptr(), B, S,
            out_size, int(dtype == torch.bfloat16), int(has_norm),
            c_mean, c_std, stream)
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
