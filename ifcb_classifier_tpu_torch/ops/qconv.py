"""The int8 convolution of the int8-resident forward (the epilogue of
ifcb_classifier_tpu/models/quant_graph.py:96-113 _QuantCtx.conv, with _q8
of models/quant_resident.py:27-28):

  x s8 NHWC [B,H,W,Ci], w s8 [Co,kh,kw,Ci]
    → acc  = the exact s32 convolution (stride, pads ((top, bottom),
             (left, right)); taps outside the image read as 0)
    → y    = max(float32(acc) * scale[co] + bias[co], 0)      in f32
    → emit: clip(round(y * inv_out), -127, 127) as s8         (inv_out given)
            y in ``out_dtype`` (bf16 or f32)                  (inv_out None)

``scale`` is f32 w_scale[co] * s_x, ``inv_out`` the f32 1/s_out. The
output goes into channels ``c_off..c_off+Co`` of ``out`` (a contiguous
NHWC [B,Ho,Wo,C] tensor, allocated when not given), so the branches of an
inception block write straight into their concat buffer.

Two versions compute it:

* ``qconv_cuda`` — kernel K3 (``csrc/qconv_s8.cu``), an s8 implicit-GEMM
  convolution on the tensor cores with the epilogue fused, written by hand
  for Hopper, built at first use with nvcc and called through ctypes. It
  counts its launches in ``qconv_cuda.launches``.
* ``qconv_plain`` — plain PyTorch: the s32 product as a float64
  convolution of the int8 values (exact: |acc| < 2^53, where float32 is not
  — Mixed_7's K = 2048·127² > 2^24), then the epilogue as separate f32
  ``mul``, ``add``, ``clamp_min``, ``mul``, ``round`` and ``clamp``, in the
  JAX package's order. It is the CPU path and the kernel's oracle: K3's
  output is bitwise equal to it.

``qconv`` picks by where ``x`` lies: the plain version for a CPU tensor,
the kernel for any other; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from .._build import build_shared_library
from .preprocess import _nvcc_command, _stream

__all__ = ["conv_out_size", "qconv_acc_plain", "qconv_plain", "qconv_cuda",
           "qconv", "build_k3"]

_K3_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "qconv_s8.cu")
_OUT_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def conv_out_size(H, W, kh, kw, stride, pads):
    """(Ho, Wo) of a VALID convolution over the padded input."""
    (pt, pb), (pl, pr) = pads
    return ((H + pt + pb - kh) // stride[0] + 1,
            (W + pl + pr - kw) // stride[1] + 1)


def _out_buffer(x, w, stride, pads, out, c_off, dtype):
    B, H, W, _ = x.shape
    Co, kh, kw, _ = w.shape
    Ho, Wo = conv_out_size(H, W, kh, kw, stride, pads)
    if out is None:
        if c_off:
            raise ValueError("c_off needs an out buffer")
        return torch.empty((B, Ho, Wo, Co), dtype=dtype, device=x.device)
    if out.dtype != dtype or out.dim() != 4 or out.device != x.device \
            or tuple(out.shape[:3]) != (B, Ho, Wo) \
            or not 0 <= c_off <= out.shape[3] - Co \
            or not out.is_contiguous():
        raise ValueError(
            f"qconv: out must be a contiguous {dtype} [{B},{Ho},{Wo},C] on "
            f"{x.device} with C >= {c_off} + {Co} (got {out.dtype} "
            f"{tuple(out.shape)} on {out.device})")
    return out


def _emit_dtype(inv_out, out_dtype):
    if inv_out is not None:
        return torch.int8
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qconv emits s8, bf16 or f32, not {out_dtype}")
    return out_dtype


def qconv_acc_plain(x, w, stride, pads):
    """The exact s32 convolution of s8 NHWC ``x`` with s8 [Co,kh,kw,Ci]
    ``w``, as float64 NHWC (every value an integer). cuDNN is kept out:
    its float64 algorithms need not sum exactly."""
    (pt, pb), (pl, pr) = pads
    xf = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (pl, pr, pt, pb))
    wf = w.permute(0, 3, 1, 2).to(torch.float64)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xf, wf, stride=tuple(stride))
    return acc.permute(0, 2, 3, 1)


def qconv_plain(x, w, scale, bias, stride, pads, inv_out,
                out_dtype=torch.float32, out=None, c_off=0):
    """Plain PyTorch version of K3 (module docstring); returns ``out``."""
    dtype = _emit_dtype(inv_out, out_dtype)
    out = _out_buffer(x, w, stride, pads, out, c_off, dtype)
    y = qconv_acc_plain(x, w, stride, pads).to(torch.float32)
    y = torch.mul(y, scale)
    y = torch.add(y, bias)
    y = torch.clamp_min(y, 0.0)
    if inv_out is not None:
        y = torch.clamp(torch.round(torch.mul(y, inv_out)), -127, 127)
    out[..., c_off:c_off + w.shape[0]] = y.to(dtype)
    return out


_k3 = None  # (ctypes library, compiler output), built at first launch


def build_k3():
    """Build (once) and load K3; returns (ctypes library, compiler output,
    which holds ptxas's register and shared-memory report)."""
    global _k3
    if _k3 is None:
        so, log = build_shared_library("k3_qconv_s8", [_K3_SRC],
                                       _nvcc_command())
        lib = ctypes.CDLL(so)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.k3_qconv_s8.restype = i32
        lib.k3_qconv_s8.argtypes = [ptr] * 5 + [i32] * 16 + [
            ctypes.c_float, ptr]
        _k3 = (lib, log)
    return _k3


def _check_launch(x, w, scale, bias):
    dev = x.device
    if not x.is_cuda:
        raise ValueError(f"K3 needs CUDA tensors (got x on {dev})")
    if x.dtype != torch.int8 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("K3 needs a contiguous s8 NHWC x (got "
                         f"{x.dtype} {tuple(x.shape)})")
    if w.dtype != torch.int8 or w.dim() != 4 or not w.is_contiguous() \
            or w.shape[3] != x.shape[3] or w.device != dev:
        raise ValueError(f"K3 needs contiguous s8 weights [Co,kh,kw,"
                         f"{x.shape[3]}] on {dev} (got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device})")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (w.shape[0],) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"K3 needs a contiguous f32 {name} "
                             f"[{w.shape[0]}] on {dev} (got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device})")
    if x.shape[3] % 16 == 0 and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("K3 loads x and w in 16-byte pieces when Ci is a "
                         "multiple of 16: they must be 16-byte aligned")


def qconv_cuda(x, w, scale, bias, stride, pads, inv_out,
               out_dtype=torch.float32, out=None, c_off=0):
    """K3 on the card: same contract as ``qconv_plain``; the output is
    allocated here unless given and the kernel launches on the current
    stream without synchronising. Counts its launches in
    ``qconv_cuda.launches``."""
    _check_launch(x, w, scale, bias)
    dtype = _emit_dtype(inv_out, out_dtype)
    out = _out_buffer(x, w, stride, pads, out, c_off, dtype)
    B, H, W, Ci = x.shape
    Co, kh, kw, _ = w.shape
    Ho, Wo = out.shape[1], out.shape[2]
    if B * Ho * Wo == 0:
        return out
    lib, _ = build_k3()
    (pt, _), (pl, _) = pads
    with torch.cuda.device(x.device):
        err = lib.k3_qconv_s8(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, W, Ci, Co, kh, kw, stride[0], stride[1],
            pt, pl, Ho, Wo, out.shape[3], c_off, _OUT_KIND[dtype],
            0.0 if inv_out is None else inv_out, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"K3 launch failed with cudaError_t {err}")
    qconv_cuda.launches += 1
    return out


qconv_cuda.launches = 0


def qconv(x, w, scale, bias, stride, pads, inv_out,
          out_dtype=torch.float32, out=None, c_off=0):
    """The plain version for a CPU ``x``, K3 for any other."""
    fn = qconv_plain if x.device.type == "cpu" else qconv_cuda
    return fn(x, w, scale, bias, stride, pads, inv_out, out_dtype=out_dtype,
              out=out, c_off=c_off)
