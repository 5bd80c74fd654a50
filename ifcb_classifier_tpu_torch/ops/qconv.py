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
  convolution on the tensor cores (wgmma fed by a shared-memory ring: the
  weights by TMA, the gathered input by cp.async) with the epilogue fused,
  written by hand for Hopper, built at first use with nvcc and called
  through ctypes. It reads the weights packed once per conv
  (``pack_k3_weights``: a zero-padded K-major [Co_pad, K_pad] matrix and
  its TMA descriptor); given none, it packs them per call. It counts its
  launches in ``qconv_cuda.launches``.
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
           "qconv", "build_k3", "pack_k3_weights", "K3Pack", "k3_tile_n",
           "k3_smem_bytes", "k3_plan", "k3_a_stages_plain"]

_K3_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "qconv_s8.cu")
_OUT_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}

# K3's launch plan (mirrors csrc/qconv_s8.cu)
WGMMA_S8_N = (8, 16, 24) + tuple(range(32, 257, 16))  # wgmma's s8 widths
K3_TILE_N = (32, 64, 96, 128, 160, 192, 224)  # the kernel's instantiations
K3_BM = 128          # output pixels per tile
K3_BK = 128          # K bytes per ring stage
K3_STAGES = 6        # ring depth, where it fits
K3_STAGES_NARROW = 3  # bn <= 64, two blocks a SM: more L1 left for the gather
K3_MIN_STAGES = 3
K3_MAX_STAGES = 8
K3_SUB = 4           # row blocks per stage where K_pad = 32 (the stem)
K3_K_ALIGN = 32      # K_pad: K rounded up to one wgmma k-step
SMEM_PER_BLOCK = 232448  # Hopper: 227 KB of dynamic shared memory a block
SMEM_PER_SM = 233472     # 228 KB an SM, 1 KB of it reserved per block


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


def k3_tile_n(co):
    """K3's tile width for ``co`` output channels: the kernel width that
    pads Co the least, then the one with fewer tiles."""
    return min(K3_TILE_N, key=lambda n: (-(-co // n) * n, -n))


def k3_smem_bytes(bn, stages, co_pad):
    """Dynamic shared memory of one K3 block (the kernel's Layout): the
    ring, the s8 staging rows, scale and bias, the barriers, and 1024 bytes
    to align the base."""
    return (stages * K3_BK * (K3_BM + bn) + K3_BM * (bn + 16) + 8 * co_pad
            + 16 * K3_MAX_STAGES + 1024)


def k3_blocks_per_sm(bn):
    """K3 runs two blocks per SM for tiles of up to 64 channels (their
    registers fit), one otherwise."""
    return 2 if bn <= 64 else 1


def k3_plan(B, Ho, Wo, co, k, ci):
    """K3's launch plan for one conv: a dict of bn, n_tiles_n, sub, rows
    (output pixels per tile: 128 x sub), tiles_m, tiles, co_pad, k_pad (K
    rounded up to K3_K_ALIGN), n_kst (ring stages per tile), stages (the
    ring depth: K3_STAGES, or K3_STAGES_NARROW where two blocks share an
    SM, or fewer, to fit) and smem (bytes per block).
    Tile t covers output pixels ``(t // n_tiles_n) * rows`` on and channels
    ``(t % n_tiles_n) * bn`` on."""
    bn = k3_tile_n(co)
    n_tiles_n = -(-co // bn)
    co_pad = n_tiles_n * bn
    k_pad = -(-k // K3_K_ALIGN) * K3_K_ALIGN
    budget = SMEM_PER_BLOCK if k3_blocks_per_sm(bn) == 1 else \
        SMEM_PER_SM // 2 - 1024
    depth = K3_STAGES if k3_blocks_per_sm(bn) == 1 else K3_STAGES_NARROW
    while depth > K3_MIN_STAGES and \
            k3_smem_bytes(bn, depth, co_pad) > budget:
        depth -= 1
    sub = K3_SUB if ci % 16 and k_pad == 32 and bn == 32 else 1
    tiles_m = -(-(B * Ho * Wo) // (K3_BM * sub))
    return dict(bn=bn, n_tiles_n=n_tiles_n, sub=sub, rows=K3_BM * sub,
                tiles_m=tiles_m, tiles=tiles_m * n_tiles_n, co_pad=co_pad,
                k_pad=k_pad, n_kst=-(-k_pad // K3_BK), stages=depth,
                smem=k3_smem_bytes(bn, depth, co_pad))


class K3Pack:
    """K3's weights for one conv, packed once: ``w`` s8 [co_pad, k_pad]
    (row co = w[co] flattened in (kh, kw, ci) order, zero-padded), its TMA
    descriptor (a 128-byte CUtensorMap; on the card only) and the plan
    fields that do not depend on the batch."""

    def __init__(self, w):
        co, kh, kw, ci = w.shape
        plan = k3_plan(1, 1, 1, co, kh * kw * ci, ci)
        self.shape, self.device = tuple(w.shape), w.device
        self.bn, self.k_pad = plan["bn"], plan["k_pad"]
        self.stages, self.smem = plan["stages"], plan["smem"]
        k = kh * kw * ci
        self.w = torch.zeros((plan["co_pad"], self.k_pad), dtype=torch.int8,
                             device=w.device)
        self.w[:co, :k] = w.reshape(co, k)
        self.map, self.map_ptr = None, None
        if w.device.type != "cpu":
            lib, _ = build_k3()
            self.map = ctypes.create_string_buffer(128)
            self.map_ptr = ctypes.addressof(self.map)
            if self.w.data_ptr() % 16:
                raise ValueError("K3's packed weights must be 16-byte "
                                 "aligned for TMA")
            with torch.cuda.device(w.device):
                err = lib.k3_weight_map(self.w.data_ptr(), self.w.shape[0],
                                        self.k_pad, self.bn, self.map_ptr)
            if err != 0:
                raise RuntimeError("K3: encoding the weights' TMA "
                                   f"descriptor failed ({err})")


def pack_k3_weights(w):
    """Pack s8 [Co,kh,kw,Ci] weights for K3 (``K3Pack``)."""
    if w.dtype != torch.int8 or w.dim() != 4:
        raise ValueError(f"K3 packs s8 [Co,kh,kw,Ci] weights (got {w.dtype} "
                         f"{tuple(w.shape)})")
    return K3Pack(w)


def k3_a_stages_plain(x, kh, kw, stride, pads, m0, k_pad):
    """The A tiles K3's producer writes for rows m0..m0+127, Ci % 16 == 0:
    uint8 [n_stages, 128, 128], each stage 128 rows x 128 K-bytes in the
    128-byte swizzled layout (byte k of row r at r*128 + ((k//16) ^ (r%8))
    *16 + k%16). Mirrors produce_wide: thread t fills 16-byte column t % 8
    of rows t//8 + 16i, walking its tap (r, s, c) without a division; taps
    outside the image, rows past M and K past its end read as zero."""
    B, H, W, ci = x.shape
    (pt, _), (pl, _) = pads
    Ho, Wo = conv_out_size(H, W, kh, kw, stride, pads)
    M, n_st = B * Ho * Wo, -(-k_pad // K3_BK)
    flat = x.reshape(-1).view(torch.uint8)
    out = torch.zeros((n_st, K3_BM, K3_BK), dtype=torch.uint8)

    def advance(tap, nbytes):
        r, s, c = tap
        c += nbytes
        while c >= ci:
            c -= ci
            s += 1
            if s == kw:
                s, r = 0, r + 1
        return r, s, c

    for t in range(K3_BM):
        col, row0 = t % 8, t // 8
        tap = advance((0, 0, 0), 16 * col)
        for st in range(n_st):
            r, s, c = tap
            for i in range(8):
                row, m = row0 + 16 * i, m0 + row0 + 16 * i
                if m >= M or r >= kh:
                    continue
                n, rem = divmod(m, Ho * Wo)
                oh, ow = divmod(rem, Wo)
                ih, iw = oh * stride[0] - pt + r, ow * stride[1] - pl + s
                if 0 <= ih < H and 0 <= iw < W:
                    at = ((n * H + ih) * W + iw) * ci + c
                    slot = (col ^ (row % 8)) * 16
                    out[st, row, slot:slot + 16] = flat[at:at + 16]
            tap = advance(tap, K3_BK)
    return out


_k3 = None  # (ctypes library, compiler output), built at first launch
_k3_geoms = {}  # launch geometry -> its ctypes int array, made once


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
        lib.k3_qconv_s8.argtypes = [ptr] * 6 + [ctypes.c_longlong, i32, i32,
                                                ctypes.c_float, ptr]
        lib.k3_weight_map.restype = i32
        lib.k3_weight_map.argtypes = [ptr, i32, i32, i32, ptr]
        _k3 = (lib, log)
    return _k3


def _check_launch(x, w, scale, bias, pack):
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
    if x.numel() >= 2 ** 31:
        raise ValueError("K3 addresses x with 32-bit offsets: it takes "
                         f"fewer than 2^31 bytes (got {x.numel()})")
    if x.shape[3] % 16 == 0 and x.data_ptr() % 16:
        raise ValueError("K3 loads x in 16-byte pieces when Ci is a "
                         "multiple of 16: it must be 16-byte aligned")
    if pack is not None and (pack.shape != tuple(w.shape)
                             or pack.device != dev or pack.map is None):
        raise ValueError(f"K3's pack is of {pack.shape} weights on "
                         f"{pack.device}, not of {tuple(w.shape)} on {dev}")


def qconv_cuda(x, w, scale, bias, stride, pads, inv_out,
               out_dtype=torch.float32, out=None, c_off=0, pack=None):
    """K3 on the card: same contract as ``qconv_plain``; ``pack`` is
    ``pack_k3_weights(w)`` (made here when not given). The output is
    allocated here unless given and the kernel launches on the current
    stream without synchronising. Counts its launches in
    ``qconv_cuda.launches``."""
    _check_launch(x, w, scale, bias, pack)
    dtype = _emit_dtype(inv_out, out_dtype)
    out = _out_buffer(x, w, stride, pads, out, c_off, dtype)
    B, H, W, Ci = x.shape
    Co, kh, kw, _ = w.shape
    Ho, Wo = out.shape[1], out.shape[2]
    if B * Ho * Wo == 0:
        return out
    if pack is None:
        pack = pack_k3_weights(w)
    lib, _ = build_k3()
    (pt, _), (pl, _) = pads
    key = (B, H, W, Ci, Co, kh, kw, stride[0], stride[1], pt, pl, Ho, Wo,
           pack.k_pad, pack.bn, pack.stages, pack.smem)
    geom = _k3_geoms.get(key)
    if geom is None:  # the int array the kernel's launcher reads
        if len(_k3_geoms) > 4096:
            _k3_geoms.clear()
        geom = _k3_geoms[key] = (ctypes.c_int * len(key))(*key)
    dev = x.device.index
    args = (x.data_ptr(), pack.map_ptr, scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), geom, out.shape[3], c_off, _OUT_KIND[dtype],
            0.0 if inv_out is None else inv_out, _stream(x.device))
    if dev == torch.cuda.current_device():
        err = lib.k3_qconv_s8(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.k3_qconv_s8(*args)
    if err != 0:
        raise RuntimeError(f"K3 launch failed with cudaError_t {err}")
    qconv_cuda.launches += 1
    return out


qconv_cuda.launches = 0


def qconv(x, w, scale, bias, stride, pads, inv_out,
          out_dtype=torch.float32, out=None, c_off=0, pack=None):
    """The plain version for a CPU ``x``, K3 for any other (with ``pack``,
    K3's packed weights, when given)."""
    if x.device.type == "cpu":
        return qconv_plain(x, w, scale, bias, stride, pads, inv_out,
                           out_dtype=out_dtype, out=out, c_off=c_off)
    return qconv_cuda(x, w, scale, bias, stride, pads, inv_out,
                      out_dtype=out_dtype, out=out, c_off=c_off, pack=pack)
