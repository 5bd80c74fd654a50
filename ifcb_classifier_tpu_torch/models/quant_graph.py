"""int8-resident inference graph for inception_v3 (the port's counterpart of
ifcb_classifier_tpu/models/quant_graph.py, whose docstring gives the
quantization points and why they equal the interceptor graph's).

Every conv runs as an s8 x s8 product into s32 with its dequantize, bias,
relu and requantize fused (ops/qconv.py: kernel K3 on the card, its plain
version on the CPU); activations live between convs as (s8 NHWC tensor,
Python-float scale) pairs. The branches of a block share one emission scale
(``group``) and write straight into the block's concat buffer at their
channel offset. Float inputs (the image after the optional
``transform_input`` renorm, the avg-pooled branches) are quantized at entry
with their ``':in'`` scale; max-pool runs on s8 and keeps its input's
scale; avg-pool branches dequantize to the float dtype and pool there; the
last block (Mixed_7c) emits floats that feed the head (global mean, ``fc``
in the float dtype, softmax in f32).

The calibration pass (``_CalibCtx``) is the float forward of the folded
model with the port's convolutions (cuDNN on the card), in the model's
dtype, on NCHW tensors laid out channels_last; it records every conv's
input and post-relu output absmax under '<path>:in' / '<path>:out' (paths
are the folded checkpoint's, '/'-joined) and every conv's geometry.
The entry quantize, ``requant``, the s8 max-pool and the avg-pool
dequantize are plain PyTorch, as the JAX package leaves them to XLA outside
any kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.qconv import conv_out_size, pack_k3_weights, qconv
from .layers import avg_pool as _avg_pool_f32
from .layers import max_pool as _max_pool_f32
from .quant_resident import (_norm, _q8, f32, CalibCtxBase, QuantCtxBase,
                             make_entrypoints)

__all__ = ["make_calib_fn", "make_quant_predict"]

_POOL = "pool"  # the concat member that is the block input, max-pooled


def _renorm_nhwc(x):
    """transform_input_renorm of the JAX package (models/inception.py:25-34)
    on NHWC: maps inputs normalised to mean/std 0.5 onto the ImageNet
    per-channel statistics."""
    ch0 = x[..., 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5
    ch1 = x[..., 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5
    ch2 = x[..., 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5
    return torch.cat([ch0, ch1, ch2], dim=-1)


class _CalibCtx(CalibCtxBase):
    """Float forward over the folded parameters (NCHW, channels_last),
    recording '<conv path>:in' (the tensor arriving at a conv) and
    '<conv path>:out' (its post-relu output) absmax, and filling
    ``geoms`` (path tuple → strides and padding)."""

    def enter(self, x):
        return x.permute(0, 3, 1, 2)  # NHWC memory = NCHW channels_last

    def conv(self, x, path, stride=1, padding=0, emit="self", dst=None):
        strides, pads = _norm(stride, padding)
        self.geoms[tuple(path)] = dict(strides=strides, padding=pads)
        key = "/".join(path)
        self._rec(key + ":in", x)
        name = ".".join(path)
        y = F.conv2d(x.to(self.dtype), self.p[name + ".weight"],
                     self.p[name + ".bias"], strides,
                     (pads[0][0], pads[1][0]))
        y = F.relu(y)
        self._rec(key + ":out", y)
        return y

    def group(self, out_keys, extra=()):
        return None  # scales exist only in the quantized pass

    def concat_buffer(self, x, members, sig):
        return None  # the calibration pass concatenates its parts

    def concat(self, parts, sig, dst):
        return torch.cat(parts, dim=1)

    def max_pool(self, x, window, stride):
        return _max_pool_f32(x, window, stride)

    def avg_pool_f(self, x, window, stride, padding):
        return _avg_pool_f32(x, window, stride, padding)

    def requant(self, x, sig, dst=None):
        return x

    def global_pool(self, x):
        return x.mean(dim=(2, 3))


class _Concat:
    """A block's NHWC concat buffer: each member (a conv path key, or
    ``_POOL``) owns ``width`` channels at its offset, in concat order. The
    buffer is allocated at the first write, which gives its spatial
    size."""

    def __init__(self, widths, dtype):
        self.offsets, total = {}, 0
        for key, width in widths:
            self.offsets[key] = total
            total += width
        self.channels, self.dtype, self.buf = total, dtype, None

    def slot(self, key, B, Ho, Wo, device):
        if self.buf is None:
            self.buf = torch.empty((B, Ho, Wo, self.channels),
                                   dtype=self.dtype, device=device)
        return self.buf, self.offsets[key]


class _QuantCtx(QuantCtxBase):
    """Activations are (s8 NHWC tensor, Python-float scale) pairs between
    convs; inception's concat groups share one emission scale (group()
    below), which is why conv() takes an explicit ``emit`` argument."""

    def enter(self, x):
        return x  # NHWC float until the stem quantizes it

    def _mul(self, q, s_x):
        """f32 w_scale[co] * s_x (JAX: a float32 array times a weakly
        typed Python float), kept with the conv's weights for reuse."""
        cache = q.setdefault("mul", {})
        if s_x not in cache:
            cache[s_x] = q["w_scale"] * f32(s_x)
        return cache[s_x]

    @staticmethod
    def _pack(q, xq):
        """K3's packed weights (ops/qconv.pack_k3_weights), made once per
        conv and kept with its weights; none on the CPU."""
        if xq.device.type == "cpu":
            return None
        if "k3" not in q:
            q["k3"] = pack_k3_weights(q["w"])
        return q["k3"]

    def conv(self, x, path, stride=1, padding=0, emit="self", dst=None):
        strides, pads = _norm(stride, padding)
        key = "/".join(path)
        q = self.qconv[key]
        if isinstance(x, tuple):
            xq, s_x = x
        else:  # float entry (image, avg-pooled branch)
            s_x = self._scale(key + ":in")
            xq = _q8(x.float(), 1.0 / s_x)
        if emit is None:
            s_out, inv = None, None
        else:
            s_out = self._scale(key + ":out") if emit == "self" else emit
            inv = f32(1.0 / s_out)
        out, c_off = None, 0
        if dst is not None:
            B, H, W, _ = xq.shape
            Ho, Wo = conv_out_size(H, W, q["w"].shape[1], q["w"].shape[2],
                                   strides, pads)
            out, c_off = dst.slot(key, B, Ho, Wo, xq.device)
        y = qconv(xq, q["w"], self._mul(q, s_x), q["bias"], strides, pads,
                  inv, out_dtype=self.dtype, out=out, c_off=c_off,
                  pack=self._pack(q, xq))
        return y if emit is None else (y, s_out)

    def group(self, out_keys, extra=()):
        """Shared emission scale of a concat domain: max over the member
        convs' output absmaxes and any pass-through parts' scales."""
        hi = max(float(self.absmax[k]) for k in out_keys)
        for part in extra:
            hi = max(hi, part[1] * 127.0)
        return max(hi, 1e-12) / 127.0

    def concat_buffer(self, x, members, sig):
        """The block's concat buffer: s8, or the float dtype for the last
        block (``sig`` None). ``members``: conv paths, or ``_POOL`` for the
        max-pooled block input ``x``."""
        widths = [(m, x[0].shape[3]) if m == _POOL else
                  ("/".join(m), self.qconv["/".join(m)]["w"].shape[0])
                  for m in members]
        return _Concat(widths, torch.int8 if sig is not None else self.dtype)

    def concat(self, parts, sig, dst):
        return dst.buf if sig is None else (dst.buf, sig)

    def max_pool(self, x, window, stride):
        """s8 max-pool through bf16, which holds every int8 value exactly
        (one path for the CPU and the card)."""
        q, s = x
        p = F.max_pool2d(q.permute(0, 3, 1, 2).to(torch.bfloat16), window,
                         stride)
        return p.to(torch.int8).permute(0, 2, 3, 1).contiguous(), s

    def avg_pool_f(self, x, window, stride, padding):
        q, s = x
        xf = (q.float() * f32(s)).to(self.dtype)
        y = _avg_pool_f32(xf.permute(0, 3, 1, 2), window, stride, padding)
        return y.permute(0, 2, 3, 1).contiguous()

    def requant(self, x, sig, dst=None):
        q, s = x
        if abs(s - sig) >= 1e-30:
            # sig >= s by group() construction: pure rescale, no clipping
            q = _q8(q.float() * f32(s / sig), 1.0)
        if dst is not None:
            buf, off = dst.slot(_POOL, *q.shape[:3], q.device)
            buf[..., off:off + q.shape[3]] = q
        return q, sig

    def global_pool(self, x):
        return x.mean(dim=(1, 2))


def _block_a(ctx, x, name):
    sig = ctx.group([f"{name}/{b}/conv:out" for b in
                     ("branch1x1", "branch5x5_2", "branch3x3dbl_3",
                      "branch_pool")])
    cat = ctx.concat_buffer(x, [(name, b, "conv") for b in (
        "branch1x1", "branch5x5_2", "branch3x3dbl_3", "branch_pool")], sig)
    b1 = ctx.conv(x, (name, "branch1x1", "conv"), emit=sig, dst=cat)
    b5 = ctx.conv(x, (name, "branch5x5_1", "conv"))
    b5 = ctx.conv(b5, (name, "branch5x5_2", "conv"), padding=2, emit=sig,
                  dst=cat)
    bd = ctx.conv(x, (name, "branch3x3dbl_1", "conv"))
    bd = ctx.conv(bd, (name, "branch3x3dbl_2", "conv"), padding=1)
    bd = ctx.conv(bd, (name, "branch3x3dbl_3", "conv"), padding=1, emit=sig,
                  dst=cat)
    bp = ctx.avg_pool_f(x, 3, 1, 1)
    bp = ctx.conv(bp, (name, "branch_pool", "conv"), emit=sig, dst=cat)
    return ctx.concat([b1, b5, bd, bp], sig, cat)


def _block_b(ctx, x, name):
    extra = [x] if not ctx.calib else []
    sig = ctx.group([f"{name}/branch3x3/conv:out",
                     f"{name}/branch3x3dbl_3/conv:out"], extra=extra)
    cat = ctx.concat_buffer(x, [(name, "branch3x3", "conv"),
                                (name, "branch3x3dbl_3", "conv"), _POOL],
                            sig)
    b3 = ctx.conv(x, (name, "branch3x3", "conv"), stride=2, emit=sig,
                  dst=cat)
    bd = ctx.conv(x, (name, "branch3x3dbl_1", "conv"))
    bd = ctx.conv(bd, (name, "branch3x3dbl_2", "conv"), padding=1)
    bd = ctx.conv(bd, (name, "branch3x3dbl_3", "conv"), stride=2, emit=sig,
                  dst=cat)
    bp = ctx.requant(ctx.max_pool(x, 3, 2), sig, dst=cat)
    return ctx.concat([b3, bd, bp], sig, cat)


def _block_c(ctx, x, name):
    sig = ctx.group([f"{name}/{b}/conv:out" for b in
                     ("branch1x1", "branch7x7_3", "branch7x7dbl_5",
                      "branch_pool")])
    cat = ctx.concat_buffer(x, [(name, b, "conv") for b in (
        "branch1x1", "branch7x7_3", "branch7x7dbl_5", "branch_pool")], sig)
    b1 = ctx.conv(x, (name, "branch1x1", "conv"), emit=sig, dst=cat)
    b7 = ctx.conv(x, (name, "branch7x7_1", "conv"))
    b7 = ctx.conv(b7, (name, "branch7x7_2", "conv"), padding=(0, 3))
    b7 = ctx.conv(b7, (name, "branch7x7_3", "conv"), padding=(3, 0),
                  emit=sig, dst=cat)
    bd = ctx.conv(x, (name, "branch7x7dbl_1", "conv"))
    bd = ctx.conv(bd, (name, "branch7x7dbl_2", "conv"), padding=(3, 0))
    bd = ctx.conv(bd, (name, "branch7x7dbl_3", "conv"), padding=(0, 3))
    bd = ctx.conv(bd, (name, "branch7x7dbl_4", "conv"), padding=(3, 0))
    bd = ctx.conv(bd, (name, "branch7x7dbl_5", "conv"), padding=(0, 3),
                  emit=sig, dst=cat)
    bp = ctx.avg_pool_f(x, 3, 1, 1)
    bp = ctx.conv(bp, (name, "branch_pool", "conv"), emit=sig, dst=cat)
    return ctx.concat([b1, b7, bd, bp], sig, cat)


def _block_d(ctx, x, name):
    extra = [x] if not ctx.calib else []
    sig = ctx.group([f"{name}/branch3x3_2/conv:out",
                     f"{name}/branch7x7x3_4/conv:out"], extra=extra)
    cat = ctx.concat_buffer(x, [(name, "branch3x3_2", "conv"),
                                (name, "branch7x7x3_4", "conv"), _POOL],
                            sig)
    b3 = ctx.conv(x, (name, "branch3x3_1", "conv"))
    b3 = ctx.conv(b3, (name, "branch3x3_2", "conv"), stride=2, emit=sig,
                  dst=cat)
    b7 = ctx.conv(x, (name, "branch7x7x3_1", "conv"))
    b7 = ctx.conv(b7, (name, "branch7x7x3_2", "conv"), padding=(0, 3))
    b7 = ctx.conv(b7, (name, "branch7x7x3_3", "conv"), padding=(3, 0))
    b7 = ctx.conv(b7, (name, "branch7x7x3_4", "conv"), stride=2, emit=sig,
                  dst=cat)
    bp = ctx.requant(ctx.max_pool(x, 3, 2), sig, dst=cat)
    return ctx.concat([b3, b7, bp], sig, cat)


def _block_e(ctx, x, name, final=False):
    # torchvision concat order: [b1, b3a, b3b, bda, bdb, bp] (the inner
    # branch concats flatten into the block concat)
    branches = ("branch1x1", "branch3x3_2a", "branch3x3_2b",
                "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool")
    sig = None if final else ctx.group(
        [f"{name}/{b}/conv:out" for b in branches])
    emit = None if final else sig
    cat = ctx.concat_buffer(x, [(name, b, "conv") for b in branches], sig)
    b1 = ctx.conv(x, (name, "branch1x1", "conv"), emit=emit, dst=cat)
    b3 = ctx.conv(x, (name, "branch3x3_1", "conv"))
    b3a = ctx.conv(b3, (name, "branch3x3_2a", "conv"), padding=(0, 1),
                   emit=emit, dst=cat)
    b3b = ctx.conv(b3, (name, "branch3x3_2b", "conv"), padding=(1, 0),
                   emit=emit, dst=cat)
    bd = ctx.conv(x, (name, "branch3x3dbl_1", "conv"))
    bd = ctx.conv(bd, (name, "branch3x3dbl_2", "conv"), padding=1)
    bda = ctx.conv(bd, (name, "branch3x3dbl_3a", "conv"), padding=(0, 1),
                   emit=emit, dst=cat)
    bdb = ctx.conv(bd, (name, "branch3x3dbl_3b", "conv"), padding=(1, 0),
                   emit=emit, dst=cat)
    bp = ctx.avg_pool_f(x, 3, 1, 1)
    bp = ctx.conv(bp, (name, "branch_pool", "conv"), emit=emit, dst=cat)
    # final: float parts feed the head directly
    return ctx.concat([b1, b3a, b3b, bda, bdb, bp], sig, cat)


def _graph(ctx, x, transform_input):
    """x: NHWC images [B,r,r,3] → f32 logits."""
    x = x.float()
    if transform_input:  # torchvision pretrained-mode channel renorm
        x = _renorm_nhwc(x)
    x = ctx.enter(x)
    x = ctx.conv(x, ("Conv2d_1a_3x3", "conv"), stride=2)
    x = ctx.conv(x, ("Conv2d_2a_3x3", "conv"))
    x = ctx.conv(x, ("Conv2d_2b_3x3", "conv"), padding=1)
    x = ctx.max_pool(x, 3, 2)
    x = ctx.conv(x, ("Conv2d_3b_1x1", "conv"))
    x = ctx.conv(x, ("Conv2d_4a_3x3", "conv"))
    x = ctx.max_pool(x, 3, 2)
    x = _block_a(ctx, x, "Mixed_5b")
    x = _block_a(ctx, x, "Mixed_5c")
    x = _block_a(ctx, x, "Mixed_5d")
    x = _block_b(ctx, x, "Mixed_6a")
    x = _block_c(ctx, x, "Mixed_6b")
    x = _block_c(ctx, x, "Mixed_6c")
    x = _block_c(ctx, x, "Mixed_6d")
    x = _block_c(ctx, x, "Mixed_6e")
    x = _block_d(ctx, x, "Mixed_7a")
    x = _block_e(ctx, x, "Mixed_7b")
    x = _block_e(ctx, x, "Mixed_7c", final=True)
    # head: global avg pool → (dropout: eval identity) → fc, full precision
    x = ctx.global_pool(x)
    x = F.linear(x.to(ctx.dtype), ctx.p["fc.weight"].to(ctx.dtype),
                 ctx.p["fc.bias"].to(ctx.dtype))
    return x.float()


make_calib_fn, make_quant_predict = make_entrypoints(
    _CalibCtx, _QuantCtx, _graph, lambda m: (m.transform_input,))
