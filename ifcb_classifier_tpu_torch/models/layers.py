"""Layers with the JAX package's torch-parity semantics
(ifcb_classifier_tpu/models/layers.py), on NCHW tensors.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode batch norm: the JAX package's forward, torch's native
    backward.

    Forward (models/layers.py:40-101 of the JAX package): batch statistics
    in f32 for bf16/f16 inputs (f64 inputs, for reference gradients, stay
    f64); the variance two-pass quality (Welford, ``var_mean``) for f32 and
    f64 inputs, one-pass clamped max(E[x^2] - E[x]^2, 0) for lower
    precision; y = (x - mean) * rsqrt(var + eps) * weight + bias, cast back
    to the input dtype.

    Backward: the analytic gradient of that expression (the same for both
    variance forms while var > 0), from ``native_batch_norm_backward``.
    Autograd through the forward would reduce dy and dy*x_hat with
    PyTorch's generic sum over dims (0, 2, 3), which on channels_last CUDA
    tensors loses most of the digits of the (heavily cancelling) BN weight
    and bias gradients of the early layers; the native kernel reduces them
    per channel as accurately as the NCHW path."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        low = x.dtype in (torch.bfloat16, torch.float16)
        xf = x.float() if low else x
        axes = (0, 2, 3)
        if low:
            mean = xf.mean(dim=axes)
            var = torch.clamp(xf.square().mean(dim=axes) - mean.square(),
                              min=0.0)
        else:
            var, mean = torch.var_mean(xf, dim=axes, correction=0)
        invstd = torch.rsqrt(var + eps)
        shape = (1, -1, 1, 1)
        w = weight.to(xf.dtype)
        y = (xf - mean.view(shape)) * (invstd * w).view(shape) \
            + bias.to(xf.dtype).view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.eps = eps
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        dx, dw, db = torch.ops.aten.native_batch_norm_backward(
            dy.contiguous(memory_format=_memory_format(x)), x, weight,
            None, None, mean, invstd, True, ctx.eps,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
             ctx.needs_input_grad[2]])
        return dx, dw, db, None


def _memory_format(x):
    return torch.channels_last \
        if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last) \
        and not x.is_contiguous() else torch.contiguous_format


class TorchBN(nn.Module):
    """torch.nn.BatchNorm2d-exact batch norm (TorchBN of the JAX package,
    models/layers.py:40-101), with the state-dict names of BatchNorm2d
    (weight, bias, running_mean, running_var).

    Eval: y = (x - running_mean) * rsqrt(running_var + eps) * weight + bias,
    in f32 for bf16/f16 inputs, cast back to the input dtype.
    Training (_BatchNormTrain): normalisation with the biased batch
    variance; the running variance updated with the unbiased one
    (x n/(n-1)), momentum 0.1. The parameters and running statistics are
    f32 in training (autocast casts the convolutions' operands, not the
    model)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                                 self.eps)
            with torch.no_grad():
                n = x.numel() // x.shape[1]
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * var * (n / max(n - 1, 1)))
            return y
        low = x.dtype in (torch.bfloat16, torch.float16)
        xf = x.float() if low else x
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var.to(xf.dtype) + self.eps) \
            * self.weight.to(xf.dtype)
        y = (xf - self.running_mean.to(xf.dtype).view(shape)) \
            * mul.view(shape) + self.bias.to(xf.dtype).view(shape)
        return y.to(x.dtype)


class BatchNormT(TorchBN):
    """torch.nn.BatchNorm2d defaults (eps 1e-5, momentum 0.1): BatchNormT
    of the JAX package (models/layers.py:104), for the families of a later
    slice (ROADMAP P7)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


def max_pool(x, window, stride, padding=0):
    """torch MaxPool2d (VALID unless padded)."""
    return F.max_pool2d(x, window, stride, padding)


class _AvgPool(torch.autograd.Function):
    """AvgPool2d (count_include_pad=True) whose backward runs PyTorch's
    native avg_pool2d backward in NCHW, never its channels_last CUDA
    kernel: on the card (torch 2.11) that kernel returns gradients off by
    about their own norm for inception's 3x3/1/1 pools (chip_smoke.py
    measures it; the forward is right)."""

    @staticmethod
    def forward(ctx, x, window, stride, padding):
        ctx.geometry = (window, stride, padding)
        ctx.shape, ctx.channels_last = x.shape, (
            x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))
        return F.avg_pool2d(x, window, stride, padding,
                            count_include_pad=True)

    @staticmethod
    def backward(ctx, dy):
        window, stride, padding = ctx.geometry
        shape = torch.empty(ctx.shape, dtype=dy.dtype, device=dy.device)
        dx = torch.ops.aten.avg_pool2d_backward(
            dy.contiguous(), shape, [window, window], [stride, stride],
            [padding, padding], False, True, None)
        if ctx.channels_last:
            dx = dx.contiguous(memory_format=torch.channels_last)
        return dx, None, None, None


def avg_pool(x, window, stride, padding=0):
    """torch AvgPool2d with count_include_pad=True (backward: _AvgPool)."""
    if not torch.is_grad_enabled() or not x.requires_grad:
        return F.avg_pool2d(x, window, stride, padding,
                            count_include_pad=True)
    return _AvgPool.apply(x, window, stride, padding)


def global_avg_pool(x):
    """AdaptiveAvgPool2d(1) + flatten: [B,C,H,W] -> [B,C]."""
    return x.mean(dim=(2, 3))
