"""Layers with the JAX package's torch-parity semantics
(ifcb_classifier_tpu/models/layers.py), on NCHW tensors.

Only what inception_v3 serving needs is here; TorchBN's training semantics
(unbiased running variance, f32 statistics) come with the TRAIN slice
(ROADMAP P5).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class TorchBN(nn.Module):
    """torch.nn.BatchNorm2d in eval: y = (x - mean) * rsqrt(var + eps) *
    weight + bias, computed in f32 and cast back to the input dtype, with
    the state-dict names of BatchNorm2d (weight, bias, running_mean,
    running_var)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "TorchBN training semantics are not ported yet "
                "(ROADMAP P5); call .eval()")
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var.float() + self.eps) \
            * self.weight.float()
        y = (x.float() - self.running_mean.float().view(shape)) \
            * mul.view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)


def max_pool(x, window, stride, padding=0):
    """torch MaxPool2d (VALID unless padded)."""
    return F.max_pool2d(x, window, stride, padding)


def avg_pool(x, window, stride, padding=0):
    """torch AvgPool2d with count_include_pad=True."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=True)


def global_avg_pool(x):
    """AdaptiveAvgPool2d(1) + flatten: [B,C,H,W] -> [B,C]."""
    return x.mean(dim=(2, 3))
