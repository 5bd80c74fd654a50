"""Inception-v3 in PyTorch with torchvision's module names (the port's
counterpart of ifcb_classifier_tpu/models/inception.py).

Eval mode returns logits. ``fold=True`` builds the eval-only variant whose
BatchNorms were folded into the convolutions (models/fold.py): each conv
carries a bias and the BN module is absent. ``transform_input`` is
torchvision's pretrained-mode channel renormalisation. The JAX package's
space-to-depth stem is a TPU layout trick, exactly equal to the plain
stride-2 conv used here, and is not ported.

The aux head runs only in training, which comes with the TRAIN slice
(ROADMAP P5); it is not built here, and the engine drops its weights.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import TorchBN, avg_pool, global_avg_pool, max_pool


def transform_input_renorm(x):
    """Maps NCHW inputs normalised to mean/std 0.5 onto the ImageNet
    per-channel statistics (inception.py:25-34 of the JAX package)."""
    ch0 = x[:, 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5
    ch1 = x[:, 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5
    ch2 = x[:, 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5
    return torch.cat([ch0, ch1, ch2], dim=1)


class BasicConv2d(nn.Module):
    """conv(bias=False) + BN(eps=1e-3) + relu, or conv(bias) + relu when
    the BN is folded."""

    def __init__(self, i, o, fold=False, **kw):
        super().__init__()
        self.conv = nn.Conv2d(i, o, bias=fold, **kw)
        self.bn = None if fold else TorchBN(o, eps=0.001)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x)


class InceptionA(nn.Module):
    def __init__(self, i, pool_features, fold):
        super().__init__()
        self.branch1x1 = BasicConv2d(i, 64, fold, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(i, 48, fold, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, fold, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(i, 64, fold, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, fold, kernel_size=3,
                                          padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, fold, kernel_size=3,
                                          padding=1)
        self.branch_pool = BasicConv2d(i, pool_features, fold, kernel_size=1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(avg_pool(x, 3, 1, 1))], 1)


class InceptionB(nn.Module):
    def __init__(self, i, fold):
        super().__init__()
        self.branch3x3 = BasicConv2d(i, 384, fold, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(i, 64, fold, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, fold, kernel_size=3,
                                          padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, fold, kernel_size=3,
                                          stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            max_pool(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, i, c7, fold):
        super().__init__()
        bc = BasicConv2d
        self.branch1x1 = bc(i, 192, fold, kernel_size=1)
        self.branch7x7_1 = bc(i, c7, fold, kernel_size=1)
        self.branch7x7_2 = bc(c7, c7, fold, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = bc(c7, 192, fold, kernel_size=(7, 1),
                              padding=(3, 0))
        self.branch7x7dbl_1 = bc(i, c7, fold, kernel_size=1)
        self.branch7x7dbl_2 = bc(c7, c7, fold, kernel_size=(7, 1),
                                 padding=(3, 0))
        self.branch7x7dbl_3 = bc(c7, c7, fold, kernel_size=(1, 7),
                                 padding=(0, 3))
        self.branch7x7dbl_4 = bc(c7, c7, fold, kernel_size=(7, 1),
                                 padding=(3, 0))
        self.branch7x7dbl_5 = bc(c7, 192, fold, kernel_size=(1, 7),
                                 padding=(0, 3))
        self.branch_pool = bc(i, 192, fold, kernel_size=1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x))),
            self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(
                self.branch7x7dbl_2(self.branch7x7dbl_1(x))))),
            self.branch_pool(avg_pool(x, 3, 1, 1))], 1)


class InceptionD(nn.Module):
    def __init__(self, i, fold):
        super().__init__()
        bc = BasicConv2d
        self.branch3x3_1 = bc(i, 192, fold, kernel_size=1)
        self.branch3x3_2 = bc(192, 320, fold, kernel_size=3, stride=2)
        self.branch7x7x3_1 = bc(i, 192, fold, kernel_size=1)
        self.branch7x7x3_2 = bc(192, 192, fold, kernel_size=(1, 7),
                                padding=(0, 3))
        self.branch7x7x3_3 = bc(192, 192, fold, kernel_size=(7, 1),
                                padding=(3, 0))
        self.branch7x7x3_4 = bc(192, 192, fold, kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3_2(self.branch3x3_1(x)),
            self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(
                self.branch7x7x3_1(x)))),
            max_pool(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, i, fold):
        super().__init__()
        bc = BasicConv2d
        self.branch1x1 = bc(i, 320, fold, kernel_size=1)
        self.branch3x3_1 = bc(i, 384, fold, kernel_size=1)
        self.branch3x3_2a = bc(384, 384, fold, kernel_size=(1, 3),
                               padding=(0, 1))
        self.branch3x3_2b = bc(384, 384, fold, kernel_size=(3, 1),
                               padding=(1, 0))
        self.branch3x3dbl_1 = bc(i, 448, fold, kernel_size=1)
        self.branch3x3dbl_2 = bc(448, 384, fold, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = bc(384, 384, fold, kernel_size=(1, 3),
                                  padding=(0, 1))
        self.branch3x3dbl_3b = bc(384, 384, fold, kernel_size=(3, 1),
                                  padding=(1, 0))
        self.branch_pool = bc(i, 192, fold, kernel_size=1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        return torch.cat([
            self.branch1x1(x),
            self.branch3x3_2a(b3), self.branch3x3_2b(b3),
            self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
            self.branch_pool(avg_pool(x, 3, 1, 1))], 1)


class InceptionV3(nn.Module):
    """Takes NCHW images (channels_last memory is the fast form on the
    card) and returns f32 logits in eval."""

    def __init__(self, num_classes=1000, transform_input=False,
                 fold=False):
        super().__init__()
        self.transform_input = transform_input
        self.fold = fold
        f = fold
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, f, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, f, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, f, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, f, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, f, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32, f)
        self.Mixed_5c = InceptionA(256, 64, f)
        self.Mixed_5d = InceptionA(288, 64, f)
        self.Mixed_6a = InceptionB(288, f)
        self.Mixed_6b = InceptionC(768, 128, f)
        self.Mixed_6c = InceptionC(768, 160, f)
        self.Mixed_6d = InceptionC(768, 160, f)
        self.Mixed_6e = InceptionC(768, 192, f)
        self.Mixed_7a = InceptionD(768, f)
        self.Mixed_7b = InceptionE(1280, f)
        self.Mixed_7c = InceptionE(2048, f)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "inception_v3 training is not ported yet (ROADMAP P5); "
                "call .eval()")
        if self.transform_input:
            x = transform_input_renorm(x)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = max_pool(x, 3, 2)
        x = self.Mixed_5d(self.Mixed_5c(self.Mixed_5b(x)))
        x = self.Mixed_6e(self.Mixed_6d(self.Mixed_6c(self.Mixed_6b(
            self.Mixed_6a(x)))))
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        # dropout is the identity in eval
        return self.fc(global_avg_pool(x)).float()
