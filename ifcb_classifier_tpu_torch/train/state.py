"""Optimizer, loss and the train/eval/predict steps (counterpart of
ifcb_classifier_tpu/train/state.py; the reference's LightningModule step
methods, neuston_models.py:63-157).

  * Adam lr=0.001 by default, no scheduler (neuston_models.py:63-64), from
    torch.optim; AdamW and SGD (momentum 0.9) for --optimizer
  * CE loss; inception's aux logits combined as loss1 + 0.4*loss2
    (neuston_models.py:70-78)
  * batches are padded to a static size and masked: mask=False rows add
    nothing to the loss
  * per-batch mean CE over valid rows (torch CrossEntropyLoss reduction)

Compute policy (the JAX package's dtype=bf16 policy): parameters and the
optimizer's moments stay f32; with ``dtype=torch.bfloat16`` the
convolutions and linear layers run in bf16 under ``torch.autocast``,
while the BN statistics (models/layers.TorchBN), the loss and the softmax
are f32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["init_params", "make_optimizer", "cross_entropy", "loss_fn",
           "make_train_step", "make_eval_step", "make_predict_step"]


def init_params(model, seed: int):
    """Deterministic random init from ``seed`` on a CPU generator (the same
    weights on any device), with the JAX package's flax defaults:
    convolution and linear weights from the truncated normal of
    lecun_normal (variance 1/fan_in, cut at two standard deviations), biases
    0, BN scale 1 and shift 0, running statistics 0 and 1. The values are
    not JAX's: the two generators differ."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                # flax's truncated normal: stddev corrected for the cut
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def make_optimizer(params, optimizer: str = "Adam",
                   learning_rate: float = 0.001, weight_decay: float = 0.0):
    """--optimizer/--learning-rate/--weight-decay (make_optimizer of the
    JAX package, train/state.py:37): Adam with coupled L2 decay (decay
    added to the gradient before the moments), AdamW with decoupled decay,
    SGD with momentum 0.9; betas (0.9, 0.999), eps 1e-8."""
    opt = optimizer.lower()
    if opt == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=weight_decay)
    if opt == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if opt == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=0.9,
                               weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {optimizer!r} "
                     "(choose Adam, AdamW, or SGD)")


def cross_entropy(logits, labels, mask, class_weights=None):
    """Mean CE over valid rows (torch CrossEntropyLoss reduction='mean'),
    in f32. ``class_weights`` (--class-norm): torch
    CrossEntropyLoss(weight=w) semantics, Σ w[y]·nll / Σ w[y] over valid
    rows."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    mask = mask.float()
    if class_weights is not None:
        w = class_weights[labels.long()] * mask
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-9)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(outputs, labels, mask, class_weights=None):
    """CE with the inception aux rule (neuston_models.py:70-78)."""
    if isinstance(outputs, tuple) and len(outputs) == 2:
        main, aux = outputs
        return (cross_entropy(main, labels, mask, class_weights)
                + 0.4 * cross_entropy(aux, labels, mask, class_weights))
    return cross_entropy(outputs, labels, mask, class_weights)


def compute_context(device, dtype):
    """bf16 autocast for the convolutions and linear layers, or nothing."""
    if dtype == torch.bfloat16:
        return torch.autocast(device_type=torch.device(device).type,
                              dtype=torch.bfloat16)
    return contextlib.nullcontext()


def make_train_step(model, optimizer, dtype=torch.float32,
                    class_weights=None, accum: int = 1):
    """One optimizer step over a batch of NHWC images [B,r,r,3] with int
    labels [B] and a bool mask [B]; returns the batch loss as a device
    scalar (no host sync). BN running statistics update in the forward.

    accum > 1 (--accum, make_train_step of the JAX package, :128): one
    optimizer step per batch over ``accum`` sequential micro-batches that
    take the INTERLEAVED rows [k::accum]; each micro normalises by its own
    BN statistics and updates the running ones in turn; the gradient is the
    sum of each micro's gradient weighted by its valid-row count (Σw under
    class weights), divided by the total: the exact masked-mean gradient of
    the full batch, not torch's usual loss/accum. The loss is combined the
    same way."""
    cw = None
    if class_weights is not None:
        cw = torch.as_tensor(class_weights, dtype=torch.float32)
    params = [p for p in model.parameters() if p.requires_grad]

    def denom_of(labels, mask):
        m = mask.float()
        return torch.sum(cw[labels.long()] * m) if cw is not None \
            else torch.sum(m)

    def train_step(images, labels, mask):
        nonlocal cw
        if cw is not None and cw.device != images.device:
            cw = cw.to(images.device)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        x = images.permute(0, 3, 1, 2)
        if accum == 1:
            with compute_context(images.device, dtype):
                outputs = model(x)
            loss = loss_fn(outputs, labels, mask, cw)
            loss.backward()
        else:
            b = images.shape[0]
            if b % accum:
                raise ValueError(f"batch {b} is not a multiple of --accum "
                                 f"{accum}")
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in params]
            lsum = torch.zeros((), dtype=torch.float32, device=images.device)
            dsum = torch.zeros((), dtype=torch.float32, device=images.device)
            for k in range(accum):
                with compute_context(images.device, dtype):
                    outputs = model(x[k::accum])
                lk = loss_fn(outputs, labels[k::accum], mask[k::accum], cw)
                dk = denom_of(labels[k::accum], mask[k::accum])
                grads = torch.autograd.grad(lk, params, allow_unused=True)
                for a, g in zip(gsum, grads):
                    if g is not None:
                        a.add_(g.float() * dk)
                lsum = lsum + lk.detach() * dk
                dsum = dsum + dk
            dsum = torch.clamp(dsum, min=1e-9)
            for p, a in zip(params, gsum):
                p.grad = (a / dsum).to(p.dtype)
            loss = lsum / dsum
        optimizer.step()
        return loss.detach()

    return train_step


def make_eval_step(model, dtype=torch.float32):
    """Forward + softmax + per-batch mean CE (validation_step parity,
    neuston_models.py:94-103): NHWC images, labels, mask → (loss, probs)
    device tensors, probs f32 [B, n_classes]."""

    def eval_step(images, labels, mask):
        model.eval()
        with torch.no_grad():
            with compute_context(images.device, dtype):
                outputs = model(images.permute(0, 3, 1, 2))
            if isinstance(outputs, tuple):
                outputs = outputs[0]
            loss = cross_entropy(outputs, labels, mask)
            return loss, torch.softmax(outputs.float(), dim=-1)

    return eval_step


def make_predict_step(model):
    """Forward + softmax in f32 (test_step parity,
    neuston_models.py:152-157). Takes NHWC images [B,r,r,3] and returns
    [B, n_classes] f32 probabilities on the images' device."""

    def predict_step(images):
        with torch.inference_mode():
            logits = model(images.permute(0, 3, 1, 2))
            return torch.softmax(logits.float(), dim=-1)

    return predict_step
