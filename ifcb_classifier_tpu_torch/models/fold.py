"""Eval-time BatchNorm→conv folding (the port's counterpart of
ifcb_classifier_tpu/models/fold.py), applied to the port's state dict.

At eval, BatchNorm is the affine map y = (x − μ)·γ/√(σ²+ε) + β with frozen
running stats, which folds into the preceding convolution:

    mul = γ/√(σ²+ε)          weight' = weight · mul        (per out-channel)
    bias' = (bias₀ − μ)·mul + β          (bias₀ = 0 for bias-free convs)

The math runs in float64 and is cast to float32 once, as in the JAX
package, so the two packages fold to the same float32 values.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["supports_fold", "fold_conv_bn", "fold_state_dict"]


def supports_fold(model_name: str) -> bool:
    """Families whose fold is ported (the JAX package also folds resnet*,
    vgg*_bn and efficientnet_b*: ROADMAP P7)."""
    return model_name == "inception_v3"


def fold_conv_bn(weight, conv_bias, bn_weight, bn_bias, mean, var, eps):
    """Fold one BN into the preceding conv; ``weight`` is torch-layout
    [O,I,kh,kw]. Returns (weight', bias') as float32 numpy arrays."""
    mul = np.asarray(bn_weight, np.float64) / np.sqrt(
        np.asarray(var, np.float64) + eps)
    w = np.asarray(weight, np.float64) * mul[:, None, None, None]
    b0 = 0.0 if conv_bias is None else np.asarray(conv_bias, np.float64)
    b = (b0 - np.asarray(mean, np.float64)) * mul + np.asarray(
        bn_bias, np.float64)
    return w.astype(np.float32), b.astype(np.float32)


def _fold_inception(state_dict, eps=1e-3):
    """Every BasicConv2d scope ``P.conv.weight`` + ``P.bn.*`` becomes
    ``P.conv.weight`` + ``P.conv.bias`` (TorchBN eps=1e-3)."""
    out = {}
    for key, v in state_dict.items():
        if ".bn." in key:
            continue  # consumed by its conv below
        if key.endswith(".conv.weight") and \
                key[:-len("conv.weight")] + "bn.weight" in state_dict:
            p = key[:-len("conv.weight")]

            def get(name):
                t = state_dict.get(p + name)
                return None if t is None else t.detach().cpu().numpy()
            w, b = fold_conv_bn(get("conv.weight"), get("conv.bias"),
                                get("bn.weight"), get("bn.bias"),
                                get("bn.running_mean"),
                                get("bn.running_var"), eps)
            out[key] = torch.from_numpy(w)
            out[p + "conv.bias"] = torch.from_numpy(b)
            continue
        if key.endswith(".conv.bias") and key in out:
            continue  # a conv bias already folded in above
        out[key] = v
    return out


def fold_state_dict(model_name: str, state_dict: dict) -> dict:
    """state dict of the standard model → state dict of the same family
    built with ``fold_bn=True``."""
    if not supports_fold(model_name):
        raise NotImplementedError(
            f"BN folding for {model_name!r} is not ported yet (ROADMAP P7)")
    return _fold_inception(state_dict)
