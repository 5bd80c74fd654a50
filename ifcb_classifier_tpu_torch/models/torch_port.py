"""Weight carry-over between the JAX package's trees and the port's
modules (based on _flax_path_to_torch_key and export_state_dict in
ifcb_classifier_tpu/models/torch_port.py).

Layout rules, JAX tree → torch state dict:
  conv   flax HWIO [kh,kw,I,O]  → torch [O,I,kh,kw]
  dense  flax [I,O]             → torch [O,I]
  bn     params scale/bias      → weight/bias
         batch_stats mean/var   → running_mean/running_var

Inception's module names are torchvision's verbatim, with the BasicConv2d
``conv``/``bn`` level kept, so a tree path joined with '.' is the state-dict
key; the aux head (``AuxLogits``, trained by TRAIN) carries across by the
same rules both ways. Folded trees (conv kernel + bias, no bn) map by the
same rules. The int8 tier's per-conv leaves (the JAX package's
``__quant__`` entries) carry across with ``qconv_from_jax``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "qconv_from_jax"]

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(params, batch_stats) -> dict:
    """The JAX package's (params, batch_stats) trees, as numpy arrays →
    the port's state dict of float32 tensors."""
    sd = {}
    for tree in (params, batch_stats):
        for path, leaf in _flat(tree):
            key = ".".join(path[:-1] + (_LEAF_TO_TORCH[path[-1]],))
            t = np.asarray(leaf, np.float32)
            if t.ndim == 4:
                t = t.transpose(3, 2, 0, 1)
            elif t.ndim == 2:
                t = t.T
            sd[key] = torch.from_numpy(np.ascontiguousarray(t))
    return sd


def params_to_jax(state_dict) -> tuple[dict, dict]:
    """The inverse: the port's state dict → the JAX package's
    (params, batch_stats) trees of float32 numpy arrays."""
    params, stats = {}, {}
    for key, v in state_dict.items():
        *path, leaf = key.split(".")
        t = v.detach().cpu().to(torch.float32).numpy()
        if leaf in ("running_mean", "running_var"):
            tree, name = stats, leaf[len("running_"):]
        elif path and path[-1] == "bn":
            tree, name = params, {"weight": "scale"}.get(leaf, leaf)
        elif leaf == "weight":
            tree, name = params, "kernel"
            if t.ndim == 4:
                t = t.transpose(2, 3, 1, 0)
            elif t.ndim == 2:
                t = t.T
        elif leaf == "bias":
            tree, name = params, "bias"
        else:
            raise ValueError(f"no JAX counterpart for state-dict key {key!r}")
        for p in path:
            tree = tree.setdefault(p, {})
        tree[name] = np.ascontiguousarray(t)
    return params, stats


def qconv_from_jax(qconv, device=None) -> dict:
    """The JAX package's int8 conv leaves ({path: {w_int8 HWIO
    [kh,kw,ci,co], w_scale [co], bias [co]}}, from quantize_params) → the
    port's, in kernel K3's layout: {path: {w s8 [co,kh,kw,ci] (each output
    channel's K = kh*kw*ci bytes contiguous), w_scale f32 [co], bias f32
    [co]}} on ``device``."""
    out = {}
    for key, q in qconv.items():
        w = np.ascontiguousarray(np.asarray(q["w_int8"], np.int8)
                                 .transpose(3, 0, 1, 2))
        out[key] = dict(
            w=torch.from_numpy(w).to(device),
            w_scale=torch.from_numpy(
                np.asarray(q["w_scale"], np.float32)).to(device),
            bias=torch.from_numpy(np.asarray(q["bias"], np.float32))
            .to(device))
    return out
