"""Shared plumbing of the int8-resident graph (the port's counterpart of
ifcb_classifier_tpu/models/quant_resident.py): the quantize helper, the
contexts' state, the activation-scale rule (absmax/127, floored at 1e-12)
and the make_calib_fn/make_quant_predict entry points.

The port has the inception graph only (models/quant_graph.py); the resnet
and vgg graphs of the JAX package come with their families (ROADMAP P7).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["f32", "CalibCtxBase", "QuantCtxBase", "make_entrypoints"]


def f32(v: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weakly typed
    Python scalar that meets a float32 array."""
    return float(np.float32(v))


def _norm(stride, padding):
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (padding, padding) if isinstance(padding, int) else tuple(padding)
    return s, ((p[0], p[0]), (p[1], p[1]))


def _q8(y, inv_scale):
    """clip(round(y * inv_scale), -127, 127) as s8 (round half to even);
    ``inv_scale`` a Python float, taken as float32."""
    return torch.clamp(torch.round(y * f32(inv_scale)), -127, 127) \
        .to(torch.int8)


class CalibCtxBase:
    """Float forward over the folded parameters (``params``: the folded
    model's state dict on its device), recording per-edge absmax into
    ``records`` (0-dim f32 tensors, fetched by the caller in one copy) and
    conv geometry into ``geoms`` (the contract quant.quantize_params
    consumes)."""

    calib = True

    def __init__(self, params, records, geoms, dtype):
        self.p, self.records, self.geoms, self.dtype = \
            params, records, geoms, dtype

    def _rec(self, key, x):
        self.records[key] = x.abs().amax().float()


class QuantCtxBase:
    """int8-resident forward: activations are (s8 NHWC tensor, Python-float
    scale) pairs between convs; ``pruned`` carries only the un-quantized
    leaves (the classifier head), ``qconv`` the per-conv int8 weights in
    K3's layout (w s8 [Co,kh,kw,Ci], w_scale and bias f32 [Co]; see
    models/torch_port.qconv_from_jax)."""

    calib = False

    def __init__(self, pruned, qconv, absmax, dtype):
        self.p, self.qconv, self.absmax, self.dtype = \
            pruned, qconv, absmax, dtype

    def _scale(self, key):
        return max(float(self.absmax[key]), 1e-12) / 127.0


def make_entrypoints(calib_cls, quant_cls, graph, model_extras):
    """Build the (make_calib_fn, make_quant_predict) pair for one resident
    graph module.

    graph(ctx, images, *extras) runs the family topology under either ctx;
    model_extras(model) -> tuple of the static attributes the graph needs.
    The float dtype is that of the model's parameters."""

    def make_calib_fn(model):
        geoms = {}
        extras = model_extras(model)
        dtype = next(model.parameters()).dtype

        def calib_fn(params, images):
            records = {}
            with torch.inference_mode():
                graph(calib_cls(params, records, geoms, dtype), images,
                      *extras)
            return records

        return calib_fn, geoms

    def make_quant_predict(model, absmax, geoms):
        from .quant import _QUANT_KEY
        extras = model_extras(model)
        dtype = next(model.parameters()).dtype

        def predict(params, images):
            params = dict(params)
            qconv = params.pop(_QUANT_KEY)
            with torch.inference_mode():
                logits = graph(quant_cls(params, qconv, absmax, dtype),
                               images, *extras)
                return torch.softmax(logits, dim=-1)

        return predict

    return make_calib_fn, make_quant_predict
