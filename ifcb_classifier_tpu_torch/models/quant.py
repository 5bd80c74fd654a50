"""int8 post-training quantization for the inference path (the port's
counterpart of ifcb_classifier_tpu/models/quant.py): ``RUN --precision
int8``.

Scheme (standard symmetric PTQ, as in the JAX package):
  * weights: per-output-channel int8, s_w[co] = absmax(w[..., co]) / 127,
    computed once at the engine's swap from the BN-FOLDED conv weights;
  * activations: per-tensor int8 with scales calibrated from real data
    (absmax of every conv's input and output over the first batch(es) the
    engine sees, or over a pinned sample, ``--calib``);
  * every conv (the stem included) runs s8 x s8 into s32 with the
    dequantize, bias, relu and requantize fused into kernel K3
    (ops/qconv.py); the classifier head stays in the float dtype.

The port runs the int8-RESIDENT graph of inception_v3
(models/quant_graph.py). The JAX package's generic interceptor graph (its
``IFCBNN_QUANT_RESIDENT=0`` A/B lever) is not ported, and the resnet and vgg
resident graphs come with those families (ROADMAP P7).
"""

from __future__ import annotations

import numpy as np

__all__ = ["supports_quant", "quantize_params", "make_calib_fn",
           "make_quant_predict"]

_QUANT_KEY = "__quant__"

# the JAX package's list (models/quant.py:46-48): families whose folded
# graphs are plain conv stacks; every one of them folds in the JAX package
# (the port builds inception_v3 only; the others raise at model build,
# ROADMAP P7)
_QUANT_FAMILIES = ("inception_v3", "resnet18", "resnet34", "resnet50",
                   "resnet101", "resnet152", "vgg11_bn", "vgg13_bn",
                   "vgg16_bn", "vgg19_bn")


def supports_quant(model_name: str) -> bool:
    return model_name in _QUANT_FAMILIES


def _residency_module(model):
    """The hand-built int8-resident graph of the model's family."""
    from .inception import InceptionV3
    if isinstance(model, InceptionV3) and model.fold:
        from . import quant_graph
        return quant_graph
    raise NotImplementedError(
        f"the int8 graph of a {type(model).__name__} (folded: "
        f"{getattr(model, 'fold', False)}) is not ported yet (ROADMAP P7)")


def make_calib_fn(model):
    """(calib_fn, geoms): calib_fn(params, images) runs the float forward
    of the folded ``model`` (``params``: its state dict on its device;
    images NHWC) and returns {'<path>:in'|'<path>:out': 0-dim f32 absmax
    tensor}; ``geoms`` fills with each conv's strides and padding."""
    return _residency_module(model).make_calib_fn(model)


def make_quant_predict(model, absmax, geoms):
    """predict(params, images) -> f32 probabilities, every conv in int8:
    ``params`` holds the head's leaves ('fc.weight', 'fc.bias') and the
    per-conv int8 leaves in K3's layout under '__quant__'."""
    return _residency_module(model).make_quant_predict(model, absmax, geoms)


def quantize_params(state_dict, geoms):
    """Split a folded state dict into (pruned, qconv), with the JAX
    package's float32 numpy arithmetic (models/quant.py:148-171).

    qconv['<path>'] = {w_int8 [kh,kw,ci,co] (HWIO, the JAX package's
    layout), w_scale f32[co], bias f32[co]}; the conv weights and biases
    are REMOVED from ``pruned``. Weight scales are per-output-channel
    absmax/127; activation scales live in the predict fn."""
    qconv = {}
    pruned = dict(state_dict)
    for path in sorted(geoms):
        name = ".".join(path)
        w = state_dict[name + ".weight"].detach().cpu().float().numpy()
        w = np.ascontiguousarray(w.transpose(2, 3, 1, 0), np.float32)
        w_scale = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-12) / 127.0
        w_int8 = np.clip(np.rint(w / w_scale), -127, 127).astype(np.int8)
        b = state_dict.get(name + ".bias")
        bias = (np.zeros(w.shape[-1], np.float32) if b is None else
                b.detach().cpu().float().numpy().astype(np.float32))
        qconv["/".join(path)] = dict(w_int8=w_int8,
                                     w_scale=w_scale.astype(np.float32),
                                     bias=bias)
        pruned.pop(name + ".weight", None)
        pruned.pop(name + ".bias", None)
    return pruned, qconv
