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

Torchvision state dicts (a ``.pth``, an ``.npz`` of torch-keyed arrays, or
the reference's Lightning ``.ptl``) are read by ``load_state_dict_file``
(the JAX package's ``_load_state_dict``) through ``tolerant_torch_load``,
and ``port_state_dict`` fills the port's modules from one: since the
port's names are torchvision's, that is a key-by-key copy with shape
checks, the heads (``fc.``, ``AuxLogits.fc.``) left as they are when
seeding TRAIN (``--weights``), any missing tensor an error when reading a
checkpoint.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "qconv_from_jax",
           "tolerant_torch_load", "load_state_dict_file", "port_state_dict",
           "load_torch_weights"]

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
    the port's state dict of float32 tensors: torchvision's keys and
    layouts, so also the JAX package's export_state_dict for
    inception_v3 (PORT_WEIGHTS to a .pth)."""
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


# The torch._utils functions that rebuild a dense tensor or parameter
# (what torch.save writes for a state dict, its optimizer state and its
# Lightning callbacks' tensors).
_REBUILDERS = ("_rebuild_tensor", "_rebuild_tensor_v2", "_rebuild_tensor_v3",
               "_rebuild_parameter", "_rebuild_parameter_with_state")


def _checkpoint_globals() -> dict:
    """(module, name) → object: every global a checkpoint may name, each
    pair listed exactly. torch's tensor rebuilders, storage classes,
    dtypes, Size and device; numpy's array and scalar reconstruction
    (both its 1.x ``numpy.core`` and 2.x ``numpy._core`` paths);
    ``_codecs.encode``, through which pickle protocol 2 (torch.save's
    default) writes bytes; and the stdlib containers. No module is taken
    whole: ``torch.storage._load_from_bytes`` or ``torch.serialization``'s
    own load and save would reopen an unrestricted unpickle."""
    import _codecs
    import argparse
    import collections
    import importlib

    import torch._utils

    out = {("collections", "OrderedDict"): collections.OrderedDict,
           ("collections", "defaultdict"): collections.defaultdict,
           ("argparse", "Namespace"): argparse.Namespace,
           ("_codecs", "encode"): _codecs.encode,
           ("torch", "Size"): torch.Size,
           ("torch", "device"): torch.device,
           ("torch", "dtype"): torch.dtype,
           ("torch", "Tensor"): torch.Tensor}
    for name in _REBUILDERS:
        out["torch._utils", name] = getattr(torch._utils, name)
    for name, obj in vars(torch).items():
        if isinstance(obj, torch.dtype):
            out["torch", name] = obj
        elif (name.endswith("Storage") and not name.startswith("_")
              and isinstance(obj, type)):
            out["torch", name] = obj
    try:
        multiarray = importlib.import_module("numpy._core.multiarray")
    except ImportError:  # numpy 1.x
        multiarray = importlib.import_module("numpy.core.multiarray")
    for core in ("numpy.core.multiarray", "numpy._core.multiarray"):
        out[core, "_reconstruct"] = multiarray._reconstruct
        out[core, "scalar"] = multiarray.scalar
    out["numpy", "ndarray"] = np.ndarray
    out["numpy", "dtype"] = np.dtype
    return out


def tolerant_torch_load(path: str):
    """torch.load that reads the reference's Lightning checkpoints without
    pytorch_lightning: its AttributeDict (a plain dict subclass) pickled
    into hyper_parameters, and any other Lightning class, is mapped back
    to dict at unpickle time (the JAX package's models/torch_port.py:28-81).

    ``weights_only=True`` rejects those pickled hparams objects, and this
    loader must not reopen the arbitrary-code-execution hole that closes:
    find_class resolves only the exact (module, name) pairs of
    ``_checkpoint_globals``, never a whole module. Anything else fails the
    unpickle (pickle.UnpicklingError) instead of importing attacker-chosen
    code. The JAX package's allowlist admits all of ``torch.storage`` and
    ``torch.serialization``, whose ``_load_from_bytes`` is a plain
    ``torch.load``; the port departs from it there on purpose."""
    import inspect
    import pickle
    import types

    allowed = _checkpoint_globals()

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] in ("pytorch_lightning", "lightning"):
                return dict  # AttributeDict et al. -> plain dict
            if (module, name) in allowed:
                return allowed[module, name]
            raise pickle.UnpicklingError(
                f"{module}.{name} is not allowlisted for checkpoint "
                "unpickling (refusing to execute arbitrary classes from "
                "an untrusted model file)")

    shim = types.ModuleType("_ptl_pickle_shim")
    shim.Unpickler = _Unpickler
    shim.load = lambda f, **kw: _Unpickler(f, **kw).load()
    kwargs = {}
    if "weights_only" in inspect.signature(torch.load).parameters:
        kwargs["weights_only"] = False  # the allowlist above is the guard
    return torch.load(path, map_location="cpu", pickle_module=shim, **kwargs)


def _strip_wrapper(sd) -> dict:
    """A Lightning checkpoint's (or a module's) state dict with the
    reference's ``model.`` prefix stripped (NeustonModel wraps the net at
    self.model, neuston_models.py:56), as numpy arrays."""
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def load_state_dict_file(path: str) -> dict:
    """A torchvision-keyed state dict of numpy arrays from a ``.npz``, a
    ``.pth`` or a Lightning ``.ptl`` (the JAX package's _load_state_dict):
    ``weights_only`` torch.load first, the allowlist loader for the
    pickled hparams objects of a Lightning file."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return dict(z)
    import pickle
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # a Lightning .ptl: weights_only
        sd = tolerant_torch_load(path)  # refuses its pickled hparams
    return _strip_wrapper(sd)


def _is_head(key: str) -> bool:
    """The layers the reference re-sizes for a new class set
    (neuston_models.py:24-42): inception's fc and its aux fc."""
    return key.startswith(("fc.", "AuxLogits.fc."))


def port_state_dict(state_dict: dict, template: dict, skip_head=True,
                    on_missing="warn") -> dict:
    """The port's state dict ``template`` (name → tensor) with every tensor
    that ``state_dict`` (torchvision keys, numpy or torch values) holds
    copied in as float32, checked for shape; ``num_batches_tracked`` and
    keys the template lacks (an aux head the served model has none of)
    are ignored. ``skip_head`` keeps the template's heads (the fresh
    classifier of ``TRAIN --weights``). A tensor missing from
    ``state_dict`` is kept from the template with a printed note
    (``on_missing="warn"``) or raises (``"raise"``: a checkpoint, whose
    template is zeros)."""
    out, missing, ported = {}, [], 0
    for key, leaf in template.items():
        if skip_head and _is_head(key):
            out[key] = leaf
            continue
        if key not in state_dict:
            missing.append(key)
            out[key] = leaf
            continue
        t = torch.as_tensor(np.asarray(state_dict[key], np.float32))
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(
                f"torch_port: {key} shape mismatch ({tuple(t.shape)} vs the "
                f"model's {tuple(leaf.shape)}) — wrong variant's weights? "
                "Refusing a silent partial port")
        out[key] = t
        ported += 1
    if missing:
        if on_missing == "raise":
            raise ValueError(
                f"torch_port: {len(missing)} of the model's tensors have no "
                f"source key in the state_dict (first few: {missing[:5]}) "
                "— refusing a partial port")
        print(f"torch_port: {len(missing)} keys not found in state_dict "
              f"(first few: {missing[:5]})")
    print(f"torch_port: ported {ported} tensors")
    return out


def load_torch_weights(path: str, family: str, template: dict) -> dict:
    """TRAIN --weights: ``template`` (the fresh model's state dict) with
    its trunk read from the torchvision state dict at ``path``; the heads
    stay fresh."""
    if family != "inception_v3":
        raise NotImplementedError(f"--weights for {family!r} is not ported "
                                  "yet (ROADMAP P7: the other families)")
    return port_state_dict(load_state_dict_file(path), template)
