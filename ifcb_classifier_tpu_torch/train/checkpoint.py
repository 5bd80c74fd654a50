"""The ``ifcbnn-ckpt-v1`` checkpoint format, read and written without
``msgpack`` or ``flax`` (counterpart of load_checkpoint/save_checkpoint in
ifcb_classifier_tpu/train/checkpoint.py).

A checkpoint is one msgpack map::

    {"format": "ifcbnn-ckpt-v1", "hparams_json": str,
     "params": tree, "batch_stats": tree}

where a tree is nested str-keyed maps with ndarray leaves. An ndarray is
flax's msgpack extension type 1, whose payload is itself the msgpack array
``[shape, dtype name, raw C-order bytes]``. The codec below covers exactly
the msgpack types this format uses: map, array, str, bin, int, float, bool,
nil and ext. (flax splits a leaf over 1 GiB into chunks; no model here has
one.)

The reference's Lightning ``.ptl`` checkpoints (a torch zip) are read too
(``_load_lightning_checkpoint``): the allowlist unpickler of
models/torch_port.py, the net's tensors ported into a zero template of the
model the hparams name, the hparams carried over as the JAX package gives
them.

The resume state ``chkpts/last.state`` (save_train_state) is the port's
own format, deliberately not the JAX package's: the same codec and
params/batch_stats trees, but the optimizer state as torch keeps it
(moments per parameter, keyed by the state-dict name, in torch layout, and
the param groups as JSON) and torch generator states in place of a JAX
PRNG key. Neither package resumes the other's ``last.state``; both read
each other's ``.ckpt``/``.ptl``.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

FORMAT_TAG = "ifcbnn-ckpt-v1"
_EXT_NDARRAY = 1


# ------------------------------------------------------------- msgpack ---

def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(bytes([0xa0 | n]))
        elif n < 1 << 8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        n = len(b)
        if n < 1 << 8:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(b)
    elif isinstance(obj, np.ndarray):
        payload = _packb([list(obj.shape), obj.dtype.name,
                          np.ascontiguousarray(obj).tobytes()])
        n = len(payload)
        if n < 1 << 8:
            out.append(b"\xc7" + struct.pack(">BB", n, _EXT_NDARRAY))
        elif n < 1 << 16:
            out.append(b"\xc8" + struct.pack(">HB", n, _EXT_NDARRAY))
        else:
            out.append(b"\xc9" + struct.pack(">IB", n, _EXT_NDARRAY))
        out.append(payload)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x90 | n]))
        elif n < 1 << 16:
            out.append(b"\xdc" + struct.pack(">H", n))
        else:
            out.append(b"\xdd" + struct.pack(">I", n))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x80 | n]))
        elif n < 1 << 16:
            out.append(b"\xde" + struct.pack(">H", n))
        else:
            out.append(b"\xdf" + struct.pack(">I", n))
        for k in sorted(obj):  # flax writes maps key-sorted (jax tree order)
            _pack(k, out)
            _pack(obj[k], out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def _pack_int(v: int, out: list):
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, lim in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < lim:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(v)
    else:
        for code, fmt, lim in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                               (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -lim:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(v)


def _packb(obj) -> bytes:
    out = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    """Decoder over one buffer; ``raw`` keeps str values as bytes (the
    ndarray payload's dtype name is read that way, as flax does)."""

    def __init__(self, buf, raw=False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def _take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def _unpack(self, fmt, n):
        return struct.unpack(fmt, self._take(n))[0]

    def read(self):
        c = self._take(1)[0]
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self._map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return self._array(c & 0x0f)
        if 0xa0 <= c <= 0xbf:
            return self._str(c & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        lengths = {0xc4: (">B", 1), 0xc5: (">H", 2), 0xc6: (">I", 4)}
        if c in lengths:  # bin; a bytearray, so arrays over it are writable
            return bytearray(self._take(self._unpack(*lengths[c])))
        ext = {0xc7: (">B", 1), 0xc8: (">H", 2), 0xc9: (">I", 4)}
        if c in ext:
            n = self._unpack(*ext[c])
            return self._ext(self._unpack(">b", 1), n)
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if c in fixext:
            return self._ext(self._unpack(">b", 1), fixext[c])
        numbers = {0xca: (">f", 4), 0xcb: (">d", 8),
                   0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4),
                   0xcf: (">Q", 8), 0xd0: (">b", 1), 0xd1: (">h", 2),
                   0xd2: (">i", 4), 0xd3: (">q", 8)}
        if c in numbers:
            return self._unpack(*numbers[c])
        strs = {0xd9: (">B", 1), 0xda: (">H", 2), 0xdb: (">I", 4)}
        if c in strs:
            return self._str(self._unpack(*strs[c]))
        if c in (0xdc, 0xdd):
            return self._array(self._unpack(*((">H", 2) if c == 0xdc
                                              else (">I", 4))))
        if c in (0xde, 0xdf):
            return self._map(self._unpack(*((">H", 2) if c == 0xde
                                            else (">I", 4))))
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def _str(self, n):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _array(self, n):
        return [self.read() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, code, n):
        data = self._take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, raw = _Reader(data, raw=True).read()
        dtype_name = dtype_name.decode()
        if dtype_name == "bfloat16":
            raise ValueError("bfloat16 leaves are not supported; the JAX "
                             "package writes float32 checkpoints")
        return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)


def msgpack_dumps(obj) -> bytes:
    return _packb(obj)


def msgpack_loads(blob):
    r = _Reader(blob)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


# ---------------------------------------------------------- checkpoint ---

def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = str(v)
    return out


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def save_checkpoint(path: str, params, batch_stats, hparams: dict):
    """Write (params, batch_stats) trees — the JAX package's layout
    (models/torch_port.params_to_jax gives it from a state dict) — and the
    hparams dict, atomically (tmp + rename)."""
    payload = {
        "format": FORMAT_TAG,
        "hparams_json": json.dumps(_jsonable(hparams)),
        "params": _numpy_tree(params),
        "batch_stats": _numpy_tree(batch_stats),
    }
    blob = msgpack_dumps(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Returns (params, batch_stats, hparams_dict) as numpy trees, from the
    port's format or a reference Lightning ``.ptl``."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] == b"PK\x03\x04":  # a torch zip
        return _load_lightning_checkpoint(path)
    try:
        payload = msgpack_loads(blob)
    except (ValueError, struct.error, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: not an ifcbnn checkpoint ({e})") from e
    if not (isinstance(payload, dict)
            and payload.get("format") == FORMAT_TAG):
        raise ValueError(f"{path}: not an ifcbnn checkpoint")
    hparams = json.loads(payload["hparams_json"])
    return payload["params"], payload["batch_stats"], hparams


def _read_torch_zip(path: str):
    """The unpickled torch zip at ``path`` through the allowlist loader;
    a zip torch cannot read is a ValueError, a refused class stays the
    unpickler's pickle.UnpicklingError."""
    from ..models.torch_port import tolerant_torch_load
    try:
        return tolerant_torch_load(path)
    except (RuntimeError, EOFError, OSError) as e:
        raise ValueError(f"{path}: a zip but no torch checkpoint ({e})") \
            from e


def _ptl_hparams(ckpt) -> dict:
    hp = ckpt.get("hyper_parameters") or ckpt.get("hparams") or {}
    return hp if isinstance(hp, dict) else vars(hp)  # argparse.Namespace


def _load_lightning_checkpoint(path: str):
    """Port a reference ``.ptl`` Lightning checkpoint to the JAX package's
    trees (its train/checkpoint.py:119-176).

    The reference persists the full TRAIN args namespace as
    hyper_parameters (neuston_models.py:50-54), including the keys RUN
    recovers later: MODEL, classes, resize, img_norm, seed, model_id,
    pretrained (neuston_net.py:62,70,173-174; neuston_data.py:344). The
    net lives at ``self.model``, so its keys carry a ``model.`` prefix.
    Keys the served model lacks (its aux head) are ignored; a tensor it
    needs and the file lacks raises."""
    ckpt = _read_torch_zip(path)
    if not (isinstance(ckpt, dict) and "state_dict" in ckpt):
        raise ValueError(f"{path}: torch file without a state_dict — "
                         "not a Lightning checkpoint")
    hp = _ptl_hparams(ckpt)
    if "MODEL" not in hp or "classes" not in hp:
        raise ValueError(
            f"{path}: Lightning checkpoint lacks MODEL/classes hparams "
            "(is this a NeustonModel .ptl?)")
    import torch

    from ..models import get_namebrand_model, input_size_for
    from ..models.torch_port import (_strip_wrapper, params_to_jax,
                                     port_state_dict)
    model_name = str(hp["MODEL"])
    classes = [str(c) for c in hp["classes"]]
    resize = int(hp.get("resize") or input_size_for(model_name))
    pretrained = bool(hp.get("pretrained", True))
    sd = {k: v for k, v in ckpt["state_dict"].items()
          if k.startswith("model.")}
    model = get_namebrand_model(model_name, len(classes),
                                pretrained=pretrained)
    template = {k: torch.zeros(v.shape) for k, v in
                model.state_dict().items()}
    params, stats = params_to_jax(port_state_dict(
        _strip_wrapper(sd), template, skip_head=False, on_missing="raise"))

    hparams = dict(_jsonable(hp))
    hparams.update(MODEL=model_name, classes=classes, resize=resize,
                   img_norm=hp.get("img_norm"), seed=hp.get("seed"),
                   model_id=hp.get("model_id"), pretrained=pretrained)
    return params, stats, hparams


def load_hparams(path: str) -> dict:
    """The hparams alone, without building the model or porting weights
    (the JAX package's load_hparams): a Lightning ``.ptl`` stops after
    reading ``hyper_parameters``; the port's format parses the one file."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return dict(_jsonable(_ptl_hparams(_read_torch_zip(path))))
    return load_checkpoint(path)[2]


# ------------------------------------------------------- resume state ---

TRAINSTATE_TAG = FORMAT_TAG + "-torch-trainstate"


def save_train_state(path: str, model, optimizer, extra: dict,
                     rng_states: dict):
    """Everything --resume needs, atomically: the model's parameters and
    BN statistics (the JAX layout of save_checkpoint), the optimizer's
    moments and param groups, the torch generator states (name → uint8
    state tensor) and the loop's ``extra`` JSON (epoch, best loss and
    epoch, best checkpoint path, csv rows, seed)."""
    from ..models.torch_port import params_to_jax
    params, stats = params_to_jax(model.state_dict())
    names = {p: n for n, p in model.named_parameters()}
    opt = optimizer.state_dict()
    by_index = dict(enumerate(p for g in optimizer.param_groups
                              for p in g["params"]))
    moments = {names[by_index[i]]: {k: v.detach().cpu().numpy()
                                    for k, v in st.items()}
               for i, st in opt["state"].items()}
    payload = {
        "format": TRAINSTATE_TAG,
        "extra_json": json.dumps(_jsonable(extra)),
        "params": params, "batch_stats": stats,
        "moments": moments,
        "param_groups_json": json.dumps(opt["param_groups"]),
        "rng": {k: v.cpu().numpy() for k, v in rng_states.items()},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_dumps(payload))
    os.replace(tmp, path)


def restore_trainstate_payload(path: str) -> dict:
    """Read a resume state once (--resume peeks its seed before the model
    exists, then hands the same payload to load_train_state)."""
    with open(path, "rb") as f:
        payload = msgpack_loads(f.read())
    if not (isinstance(payload, dict)
            and payload.get("format") == TRAINSTATE_TAG):
        raise ValueError(f"{path}: not a resume state of the port")
    return payload


def load_train_state(path: str, model, optimizer, payload=None):
    """Restore the model and optimizer in place from ``path`` (or a payload
    from restore_trainstate_payload). Returns (extra dict, generator states
    as uint8 tensors)."""
    import torch

    from ..models.torch_port import params_from_jax
    if payload is None:
        payload = restore_trainstate_payload(path)
    sd = params_from_jax(payload["params"], payload["batch_stats"])
    model.load_state_dict(sd, strict=True)
    index = {n: i for i, (n, _) in enumerate(model.named_parameters())}
    optimizer.load_state_dict({
        "state": {index[n]: {k: torch.as_tensor(np.array(v))
                             for k, v in st.items()}
                  for n, st in payload["moments"].items()},
        "param_groups": json.loads(payload["param_groups_json"])})
    rng = {k: torch.as_tensor(np.array(v, np.uint8))
           for k, v in payload["rng"].items()}
    return json.loads(payload["extra_json"]), rng


def peek_train_state_extra(path: str) -> dict:
    """The loop's ``extra`` dict of a resume state, without a model."""
    return json.loads(restore_trainstate_payload(path)["extra_json"])
