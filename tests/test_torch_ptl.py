"""The reference's checkpoints and torchvision state dicts in the port
(train/checkpoint._load_lightning_checkpoint, models/torch_port) against
the JAX package's readers, on the CPU.

A reference-format Lightning ``.ptl`` of an inception_v3 (resize 96) is
fabricated as PyTorch-Lightning 1.3 writes one for a NeustonModel: the net's
torchvision keys with the ``model.`` prefix, BN ``num_batches_tracked``,
the aux head, and the TRAIN args as ``hyper_parameters`` (a plain dict,
or Lightning's AttributeDict pickled from a throwaway
``pytorch_lightning.utilities.parsing`` module that is gone at load time).
Both packages read it into equal trees (leaf for leaf, exactly) and equal
hparams; ``load_hparams`` reads it without porting a tensor; a class
outside the unpickler's allowlist is refused, and so is a REDUCE through
``torch.storage._load_from_bytes`` by every loader (the port's allowlist
lists exact names where the JAX package's admits whole torch modules),
while what else Lightning writes still reads; RUN from the ``.ptl`` gives
exactly the scores RUN from the port's own checkpoint of the same weights
gives. ``--weights`` (``load_torch_weights``) fills the trunk exactly as
the JAX package's does and leaves the heads as they were; PORT_WEIGHTS
writes the JAX package's tensors in both directions, exactly.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import ifcb_classifier_tpu.train.checkpoint  # noqa: F401  (JAX on the CPU)
from test_torch_checkpoint import _assert_trees_equal
from test_torch_inception import random_inception_trees

CLASSES = ["a", "b", "c"]
HP = {"MODEL": "inception_v3", "classes": CLASSES, "resize": 96,
      "img_norm": ["0.667", "0.161"], "seed": 11, "model_id": "ptl_twin",
      "pretrained": False, "TRAIN_ID": "ptl_twin", "cmd_mode": "TRAIN",
      "batch_size": 108}


def torchvision_state_dict(n_classes, seed):
    """A torchvision-keyed inception_v3 state dict (aux head and BN
    ``num_batches_tracked`` included) from ``seed``."""
    from ifcb_classifier_tpu_torch.models.torch_port import params_from_jax
    sd = params_from_jax(*random_inception_trees(n_classes, seed=seed))
    for k in [k for k in sd if k.endswith(".bn.running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = \
            torch.tensor(7)
    return sd


def save_reference_ptl(path, sd, hp, attr_dict=False):
    """torch.save what Lightning saves for a NeustonModel: the prefixed
    state dict and the hparams, optionally as an AttributeDict of a module
    that is removed again before anything loads the file."""
    if not attr_dict:
        torch.save({"state_dict": {"model." + k: v for k, v in sd.items()},
                    "hyper_parameters": dict(hp), "epoch": 3}, path)
        return
    names = ("pytorch_lightning", "pytorch_lightning.utilities",
             "pytorch_lightning.utilities.parsing")
    mods = {n: types.ModuleType(n) for n in names}

    class AttributeDict(dict):
        pass

    AttributeDict.__module__ = names[-1]
    AttributeDict.__qualname__ = "AttributeDict"
    mods[names[-1]].AttributeDict = AttributeDict
    sys.modules.update(mods)
    try:
        torch.save({"state_dict": {"model." + k: v for k, v in sd.items()},
                    "hyper_parameters": AttributeDict(hp)}, path)
    finally:
        for n in names:
            sys.modules.pop(n, None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ptl")
    sd = torchvision_state_dict(len(CLASSES), seed=8)
    out = dict(sd=sd)
    for attr in (False, True):
        out[attr] = str(root / f"ref_{int(attr)}.ptl")
        save_reference_ptl(out[attr], sd, HP, attr_dict=attr)
    return out


@pytest.mark.parametrize("attr_dict", [False, True],
                         ids=["dict", "AttributeDict"])
def test_ptl_reads_into_the_jax_trees(files, attr_dict):
    from ifcb_classifier_tpu.train.checkpoint import \
        load_checkpoint as jax_load
    from ifcb_classifier_tpu_torch.train.checkpoint import load_checkpoint
    jp, js, jh = jax_load(files[attr_dict])
    pp, ps, ph = load_checkpoint(files[attr_dict])
    _assert_trees_equal(pp, jax_tree(jp))
    _assert_trees_equal(ps, jax_tree(js))
    assert ph == jh
    assert "AuxLogits" not in pp  # the served model has no aux head
    assert ph["model_id"] == "ptl_twin" and ph["resize"] == 96


def jax_tree(tree):
    """A JAX package's tree (flax FrozenDict or dict, jax or numpy leaves)
    as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: jax_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_allowlist_refuses_a_foreign_class(tmp_path):
    """A pickled class outside the allowlist fails the unpickle in both
    packages; its module is never imported."""
    import pickle

    from ifcb_classifier_tpu.train.checkpoint import \
        load_checkpoint as jax_load
    from ifcb_classifier_tpu_torch.train.checkpoint import (load_checkpoint,
                                                            load_hparams)
    mod = types.ModuleType("ptl_payload")

    class Payload:
        pass

    Payload.__module__ = "ptl_payload"
    Payload.__qualname__ = "Payload"
    mod.Payload = Payload
    sys.modules["ptl_payload"] = mod
    path = str(tmp_path / "evil.ptl")
    try:
        torch.save({"state_dict": {}, "hyper_parameters": Payload()}, path)
    finally:
        sys.modules.pop("ptl_payload")
    for load in (load_checkpoint, load_hparams):
        with pytest.raises(pickle.UnpicklingError, match="not allowlisted"):
            load(path)
    with pytest.raises(Exception, match="not allowlisted"):
        jax_load(path)
    assert "ptl_payload" not in sys.modules


def _loaders():
    """Every way the port unpickles a user's torch file: the unpickler,
    the state-dict reader, RUN/VAL's checkpoint and hparams readers,
    TRAIN --weights and PORT_WEIGHTS."""
    from ifcb_classifier_tpu_torch.models.torch_port import (
        load_state_dict_file, load_torch_weights, tolerant_torch_load)
    from ifcb_classifier_tpu_torch.train.checkpoint import (load_checkpoint,
                                                            load_hparams)
    from ifcb_classifier_tpu_torch.util_cli import main_cli
    return {
        "tolerant_torch_load": tolerant_torch_load,
        "load_state_dict_file": load_state_dict_file,
        "load_checkpoint": load_checkpoint,
        "load_hparams": load_hparams,
        "load_torch_weights": lambda p: load_torch_weights(
            p, "inception_v3", {}),
        "PORT_WEIGHTS": lambda p: main_cli(
            ["PORT_WEIGHTS", p, "-o", p + ".npz"]),
    }


@pytest.mark.parametrize("loader", sorted(_loaders()))
def test_allowlist_refuses_a_reduce_into_torch_load(tmp_path, loader):
    """A .ptl whose hparams REDUCE through torch.storage._load_from_bytes
    (an unrestricted torch.load of the bytes it is given) is refused by
    every loader, and the payload inside those bytes never runs."""
    import io
    import pickle

    marker = str(tmp_path / "payload_ran")

    class Inner:
        def __reduce__(self):
            return os.mkdir, (marker,)

    buf = io.BytesIO()
    torch.save(Inner(), buf)

    class Outer:
        def __reduce__(self):
            return torch.storage._load_from_bytes, (buf.getvalue(),)

    path = str(tmp_path / "evil.ptl")
    # protocol 4 pickles bytes natively (protocol 2 needs _codecs.encode)
    torch.save({"state_dict": {}, "hyper_parameters": Outer()}, path,
               pickle_protocol=4)
    with pytest.raises(pickle.UnpicklingError,
                       match="torch.storage._load_from_bytes is not "
                             "allowlisted"):
        _loaders()[loader](path)
    assert not os.path.exists(marker)


@pytest.mark.parametrize("protocol", [2, 4])
def test_ptl_with_lightning_extras_reads(files, tmp_path, protocol):
    """What else Lightning writes beside the weights reads through the
    exact allowlist: Adam's state, callback states keyed by a Lightning
    class, numpy arrays and scalars, torch dtypes and devices."""
    from ifcb_classifier_tpu_torch.train.checkpoint import load_checkpoint
    names = ("pytorch_lightning", "pytorch_lightning.callbacks")
    mods = {n: types.ModuleType(n) for n in names}

    class ModelCheckpoint:
        pass

    ModelCheckpoint.__module__ = names[-1]
    ModelCheckpoint.__qualname__ = "ModelCheckpoint"
    mods[names[-1]].ModelCheckpoint = ModelCheckpoint
    w = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([w])
    w.sum().backward()
    opt.step()
    ckpt = torch.load(files[False], weights_only=True)
    ckpt.update(
        optimizer_states=[opt.state_dict()],
        callbacks={ModelCheckpoint: {"best_model_score": torch.tensor(0.5),
                                     "monitor": "val_loss"}},
        extras={"mean": np.float64(0.25), "hist": np.arange(4),
                "dtype": torch.bfloat16, "device": torch.device("cpu")})
    path = str(tmp_path / "extras.ptl")
    sys.modules.update(mods)
    try:
        torch.save(ckpt, path, pickle_protocol=protocol)
    finally:
        for n in names:
            sys.modules.pop(n, None)
    p1, s1, h1 = load_checkpoint(files[False])
    p2, s2, h2 = load_checkpoint(path)
    _assert_trees_equal(p2, p1)
    _assert_trees_equal(s2, s1)
    assert h2 == h1


def test_load_hparams_ports_nothing(files, monkeypatch):
    from ifcb_classifier_tpu.train.checkpoint import \
        load_hparams as jax_hparams
    from ifcb_classifier_tpu_torch.models import torch_port
    from ifcb_classifier_tpu_torch.train.checkpoint import load_hparams

    def refuse(*a, **k):
        raise AssertionError("load_hparams ported tensors")

    monkeypatch.setattr(torch_port, "port_state_dict", refuse)
    for attr in (False, True):
        assert load_hparams(files[attr]) == jax_hparams(files[attr])
        assert load_hparams(files[attr])["classes"] == CLASSES


def test_run_from_ptl_equals_run_from_the_port_checkpoint(files, tmp_path):
    """The same weights served from the reference .ptl and from the port's
    own checkpoint give the same scores, gray (K1's path) and RGB (K2's)."""
    from ifcb_classifier_tpu_torch.infer.runner import InferenceEngine
    from ifcb_classifier_tpu_torch.models.torch_port import params_to_jax
    from ifcb_classifier_tpu_torch.train.checkpoint import save_checkpoint
    own = str(tmp_path / "own.ptl")
    save_checkpoint(own, *params_to_jax(
        {k: v for k, v in files["sd"].items()
         if not k.endswith("num_batches_tracked")}), HP)
    rng = np.random.default_rng(3)
    gray = [rng.integers(0, 256, (30, 20), dtype=np.uint8) for _ in range(3)]
    rgb = gray[:1] + [rng.integers(0, 256, (40, 25, 3), dtype=np.uint8)]
    got = []
    for path in (files[True], own):
        eng = InferenceEngine(path, batch_size=4, device="cpu")
        got.append((eng.predict_images(gray), eng.predict_images(rgb),
                    eng.model_id))
    (g1, r1, m1), (g2, r2, m2) = got
    assert m1 == m2 == "ptl_twin"
    assert np.array_equal(g1, g2) and np.array_equal(r1, r2)


def test_weights_trunk_equals_the_jax_port(tmp_path):
    """TRAIN --weights: the trunk from a torchvision .pth (10 classes,
    num_batches_tracked) into a 3-class TRAIN model equals the JAX
    package's load_torch_weights; both heads stay as they were."""
    from ifcb_classifier_tpu.models.torch_port import \
        load_torch_weights as jax_load_weights
    from ifcb_classifier_tpu_torch.models.torch_port import (
        load_torch_weights, params_from_jax, params_to_jax)
    pth = str(tmp_path / "tv.pth")
    torch.save(torchvision_state_dict(10, seed=9), pth)
    params, stats = random_inception_trees(len(CLASSES), seed=1)
    want = jax_load_weights(pth, "inception_v3", params, stats)
    template = params_from_jax(params, stats)
    got = load_torch_weights(pth, "inception_v3", template)
    gp, gs = params_to_jax(got)
    _assert_trees_equal(gp, jax_tree(want["params"]))
    _assert_trees_equal(gs, jax_tree(want["batch_stats"]))
    for k in ("fc.weight", "fc.bias", "AuxLogits.fc.weight"):
        assert torch.equal(got[k], template[k]), k
    src = torch.load(pth)
    assert torch.equal(got["Mixed_7c.branch_pool.conv.weight"],
                       src["Mixed_7c.branch_pool.conv.weight"])


@pytest.mark.parametrize("direction", ["to_npz", "to_pth"])
def test_port_weights_matches_the_jax_util(files, tmp_path, direction):
    """PORT_WEIGHTS: a Lightning .ptl → .npz of torchvision-keyed arrays,
    and a checkpoint → a torchvision-keyed .pth; the same tensors as the
    JAX package's util_cli writes."""
    from ifcb_classifier_tpu.train.checkpoint import \
        save_checkpoint as jax_save
    from ifcb_classifier_tpu.util_cli import main_cli as jax_util
    from ifcb_classifier_tpu_torch.util_cli import main_cli
    if direction == "to_npz":
        src, ext = files[True], ".npz"
    else:
        src, ext = str(tmp_path / "ck.ckpt"), ".pth"
        jax_save(src, *random_inception_trees(len(CLASSES), seed=5), HP)
    outs = {}
    for name, fn in (("jax", jax_util), ("port", main_cli)):
        outs[name] = str(tmp_path / (name + ext))
        fn(["PORT_WEIGHTS", src, "-o", outs[name]])
    if ext == ".npz":
        with np.load(outs["jax"]) as j, np.load(outs["port"]) as p:
            want, got = dict(j), dict(p)
    else:
        want, got = ({k: v.numpy() for k, v in torch.load(outs[n]).items()}
                     for n in ("jax", "port"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k
    if ext == ".npz":
        assert "AuxLogits.fc.weight" in got and not any(
            k.startswith("model.") for k in got)
    assert os.path.getsize(outs["port"]) > 0
