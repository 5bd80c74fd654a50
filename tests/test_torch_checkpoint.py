"""The port's ifcbnn-ckpt-v1 codec (ifcb_classifier_tpu_torch/train/
checkpoint.py, no msgpack or flax) against the JAX package's
(flax.serialization): each reads what the other writes, leaf-exact, and
params_to_jax inverts params_from_jax exactly."""

import numpy as np
import pytest

from test_torch_inception import random_inception_trees

HPARAMS = dict(MODEL="inception_v3", classes=["a", "b", "c"], resize=96,
               model_id="m", seed=3, img_norm=["0.667", "0.161"],
               pretrained=False, batch_size=108, learning_rate=0.001,
               notes=None, flip="xy")


@pytest.fixture(scope="module")
def trees():
    return random_inception_trees(3, seed=2)


def _assert_trees_equal(a, b):
    assert isinstance(a, dict) and isinstance(b, dict)
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert np.array_equal(x, y), k


def test_port_reads_jax_checkpoint(trees, tmp_path):
    from ifcb_classifier_tpu.train.checkpoint import save_checkpoint
    from ifcb_classifier_tpu_torch.train.checkpoint import load_checkpoint
    params, stats = trees
    path = str(tmp_path / "jax.ptl")
    save_checkpoint(path, params, stats, HPARAMS)
    p, s, hp = load_checkpoint(path)
    _assert_trees_equal(p, params)
    _assert_trees_equal(s, stats)
    assert hp == HPARAMS


def test_jax_reads_port_checkpoint(trees, tmp_path):
    from ifcb_classifier_tpu.train.checkpoint import load_checkpoint
    from ifcb_classifier_tpu_torch.train.checkpoint import save_checkpoint
    params, stats = trees
    path = str(tmp_path / "port.ptl")
    save_checkpoint(path, params, stats, HPARAMS)
    p, s, hp = load_checkpoint(path)
    _assert_trees_equal(p, params)
    _assert_trees_equal(s, stats)
    assert hp == HPARAMS


def test_port_bytes_equal_flax_bytes(trees):
    """The encoder emits the same bytes as flax.serialization for the
    checkpoint payload, so the two formats cannot drift apart."""
    import flax.serialization
    from ifcb_classifier_tpu_torch.train.checkpoint import msgpack_dumps
    params, stats = trees
    payload = {"format": "ifcbnn-ckpt-v1", "hparams_json": "{}",
               "params": params, "batch_stats": stats, "n": -5, "big": 70000,
               "f": 0.25, "t": True, "none": None, "l": [1, "x", -200]}
    assert msgpack_dumps(payload) == flax.serialization.msgpack_serialize(
        payload)


def test_state_dict_round_trip(trees):
    from ifcb_classifier_tpu_torch.models.torch_port import (
        params_from_jax, params_to_jax)
    params, stats = trees
    p, s = params_to_jax(params_from_jax(params, stats))
    _assert_trees_equal(p, params)
    _assert_trees_equal(s, stats)


def test_rejects_other_files(tmp_path):
    from ifcb_classifier_tpu_torch.train.checkpoint import load_checkpoint
    bad = tmp_path / "x.ptl"
    bad.write_bytes(b"\x81\xa6format\xa3bad")
    with pytest.raises(ValueError, match="not an ifcbnn checkpoint"):
        load_checkpoint(str(bad))
    bad.write_bytes(b"\x81\xa6format")  # truncated
    with pytest.raises(ValueError, match="not an ifcbnn checkpoint"):
        load_checkpoint(str(bad))
    bad.write_bytes(b"PK\x03\x04rest")  # a zip that is no Lightning file
    with pytest.raises(ValueError, match="no torch checkpoint"):
        load_checkpoint(str(bad))
