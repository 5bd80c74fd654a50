"""VAL of the port (train/evaluate.do_validation on the CPU) against the
JAX package's VAL, on the same labeled folder tree and the same
inception_v3 checkpoint as tests/test_torch_run.py (resize 96, image norm;
VAL keeps the BNs unfolded, as TRAIN's validation does).

The tree mixes RGB and gray (mode L) PNGs in the checkpoint's classes.
Paths, classes and F1 must be equal; scores agree within 1e-5 (the
tolerance of tests/test_torch_run.py: the same f32 arithmetic in other
orders), val_loss within 1e-5 relative (a sum of per-batch mean
cross-entropies of those scores). Also: --class-config maps folder names
onto the checkpoint's classes, an unknown class and an empty SRC fail
before any inference, and ``{epoch}`` in a result-file name renders as
``VAL``.
"""

import argparse
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

import ifcb_classifier_tpu.train.evaluate  # noqa: F401  (JAX on the CPU)
from test_torch_run import CLASSES, ckpt  # noqa: F401

ATOL_SCORES = 1e-5
RTOL_LOSS = 1e-5
BATCH = 4
PER_CLASS = {"c0": 3, "c1": 2, "c3": 2}  # c2 absent: zero rows, zero counts


def write_labeled_tree(root, per_class=PER_CLASS, seed=0):
    """Folder-per-class PNGs, every third one gray, sides 8..60."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    k = 0
    for cls, n in per_class.items():
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i in range(n):
            h, w = (int(v) for v in rng.integers(8, 61, 2))
            shape, mode = ((h, w), "L") if k % 3 == 1 else ((h, w, 3), None)
            Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8),
                            mode).save(os.path.join(root, cls, f"{i}.png"))
            k += 1
    return root


def _args(src, ckpt, outdir, **kw):
    args = argparse.Namespace(
        cmd_mode="VAL", SRC=src, MODEL=ckpt, VAL_ID="v1", outdir=outdir,
        class_config=None, class_min=1, class_max=None, batch_size=BATCH,
        loaders=2, args_log="args.yml",
        result_files=[["val_results.json"], ["r_{epoch}.json",
                                              "output_scores"]],
        cmd_timestamp="2026-08-16T00:00:00+00:00")
    vars(args).update(kw)
    return args


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_labeled_tree(str(tmp_path_factory.mktemp("val_ds")))


@pytest.fixture(scope="module")
def runs(ckpt, tree, tmp_path_factory):  # noqa: F811
    """Both VALs once: {package: (outdir, returned metrics)}."""
    from ifcb_classifier_tpu.train.evaluate import \
        do_validation as jax_validation
    from ifcb_classifier_tpu_torch.train.evaluate import do_validation
    out = {}
    for name in ("jax", "port"):
        outdir = str(tmp_path_factory.mktemp(name))
        with redirect_stdout(io.StringIO()):
            if name == "jax":
                res = jax_validation(_args(tree, ckpt, outdir))
            else:
                res = do_validation(_args(tree, ckpt, outdir), device="cpu")
        out[name] = (outdir, res)
    return out


def _load(outdir, name="val_results.json"):
    with open(os.path.join(outdir, name)) as f:
        return json.load(f)


def test_val_results_match(runs):
    j, p = (_load(runs[k][0]) for k in ("jax", "port"))
    assert sorted(p) == sorted(j)
    for key in ("class_labels", "image_basenames", "input_classes",
                "counts_perclass", "confusion_matrix", "f1_perclass",
                "f1_weighted", "f1_macro", "model_id", "timestamp"):
        assert p[key] == j[key], key
    assert p["class_labels"] == CLASSES
    assert p["counts_perclass"] == [3, 2, 0, 2]
    sj, sp = np.asarray(j["output_scores"]), np.asarray(p["output_scores"])
    assert sp.shape == sj.shape == (7, len(CLASSES))
    np.testing.assert_allclose(sp, sj, rtol=0, atol=ATOL_SCORES)
    top2 = np.sort(sj, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * ATOL_SCORES
    assert np.array_equal(np.asarray(p["output_classes"])[clear],
                          np.asarray(j["output_classes"])[clear])


def test_val_loss_and_f1_match(runs):
    (_, j), (_, p) = runs["jax"], runs["port"]
    assert p["n_images"] == j["n_images"] == 7
    assert abs(p["val_loss"] - j["val_loss"]) <= RTOL_LOSS * abs(j["val_loss"])
    assert p["f1_weighted"] == pytest.approx(j["f1_weighted"], abs=1e-12)
    assert p["f1_macro"] == pytest.approx(j["f1_macro"], abs=1e-12)


def test_epoch_renders_as_val(runs):
    for name in ("jax", "port"):
        outdir = runs[name][0]
        assert sorted(os.listdir(outdir)) == [
            "args.yml", "r_VAL.json", "val_results.json",
            "validation_images.list"]
    assert _load(runs["port"][0], "r_VAL.json").keys() == \
        _load(runs["jax"][0], "r_VAL.json").keys()


def test_class_config_maps_folders(ckpt, tmp_path):  # noqa: F811
    """Folder names that are not the checkpoint's are mapped onto its
    classes by --class-config (TRAIN's semantics): the labels land on the
    checkpoint's indices."""
    from ifcb_classifier_tpu_torch.train.evaluate import do_validation
    src = write_labeled_tree(str(tmp_path / "ds"),
                             {"zero": 3, "one": 2, "c3": 2})
    cfg = tmp_path / "cfg.csv"
    cfg.write_text("src,map\nzero,c0\none,c1\nc3,c3\n")
    outdir = str(tmp_path / "o")
    with redirect_stdout(io.StringIO()):
        res = do_validation(_args(src, ckpt, outdir, class_config=[
            str(cfg), "map"]), device="cpu")
    got = _load(outdir)
    assert res["n_images"] == 7
    assert sorted(set(got["input_classes"])) == [0, 1, 3]
    assert got["counts_perclass"] == [3, 2, 0, 2]


@pytest.mark.parametrize("case", ["unknown_class", "empty_src"])
def test_refuses_before_inference(ckpt, tmp_path, case):  # noqa: F811
    from ifcb_classifier_tpu_torch.train.evaluate import do_validation
    if case == "unknown_class":
        src = write_labeled_tree(str(tmp_path / "ds"), {"c0": 1, "mystery": 1})
        match = "not in the checkpoint's class list"
    else:
        src = str(tmp_path / "ds")
        os.makedirs(src)
        match = "no images to evaluate"
    with pytest.raises(ValueError, match=match):
        do_validation(_args(src, ckpt, str(tmp_path / "o")), device="cpu")
    assert not os.path.exists(tmp_path / "o" / "val_results.json")
