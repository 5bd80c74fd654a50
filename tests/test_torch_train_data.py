"""The port's TRAIN host side against the JAX package on the same inputs:
dataset manifests and splits for one seed, HostLoader batches (canvas,
sizes, labels, mask, indices) for one seed and epoch, decode, the
validation results and the numpy F1/precision/recall/confusion matrix
(against the JAX package and sklearn), and args.yml (read back, the same
keys and values as the JAX package's PyYAML dump).

Everything here is exact (integers, bytes, strings) except the metrics,
which are float64 sums of the same counts: 1e-12.
"""

import argparse
import os
import random

import numpy as np
import pytest

from fixtures import write_image_folder_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds"))
    write_image_folder_dataset(root, {"diatom": 9, "ciliate": 6,
                                      "detritus": 4, "lone": 1},
                               size=(37, 23), seed=1)
    # a larger image, for a second canvas rung
    from PIL import Image
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (150, 90, 3), dtype=np.uint8)).save(
            os.path.join(root, "diatom", "diatom_big.png"))
    return root


def _args(src, **kw):
    base = dict(SRC=src, class_config=None, class_min=2, class_max=None,
                split="80:20", seed=5, swap=False)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kw", [{}, {"swap": True}, {"class_max": 5},
                                {"split": "50:50"}])
def test_manifests_and_split_match_jax(dataset, kw):
    from ifcb_classifier_tpu.data.datasets import get_trainval_datasets as J
    from ifcb_classifier_tpu_torch.data.datasets import (
        get_trainval_datasets as P)
    random.seed(5)
    jt, jv = J(_args(dataset, **kw))
    random.seed(5)
    pt, pv = P(_args(dataset, **kw))
    for a, b in ((jt, pt), (jv, pv)):
        assert a.classes == b.classes
        assert a.images == b.images and a.targets == b.targets
        assert a.count_perclass == b.count_perclass
        assert (a.classes_ignored_from_too_few_samples
                == b.classes_ignored_from_too_few_samples)


def test_tiny_class_split_fails_as_in_jax(dataset):
    """The kept quirk: with --class-min 1 a one-image class lands whole in
    one half and both packages refuse the split."""
    from ifcb_classifier_tpu.data.datasets import get_trainval_datasets as J
    from ifcb_classifier_tpu_torch.data.datasets import (
        get_trainval_datasets as P)
    for fn in (J, P):
        with pytest.raises(AssertionError, match="lone"):
            fn(_args(dataset, class_min=1))


def test_class_config_matches_jax(dataset, tmp_path):
    from ifcb_classifier_tpu.data.datasets import NeustonDataset as J
    from ifcb_classifier_tpu_torch.data.datasets import NeustonDataset as P
    csv = tmp_path / "classes.csv"
    csv.write_text("class,run\ndiatom,1\nciliate,protist\ndetritus,0\n"
                   "lone,protist\n")
    a = J.from_csv(dataset, str(csv), "run")
    b = P.from_csv(dataset, str(csv), "run")
    assert (a.classes, a.images, a.targets) == (b.classes, b.images,
                                                 b.targets)


@pytest.mark.parametrize("mode,shape", [("RGB", (150, 90)),
                                        ("L", (150, 90)),
                                        ("RGB", (1100, 300))])
def test_decode_matches_jax(tmp_path, mode, shape):
    """RGB and gray files both decode to RGB; over MAX_CANVAS, thumbnailed."""
    from PIL import Image
    from ifcb_classifier_tpu.data.pipeline import decode_image as J
    from ifcb_classifier_tpu_torch.data.pipeline import decode_image as P
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 256, shape + ((3,) if mode == "RGB" else ()),
                       dtype=np.uint8)
    path = str(tmp_path / "im.png")
    Image.fromarray(arr).save(path)  # 2-D: mode L
    a, b = J(path), P(path)
    assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    assert b.ndim == 3 and b.shape[2] == 3 and max(b.shape) <= 1024


@pytest.mark.parametrize("kw", [dict(shuffle=True, seed=5),
                                dict(shuffle=False),
                                dict(shuffle=True, seed=5, balanced=True),
                                dict(shuffle=True, seed=5, cache=True),
                                dict(shuffle=True, seed=5, n_real=15),
                                dict(shuffle=True, seed=5, balanced=True,
                                     n_real=15)])
def test_host_loader_batches_match_jax(dataset, kw):
    """items[n_real:] are manifest pads: fed to the model, masked out."""
    from ifcb_classifier_tpu.data.pipeline import HostLoader as J
    from ifcb_classifier_tpu_torch.data.datasets import NeustonDataset
    from ifcb_classifier_tpu_torch.data.pipeline import HostLoader as P
    nd = NeustonDataset(dataset, minimum_images_per_class=1)
    batches = []
    for cls in (J, P):
        loader = cls(nd.images, nd.targets, batch_size=8, num_workers=2,
                     **kw)
        loader._epoch = 1  # the second epoch's order
        batches.append(list(loader))
    assert len(batches[0]) == len(batches[1]) == 3
    for a, b in zip(*batches):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    assert {b["canvas"].shape[1] for b in batches[1]} >= {64}
    n_real = kw.get("n_real", len(nd))
    assert sum(b["mask"].sum() for b in batches[1]) == (
        len(nd) if kw.get("balanced") else n_real)
    if "n_real" not in kw:
        assert batches[1][-1]["mask"].sum() == len(nd) - 16  # a short batch


def test_prefetch_keeps_order_and_raises():
    from ifcb_classifier_tpu_torch.data.pipeline import prefetch
    assert list(prefetch(iter(range(10)))) == list(range(10))

    def boom():
        yield 1
        raise OSError("bad file")
    with pytest.raises(OSError, match="bad file"):
        list(prefetch(boom()))


@pytest.mark.parametrize("labels_arg", [None, "all"])
@pytest.mark.parametrize("average", [None, "macro", "weighted"])
def test_numpy_scores_match_sklearn(labels_arg, average):
    from sklearn import metrics
    from ifcb_classifier_tpu_torch.results.validation import prf_scores
    rng = np.random.default_rng(8)
    y_true = rng.integers(0, 5, 40)
    y_pred = np.where(rng.random(40) < 0.6, y_true, rng.integers(0, 6, 40))
    y_pred[y_pred == 3] = 4  # class 3 never predicted: 0/0 precision
    labels = list(range(7)) if labels_arg else None  # 5, 6: no support
    got = prf_scores(y_true, y_pred, labels=labels, average=average)
    for value, fn in zip(got, (metrics.precision_score, metrics.recall_score,
                               metrics.f1_score)):
        want = fn(y_true, y_pred, labels=labels, average=average,
                  zero_division=0)
        np.testing.assert_allclose(value, want, rtol=0, atol=1e-12)
    cm = metrics.confusion_matrix(y_true, y_pred, labels=list(range(7)))
    from ifcb_classifier_tpu_torch.results.validation import confusion_matrix
    assert np.array_equal(confusion_matrix(y_true, y_pred, range(7)), cm)


def _results_inputs():
    rng = np.random.default_rng(9)
    n, c = 30, 4
    scores = rng.dirichlet(np.ones(c), n).astype(np.float32)
    return dict(class_labels=[f"c{i}" for i in range(c)],
                input_classes=rng.integers(0, c, n),
                output_scores=scores,
                image_fullpaths=[f"/d/c/img_{i}.png" for i in range(n)],
                model_id="m1", timestamp="2026-01-01T00:00:00+00:00",
                counts_perclass=[10, 7, 8, 5], val_counts_perclass=[3, 2, 2, 1],
                train_counts_perclass=[7, 5, 6, 4],
                training_image_fullpaths=[f"/t/x_{i}.png" for i in range(6)],
                training_classes=[0, 1, 2, 3, 0, 1])


SERIES = ("training_image_basenames training_classes image_basenames "
          "image_fullpaths input_classes output_scores output_winscores "
          "confusion_matrix counts_perclass val_counts_perclass "
          "train_counts_perclass f1_perclass f1_weighted f1_macro "
          "recall_perclass recall_weighted recall_macro precision_perclass "
          "precision_weighted precision_macro classes_by_f1 "
          "classes_by_recall classes_by_precision classes_by_count").split()


def test_validation_results_match_jax(tmp_path):
    from ifcb_classifier_tpu.results.validation import (
        compute_validation_results as J)
    from ifcb_classifier_tpu_torch.results.validation import (
        compute_validation_results as P, save_validation_results)
    a = J(SERIES, **_results_inputs())
    b = P(SERIES, **_results_inputs())
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, (float, np.floating)) or (
                isinstance(va, np.ndarray) and va.dtype.kind == "f"):
            np.testing.assert_allclose(vb, va, rtol=0, atol=1e-12,
                                       err_msg=k)
        else:
            assert np.array_equal(np.asarray(va), np.asarray(vb)), k
    for ext in (".json", ".mat"):
        save_validation_results(str(tmp_path / ("r" + ext)), b)
        assert (tmp_path / ("r" + ext)).stat().st_size > 0


def test_args_yml_reads_back_as_the_jax_dump(tmp_path):
    yaml = pytest.importorskip("yaml")
    from ifcb_classifier_tpu.utils.config import dump_args_yml as J
    from ifcb_classifier_tpu_torch.utils.config import dump_args_yml as P
    args = argparse.Namespace(
        MODEL="inception_v3", SRC="/data/set one", split="80:20",
        learning_rate=1e-05, weight_decay=0.0, batch_size=108, seed=0,
        flip=None, pretrained=True, img_norm=["0.667", "0.161"],
        classes=["a", "b:c", "yes", "007", "-x"],
        result_files=[["results.mat", "f1_macro"]], notes="it's \"quoted\"",
        best=float("inf"), version="0.1.0", cmd_mode="TRAIN")
    J(args, tmp_path / "jax.yml")
    P(args, tmp_path / "port.yml")
    want = yaml.safe_load((tmp_path / "jax.yml").read_text())
    got = yaml.safe_load((tmp_path / "port.yml").read_text())
    assert got == want
    assert list(got) == sorted(vars(args))
