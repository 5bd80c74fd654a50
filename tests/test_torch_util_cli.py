"""The port's utility CLI (python -m ifcb_classifier_tpu_torch.util_cli)
against the JAX package's (ifcb_classifier_tpu/util_cli.py), on the CPU.

MAKE_DATASET_CONFIG and MAKE_CLASS_CONFIG write byte-identical files (to a
file and to stdout). CALC_IMG_NORM (the port: the RGB preprocess without a
norm, K2's plain version on the CPU, then the masked joint mean/std of
each batch) agrees with the JAX package's within 1e-6 at --resize 299 and
224: both average per-batch statistics of the same f32 images, which the
two preprocesses produce within ≈1e-6 of each other (values in [0, 1]).
PORT_WEIGHTS is held in tests/test_torch_ptl.py.
"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

import ifcb_classifier_tpu.util_cli  # noqa: F401  (JAX on the CPU)
from fixtures import write_image_folder_dataset
from test_torch_val import write_labeled_tree

TOL_NORM = 1e-6


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    a = write_image_folder_dataset(str(root / "a"), {"x": 1, "y": 1, "z": 1})
    b = write_image_folder_dataset(str(root / "b"), {"y": 1, "w": 1})
    return str(a), str(b), str(root)


def _both(argv, outdir):
    """Run argv through both CLIs; returns {package: (file bytes or None,
    stdout)} with ``-o`` pointed into ``outdir`` when argv asks for one."""
    from ifcb_classifier_tpu.util_cli import main_cli as jax_cli
    from ifcb_classifier_tpu_torch.util_cli import main_cli
    out = {}
    for name, fn in (("jax", jax_cli), ("port", main_cli)):
        path = os.path.join(outdir, name + ".csv")
        args = [a.replace("OUT", path) for a in argv]
        buf = io.StringIO()
        with redirect_stdout(buf):
            fn(args)
        data = open(path, "rb").read() if "OUT" in argv else None
        out[name] = (data, buf.getvalue())
    return out


@pytest.mark.parametrize("case", ["dataset_file", "dataset_stdout",
                                  "class_dir", "class_csv"])
def test_make_configs_are_byte_identical(datasets, tmp_path, case):
    a, b, root = datasets
    if case.startswith("dataset"):
        argv = ["MAKE_DATASET_CONFIG", a, "1:" + b]
    elif case == "class_dir":
        argv = ["MAKE_CLASS_CONFIG", a]
    else:
        cfg = os.path.join(root, "cfg.csv")
        with open(cfg, "w") as f:
            f.write(",1:a,2:b\nw,0,1\nx,1,0\ny,0,0\n")
        argv = ["MAKE_CLASS_CONFIG", cfg]
    if not case.endswith("stdout"):
        argv += ["-o", "OUT"]
    got = _both(argv, str(tmp_path))
    assert got["port"] == got["jax"]
    assert (got["port"][0] or got["port"][1].encode()).count(b"\n") >= 3


@pytest.fixture(scope="module")
def norm_tree(tmp_path_factory):
    """Mixed RGB/gray PNGs in three classes (7 images, batches of 3)."""
    return write_labeled_tree(str(tmp_path_factory.mktemp("norm")))


@pytest.mark.parametrize("resize", [299, 224])
def test_calc_img_norm_matches(norm_tree, resize):
    from ifcb_classifier_tpu.util_cli import argparse_util as jax_parser
    from ifcb_classifier_tpu.util_cli import calc_img_norm as jax_norm
    from ifcb_classifier_tpu_torch.util_cli import main_cli
    argv = ["CALC_IMG_NORM", norm_tree, "--resize", str(resize),
            "--batch-size", "3", "--class-min", "1"]
    with redirect_stdout(io.StringIO()):
        want = jax_norm(jax_parser().parse_args(argv))
        got = main_cli(argv, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3,)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_NORM)
    assert 0.2 < float(got[0][0]) < 0.8 and float(got[1][0]) > 0.1


def test_calc_img_norm_needs_a_card_unless_the_cpu_is_asked_for(norm_tree,
                                                               monkeypatch):
    import torch
    from ifcb_classifier_tpu_torch.util_cli import main_cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        main_cli(["CALC_IMG_NORM", norm_tree])
