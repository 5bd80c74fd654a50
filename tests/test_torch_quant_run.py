"""RUN --precision int8 of the port (its InferenceEngine on the CPU)
against the JAX package's, on the same bins and the same inception_v3
checkpoint (resize 96, with an image norm; both engines fold its BNs, then
calibrate, quantize and swap to their int8-resident graphs).

The first bin in run order holds fewer ROIs than the batch, so both engines
calibrate on a dispatch padded to the full batch (zero canvases, sizes
(1,1)), as the JAX engine does; then a schema-2 bin on two canvas rungs and
a schema-1 bin (stitched triggers, served through predict_images).

Tolerances: the absmax the two engines calibrate agree within 1e-5
relative (the float convs sum in other orders; measured 3.1e-6); class
lists, roi numbers and every argmax are identical. Scores agree within
ATOL_SCORES = 5e-2, the size of the int8 tier's own error on this
checkpoint, not tighter: the two packages' float preprocess differs by
~1e-7, so a few stem inputs land one s8 step apart, and through 94
requantized layers of this untrained net with a 10x head (the scores sit
near 0.93) those steps grow into another draw of the same quantization
noise. Measured: port against JAX 3.5e-2, while each package's int8 is
2.2e-2 (JAX) and 3.0e-2 (port) from its own fp32 scores on the same bin;
fed the same images and the same scales the two graphs agree to 3.2e-7
on the first batch of the second bin (every conv's output equal), and
within 1.3e-3 on tests/test_torch_quant.py's images.
TOL_INT8_VS_FP32 = 5e-2 for the same reason (the JAX package's 2e-2 gate
is held on its seed-0 checkpoint in tests/test_torch_quant.py and on the
card by chip_smoke.py).
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from fixtures import make_roi, write_bin, write_image_folder_dataset
from test_torch_inception import random_inception_trees

ATOL_SCORES = 5e-2
RTOL_ABSMAX = 1e-5
TOL_INT8_VS_FP32 = 5e-2
BATCH = 8
CLASSES = ["c0", "c1", "c2", "c3"]
SMALL, V2, V1 = ("D20240101T000000_IFCB900", "D20240102T000000_IFCB900",
                 "IFCB1_2010_001_000000")


def _save(path, model_name, trees):
    from ifcb_classifier_tpu.train.checkpoint import save_checkpoint
    save_checkpoint(path, *trees,
                    dict(MODEL=model_name, classes=CLASSES, resize=96,
                         model_id="incep", seed=1,
                         img_norm=["0.667", "0.161"], pretrained=False))
    return path



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six test
    processes on eight cores, and the CPU int8 path's float64
    convolutions slow down many times over when every process spreads
    them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def trees():
    return random_inception_trees(len(CLASSES), seed=4)


@pytest.fixture(scope="module")
def ckpt(trees, tmp_path_factory):
    return _save(str(tmp_path_factory.mktemp("ck") / "incep.ptl"),
                 "inception_v3", trees)


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bins"))
    write_bin(root, SMALL, [make_roi(20, 24, 1), make_roi(33, 12, 2),
                            make_roi(60, 50, 3)], 2)
    shapes = [(16, 20), (10, 10), (64, 30), (5, 60), (33, 33), (20, 7),
              (60, 64), (12, 40), (50, 50), (70, 40), (100, 120), (128, 90)]
    write_bin(root, V2, [make_roi(h, w, 10 + k) for k, (h, w) in
                         enumerate(shapes)], 2)
    write_bin(root, V1, [make_roi(20, 30, 1), make_roi(20, 25, 2),
                         make_roi(40, 40, 3), make_roi(15, 90, 4)], 1,
              trigger_of=[1, 1, 2, 3])
    return root


def _args(src, ckpt, outdir, **extra):
    args = argparse.Namespace(
        cmd_mode="RUN", SRC=src, MODEL=ckpt, RUN_ID="r",
        batch_size=BATCH, loaders=1, src_type="bin", outdir=outdir,
        outfile=["{BIN_ID}.json"], filter=None, clobber=False, gobig=False,
        precision="int8", cmd_timestamp="2026-08-16T00:00:00+00:00")
    vars(args).update(extra)
    return args


@pytest.fixture(scope="module")
def runs(ckpt, bins, tmp_path_factory):
    """Both int8 RUNs over the bins, once: {package: (outdir, engine)}."""
    import io
    from contextlib import redirect_stdout

    from ifcb_classifier_tpu.infer import runner as jax_runner
    from ifcb_classifier_tpu_torch.infer import runner
    out = {}
    for name, mod in (("jax", jax_runner), ("port", runner)):
        outdir = str(tmp_path_factory.mktemp(name))
        args = _args(bins, ckpt, outdir)
        engine = mod.InferenceEngine.from_args(args) if name == "jax" \
            else mod.InferenceEngine.from_args(args, device="cpu")
        with redirect_stdout(io.StringIO()):
            mod.do_run(args, engine=engine)
        out[name] = (outdir, engine)
    return out


def _close_absmax(got, want):
    assert set(got) == set(want) and len(got) == 2 * 94
    for k, v in want.items():
        assert abs(got[k] - v) <= RTOL_ABSMAX * v, k


def test_lazy_calibration_matches_jax(runs):
    """Both engines calibrated on the small bin's padded dispatch, once,
    and served every dispatch after it in int8."""
    port, jax_eng = runs["port"][1], runs["jax"][1]
    assert port._quant_ready and jax_eng._quant_ready
    assert port._calib_seen == jax_eng._calib_seen == 1
    _close_absmax(port._calib_absmax, jax_eng._calib_absmax)
    assert port.int8_dispatches == port.dispatches > 1


@pytest.mark.parametrize("pid", [SMALL, V2, V1])
def test_int8_json_results_match(runs, pid):
    res = {}
    for name, (outdir, _) in runs.items():
        with open(os.path.join(outdir, pid + ".json")) as f:
            res[name] = json.load(f)
    j, p = res["jax"], res["port"]
    for key in ("version", "model_id", "bin_id", "class_labels",
                "roi_numbers", "output_classes"):
        assert p[key] == j[key], key
    sj = np.asarray(j["output_scores"])
    sp = np.asarray(p["output_scores"])
    assert sp.shape == sj.shape == (len(j["roi_numbers"]), len(CLASSES))
    np.testing.assert_allclose(sp, sj, rtol=0, atol=ATOL_SCORES)


def test_small_bin_calibrates_on_the_padded_batch(ckpt, bins):
    """The absmax of a dispatch smaller than the batch covers its pad rows
    (zero canvases, sizes (1,1)): equal to a calibration pass over the
    padded batch, not to one over the real rows alone."""
    from ifcb_classifier_tpu_torch.data.ifcb import Bin
    from ifcb_classifier_tpu_torch.data.pipeline import pack_canvas_batch
    from ifcb_classifier_tpu_torch.infer.runner import InferenceEngine
    from ifcb_classifier_tpu_torch.ops.preprocess import preprocess_gray
    eng = InferenceEngine(ckpt, batch_size=BATCH, device="cpu", quant=True)
    b = Bin(os.path.join(bins, SMALL + ".adc"))
    eng.predict_bin(b)
    rois = list(b.images.values())
    mean, std = eng._mean_std

    def absmax(batch):
        canvas, sizes, _ = pack_canvas_batch(rois, batch_size=batch)
        x = preprocess_gray(torch.from_numpy(canvas),
                            torch.from_numpy(sizes), out_size=96,
                            mean=mean, std=std)
        return eng._absmax(x)

    assert eng._calib_absmax == absmax(BATCH)
    unpadded = absmax(len(rois))
    assert any(unpadded[k] != v for k, v in eng._calib_absmax.items())


def test_calib_batches_accumulates_then_swaps(ckpt):
    """--calib-batches 2: batches 1-2 are served by the full-precision
    graph, the engine swaps to int8 after them with the absmax the max
    over both, and batch 3 on is int8 (tests/test_quant.py:118-140)."""
    from ifcb_classifier_tpu_torch.infer.runner import InferenceEngine
    rng = np.random.RandomState(1)
    # 12 images on one canvas rung at batch 4: three dispatches, in order
    imgs = [rng.randint(0, 255, (16 + i % 5, 18 - i % 4), np.uint8)
            for i in range(12)]
    eng = InferenceEngine(ckpt, batch_size=4, device="cpu", quant=True,
                          calib_batches=2)
    ref = InferenceEngine(ckpt, batch_size=4, device="cpu")
    p = eng.predict_images(imgs)
    assert eng._quant_ready and eng._calib_seen == 2
    assert eng.int8_dispatches == 1 and eng.dispatches == 3
    p_ref = ref.predict_images(imgs)
    np.testing.assert_array_equal(p[:8], p_ref[:8])
    assert np.abs(p[8:] - p_ref[8:]).max() < TOL_INT8_VS_FP32
    assert (p[8:].argmax(-1) == p_ref[8:].argmax(-1)).all()
    p2, p3 = eng.predict_images(imgs), eng.predict_images(imgs)
    np.testing.assert_array_equal(p2, p3)
    assert eng.int8_dispatches == 7
    assert np.abs(p2 - p_ref).max() < TOL_INT8_VS_FP32


def test_calib_batches_absmax_is_max_over_batches(ckpt):
    from ifcb_classifier_tpu_torch.infer.runner import InferenceEngine
    rng = np.random.RandomState(2)
    dim = [rng.randint(0, 40, (20, 20), np.uint8) for _ in range(4)]
    bright = [rng.randint(200, 255, (20, 20), np.uint8) for _ in range(4)]
    eng = InferenceEngine(ckpt, batch_size=4, device="cpu", quant=True,
                          calib_batches=2)
    eng.predict_images(dim + bright)
    one = {}
    for part in (dim, bright):
        e = InferenceEngine(ckpt, batch_size=4, device="cpu", quant=True)
        e.predict_images(part)
        one[len(one)] = e._calib_absmax
    assert eng._calib_absmax == {k: max(v, one[1][k])
                                 for k, v in one[0].items()}


@pytest.mark.parametrize("kind", ["bins", "images"])
def test_pinned_calibration_matches_jax(ckpt, bins, kind, tmp_path):
    """RUN --calib DIR: the engine is int8 before its first dispatch, with
    the absmax of the JAX package's _load_calib_batch path (bins through
    the gray preprocess, an image folder through HostLoader and the RGB
    preprocess)."""
    from ifcb_classifier_tpu.infer.runner import InferenceEngine as JaxEngine
    from ifcb_classifier_tpu_torch.infer.runner import InferenceEngine
    src = bins if kind == "bins" else write_image_folder_dataset(
        str(tmp_path / "imgs"), {"a": 3, "b": 2}, size=(37, 52))
    port = InferenceEngine(ckpt, batch_size=BATCH, device="cpu", quant=True,
                           calib_src=src, calib_count=10)
    assert port._quant_ready and port.dispatches == 0
    ref = JaxEngine(ckpt, batch_size=BATCH, quant=True, calib_src=src,
                    calib_count=10)
    _close_absmax(port._calib_absmax, ref._calib_absmax)


def test_flag_checks_raise(ckpt, bins, trees, tmp_path):
    from ifcb_classifier_tpu_torch.infer.runner import (InferenceEngine,
                                                        do_run)
    with pytest.raises(ValueError, match="only meaningful with"):
        InferenceEngine(ckpt, batch_size=4, device="cpu", calib_src=bins)
    with pytest.raises(ValueError, match="pick one"):
        InferenceEngine(ckpt, batch_size=4, device="cpu", quant=True,
                        calib_src=bins, calib_batches=2)
    empty = tmp_path / "nope"
    empty.mkdir()
    with pytest.raises(ValueError, match="no bins or images"):
        InferenceEngine(ckpt, batch_size=4, device="cpu", quant=True,
                        calib_src=str(empty))
    with pytest.raises(ValueError, match="must be >= 1"):
        InferenceEngine.from_args(_args(bins, ckpt, str(tmp_path),
                                        calib_batches=0), device="cpu")
    with pytest.raises(ValueError, match="requires --precision int8"):
        do_run(_args(bins, ckpt, str(tmp_path), precision="bf16",
                     calib_batches=2))
    squeeze = _save(str(tmp_path / "s.ptl"), "squeezenet", trees)
    with pytest.raises(ValueError, match="int8 is not supported"):
        InferenceEngine(squeeze, batch_size=4, device="cpu", quant=True)


def test_resolve_dtype_int8():
    """int8's float parts run at the auto dtype; TRAIN refuses int8
    (tests/test_torch_train_cli.py)."""
    from ifcb_classifier_tpu_torch.utils.config import resolve_dtype
    assert resolve_dtype("int8", "cpu") == torch.float32
    assert resolve_dtype("int8", "cuda") == torch.bfloat16


def test_cli_int8_run(ckpt, bins, tmp_path):
    """The CLI's RUN --precision int8 --calib-batches 1 on a CPU engine."""
    from ifcb_classifier_tpu_torch.cli import main_cli
    engine = main_cli(["--batch", str(BATCH), "--precision", "int8", "RUN",
                       bins, ckpt, "r", "--outdir", str(tmp_path),
                       "--outfile", "{BIN_ID}.json", "--calib-batches", "1"],
                      device="cpu")
    assert engine.quant and engine.int8_dispatches == engine.dispatches > 0
    assert sorted(os.listdir(tmp_path)) == sorted(
        p + ".json" for p in (SMALL, V2, V1))
