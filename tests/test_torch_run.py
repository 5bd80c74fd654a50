"""The slice as a whole: RUN --type bin of the port (on a CPU engine)
against the JAX package's RUN, on the same bins and the same inception_v3
checkpoint (saved at resize=96 with an image norm; both engines fold its
BNs).

The bins cover schema 2 (ROIs on the 64 and 128 canvas rungs, more than one
batch on a rung, and one ROI over the 1024 ceiling that takes the
shrink-to-fit path), schema 1 (stitched multi-ROI triggers), an empty bin
and a bin whose .roi file is truncated.

Class lists, roi numbers and the error report must be identical. Scores
agree within 1e-5: the two packages run the same f32 arithmetic in other
orders (preprocess ≈ 1e-6, logits ≈ 1e-5 at this size); the measured
score difference is 8.3e-7.
"""

import argparse
import json
import os

import numpy as np
import pytest

from fixtures import make_roi, write_bin
from test_torch_inception import random_inception_trees

ATOL_SCORES = 1e-5
BATCH = 8
CLASSES = ["c0", "c1", "c2", "c3"]
V2, V2_EMPTY, V2_TRUNC = ("D20240101T000000_IFCB900",
                          "D20240102T000000_IFCB900",
                          "D20240103T000000_IFCB900")
V1 = "IFCB1_2010_001_000000"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from ifcb_classifier_tpu.train.checkpoint import save_checkpoint
    params, stats = random_inception_trees(len(CLASSES), seed=4)
    path = str(tmp_path_factory.mktemp("ck") / "incep.ptl")
    save_checkpoint(path, params, stats,
                    dict(MODEL="inception_v3", classes=CLASSES, resize=96,
                         model_id="incep", seed=1,
                         img_norm=["0.667", "0.161"], pretrained=False))
    return path


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bins"))
    shapes = [(16, 20), (10, 10), (64, 30), (5, 60), (33, 33), (20, 7),
              (60, 64), (12, 40), (50, 50), (70, 40), (100, 120),
              (128, 90), (1030, 20)]
    write_bin(root, V2, [make_roi(h, w, k) for k, (h, w) in
                         enumerate(shapes)], 2)
    write_bin(root, V1, [make_roi(20, 30, 1), make_roi(20, 25, 2),
                         make_roi(40, 40, 3), make_roi(15, 90, 4)], 1,
              trigger_of=[1, 1, 2, 3])
    write_bin(root, V2_EMPTY, [None, None], 2)
    base = write_bin(root, V2_TRUNC, [make_roi(30, 30, 5),
                                      make_roi(40, 20, 6)], 2)
    with open(base + ".roi", "r+b") as f:
        f.truncate(1000)
    return root


def _args(src, ckpt, outdir, outfiles):
    return argparse.Namespace(
        cmd_mode="RUN", SRC=src, MODEL=ckpt, RUN_ID="r",
        batch_size=BATCH, loaders=1, src_type="bin", outdir=outdir,
        outfile=list(outfiles), filter=None, clobber=False, gobig=False,
        summary="summary.json",
        cmd_timestamp="2026-08-16T00:00:00+00:00")


def _errored_bins(stdout):
    lines = stdout.split("Bins that errored and produced no output:")
    if len(lines) == 1:
        return set()
    return {ln.split()[0] for ln in lines[1].strip().splitlines() if ln}


@pytest.fixture(scope="module")
def runs(ckpt, bins, tmp_path_factory):
    """Both RUNs, once: {package: (outdir, error-report bins)}."""
    import io
    from contextlib import redirect_stdout

    from ifcb_classifier_tpu.infer.runner import do_run as jax_do_run
    from ifcb_classifier_tpu_torch.infer.runner import (
        InferenceEngine, do_run)
    try:
        import h5py  # noqa: F401
        outfiles = ["{BIN_ID}.json", "{BIN_ID}.h5"]
    except ImportError:
        outfiles = ["{BIN_ID}.json"]
    out = {}
    for name in ("jax", "port"):
        outdir = str(tmp_path_factory.mktemp(name))
        args = _args(bins, ckpt, outdir, outfiles)
        buf = io.StringIO()
        with redirect_stdout(buf):
            if name == "jax":
                jax_do_run(args)
            else:
                do_run(args, engine=InferenceEngine(
                    ckpt, batch_size=BATCH, device="cpu"))
        out[name] = (outdir, _errored_bins(buf.getvalue()))
    return out


def test_same_error_report(runs):
    assert runs["port"][1] == runs["jax"][1] == {V2_EMPTY, V2_TRUNC}


@pytest.mark.parametrize("pid", [V2, V1])
def test_json_results_match(runs, pid):
    res = {}
    for name, (outdir, _) in runs.items():
        with open(os.path.join(outdir, pid + ".json")) as f:
            res[name] = json.load(f)
    j, p = res["jax"], res["port"]
    for key in ("version", "model_id", "bin_id", "class_labels",
                "roi_numbers"):
        assert p[key] == j[key], key
    sj = np.asarray(j["output_scores"])
    sp = np.asarray(p["output_scores"])
    assert sp.shape == sj.shape == (len(j["roi_numbers"]), len(CLASSES))
    np.testing.assert_allclose(sp, sj, rtol=0, atol=ATOL_SCORES)
    # argmax agrees wherever the top two scores are apart by more than
    # the tolerance
    top2 = np.sort(sj, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * ATOL_SCORES
    assert np.array_equal(np.asarray(p["output_classes"])[clear],
                          np.asarray(j["output_classes"])[clear])


def test_h5_results_match(runs):
    h5py = pytest.importorskip("h5py")
    files = {name: h5py.File(os.path.join(outdir, V2 + ".h5"), "r")
             for name, (outdir, _) in runs.items()}
    try:
        j, p = files["jax"], files["port"]
        assert list(p["class_labels"][:]) == list(j["class_labels"][:])
        assert np.array_equal(p["roi_numbers"][:], j["roi_numbers"][:])
        # float16 on disk: one f16 ulp at 1.0 is 2^-11
        np.testing.assert_allclose(p["output_scores"][:],
                                   j["output_scores"][:], rtol=0,
                                   atol=ATOL_SCORES + 2 ** -11)
    finally:
        for f in files.values():
            f.close()


def test_summary_matches(runs):
    res = {}
    for name, (outdir, _) in runs.items():
        with open(os.path.join(outdir, "summary.json")) as f:
            res[name] = json.load(f)
    for key in ("n_bins_done", "n_rois", "n_errors", "model_id"):
        assert res["port"][key] == res["jax"][key], key


def test_unported_flags_raise(ckpt, bins, tmp_path):
    from ifcb_classifier_tpu_torch.infer.runner import do_run
    for extra, item in (({"gobig": True}, "P9"), ({"watch": 5.0}, "P9"),
                        ({"src_type": "img"}, "P6"),
                        ({"mesh": "2x1"}, "P10"),
                        ({"plot_files": [["a.png"]]}, "P6")):
        args = _args(bins, ckpt, str(tmp_path), ["{BIN_ID}.json"])
        vars(args).update(extra)
        with pytest.raises(NotImplementedError, match=item):
            do_run(args)


def test_cli_without_gpu_raises(ckpt, bins, tmp_path, monkeypatch):
    """The CLI runs on the GPU; without one it raises instead of running
    on the CPU."""
    import torch
    from ifcb_classifier_tpu_torch.cli import main_cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        main_cli(["--batch", "8", "RUN", bins, ckpt, "r",
                  "--outdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_cli_on_cpu_engine(ckpt, bins, tmp_path, capsys):
    """The CLI's main(args, engine) with a CPU engine, as a test hands it
    in; flag names and defaults are the JAX package's."""
    from ifcb_classifier_tpu.cli import argparse_nn as jax_parser
    from ifcb_classifier_tpu_torch.cli import argparse_nn, main
    from ifcb_classifier_tpu_torch.infer.runner import InferenceEngine
    argv = ["--batch", "8", "RUN", bins, ckpt, "r", "--outdir",
            str(tmp_path), "--outfile", "{BIN_ID}.json", "--filter", "IN",
            V1]
    args = argparse_nn().parse_args(argv)
    ref = vars(jax_parser().parse_args(argv))
    assert {k: v for k, v in vars(args).items()} == \
        {k: v for k, v in ref.items() if k in vars(args)}
    args.cmd_timestamp = "2026-08-16T00:00:00+00:00"
    main(args, engine=InferenceEngine(ckpt, batch_size=8, device="cpu"))
    assert os.listdir(tmp_path) == [V1 + ".json"]
    assert "DONE!" in capsys.readouterr().out


@pytest.mark.parametrize("packer", ["native", "canvas_batch"])
def test_packers_fill_given_buffers(packer):
    """The engine packs into its own (page-locked on CUDA) buffers: the
    result equals the packer's own allocation, stale bytes included, and a
    buffer of the wrong shape raises."""
    from ifcb_classifier_tpu_torch import native
    from ifcb_classifier_tpu_torch.data.pipeline import pack_canvas_batch
    rng = np.random.default_rng(3)
    rois = [rng.integers(0, 256, (h, w), dtype=np.uint8)
            for h, w in ((5, 9), (30, 17), (1, 1))]
    if packer == "native":
        buf = np.concatenate([r.ravel() for r in rois])
        starts = np.cumsum([0] + [r.size for r in rois[:-1]])
        hs = np.asarray([r.shape[0] for r in rois])
        ws = np.asarray([r.shape[1] for r in rois])

        def pack(out=None, B=4):
            return native.pack_rois_native(buf, starts, hs, ws, B, 64,
                                           out=out)
    else:
        def pack(out=None, B=4):
            return pack_canvas_batch(rois, batch_size=B, out=out)[:2]
    want_c, want_s = pack()
    out = (np.full((4, 64, 64), 7, np.uint8), np.full((4, 2), 9, np.int32))
    got_c, got_s = pack(out=out)
    assert got_c is out[0] and got_s is out[1]
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_s, want_s)
    with pytest.raises(ValueError, match="out must be"):
        pack(out=out, B=5)
