"""The port's plots (ifcb_classifier_tpu_torch/results/plots.py) against
the JAX package's (ifcb_classifier_tpu/results/plots.py), on the CPU.

For the same TRAIN and RUN plot specs both write a figure, and the data
behind every panel is the same: each Axes call that draws data (plot,
imshow, barh, bar, hist) is recorded with its arrays, and the two records
must be equal — exactly for counts, histograms and the confusion matrix,
within 1e-12 for the per-class scores (the port's numpy metrics against
sklearn's, both float64). Bad params, unknown placeholders and
extensions fail validation in both; bin patterns are refused with
``--type img``.
"""

import numpy as np
import pytest

import ifcb_classifier_tpu.results.plots as jax_plots
import ifcb_classifier_tpu_torch.results.plots as port_plots

CLASSES = ["c0", "c1", "c2", "c3", "c4"]
DRAWS = ("plot", "imshow", "barh", "bar", "hist")


@pytest.fixture()
def record(monkeypatch):
    """Every data-drawing Axes call as (name, [arrays]), in call order."""
    from matplotlib.axes import Axes
    calls = []
    for name in DRAWS:
        orig = getattr(Axes, name)

        def wrapper(self, *args, _orig=orig, _name=name, **kw):
            calls.append((_name, [np.asarray(a, np.float64) for a in args
                                  if not isinstance(a, str)]))
            return _orig(self, *args, **kw)

        monkeypatch.setattr(Axes, name, wrapper)
    return calls


def _assert_same_draws(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, ga), (_, wa) in zip(got, want):
        assert len(ga) == len(wa), name
        for g, w in zip(ga, wa):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12,
                                       err_msg=name)


def _train_inputs():
    rng = np.random.default_rng(0)
    scores = rng.dirichlet(np.ones(len(CLASSES)), size=40)
    labels = rng.integers(0, len(CLASSES) - 1, size=40)  # c4 never true
    rows = [dict(epoch=e, train_loss=3.0 - e, val_loss=2.5 - 0.5 * e,
                 f1_weighted=0.2 * e, f1_macro=0.15 * e) for e in range(3)]
    return dict(epoch_rows=rows, class_labels=CLASSES, input_classes=labels,
                output_scores=scores, counts_perclass=[9, 8, 12, 11, 0],
                model_id="m", epoch=2)


def test_training_plots_same_figure_and_data(record, tmp_path):
    kw = _train_inputs()
    params = list(port_plots.TRAIN_PLOT_PARAMS)
    assert params == jax_plots.TRAIN_PLOT_PARAMS
    jax_plots.save_training_plots(str(tmp_path / "j.svg"), params, **kw)
    want = list(record)
    record.clear()
    port_plots.save_training_plots(str(tmp_path / "p.svg"), params, **kw)
    _assert_same_draws(record, want)
    assert (tmp_path / "p.svg").stat().st_size > 0
    assert [n for n, _ in want].count("barh") == 4  # 3 per-class + counts


@pytest.mark.parametrize("form", ["per_roi", "accumulated"])
def test_run_plots_same_figure_and_data(record, tmp_path, form):
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(len(CLASSES)) * 0.3, size=200)
    cls, win = probs.argmax(1), probs.max(1)
    if form == "per_roi":
        kw = dict(output_classes=cls, winscores=win)
    else:
        kw = dict(counts=np.bincount(cls, minlength=len(CLASSES)),
                  score_hist=np.histogram(win, bins=50, range=(0, 1))[0],
                  total=len(cls))
    for mod, name in ((jax_plots, "j.svg"), (port_plots, "p.svg")):
        mod.save_run_plots(str(tmp_path / name), ["counts", "scores"],
                           class_labels=CLASSES, title="t", **kw)
    half = len(record) // 2
    _assert_same_draws(record[half:], record[:half])
    assert (tmp_path / "p.svg").stat().st_size > 0


@pytest.mark.parametrize("plot_files,which,src_type,match", [
    ([["a.png", "curvez"]], "train", None, "unknown plot param"),
    ([["a.png", "scores"]], "train", None, "unknown plot param"),
    ([["a.png", "curves"]], "run", "bin", "unknown plot param"),
    ([["a.pgn"]], "run", "bin", "unsupported figure extension"),
    ([["counts"]], "train", None, "unsupported figure extension"),
    ([["a_{epochs}.png"]], "train", None, "unknown FNAME placeholder"),
    ([["{BIN_IDX}.png"]], "run", "bin", "unknown FNAME placeholder"),
    ([["{BIN_ID}.png"]], "run", "img", "not available with --type img"),
    ([["{INPUT_SUBDIRS}a.png"]], "run", "img",
     "not available with --type img"),
])
def test_validation_refuses_like_the_jax_package(plot_files, which,
                                                 src_type, match):
    for mod in (jax_plots, port_plots):
        with pytest.raises(ValueError, match=match):
            mod.validate_plot_files(plot_files, which=which,
                                    src_type=src_type)


def test_validation_passes_good_specs():
    port_plots.validate_plot_files([["p_{epoch}.pdf", "f1", "winscores"]],
                                   which="train")
    port_plots.validate_plot_files([["{BIN_ID}.png", "counts"], ["a.svg"]],
                                   which="run", src_type="bin")
