"""Plotting callbacks (the port's copy of ifcb_classifier_tpu/results/
plots.py) — implements the reference's explicit TODO.

The reference reserved a `-p/--plot FNAME PARAM...` flag on both the TRAIN and
RUN subparsers but never built it (neuston_net.py:379,413 are
commented out; :48,185 `plotting_callbacks = [] # TODO`; :455 "TODO implement
plots (matplotlib vs plotly?)"). This module completes that surface with
matplotlib (Agg), mirroring the `--results FNAME SERIES...` shape:

  TRAIN `--plot FNAME [PARAM ...]` — rendered on best epochs, like the
    validation-results writer (neuston_callbacks.py:32-33); `{epoch}` in
    FNAME is templated. PARAMs (default: curves confusion perclass_f1):
      curves             train/val loss per epoch (so-far history)
      f1                 weighted + macro F1 per epoch
      confusion          confusion-matrix heatmap at this epoch
      perclass_f1|perclass_recall|perclass_precision   per-class bar chart
      counts_perclass    validation-image counts per class
      winscores          histogram of winning softmax scores
  RUN `--plot FNAME [PARAM ...]` — PARAMs (default: counts scores):
      counts             classified-ROI counts per class (argmax)
      scores             histogram of winning softmax scores
    FNAME containing bin patterns ({BIN_ID} etc.) renders per bin; a plain
    FNAME renders ONE aggregate figure at end of run.

Any matplotlib-supported extension works (.png .pdf .svg). matplotlib is
imported only when a figure is validated or drawn, and the per-class
statistics come from the port's numpy scores (results/validation.py:
sklearn's confusion matrix and zero_division=0 scores), so the module
needs neither at import time.
"""

from __future__ import annotations

import os

import numpy as np

from .validation import confusion_matrix, prf_scores

TRAIN_PLOT_PARAMS = ('curves f1 confusion perclass_f1 perclass_recall '
                     'perclass_precision counts_perclass winscores').split()
DEFAULT_TRAIN_PLOTS = ['curves', 'confusion', 'perclass_f1']
RUN_PLOT_PARAMS = ['counts', 'scores']
DEFAULT_RUN_PLOTS = ['counts', 'scores']

_MAX_BAR_CLASSES = 40  # per-class bar charts show the top-N for readability

# validated categorical slots (CVD-safe adjacent pair) + single-hue
# sequential ramp for the confusion heatmap
_SERIES_1 = "#2a78d6"  # blue — primary/single series
_SERIES_2 = "#eb6834"  # orange — second series on two-line charts
_SEQ_CMAP = "Blues"    # sequential = one hue, light→dark


# recessive axes/grid: marks carry the data, chrome stays in the background.
# Applied per-figure via rc_context — this module NEVER mutates global
# matplotlib state (no matplotlib.use, no global rcParams, no pyplot
# figure registry), so library embedders keep their backend and styling.
_RC = {
    "axes.spines.top": False, "axes.spines.right": False,
    "axes.grid": True, "grid.color": "#e3e2dd", "grid.linewidth": 0.6,
    "axes.axisbelow": True, "axes.edgecolor": "#52514e",
    "text.color": "#0b0b0b", "axes.labelcolor": "#52514e",
    "xtick.color": "#52514e", "ytick.color": "#52514e",
    "figure.facecolor": "#fcfcfb", "axes.facecolor": "#fcfcfb",
    "legend.frameon": False,
}


def _make_fig(n):
    """(fig, axes[n]) built directly on matplotlib.figure.Figure — no
    pyplot, no backend switch; Figure.savefig picks the right non-
    interactive canvas per extension."""
    from matplotlib.figure import Figure

    ncols = 1 if n == 1 else 2
    nrows = -(-n // ncols)
    fig = Figure(figsize=(7.5 * ncols, 5.5 * nrows))
    axes = fig.subplots(nrows, ncols, squeeze=False)
    flat = [ax for row in axes for ax in row]
    for ax in flat[n:]:
        ax.set_visible(False)
    return fig, flat[:n]


def _barh_perclass(ax, class_labels, values, title):
    order = np.argsort(values)[::-1][:_MAX_BAR_CLASSES]
    labels = [class_labels[i] for i in order][::-1]
    vals = np.asarray(values)[order][::-1]
    ax.barh(range(len(vals)), vals, color=_SERIES_1, height=0.72)
    ax.set_yticks(range(len(vals)))
    ax.set_yticklabels(labels, fontsize=7)
    extra = len(class_labels) - len(order)
    ax.set_title(title + (f" (top {len(order)} of {len(class_labels)})"
                          if extra > 0 else ""))
    ax.margins(y=0.01)


def _confusion_ax(ax, confusion, class_labels):
    im = ax.imshow(confusion, cmap=_SEQ_CMAP, aspect="auto")
    ax.grid(False)
    ax.figure.colorbar(im, ax=ax, fraction=0.046)
    ax.set_xlabel("predicted class")
    ax.set_ylabel("true class")
    ax.set_title("confusion matrix (unnormalized)")
    if len(class_labels) <= _MAX_BAR_CLASSES:
        ax.set_xticks(range(len(class_labels)))
        ax.set_xticklabels(class_labels, rotation=90, fontsize=6)
        ax.set_yticks(range(len(class_labels)))
        ax.set_yticklabels(class_labels, fontsize=6)


def save_training_plots(outfile, params, *, epoch_rows, class_labels,
                        input_classes, output_scores, counts_perclass,
                        model_id=None, epoch=None):
    """Render the requested TRAIN plot panels into one figure at `outfile`.

    epoch_rows: list of dicts with epoch/train_loss/val_loss/f1_weighted/
    f1_macro keys (the epochs.csv rows so far). Stats are recomputed here
    from (input_classes, output_scores) so this module stays independent of
    the results writer's series selection.
    """
    params = list(params) or list(DEFAULT_TRAIN_PLOTS)
    unknown = [p for p in params if p not in TRAIN_PLOT_PARAMS]
    if unknown:
        raise ValueError("unknown plot param(s) {}; choose from {}".format(
            unknown, TRAIN_PLOT_PARAMS))

    import matplotlib
    with matplotlib.rc_context(_RC):
        fig, axes = _make_fig(len(params))
        _draw_training_panels(params, axes, epoch_rows, class_labels,
                              input_classes, output_scores, counts_perclass)
        title = "validation plots"
        if model_id:
            title = "{} — {}".format(model_id, title)
        if epoch is not None:
            title += " (epoch {})".format(epoch)
        fig.suptitle(title)
        fig.tight_layout(rect=(0, 0, 1, 0.96))
        os.makedirs(os.path.dirname(outfile) or ".", exist_ok=True)
        fig.savefig(outfile)


_PRF_INDEX = {"precision": 0, "recall": 1, "f1": 2}


def _draw_training_panels(params, axes, epoch_rows, class_labels,
                          input_classes, output_scores, counts_perclass):
    output_scores = np.asarray(output_scores)
    input_classes = np.asarray(input_classes)
    output_classes = np.argmax(output_scores, axis=1)
    class_idxs = list(range(len(class_labels)))
    epochs = [r["epoch"] for r in epoch_rows]
    for p, ax in zip(params, axes):
        if p == "curves":
            ax.plot(epochs, [r["train_loss"] for r in epoch_rows],
                    label="train_loss", marker="o", ms=3, lw=1.8,
                    color=_SERIES_1)
            ax.plot(epochs, [r["val_loss"] for r in epoch_rows],
                    label="val_loss", marker="o", ms=3, lw=1.8,
                    color=_SERIES_2)
            ax.set_xlabel("epoch")
            ax.set_ylabel("loss (epoch sum)")
            ax.set_title("training curves")
            ax.legend()
        elif p == "f1":
            ax.plot(epochs, [100 * r["f1_weighted"] for r in epoch_rows],
                    label="f1_weighted", marker="o", ms=3, lw=1.8,
                    color=_SERIES_1)
            ax.plot(epochs, [100 * r["f1_macro"] for r in epoch_rows],
                    label="f1_macro", marker="o", ms=3, lw=1.8,
                    color=_SERIES_2)
            ax.set_xlabel("epoch")
            ax.set_ylabel("F1 (%)")
            ax.set_title("validation F1")
            ax.legend()
        elif p == "confusion":
            confusion = confusion_matrix(input_classes, output_classes,
                                         labels=class_idxs)
            _confusion_ax(ax, confusion, class_labels)
        elif p.startswith("perclass_"):
            stat = p.split("_", 1)[1]
            vals = prf_scores(input_classes, output_classes,
                              labels=class_idxs)[_PRF_INDEX[stat]]
            _barh_perclass(ax, class_labels, vals, "per-class " + stat)
        elif p == "counts_perclass":
            _barh_perclass(ax, class_labels, np.asarray(counts_perclass),
                           "validation images per class")
        elif p == "winscores":
            ax.hist(np.max(output_scores, axis=1), bins=50, range=(0, 1),
                    color=_SERIES_1)
            ax.set_xlabel("winning softmax score")
            ax.set_ylabel("validation images")
            ax.set_title("winning-score distribution")


SCORE_HIST_BINS = 50  # fixed histogram resolution for aggregate accumulators


def save_run_plots(outfile, params, *, class_labels, output_classes=None,
                   winscores=None, counts=None, score_hist=None, total=None,
                   title=None):
    """Render the requested RUN plot panels (one figure) at `outfile`.

    Two input forms:
      * raw per-ROI arrays: output_classes (argmax idx) + winscores — the
        per-bin case;
      * fixed-size accumulators: counts [n_classes] + score_hist
        [SCORE_HIST_BINS] + total — the run-forever aggregate case, O(1)
        memory no matter how many ROIs have streamed through.
    """
    params = list(params) or list(DEFAULT_RUN_PLOTS)
    unknown = [p for p in params if p not in RUN_PLOT_PARAMS]
    if unknown:
        raise ValueError("unknown plot param(s) {}; choose from {}".format(
            unknown, RUN_PLOT_PARAMS))

    if counts is None:
        output_classes = np.asarray(output_classes)
        counts = np.bincount(output_classes, minlength=len(class_labels))
        total = len(output_classes)
    if score_hist is None and winscores is not None:
        score_hist = np.histogram(np.asarray(winscores),
                                  bins=SCORE_HIST_BINS, range=(0, 1))[0]

    import matplotlib
    with matplotlib.rc_context(_RC):
        fig, axes = _make_fig(len(params))
        for p, ax in zip(params, axes):
            if p == "counts":
                _barh_perclass(ax, class_labels, counts,
                               "classified ROIs per class")
            elif p == "scores":
                edges = np.linspace(0, 1, SCORE_HIST_BINS + 1)
                ax.bar(edges[:-1], score_hist, width=np.diff(edges),
                       align="edge", color=_SERIES_1)
                ax.set_xlabel("winning softmax score")
                ax.set_ylabel("ROIs")
                ax.set_title("winning-score distribution")
        fig.suptitle(title or "run plots ({} ROIs)".format(total))
        fig.tight_layout(rect=(0, 0, 1, 0.95))
        os.makedirs(os.path.dirname(outfile) or ".", exist_ok=True)
        fig.savefig(outfile)


def validate_plot_files(plot_files, *, which, src_type=None):
    """Fail fast at startup (before any compute) on unknown plot params or
    an invalid FNAME-pattern/mode combination — render-time discovery would
    surface hours into a run (or mid-training)."""
    allowed = TRAIN_PLOT_PARAMS if which == "train" else RUN_PLOT_PARAMS
    for pf in plot_files or []:
        fname, params = pf[0], pf[1:]
        unknown = [p for p in params if p not in allowed]
        if unknown:
            raise ValueError("--plot {}: unknown plot param(s) {}; choose "
                             "from {}".format(fname, unknown, allowed))
        # extension must be a format matplotlib can actually save — a typo
        # (.pgn) or a params-as-fname slip (--plot counts) would otherwise
        # pass startup and raise at the FIRST render, killing a TRAIN at
        # its first best epoch (validate_result_files checks its
        # extensions; this is the same front-loading for figures)
        ext = os.path.splitext(fname)[1].lstrip(".").lower()
        from matplotlib.figure import Figure
        supported = Figure().canvas.get_supported_filetypes()
        if ext not in supported:
            raise ValueError(
                "--plot {}: unsupported figure extension {!r}; matplotlib "
                "formats here: {}".format(fname, ext or "(none)",
                                          sorted(supported)))
        if which == "run" and src_type == "img" and (
                "{BIN_" in fname or "{INPUT_SUBDIRS}" in fname):
            raise ValueError("--plot bin patterns ({BIN_ID} etc.) are not "
                             "available with --type img")
        if "{" in fname or "}" in fname:  # lone '}' also crashes .format
            # a typo'd placeholder ({epochs}, {BIN_IDX}) would otherwise
            # pass startup validation and KeyError at the FIRST render —
            # hours into a run, the exact failure this function exists to
            # front-load
            dummy = (dict(epoch=0) if which == "train"
                     else dict(BIN_ID="b", BIN_YEAR=2020, BIN_DATE="d",
                               INPUT_SUBDIRS=""))
            try:
                fname.format(**dummy)
            except (KeyError, IndexError, ValueError):
                raise ValueError(
                    "--plot {}: unknown FNAME placeholder; available: {}"
                    .format(fname, sorted("{%s}" % k for k in dummy))
                ) from None
