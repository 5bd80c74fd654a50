"""The main CLI of the port: the reference's argparse surface
(neuston_net.py:311-452) with the JAX package's global flags and its TRAIN,
RUN and VAL sub-parsers, flag for flag (ifcb_classifier_tpu/cli.py:39-132,
:135-378).

TRAIN and VAL of inception_v3 and RUN on bins and image directories are
served; flags that this port does not serve yet raise naming their ROADMAP
item (train/loop.reject_unported_train, infer/runner.reject_unported).
Runs on the GPU; without one it raises.
"""

from __future__ import annotations

import argparse

from .utils.config import add_runtime_params, proc_outdir


def main(args, engine=None, device=None):
    if args.cmd_mode == "TRAIN":
        from .train.loop import do_training
        do_training(args, device=device)
    elif args.cmd_mode == "VAL":
        from .train.evaluate import do_validation
        do_validation(args, device=device)
    else:
        from .infer.runner import do_run
        do_run(args, engine=engine)
    print("\nDONE!")


def argparse_nn(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(
            prog="ifcbnn",
            description="Train, Run, and perform other tasks related to ifcb "
                        "and general image classification! (PyTorch/CUDA)")

    subparsers = parser.add_subparsers(
        dest="cmd_mode",
        help='Pick exactly one sub-command. Note: optional '
             'arguments (below) must be specified before "TRAIN", "RUN", '
             'or "VAL"')
    train = subparsers.add_parser("TRAIN", help="Train a new model")
    run = subparsers.add_parser("RUN", help="Run a previously trained model")
    val = subparsers.add_parser(
        "VAL", help="Evaluate a previously trained model on a labeled "
                    "dataset (TRAIN-comparable metrics and result files)")

    common = parser.add_argument_group(title="NN Common Args")
    common.add_argument("--batch", dest="batch_size", metavar="SIZE",
                        default=108, type=int,
                        help="Number of images per batch. Default is 108")
    common.add_argument("--loaders", metavar="N", default=4, type=int,
                        help="Number of data-loading threads. Default is 4")
    common.add_argument("--precision",
                        choices=["auto", "bf16", "fp32", "int8"],
                        default="auto",
                        help="Compute dtype; auto = bf16 on the GPU, fp32 on "
                             "the CPU. fp32 also turns TF32 off. int8 (RUN "
                             "only) = the quantized tier: every conv s8 x s8 "
                             "with activation scales calibrated on the first "
                             "batch (--calib-batches, --calib), the rest at "
                             "the auto dtype")
    common.add_argument("--remat", action="store_true",
                        help="Rematerialize activations in backprop "
                             "(TRAIN only; not ported yet, ROADMAP P5b)")
    common.add_argument("--mesh", metavar="DATA[xMODEL]", default="auto",
                        help="Device-mesh layout; only auto (one device) is "
                             "ported (ROADMAP P10)")

    argparse_nn_train(train)
    argparse_nn_run(run)
    argparse_nn_val(val)
    return parser


def argparse_nn_val(val):
    """VAL: offline evaluation (train/evaluate.py has its contract). Flag
    spellings mirror TRAIN's where shared."""
    val.add_argument("SRC", help="Directory with class-label subfolders and "
                     "images, labeled with the checkpoint's class names "
                     "(or names mapped to them via --class-config)")
    val.add_argument("MODEL", help="Path to a trained model artifact "
                     "(.ptl checkpoint, as produced by TRAIN, or the "
                     "reference's Lightning .ptl)")
    val.add_argument("VAL_ID", help="Evaluation ID. Used by --outdir; "
                     "recorded as model_id in the result files")

    data = val.add_argument_group(title="Dataset Adjustments")
    data.add_argument("--class-config", metavar=("CSV", "COL"), nargs=2,
                      help="Skip and combine classes as defined by column "
                           "COL of a special CSV configuration file (same "
                           "semantics as TRAIN — use it to map new folder "
                           "names onto the checkpoint's classes)")
    data.add_argument("--class-min", metavar="MIN", default=1, type=int,
                      help="Exclude classes with fewer than MIN instances. "
                           "Default is 1 (evaluate everything — unlike "
                           "TRAIN, dropping small classes would silently "
                           "change the measurement)")
    data.add_argument("--class-max", metavar="MAX", default=None, type=int,
                      help="Limit classes to a MAX number of instances.")

    out = val.add_argument_group(title="Output Options")
    out.add_argument("--outdir", default="val-output/{VAL_ID}",
                     help='Default is "val-output/{VAL_ID}"')
    out.add_argument("--args-log", metavar="ALOG", default="args.yml",
                     help="Specify a human-readable yaml filename. "
                          "Default is args.yml")
    out.add_argument("--results", dest="result_files",
                     metavar=("FNAME", "SERIES"), nargs="+", action="append",
                     help="FNAME: results filename (.json .h5 .mat; "
                          '"{epoch}" renders as "VAL"). SERIES: data series '
                          "to include — same vocabulary as TRAIN --results; "
                          "the training_* series are empty (no training set "
                          "in an offline evaluation). Default: "
                          "val_results.json with the standard series.")


def argparse_nn_train(train):
    train.add_argument("SRC", help="Directory with class-label subfolders and "
                       "images. May also be a dataset-configuration csv.")
    train.add_argument("MODEL", help='Select a base model. Eg: "inception_v3"')
    train.add_argument("TRAIN_ID", help="Training ID. This value is the default "
                       "value used by --outdir and --model-id.")

    model = train.add_argument_group(title="Model Adjustments")
    model.add_argument("--untrain", dest="pretrained", default=True,
                       action="store_false",
                       help="If set, initializes MODEL ~without~ pretrained "
                            "neurons. Default (unset) is pretrained")
    model.add_argument("--weights", metavar="PTH", default=None,
                       help="Path to a torchvision state_dict (.pth, .npz "
                            "or a Lightning .ptl) that seeds the trunk; the "
                            "classifier heads stay fresh")
    model.add_argument("--img-norm", nargs=2, metavar=("MEAN", "STD"),
                       help="Normalize images by MEAN and STD. "
                            'eg1: "0.667 0.161", eg2: "0.056,0.058,0.051 '
                            '0.067,0.071,0.057"')

    data = train.add_argument_group(title="Dataset Adjustments")
    data.add_argument("--seed", default=0, type=int,
                      help="Set a specific seed for deterministic output & "
                           "dataset-splitting reproducability.")
    data.add_argument("--split", metavar="T:V", default="80:20",
                      help="Ratio of images per-class to split randomly into "
                           'Training and Validation datasets. Default is "80:20"')
    data.add_argument("--class-config", metavar=("CSV", "COL"), nargs=2,
                      help="Skip and combine classes as defined by column COL "
                           "of a special CSV configuration file")
    data.add_argument("--class-min", metavar="MIN", default=2, type=int,
                      help="Exclude classes with fewer than MIN instances. "
                           "Default is 2")
    data.add_argument("--class-max", metavar="MAX", default=None, type=int,
                      help="Limit classes to a MAX number of instances. ")
    data.add_argument("--swap", default=False, action="store_true",
                      help=argparse.SUPPRESS)
    data.add_argument("--cache-images", default=False, action="store_true",
                      help="Keep decoded images in RAM after the first "
                           "epoch (epochs 2+ skip image decoding entirely; "
                           "memory cost ~ the decoded dataset size)")
    data.add_argument("--balanced", default=False, action="store_true",
                      help="Class-balanced sampling (with replacement, "
                           "inverse-frequency weights) for the training "
                           "epoch stream")

    epochs = train.add_argument_group(title="Epoch Parameters")
    epochs.add_argument("--emax", metavar="MAX", default=60, type=int,
                        help="Maximum number of training epochs. Default is 60")
    epochs.add_argument("--emin", metavar="MIN", default=10, type=int,
                        help="Minimum number of training epochs. Default is 10")
    epochs.add_argument("--estop", metavar="STOP", default=10, type=int,
                        help="Early Stopping: Number of epochs following a "
                             "best-epoch after-which to stop training. "
                             "Set STOP=0 to disable. Default is 10")

    augs = train.add_argument_group(
        title="Augmentation Options",
        description="Data Augmentation is a technique by which training "
                    "results may improved by simulating novel input")
    augs.add_argument("--flip", choices=["x", "y", "xy", "x+V", "y+V", "xy+V"],
                      help="Training images have 50%% chance of being flipped "
                           "along the designated axis: (x) vertically, (y) "
                           'horizontally, (xy) either/both. May optionally '
                           'specify "+V" to include Validation dataset')

    out = train.add_argument_group(title="Output Options")
    out.add_argument("--outdir", default="training-output/{TRAIN_ID}",
                     help='Default is "training-output/{TRAIN_ID}"')
    out.add_argument("--model-id", default="{TRAIN_ID}",
                     help="Set a specific model id. Patterns {TRAIN_DATE} and "
                          '{TRAIN_ID} are recognized. Default is "{TRAIN_ID}"')
    out.add_argument("--epochs-log", metavar="ELOG", default="epochs.csv",
                     help="Specify a csv filename. Default is epochs.csv")
    out.add_argument("--args-log", metavar="ALOG", default="args.yml",
                     help="Specify a human-readable yaml filename. "
                          "Default is args.yml")
    out.add_argument("--onnx", action="store_true",
                     help="Additionally output an onnx version of the model "
                          "(not ported yet, ROADMAP P11)")
    out.add_argument("--export", action="store_true",
                     help="Additionally output an exported version of the "
                          "model (not ported yet, ROADMAP P11)")
    out.add_argument("--results", dest="result_files",
                     metavar=("FNAME", "SERIES"), nargs="+", action="append",
                     help="FNAME: validation-results filename or pattern "
                          '("{epoch}" recognized; .json .h5 .mat formats). '
                          "SERIES: data series to include. Defaults match the "
                          "reference (results.mat + standard series).")
    out.add_argument("-p", "--plot", dest="plot_files",
                     metavar=("FNAME", "PARAM"), nargs="+", action="append",
                     help="Make plots on best epochs. FNAME: figure file "
                          '("{epoch}" recognized; any matplotlib format). '
                          "PARAM: curves f1 confusion perclass_f1 "
                          "perclass_recall perclass_precision "
                          "counts_perclass winscores (default: curves "
                          "confusion perclass_f1)")

    # the reference reserved this whole group but left it commented out
    # (neuston_net.py:385-390); --batch-norm is dropped — its author "forgot
    # what this is exactly" (:390) and it never had semantics to preserve
    optim = train.add_argument_group(
        title="Optimization", description="Adjust learning hyper parameters")
    optim.add_argument("--optimizer", default="Adam",
                       choices=["Adam", "AdamW", "SGD"],
                       help="Select an optimizer (torch semantics: Adam = "
                            "coupled L2 decay, AdamW = decoupled, SGD = "
                            "momentum 0.9). Default is Adam")
    optim.add_argument("--learning-rate", default=0.001, type=float,
                       help="Set a learning rate. Default is 0.001")
    optim.add_argument("--weight-decay", default=0.0, type=float,
                       help="Weight-decay coefficient. Default is 0 (off)")
    optim.add_argument("--accum", default=1, type=int, metavar="N",
                       help="Accumulate gradients over N sequential "
                            "micro-batches of --batch/N rows per optimizer "
                            "step: the update is the exact full-batch "
                            "masked-mean gradient while activation memory "
                            "scales with the micro-batch (train with an "
                            "effective batch far beyond HBM; pairs with or "
                            "replaces --remat). BatchNorm normalizes per "
                            "micro-batch, same as a torch accumulation "
                            "loop. Default 1 (off)")
    optim.add_argument("--class-norm", action="store_true",
                       help="Bias the training loss to emphasize smaller "
                            "classes: inverse-frequency class weights "
                            '(sklearn "balanced"). Validation loss stays '
                            "unweighted so early stopping is comparable.")

    meta = train.add_argument_group(title="Metadata and Annotations")
    meta.add_argument("--dataset-id",
                      help="Associate a dataset id label with this model")
    meta.add_argument("--notes", help="Add any kind of note to the trained model")

    epochs_extra = train.add_argument_group(title="Resume")
    epochs_extra.add_argument("--resume", action="store_true",
                              help="Resume mid-training from "
                                   "OUTDIR/chkpts/last.state if present "
                                   "(full optimizer state)")

    dbg = train.add_argument_group(title="Observability")
    dbg.add_argument("--profile", metavar="N", default=0, type=int,
                     help="Profiler trace of N train steps (not ported "
                          "yet, ROADMAP P9)")
    dbg.add_argument("--nan-check", action="store_true",
                     help="Fail fast on a non-finite train loss (checks "
                          "every step, which waits for the device)")


def argparse_nn_run(run):
    run.add_argument("SRC", help="Resource(s) to be classified. Accepts a bin, "
                     "an image, a text-file, or a directory (recursive).")
    run.add_argument("MODEL",
                     help="Path to a previously-trained model file (a "
                          "native checkpoint or the reference's Lightning "
                          ".ptl)")
    run.add_argument("RUN_ID", help="Run ID. Used by --outdir")

    run.add_argument("--type", dest="src_type", default="bin",
                     choices=["bin", "img"],
                     help='File type to perform classification on. '
                          'Default is "bin"')
    run.add_argument("--outdir", default="run-output/{RUN_ID}/v3/{MODEL_ID}",
                     help='Default is "run-output/{RUN_ID}/v3/{MODEL_ID}"')
    run.add_argument("--outfile", action="append",
                     help="Name/pattern of the output classification file. "
                          "Patterns: {BIN_ID} {BIN_YEAR} {BIN_DATE} "
                          "{INPUT_SUBDIRS}. Formats: .json .mat .h5. "
                          'Bin default "D{BIN_YEAR}/D{BIN_DATE}/{BIN_ID}_class.h5"; '
                          'img default "img_results.json".')
    run.add_argument("--filter", nargs="+", metavar=("IN|OUT", "KEYWORD"),
                     help="Explicitly include (IN) or exclude (OUT) bins or "
                          "image-files by KEYWORDs. KEYWORD may also be a "
                          "text file of line-delimited KEYWORDs.")
    run.add_argument("--clobber", action="store_true",
                     help="If set, already-processed bins in OUTDIR are "
                          "reprocessed.")
    run.add_argument("--summary", metavar="FNAME",
                     help="Write a machine-readable JSON run summary "
                          "(per-class ROI counts, score histogram, errors) "
                          "to OUTDIR/FNAME.")
    run.add_argument("--watch", metavar="SECONDS", type=float,
                     help="Continuous serving mode (not ported yet, "
                          "ROADMAP P9)")
    run.add_argument("--watch-settle", metavar="SECONDS", type=float,
                     help="With --watch (not ported yet, ROADMAP P9)")
    run.add_argument("--watch-passes", type=int, help=argparse.SUPPRESS)
    run.add_argument("--profile", metavar="N", default=0, type=int,
                     help="Profiler trace of the first N bins (not ported "
                          "yet, ROADMAP P9)")
    run.add_argument("--gobig", action="store_true", help=argparse.SUPPRESS)
    run.add_argument("--calib-batches", metavar="N", default=1, type=int,
                     help="With --precision int8: calibrate the activation "
                          "scales over the first N batches (max absmax); "
                          "those N batches are served at full precision "
                          "and the int8 graph takes over from the next. "
                          "Default 1: every score is int8.")
    run.add_argument("--calib", metavar="DIR", default=None,
                     help="With --precision int8: pin the activation scales "
                          "to a fixed sample (bins, or an image folder) at "
                          "engine build instead of the first batch served.")
    run.add_argument("--calib-count", metavar="N", default=128, type=int,
                     help="With --calib: how many ROIs or images of DIR "
                          "calibrate. Default 128.")
    run.add_argument("--no-batch-ladder", dest="batch_ladder",
                     action="store_false", default=None,
                     help="Disable the batch-bucket ladder: every dispatch "
                          "pads to the full --batch instead of the smallest "
                          "bucket covering it.")
    run.add_argument("-p", "--plot", dest="plot_files",
                     metavar=("FNAME", "PARAM"), nargs="+", action="append",
                     help="Make plots. FNAME: figure file; with bin "
                          "patterns ({BIN_ID} etc.) one per bin, else one "
                          "aggregate figure at the end. PARAM: counts "
                          "scores (default both)")


def main_cli(argv=None, device=None):
    """Parse and run on ``device`` (default ``cuda``; raises without a
    GPU). RUN returns the engine, whose ``dispatches`` count the batches it
    sent to the device; TRAIN and VAL return None
    (train/loop.do_training.stats and train/evaluate.do_validation.stats
    hold their counts)."""
    parser = argparse_nn()
    args = parser.parse_args(argv)
    if args.cmd_mode is None:
        parser.error('missing sub-command: specify "TRAIN", "RUN" or '
                     '"VAL".')
    if args.cmd_mode in ("TRAIN", "VAL"):
        if args.cmd_mode == "TRAIN":
            from .train.loop import reject_unported_train
            reject_unported_train(args)
        add_runtime_params(args)
        proc_outdir(args)
        main(args, device=device)
        return None
    from .infer.runner import InferenceEngine, reject_unported
    reject_unported(args)
    add_runtime_params(args)
    # built once: it reads the checkpoint and supplies {MODEL_ID}
    engine = InferenceEngine.from_args(args, device=device)
    proc_outdir(args, model_id_for_run=engine.model_id)
    main(args, engine=engine)
    return engine


if __name__ == "__main__":
    main_cli()
