"""The main CLI of the port: the reference's argparse surface
(neuston_net.py:311-452) with the JAX package's global flags and RUN
sub-parser, flag for flag (ifcb_classifier_tpu/cli.py:39-94, :286-378).

RUN on bins is served (TRAIN and VAL come with ROADMAP P5/P6); flags of
RUN that this slice does not serve raise in the engine's front door
(infer/runner.reject_unported). Runs on the GPU; without one it raises.
"""

from __future__ import annotations

import argparse

from .utils.config import add_runtime_params, proc_outdir


def main(args, engine=None):
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
             'arguments (below) must be specified before "RUN"')
    run = subparsers.add_parser("RUN", help="Run a previously trained model")

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
                             "the CPU. fp32 also turns TF32 off. int8 is not "
                             "ported yet (ROADMAP P8)")
    common.add_argument("--remat", action="store_true",
                        help="Rematerialize activations in backprop "
                             "(TRAIN only; not ported yet)")
    common.add_argument("--mesh", metavar="DATA[xMODEL]", default="auto",
                        help="Device-mesh layout; only auto (one device) is "
                             "ported (ROADMAP P10)")

    argparse_nn_run(run)
    return parser


def argparse_nn_run(run):
    run.add_argument("SRC", help="Resource(s) to be classified. Accepts a bin, "
                     "an image, a text-file, or a directory (recursive).")
    run.add_argument("MODEL",
                     help="Path to a previously-trained model file (a "
                          "native checkpoint)")
    run.add_argument("RUN_ID", help="Run ID. Used by --outdir")

    run.add_argument("--type", dest="src_type", default="bin",
                     choices=["bin", "img"],
                     help='File type to perform classification on. '
                          'Default is "bin" (img is not ported yet)')
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
                     help="With --precision int8 (not ported yet, "
                          "ROADMAP P8)")
    run.add_argument("--calib", metavar="DIR", default=None,
                     help="With --precision int8 (not ported yet, "
                          "ROADMAP P8)")
    run.add_argument("--calib-count", metavar="N", default=128, type=int,
                     help="With --calib (not ported yet, ROADMAP P8)")
    run.add_argument("--no-batch-ladder", dest="batch_ladder",
                     action="store_false", default=None,
                     help="Disable the batch-bucket ladder: every dispatch "
                          "pads to the full --batch instead of the smallest "
                          "bucket covering it.")
    run.add_argument("-p", "--plot", dest="plot_files",
                     metavar=("FNAME", "PARAM"), nargs="+", action="append",
                     help="Make plots (not ported yet, ROADMAP P6)")


def main_cli(argv=None, device=None):
    """Parse, build the engine on ``device`` (default ``cuda``; raises
    without a GPU) and run. Returns the engine, whose ``dispatches``
    count the batches it sent to the device."""
    parser = argparse_nn()
    args = parser.parse_args(argv)
    if args.cmd_mode is None:
        parser.error('missing sub-command: specify "RUN".')
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
