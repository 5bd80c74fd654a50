"""Args/outdir handling and the device/dtype policy shared by the CLI and
the engine (counterpart of ifcb_classifier_tpu/utils/config.py).

Device policy: entry points run on ``cuda`` unless the caller asks for the
CPU. A request for ``cuda`` on a machine without a usable GPU raises; it
never falls back to the CPU.
"""

from __future__ import annotations

import datetime as dt

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for but absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU explicitly")
    return device


def resolve_dtype(precision, device) -> torch.dtype:
    """--precision string -> torch dtype. None/'auto' is bf16 on CUDA and
    f32 elsewhere (the JAX package's bf16-on-TPU rule).

    fp32 also turns TF32 off for matmuls and cuDNN convolutions: a float32
    convolution on the card otherwise runs in TF32 (about three decimal
    digits), which is not what ``--precision fp32`` promises."""
    if precision in (None, "auto"):
        return torch.bfloat16 if torch.device(device).type == "cuda" \
            else torch.float32
    if precision == "int8":
        raise ValueError("--precision int8 is not ported yet (ROADMAP P8)")
    table = {"bf16": torch.bfloat16, "fp32": torch.float32}
    if precision not in table:
        raise ValueError(f"unknown precision {precision!r} "
                         "(choose auto, bf16 or fp32)")
    if precision == "fp32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return table[precision]


def add_runtime_params(args):
    """The run's UTC timestamp (neuston_net.py:415-432), which the result
    files and the outdir template carry."""
    args.cmd_timestamp = dt.datetime.now(dt.timezone.utc).isoformat(
        timespec="seconds")
    return args


def proc_outdir(args, model_id_for_run=None):
    """Outdir templating (neuston_net.py:438-444)."""
    run_date_str, _ = args.cmd_timestamp.split("T")
    if args.cmd_mode == "TRAIN":
        args.outdir = args.outdir.format(TRAIN_DATE=run_date_str,
                                         TRAIN_ID=args.TRAIN_ID)
    elif args.cmd_mode == "RUN":
        args.outdir = args.outdir.format(RUN_DATE=run_date_str,
                                         RUN_ID=args.RUN_ID,
                                         MODEL_ID=model_id_for_run)
    elif args.cmd_mode == "VAL":
        args.outdir = args.outdir.format(VAL_DATE=run_date_str,
                                         VAL_ID=args.VAL_ID)
    return args
