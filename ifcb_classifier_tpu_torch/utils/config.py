"""Args/outdir handling and the device/dtype policy shared by the CLI and
the engine (counterpart of ifcb_classifier_tpu/utils/config.py).

Device policy: entry points run on ``cuda`` unless the caller asks for the
CPU. A request for ``cuda`` on a machine without a usable GPU raises; it
never falls back to the CPU.
"""

from __future__ import annotations

import datetime as dt
import json

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
    f32 elsewhere (the JAX package's bf16-on-TPU rule); 'int8' gives the
    float dtype of the int8 engine's float parts, the same (the JAX
    package's engine passes resolve_dtype(None) for int8; TRAIN refuses
    int8, train/loop.reject_unported_train).

    fp32 also turns TF32 off for matmuls and cuDNN convolutions: a float32
    convolution on the card otherwise runs in TF32 (about three decimal
    digits), which is not what ``--precision fp32`` promises."""
    if precision in (None, "auto", "int8"):
        return torch.bfloat16 if torch.device(device).type == "cuda" \
            else torch.float32
    table = {"bf16": torch.bfloat16, "fp32": torch.float32}
    if precision not in table:
        raise ValueError(f"unknown precision {precision!r} "
                         "(choose auto, bf16, fp32, or int8 for RUN)")
    if precision == "fp32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return table[precision]


def add_runtime_params(args):
    """The run's UTC timestamp (neuston_net.py:415-432), which the result
    files and the outdir template carry, and the ``version`` file's tag
    (None without one)."""
    args.cmd_timestamp = dt.datetime.now(dt.timezone.utc).isoformat(
        timespec="seconds")
    try:
        with open("version") as f:
            args.version = f.read().strip()
    except FileNotFoundError:
        args.version = None
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


def hparams_dict(args) -> dict:
    """The checkpoint-embedded hparams (the reference's
    save_hyperparameters contract, neuston_models.py:54): the whole args
    namespace, as the JAX package keeps it."""
    return vars(args).copy()


def _yaml_scalar(v) -> str:
    """One value as YAML that a YAML 1.1 loader (PyYAML's safe_load) reads
    back as the same Python value: JSON for strings, ints and lists, with
    floats spelled with a dot (``1.0e-05``, which YAML 1.1 needs to read a
    float) and inf/nan as ``.inf``/``.nan``."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        mant, _, exp = text.partition("e")
        if "." not in mant:
            mant += ".0"
        return mant + ("e" + exp if exp else "")
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
    return json.dumps(str(v))


def dump_args_yml(args, path):
    """The args.yml contract (neuston_net.py:126-129): one ``key: value``
    line per argument, sorted by key. Written without PyYAML (the GPU
    machine may lack it); the keys and values are those of the JAX
    package's yaml.safe_dump of the same namespace."""
    with open(path, "w") as f:
        for k, v in sorted(vars(args).items()):
            f.write(f"{k}: {_yaml_scalar(v)}\n")
