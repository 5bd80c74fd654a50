"""VAL: offline evaluation of a saved model on a labeled dataset (the port
of ifcb_classifier_tpu/train/evaluate.py, a beyond-reference verb).

VAL runs TRAIN's validation loop (``evaluate_loader``, which TRAIN calls
each epoch) so its numbers are directly comparable to epochs.csv and the
TRAIN result files:
  * the same eval step (``train/state.make_eval_step``: forward, masked
    mean cross-entropy, softmax), on the model built exactly as the
    checkpoint describes (pretrained → transform_input) with its BNs NOT
    folded;
  * the same preprocess: kernel K2 on the card (the plain version on the
    CPU), f32, no flips, with the checkpoint's image norm and resize;
  * the same result-file writer and series (``results/validation.py``,
    ``--results FNAME SERIES...``, ``{epoch}`` rendered as ``VAL``). The
    training_* series are empty and train_counts_perclass is all-zero —
    there is no training set in an offline evaluation;
  * val_loss is the SUM over batches (the reference's batch-count-
    dependent quirk, kept for comparability with epochs.csv).

Class mapping: the checkpoint's class list defines the output indices.
Every class found under SRC (after an optional --class-config merge, as
TRAIN does it) must be one of the checkpoint's; an unknown class fails
loudly rather than silently mis-scoring. Checkpoint classes absent from
SRC are fine (zero rows, zero counts).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.datasets import parse_imgnorm, scan_dataset
from ..data.pipeline import HostLoader, prefetch
from ..models import get_namebrand_model
from ..models.torch_port import params_from_jax
from ..ops.preprocess import preprocess_rgb
from ..results.validation import (DEFAULT_SERIES, compute_validation_results,
                                  prf_scores, save_validation_results,
                                  validate_result_files)
from ..utils.config import dump_args_yml, resolve_device, resolve_dtype
from .checkpoint import load_checkpoint
from .state import make_eval_step

__all__ = ["do_validation", "evaluate_loader"]


def evaluate_loader(eval_step, loader, device, resize, mean, std,
                    flips_for_batch=None):
    """The eval loop of TRAIN's validation and of VAL: each batch of
    ``loader`` copied to ``device``, preprocessed in f32 (kernel K2 on the
    card, its plain version on the CPU) with the flips that
    ``flips_for_batch(batch_index, rows)`` gives (none without it), scored
    by ``eval_step`` and cut to its real rows; the losses stay on the
    device until one fetch at the end. Returns (the sum of the batch mean
    losses, in float64; probs [N,C]; true classes [N]; paths; batches)."""
    losses, probs_l, classes_l, srcs = [], [], [], []
    for bi, b in enumerate(prefetch(iter(loader))):
        canvas, sizes, labels, mask = (
            torch.as_tensor(b[k]).to(device, non_blocking=True)
            for k in ("canvas", "sizes", "labels", "mask"))
        flips = (None if flips_for_batch is None
                 else flips_for_batch(bi, canvas.shape[0]))
        images = preprocess_rgb(canvas, sizes, out_size=resize, mean=mean,
                                std=std, flips=flips, dtype=torch.float32)
        loss, probs = eval_step(images, labels, mask)
        n = int(b["mask"].sum())
        losses.append(loss)  # device tensors, fetched once below
        probs_l.append(probs[:n])
        classes_l.append(b["labels"][:n])
        srcs.extend(loader.items[i] for i in b["indices"][:n])
    loss_sum = float(np.sum(torch.stack(losses).cpu().numpy(),
                            dtype=np.float64))
    return (loss_sum, torch.cat(probs_l).cpu().numpy(),
            np.concatenate(classes_l), srcs, len(losses))


def do_validation(args, device=None):
    """Evaluate ``args.MODEL`` on the labeled folder tree ``args.SRC`` on
    ``device`` (default cuda; raises without a GPU). Returns dict(val_loss,
    f1_weighted, f1_macro, n_images); ``do_validation.stats`` then holds
    the number of eval batches and the seconds from the first batch's
    decode to the fetch of the last result."""
    device = resolve_device(device)
    if getattr(args, "precision", None) == "int8":
        raise ValueError("--precision int8 applies to RUN only "
                         "(post-training quantization of a trained model)")
    args.model_id = args.VAL_ID
    os.makedirs(args.outdir, exist_ok=True)
    dtype = resolve_dtype(getattr(args, "precision", None), device)

    result_files = getattr(args, "result_files", None) or \
        [["val_results.json"]]
    # a typo'd placeholder or extension fails now, not after inference
    validate_result_files(result_files, sample_epoch="VAL")

    params, batch_stats, hp = load_checkpoint(args.MODEL)
    classes = [str(c) for c in hp["classes"]]
    resize = hp["resize"]
    img_norm = hp.get("img_norm")
    mean, std = parse_imgnorm(img_norm) if img_norm else (None, None)

    print("Scanning dataset...")
    nd = scan_dataset(args)
    unknown = [c for c in nd.classes if c not in classes]
    if unknown:
        raise ValueError(
            "VAL: {} class(es) under SRC are not in the checkpoint's class "
            "list: {}. The model cannot score classes it was not trained "
            "on — drop those folders or map them with --class-config "
            "(checkpoint classes: {}).".format(
                len(unknown), unknown[:10], classes[:10]))
    if not nd.images:
        raise ValueError("VAL: no images to evaluate under " + args.SRC)
    remap = np.asarray([classes.index(c) for c in nd.classes], np.int32)
    labels = remap[np.asarray(nd.targets, np.int32)]
    counts = np.zeros(len(classes), np.int64)
    np.add.at(counts, labels, 1)
    print("Evaluating {} images across {} of the checkpoint's {} classes"
          .format(len(nd.images), len(nd.classes), len(classes)))

    with open(os.path.join(args.outdir, "validation_images.list"), "w") as f:
        f.write("\n".join(sorted(nd.images)))

    # the model as trained, BNs not folded, so the metrics are TRAIN's
    # given equal inputs; the aux head (absent from the eval forward) is
    # not built, and its tensors in a TRAIN checkpoint are not read
    model = get_namebrand_model(hp["MODEL"], len(classes),
                                pretrained=bool(hp.get("pretrained")))
    sd = params_from_jax(params, batch_stats)
    model.load_state_dict({k: sd[k] for k in model.state_dict()},
                          strict=True)
    model = model.to(device=device, memory_format=torch.channels_last)
    eval_step = make_eval_step(model, dtype=dtype)

    loader = HostLoader(list(nd.images), [int(x) for x in labels],
                        batch_size=args.batch_size,
                        num_workers=args.loaders, shuffle=False,
                        n_real=len(nd.images),
                        pin_memory=device.type == "cuda")
    t0 = time.perf_counter()
    val_loss, probs, input_classes, srcs, n_batches = evaluate_loader(
        eval_step, loader, device, resize, mean, std)
    do_validation.stats = dict(batches=n_batches,
                               seconds=time.perf_counter() - t0)

    for rf in result_files:
        fname, series = rf[0], rf[1:]
        results = compute_validation_results(
            series or DEFAULT_SERIES,
            class_labels=classes,
            input_classes=input_classes, output_scores=probs,
            image_fullpaths=srcs, model_id=args.model_id,
            timestamp=args.cmd_timestamp,
            counts_perclass=[int(c) for c in counts],
            val_counts_perclass=[int(c) for c in counts],
            train_counts_perclass=[0] * len(classes),
            training_image_fullpaths=[], training_classes=[])
        outfile = os.path.join(args.outdir, fname).format(epoch="VAL")
        os.makedirs(os.path.dirname(outfile) or ".", exist_ok=True)
        save_validation_results(outfile, results)
        print("Saved", outfile)

    # sklearn's default label basis (the classes present in y_true or
    # y_pred), exactly like TRAIN's epochs.csv F1: a fixed basis over the
    # checkpoint's classes would count each one absent from SRC as 0.0
    output_classes = np.argmax(probs, 1)
    f1_w = prf_scores(input_classes, output_classes, average="weighted")[2]
    f1_m = prf_scores(input_classes, output_classes, average="macro")[2]
    print("VAL: {} images, val_loss={:.3f}, val_f1_w={:.1%}, "
          "val_f1_m={:.1%}".format(len(srcs), val_loss, f1_w, f1_m))

    if getattr(args, "args_log", None):
        dump_args_yml(args, os.path.join(args.outdir, args.args_log))
    return dict(val_loss=val_loss, f1_weighted=float(f1_w),
                f1_macro=float(f1_m), n_images=len(srcs))


do_validation.stats = {}
