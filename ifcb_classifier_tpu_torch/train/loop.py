"""TRAIN: the training loop (counterpart of do_training in
ifcb_classifier_tpu/train/loop.py; the reference's `do_training` and its
Lightning Trainer, neuston_net.py:37-160, neuston_models.py:48-149).

  host decode/pack (data/pipeline.py) → kernel K2 on the device (resize,
  norm, flips: ops/preprocess.py) → train step (train/state.py)

Single process, one device. Behaviour kept from the JAX package, each
item citing the reference:
  * model_id {TRAIN_DATE}/{TRAIN_ID} templating          neuston_net.py:40-41
  * seed_everything(seed or random), stored back          neuston_net.py:62
  * training/validation_images.list (sorted)              neuston_net.py:72-75
  * input size 299 for inception_v3                       neuston_data.py:344
  * flips: x = rows, y = columns, +V applies to val       neuston_data.py:356-364
  * epoch val_loss = SUM of per-batch mean losses         neuston_models.py:109
  * best epoch strictly-less, early stop, min epochs      neuston_net.py:58-59,103
  * per-epoch stdout line                                 neuston_models.py:126-128
  * epochs.csv (scalars) and args.yml copies              neuston_net.py:87-95,122-129
  * best ckpt → outdir/{model_id}.ptl                     neuston_net.py:117-120
  * validation result files on best epochs                neuston_net.py:50-56
and the JAX package's additions: chkpts/last.state every epoch and
--resume (seed check; a resume of an early-stopped run is a no-op),
--class-norm, --accum, --balanced, --cache-images, --nan-check,
--weights (a torchvision state dict seeds the trunk, the heads stay fresh)
and --plot (figures on best epochs, results/plots.py).

Randomness differs from the JAX package by design (ROADMAP queue 3): the
weights are initialised from a CPU torch generator seeded with --seed
(train/state.init_params), train flips come from a torch generator
on the device seeded with --seed, dropout from torch's default generator
(seeded by seed_everything), and +V validation flips from a generator
reseeded per (epoch, batch). last.state carries the generator states, so
a resumed run draws what the uninterrupted run draws.
"""

from __future__ import annotations

import csv
import os
import random
import time
from shutil import copyfile

import numpy as np
import torch

from ..data.datasets import get_trainval_datasets, parse_imgnorm
from ..data.pipeline import HostLoader, prefetch
from ..models import get_namebrand_model, input_size_for
from ..models.torch_port import load_torch_weights, params_to_jax
from ..ops.preprocess import preprocess_rgb
from ..results.validation import (DEFAULT_SERIES, compute_validation_results,
                                  prf_scores, save_validation_results,
                                  validate_result_files)
from ..utils.config import (dump_args_yml, hparams_dict, resolve_device,
                            resolve_dtype)
from .checkpoint import (load_train_state, restore_trainstate_payload,
                         save_checkpoint, save_train_state)
from .evaluate import evaluate_loader
from .state import init_params, make_eval_step, make_optimizer, \
    make_train_step

__all__ = ["seed_everything", "EpochCSV", "reject_unported_train",
           "do_training"]

# (args attribute, the values this slice serves, what ports the others)
UNPORTED_TRAIN_FLAGS = (
    ("mesh", (None, "auto", "1", "1x1"), "--mesh: parallelism, P10"),
    ("remat", (None, False), "--remat: torch.utils.checkpoint, P5b"),
    ("onnx", (None, False), "--onnx: export, P11"),
    ("export", (None, False), "--export: export, P11"),
    ("profile", (None, 0), "--profile: serving extras, P9"),
)


def reject_unported_train(args):
    """Raise for any TRAIN flag value or model this slice does not serve —
    never ignore one silently. int8 is an inference-engine mode, not a
    compute dtype: TRAIN refuses it with the JAX package's ValueError
    (its utils/config.py:128-131)."""
    if getattr(args, "precision", None) == "int8":
        raise ValueError("--precision int8 applies to RUN only "
                         "(post-training quantization of a trained model)")
    for attr, served, what in UNPORTED_TRAIN_FLAGS:
        if getattr(args, attr, None) not in served:
            raise NotImplementedError(f"not ported yet: {what} (ROADMAP)")
    if args.MODEL != "inception_v3":
        get_namebrand_model(args.MODEL, 2)  # KeyError or the P7 error
        raise NotImplementedError(f"TRAIN of {args.MODEL!r} is not ported "
                                  "yet (ROADMAP P7)")


def seed_everything(seed):
    """Seed python, numpy and torch (every device); returns the concrete
    seed (random if falsy) — the reference's `seed_everything(args.seed or
    None)` (neuston_net.py:62)."""
    if not seed:
        seed = random.SystemRandom().randint(1, 2 ** 31 - 1)
    random.seed(seed)
    np.random.seed(seed & 0xFFFFFFFF)
    torch.manual_seed(seed)
    return seed


class EpochCSV:
    """epochs.csv writer (the reference's CSVLogger, neuston_net.py:87-95):
    the columns are the union of every scalar ever logged, in first-seen
    order; non-scalar values are dropped."""

    def __init__(self, path):
        self.path = path
        self.rows = []

    def log(self, **row):
        def py(v):
            return v.item() if isinstance(v, (np.bool_, np.integer,
                                              np.floating)) else v
        self.rows.append({k: py(v) for k, v in row.items()
                          if isinstance(v, (bool, int, float, np.bool_,
                                            np.integer, np.floating))})
        fields = []
        for r in self.rows:
            fields.extend(k for k in r if k not in fields)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            w.writeheader()
            w.writerows(self.rows)


def _flip_mask(gen, B, flip_x, flip_y, device):
    """[B,2] uint8 flip mask (rows, columns) with a 50% chance per image on
    the enabled axes, drawn from ``gen`` on ``device``; None if neither."""
    if not (flip_x or flip_y):
        return None
    m = torch.rand((B, 2), generator=gen, device=device) < 0.5
    on = torch.tensor([flip_x, flip_y], device=device)
    return (m & on).to(torch.uint8)


def _rng_states(device, flip_gen):
    states = {"cpu": torch.get_rng_state(), "flips": flip_gen.get_state()}
    if device.type == "cuda":
        states["cuda"] = torch.cuda.get_rng_state(device)
    return states


def do_training(args, device=None):
    """Train ``args.MODEL`` on ``args.SRC`` on ``device`` (default cuda;
    raises without a GPU). Returns the path of the best model,
    ``{outdir}/{model_id}.ptl``. ``do_training.stats`` then holds this
    call's counts: train and validation steps, the train batches per
    canvas rung, the images trained and seconds taken by the train
    passes, in all and per epoch, and per epoch the seconds its train pass
    waited on the host loader (decode and pack)."""
    device = resolve_device(device)
    date_str = args.cmd_timestamp.split("T")[0]
    args.model_id = args.model_id.format(TRAIN_DATE=date_str,
                                         TRAIN_ID=args.TRAIN_ID)

    # fail fast, before the dataset scan
    reject_unported_train(args)
    dtype = resolve_dtype(getattr(args, "precision", None), device)
    if args.img_norm:
        parse_imgnorm(args.img_norm)
    validate_result_files(getattr(args, "result_files", None) or [],
                          sample_epoch=0)
    plot_files = getattr(args, "plot_files", None) or []
    if plot_files:
        from ..results.plots import save_training_plots, validate_plot_files
        validate_plot_files(plot_files, which="train")
    os.makedirs(args.outdir, exist_ok=True)
    args.devices = [str(device)]

    # --resume reuses the original run's seed (the split depends on it)
    chkpt_dir = os.path.join(args.outdir, "chkpts")
    last_state_path = os.path.join(chkpt_dir, "last.state")
    resume_payload = None
    if getattr(args, "resume", False) and os.path.isfile(last_state_path):
        import json
        resume_payload = restore_trainstate_payload(last_state_path)
        saved_seed = json.loads(resume_payload["extra_json"]).get("seed")
        if saved_seed is not None:
            if args.seed and int(args.seed) != int(saved_seed):
                raise ValueError(
                    f"--resume: this run was trained with seed "
                    f"{saved_seed}; resuming with --seed {args.seed} "
                    "would regenerate a different train/val split "
                    "mid-run. Drop --seed or pass the matching one.")
            args.seed = int(saved_seed)
    args.seed = seed_everything(args.seed)

    # datasets and manifests (neuston_net.py:68-75)
    training_dataset, validation_dataset = get_trainval_datasets(args)
    assert training_dataset.classes == validation_dataset.classes
    args.classes = training_dataset.classes
    with open(os.path.join(args.outdir, "training_images.list"), "w") as f:
        f.write("\n".join(sorted(training_dataset.images)))
    with open(os.path.join(args.outdir, "validation_images.list"), "w") as f:
        f.write("\n".join(sorted(validation_dataset.images)))

    args.resize = input_size_for(args.MODEL)
    mean, std = parse_imgnorm(args.img_norm) if args.img_norm \
        else (None, None)
    flip = args.flip or ""
    flip_x, flip_y = "x" in flip, "y" in flip
    flip_val = "+V" in flip

    accum = max(1, int(getattr(args, "accum", 1) or 1))
    if args.batch_size % accum:
        args.batch_size = -(-args.batch_size // accum) * accum
        print(f"Rounded batch up to {args.batch_size} "
              f"(divisible by --accum {accum})")
    cache_images = getattr(args, "cache_images", False)
    train_loader = HostLoader(training_dataset.images,
                              training_dataset.targets,
                              batch_size=args.batch_size,
                              num_workers=args.loaders, shuffle=True,
                              seed=args.seed,
                              balanced=getattr(args, "balanced", False),
                              cache=cache_images)
    val_loader = HostLoader(validation_dataset.images,
                            validation_dataset.targets,
                            batch_size=args.batch_size,
                            num_workers=args.loaders, shuffle=False,
                            cache=cache_images)

    print(f"Initializing {args.MODEL} ({len(args.classes)} classes, "
          f"{str(dtype).replace('torch.', '')} compute on {device})...")
    model = get_namebrand_model(args.MODEL, len(args.classes),
                                pretrained=args.pretrained, train=True)
    init_params(model, args.seed)
    if getattr(args, "weights", None):
        model.load_state_dict(load_torch_weights(
            args.weights, args.MODEL, model.state_dict()), strict=True)
        print(f"Loaded ported weights from {args.weights}")
    elif args.pretrained:
        print("NOTE: --pretrained requested but no --weights file given; "
              "initializing randomly (no torchvision downloads here — give "
              "a state_dict with --weights).")
    model = model.to(device=device, memory_format=torch.channels_last)
    optimizer = make_optimizer(
        model.parameters(), getattr(args, "optimizer", "Adam"),
        getattr(args, "learning_rate", 0.001),
        getattr(args, "weight_decay", 0.0))

    class_weights = None
    if getattr(args, "class_norm", False):
        counts = np.asarray(training_dataset.count_perclass, np.float64)
        class_weights = counts.sum() / (len(counts) * np.maximum(counts, 1.0))
        print("Class-normalized loss: weights in [{:.3f}, {:.3f}]".format(
            class_weights.min(), class_weights.max()))
    train_step = make_train_step(model, optimizer, dtype=dtype,
                                 class_weights=class_weights, accum=accum)
    eval_step = make_eval_step(model, dtype=dtype)
    flip_gen = torch.Generator(device=device).manual_seed(args.seed)
    val_gen = torch.Generator(device=device)
    val_seed = (args.seed ^ 0x5EED) & 0x7FFFFFFF

    def to_device(b):
        return (torch.from_numpy(b["canvas"]).to(device),
                torch.from_numpy(b["sizes"]).to(device),
                torch.from_numpy(b["labels"]).to(device),
                torch.from_numpy(b["mask"]).to(device))

    os.makedirs(chkpt_dir, exist_ok=True)
    epoch_csv = EpochCSV(os.path.join(args.outdir, "logs_epochs.csv"))
    result_files = args.result_files or [["results.mat"] + DEFAULT_SERIES]
    hparams = hparams_dict(args)

    best_val_loss = np.inf
    best_epoch = 0
    best_ckpt_path = None
    start_epoch = 0
    if resume_payload is not None:
        extra, rng = load_train_state(last_state_path, model, optimizer,
                                      payload=resume_payload)
        resume_payload = None
        start_epoch = extra["epoch"] + 1
        best_val_loss = extra["best_val_loss"]
        best_epoch = extra["best_epoch"]
        best_ckpt_path = extra.get("best_ckpt_path")
        epoch_csv.rows = extra.get("csv_rows", [])
        torch.set_rng_state(rng["cpu"])
        flip_gen.set_state(rng["flips"])
        if "cuda" in rng and device.type == "cuda":
            torch.cuda.set_rng_state(rng["cuda"], device)
        train_loader._epoch = start_epoch
        print(f"Resumed from {last_state_path} at epoch {start_epoch}")

    stats = dict(train_steps=0, val_steps=0, rungs={}, train_images=0,
                 train_seconds=0.0, epoch_images=[], epoch_seconds=[],
                 epoch_wait_seconds=[])
    do_training.stats = stats

    def run_validation(epoch):
        """(sum of the batch mean losses, probs, true classes, paths)."""
        def flips(bi, rows):
            val_gen.manual_seed(val_seed + epoch * 100003 + bi)
            return _flip_mask(val_gen, rows, flip_x, flip_y, device)

        *out, batches = evaluate_loader(eval_step, val_loader, device,
                                        args.resize, mean, std,
                                        flips if flip_val else None)
        stats["val_steps"] += batches
        return out

    loop_start = start_epoch
    if (start_epoch > 0 and args.estop
            and (start_epoch - 1) - best_epoch >= args.estop):
        print(f"Resume: run already early-stopped after epoch "
              f"{start_epoch - 1} (best epoch {best_epoch}, no improvement "
              f"for {args.estop} epochs) — nothing left to train")
        loop_start = args.emax
    nan_check = getattr(args, "nan_check", False)
    for epoch in range(loop_start, args.emax):
        # --- train --- (the spans let a profile read the train pass alone
        # and split its host time into the copy in and the step's launches)
        with torch.profiler.record_function("train_pass"):
            t0 = time.time()
            epoch_losses, n_imgs, wait = [], 0, 0.0
            batches = prefetch(iter(train_loader))
            while True:
                tw = time.perf_counter()
                b = next(batches, None)  # host decode and pack, if behind
                wait += time.perf_counter() - tw
                if b is None:
                    break
                with torch.profiler.record_function("h2d"):
                    canvas, sizes, labels, mask = to_device(b)
                with torch.profiler.record_function("step"):
                    flips = _flip_mask(flip_gen, canvas.shape[0], flip_x,
                                       flip_y, device)
                    images = preprocess_rgb(canvas, sizes,
                                            out_size=args.resize, mean=mean,
                                            std=std, flips=flips, dtype=dtype)
                    loss = train_step(images, labels, mask)
                if nan_check and not bool(torch.isfinite(loss)):
                    raise FloatingPointError(
                        f"--nan-check: non-finite train loss at epoch "
                        f"{epoch}, step {stats['train_steps']}")
                epoch_losses.append(loss)
                n_imgs += int(b["mask"].sum())
                S = int(b["canvas"].shape[1])
                stats["rungs"][S] = stats["rungs"].get(S, 0) + 1
                stats["train_steps"] += 1
            agg_train_loss = float(np.sum(torch.stack(epoch_losses).cpu()
                                          .numpy(), dtype=np.float64))
            train_time = time.time() - t0
        stats["train_images"] += n_imgs
        stats["train_seconds"] += train_time
        stats["epoch_images"].append(n_imgs)
        stats["epoch_seconds"].append(train_time)
        stats["epoch_wait_seconds"].append(wait)

        # --- validate (sum of batch means, neuston_models.py:109) ---
        val_loss, outputs, input_classes, input_srcs = run_validation(epoch)
        output_classes = np.argmax(outputs, axis=1)
        f1_weighted = prf_scores(input_classes, output_classes,
                                 average="weighted")[2]
        f1_macro = prf_scores(input_classes, output_classes,
                              average="macro")[2]

        is_best = val_loss < best_val_loss
        if is_best:
            best_val_loss = val_loss
            best_epoch = epoch

        eoe = ('Best Epoch: {}, train_loss: {:.3f}, val_loss: {:.3f}, '
               'val_f1_w={:02.1f}%, val_f1_m={:02.1f}% [{:.1f}s, {:.0f} '
               'img/s]')
        print(eoe.format(True if epoch == best_epoch else best_epoch + 1,
                         agg_train_loss, val_loss, 100 * f1_weighted,
                         100 * f1_macro, train_time,
                         n_imgs / max(train_time, 1e-9)), flush=True)
        epoch_csv.log(epoch=epoch, best=(best_epoch == epoch),
                      train_loss=agg_train_loss, val_loss=val_loss,
                      f1_macro=f1_macro, f1_weighted=f1_weighted)

        if is_best:
            # ModelCheckpoint(monitor=val_loss), neuston_net.py:98-100
            best_ckpt_path = os.path.join(chkpt_dir, f"epoch={epoch}.ckpt")
            save_checkpoint(best_ckpt_path,
                            *params_to_jax(model.state_dict()), hparams)
            for rf in result_files:
                fname, series = rf[0], rf[1:]
                results = compute_validation_results(
                    series or DEFAULT_SERIES,
                    class_labels=args.classes,
                    input_classes=input_classes, output_scores=outputs,
                    image_fullpaths=input_srcs, model_id=args.model_id,
                    timestamp=args.cmd_timestamp,
                    counts_perclass=[v + t for v, t in zip(
                        validation_dataset.count_perclass,
                        training_dataset.count_perclass)],
                    val_counts_perclass=validation_dataset.count_perclass,
                    train_counts_perclass=training_dataset.count_perclass,
                    training_image_fullpaths=training_dataset.images,
                    training_classes=training_dataset.targets)
                outfile = os.path.join(args.outdir, fname).format(epoch=epoch)
                os.makedirs(os.path.dirname(outfile) or ".", exist_ok=True)
                save_validation_results(outfile, results)
            # plots on best epochs (neuston_net.py:48,379,455 reserved it)
            for fname, *plot_params in plot_files:
                save_training_plots(
                    os.path.join(args.outdir, fname).format(epoch=epoch),
                    plot_params, epoch_rows=epoch_csv.rows,
                    class_labels=args.classes, input_classes=input_classes,
                    output_scores=outputs,
                    counts_perclass=validation_dataset.count_perclass,
                    model_id=args.model_id, epoch=epoch)

        save_train_state(last_state_path, model, optimizer, dict(
            epoch=epoch, best_val_loss=best_val_loss, best_epoch=best_epoch,
            best_ckpt_path=best_ckpt_path, csv_rows=epoch_csv.rows,
            seed=args.seed), _rng_states(device, flip_gen))

        # EarlyStopping('val_loss', patience), neuston_net.py:58-59,103
        if args.estop and (epoch - best_epoch) >= args.estop:
            if epoch + 1 >= args.emin:
                print(f"Early stopping at epoch {epoch} "
                      f"(no improvement for {args.estop} epochs)")
                break

    # the best model (neuston_net.py:117-120)
    output_path = os.path.join(args.outdir, args.model_id + ".ptl")
    if best_ckpt_path:
        copyfile(best_ckpt_path, output_path)
        print(f"Best model: {output_path}")
    # logs (neuston_net.py:122-129)
    if args.epochs_log and epoch_csv.rows:
        copyfile(epoch_csv.path, os.path.join(args.outdir, args.epochs_log))
    if args.args_log:
        dump_args_yml(args, os.path.join(args.outdir, args.args_log))
    return output_path


do_training.stats = {}
