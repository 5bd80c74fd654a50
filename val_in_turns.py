#!/usr/bin/env python3
"""Time VAL's eval loop (train/evaluate.do_validation) of this checkout's
ifcb_classifier_tpu_torch against an older copy of the package, in turns,
on one CUDA GPU.

Run from the root of a checkout:

  python3 val_in_turns.py --old DIR [--pairs 3] [--passes 3]

DIR holds an older ifcb_classifier_tpu_torch/, for example unpacked with
``git archive REV ifcb_classifier_tpu_torch | tar -x -C _compare/val_REV``
into the gitignored _compare/. The script writes chip_smoke's TRAIN
dataset (4 classes x 160 RGB PNGs, roi_sides' sides) and a full-width
inception_v3 @299 checkpoint of those classes from a seed, then runs
``VAL --batch 128`` in one process per turn: old, new, new, old, --pairs
times over. Each process runs VAL once cold (its kernels' build included)
and --passes times warm, and reports each warm eval loop's seconds
(``do_validation.stats``: decode, pack, copy, K2, forward, one fetch).
Prints one line per turn and, last, a JSON object of all the numbers with
the card's name and power limit.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def worker(root, ds, ckpt, out, passes):
    """One turn: VAL of the package under ``root``; prints its JSON."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    import ifcb_classifier_tpu_torch as pkg
    from ifcb_classifier_tpu_torch.train.evaluate import do_validation
    if not pkg.__file__.startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"imported {pkg.__file__}, not the copy in {root}")
    seconds, losses = [], set()
    for i in range(passes + 1):
        res = do_validation(cs.parsed([
            "--batch", str(cs.TRAIN_BATCH), "VAL", ds, ckpt, "turn",
            "--outdir", os.path.join(out, str(i))]))
        losses.add(res["val_loss"])
        if i:
            seconds.append(do_validation.stats["seconds"])
    print("TURN " + json.dumps(dict(seconds=seconds, n=res["n_images"],
                                    val_loss=sorted(losses))), flush=True)


def turn(root, ds, ckpt, out, passes):
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", root, ds,
         ckpt, out, str(passes)], capture_output=True, text=True, cwd=HERE)
    line = [s for s in proc.stdout.splitlines() if s.startswith("TURN ")]
    if proc.returncode or not line:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"the turn of {root} failed ({proc.returncode})")
    return json.loads(line[0][len("TURN "):])


def setup(work):
    """chip_smoke's TRAIN dataset and a 4-class checkpoint of its
    classes, both from seeds."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from ifcb_classifier_tpu_torch.models import get_namebrand_model
    from ifcb_classifier_tpu_torch.models.torch_port import params_to_jax
    from ifcb_classifier_tpu_torch.train.checkpoint import save_checkpoint
    ds = os.path.join(work, "ds")
    cs.write_train_dataset(ds, np.random.default_rng(3))
    torch.manual_seed(0)
    model = get_namebrand_model("inception_v3", cs.TRAIN_CLASSES)
    ckpt = os.path.join(work, "val.ckpt")
    save_checkpoint(ckpt, *params_to_jax(model.state_dict()), dict(
        MODEL="inception_v3", resize=cs.R, pretrained=False, seed=0,
        classes=sorted(os.listdir(ds)), img_norm=["0.667", "0.161"],
        model_id="val_in_turns"))
    return ds, ckpt


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="a directory holding an older "
                    "ifcb_classifier_tpu_torch/")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--worker", nargs=5, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        root, ds, ckpt, out, passes = args.worker
        return worker(root, ds, ckpt, out, int(passes))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("val_in_turns.py needs a CUDA GPU")
    if not args.old or not os.path.isdir(
            os.path.join(args.old, "ifcb_classifier_tpu_torch")):
        raise SystemExit("--old DIR must hold ifcb_classifier_tpu_torch/")
    import chip_smoke as cs
    card = cs.card_line()
    print(card, flush=True)
    work = tempfile.mkdtemp(prefix="val_in_turns_")
    ds, ckpt = setup(work)
    roots = dict(old=os.path.abspath(args.old), new=HERE)
    got = dict(old=[], new=[])
    for p in range(args.pairs):
        for i, side in enumerate(("old", "new", "new", "old")):
            r = turn(roots[side], ds, ckpt,
                     os.path.join(work, f"{side}_{p}_{i}"), args.passes)
            got[side].append(r)
            img_s = [r["n"] / s for s in r["seconds"]]
            print(f"pair {p} {side}: warm VAL {r['n']} images, img/s "
                  f"{', '.join(f'{v:.1f}' for v in img_s)}; val_loss "
                  f"{r['val_loss']}", flush=True)
    med = {k: float(np.median([t["n"] / s for t in v for s in t["seconds"]]))
           for k, v in got.items()}
    losses = {k: sorted({x for t in v for x in t["val_loss"]})
              for k, v in got.items()}
    print(f"median warm VAL img/s: old {med['old']:.1f}, new "
          f"{med['new']:.1f} on {card}", flush=True)
    shutil.rmtree(work)
    print(json.dumps(dict(card=card, median_img_s=med, val_loss=losses,
                          turns=got)))


if __name__ == "__main__":
    main()
