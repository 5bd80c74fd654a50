"""The utility CLI of the port (counterpart of ifcb_classifier_tpu/
util_cli.py; the reference's neuston_util.py:135-165): MAKE_DATASET_CONFIG,
MAKE_CLASS_CONFIG, CALC_IMG_NORM, and PORT_WEIGHTS (torchvision state dict
→ ``.npz`` for TRAIN --weights, or a checkpoint → torchvision-keyed
``.pth``).

    python -m ifcb_classifier_tpu_torch.util_cli CALC_IMG_NORM SRC

CALC_IMG_NORM runs on the GPU (kernel K2 preprocesses each batch) and
raises without one; ``main_cli(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np


def write_csv(outfile, rows):
    """CSV to file or stdout (neuston_util.py:56-63)."""
    if outfile:
        with open(outfile, "w", newline="") as f:
            csv.writer(f).writerows(rows)
    else:
        for row in rows:
            print(",".join(str(c) for c in row))


def make_dataset_config(args):
    """Union of class subdirs across datasets → priority-headered CSV
    (neuston_util.py:66-97)."""
    datasets, priorities = [], []
    for src in args.dataset:
        parts = src.split(":", 1)
        if len(parts) == 2:
            datasets.append(parts[1])
            priorities.append(int(parts[0]))
        else:
            datasets.append(parts[0])
            priorities.append(0)
    priorities = [p if p > 0 else max(priorities) + 1 for p in priorities]

    classes = set()
    dataset_subdirs = []
    for dataset in datasets:
        subdirs = [d for d in os.listdir(dataset)
                   if os.path.isdir(os.path.join(dataset, d))]
        dataset_subdirs.append(subdirs)
        classes.update(subdirs)

    header = [""] + ["{}:{}".format(p, d) for p, d in zip(priorities, datasets)]
    rows = [[cls] + ["1" if cls in dssd else "0" for dssd in dataset_subdirs]
            for cls in sorted(classes)]
    write_csv(args.outfile, [header] + rows)


def make_class_config(args):
    """Class list → (class,'1') CSV (neuston_util.py:101-121)."""
    if os.path.isdir(args.dataset):
        classes = [d for d in os.listdir(args.dataset)
                   if os.path.isdir(os.path.join(args.dataset, d))]
    elif os.path.isfile(args.dataset) and args.dataset.endswith(".csv"):
        with open(args.dataset) as f:
            reader = csv.reader(f)
            next(reader)
            rows = list(reader)
        classes = [r[0] for r in rows if any(v != "0" for v in r[1:])]
    else:
        raise ValueError(f'Dataset is invalid: "{args.dataset}"')
    classes.sort()
    write_csv(args.outfile, [[args.dataset, "CONFIG1"]] +
              [[c, "1"] for c in classes])


def batch_norm_stats(x, mask):
    """Per-channel mean and std of one preprocessed batch ``x`` [B,r,r,3]
    over the pixels of its valid rows (``mask`` [B]): the JOINT statistics
    of the batch (np.std(batch, axis=(0,2,3)) in the reference,
    neuston_util.py:35-36), not the mean of per-image stds."""
    import torch
    m = mask.to(torch.float32)[:, None, None, None]
    n_pix = torch.clamp(m.sum() * x.shape[1] * x.shape[2], min=1.0)
    cm = (x * m).sum(dim=(0, 1, 2)) / n_pix
    cv = (((x - cm) ** 2) * m).sum(dim=(0, 1, 2)) / n_pix
    return cm, torch.sqrt(cv)


def calc_img_norm(args, device=None):
    """Dataset channel mean/std: the mean of per-batch channel means and
    stds (the reference's approximate population statistics,
    neuston_util.py:13-54), each batch preprocessed on ``device`` (default
    cuda; K2 in f32, no norm, at ``--resize``)."""
    import torch

    from .data.datasets import scan_dataset
    from .data.pipeline import HostLoader, prefetch
    from .ops.preprocess import preprocess_rgb
    from .utils.config import resolve_device

    device = resolve_device(device)
    nd = scan_dataset(args)
    loader = HostLoader(nd.images, nd.targets, batch_size=args.batch_size,
                        num_workers=4, shuffle=False,
                        pin_memory=device.type == "cuda")
    means, stds = [], []
    num_batches = len(loader)
    for i, b in enumerate(prefetch(iter(loader)), 1):
        canvas, sizes = (torch.as_tensor(b[k]).to(device, non_blocking=True)
                         for k in ("canvas", "sizes"))
        x = preprocess_rgb(canvas, sizes, out_size=args.resize,
                           dtype=torch.float32)
        cm, cs = batch_norm_stats(x, torch.from_numpy(b["mask"]).to(device))
        means.append(cm)
        stds.append(cs)
        if i % 100 == 0:
            print("\n{:.1f}% ({}/{} images) mean={} std={}".format(
                100 * i / num_batches, i, num_batches,
                float(torch.stack(means).mean(0)[0]),
                float(torch.stack(stds).mean(0)[0])))
        else:
            print(".", end="", flush=True)
    print()
    return (torch.stack(means).cpu().numpy().mean(axis=0),
            torch.stack(stds).cpu().numpy().mean(axis=0))


def _is_torch_or_npz(path):
    """A torch artifact — zip ('PK', torch>=1.6) or a legacy pickle stream
    (0x80 + protocol byte) — or an .npz; else the port's msgpack checkpoint,
    whose payload map never starts with either (the JAX package's 2-byte
    sniff; a 1-byte file is never taken for a pickle)."""
    with open(path, "rb") as f:
        head = f.read(2)
    return (head == b"PK"
            or (len(head) == 2 and head[:1] == b"\x80"
                and head[1:2] in b"\x02\x03\x04\x05")
            or path.endswith(".npz"))


def port_weights(args):
    """Both porting directions, chosen by the input's format:

    * a torch state dict (.pth / Lightning .ptl zip / .npz) → an .npz of
      torchvision-keyed arrays for TRAIN --weights;
    * the port's (or the JAX package's) checkpoint → a torchvision-keyed
      torch .pth, handing trained weights back to torch users."""
    import torch

    from .models.torch_port import load_state_dict_file, params_from_jax
    if not _is_torch_or_npz(args.STATE_DICT):
        from .train.checkpoint import load_checkpoint
        params, stats, _ = load_checkpoint(args.STATE_DICT)
        sd = params_from_jax(params, stats)
        out = args.outfile or (os.path.splitext(args.STATE_DICT)[0] + ".pth")
        torch.save(sd, out)
        print("PORTED {} tensors (checkpoint -> torch state_dict) -> {}"
              .format(len(sd), out))
        return
    sd = load_state_dict_file(args.STATE_DICT)
    out = args.outfile or (os.path.splitext(args.STATE_DICT)[0] + ".npz")
    np.savez(out, **sd)
    print("PORTED {} tensors -> {}".format(len(sd), out))


def main(args, device=None):
    if args.cmd == "MAKE_DATASET_CONFIG":
        make_dataset_config(args)
    elif args.cmd == "MAKE_CLASS_CONFIG":
        make_class_config(args)
    elif args.cmd == "CALC_IMG_NORM":
        print("Computing dataset image-normalization mean/std...")
        mean, std = calc_img_norm(args, device=device)
        print("mean={} std={}".format(mean, std))
        return mean, std
    elif args.cmd == "PORT_WEIGHTS":
        port_weights(args)


def argparse_util():
    parser = argparse.ArgumentParser(prog="ifcbnn-util")
    sub = parser.add_subparsers(dest="cmd",
                                help="Pick exactly one sub-command.")

    dc = sub.add_parser("MAKE_DATASET_CONFIG",
                        help="Write a starter dataset-combining config csv.")
    dc.add_argument("dataset", metavar="PATH", nargs="+",
                    help='Dataset paths, optionally prefixed "n:" with an '
                         "integer priority (lower = higher priority).")
    dc.add_argument("-o", "--outfile", help="Output file; default stdout.")

    cc = sub.add_parser("MAKE_CLASS_CONFIG",
                        help="Write a starter class-config csv for a dataset.")
    cc.add_argument("dataset", metavar="PATH",
                    help="dataset directory or dataset-config csv.")
    cc.add_argument("-o", "--outfile", help="Output file; default stdout.")

    im = sub.add_parser("CALC_IMG_NORM",
                        help="Calculate dataset MEAN/STD for image normalizing")
    im.add_argument("SRC")
    im.add_argument("--resize", metavar="N", default=299, type=int,
                    choices=[224, 299], help="Resize edge used during the "
                    "scan; 299 (inception_v3 default) or 224")
    im.add_argument("--class-config", metavar=("CSV", "COL"), nargs=2)
    im.add_argument("--class-min", metavar="MIN", default=2, type=int)
    im.add_argument("--class-max", metavar="MAX", default=None, type=int)
    im.add_argument("--batch-size", metavar="B", default=108, type=int)

    pw = sub.add_parser("PORT_WEIGHTS",
                        help="Convert a torch state_dict .pth to .npz for "
                             "TRAIN --weights — or, given a checkpoint, the "
                             "reverse: a torchvision-keyed .pth for torch "
                             "users")
    pw.add_argument("STATE_DICT")
    pw.add_argument("-o", "--outfile")
    return parser


def main_cli(argv=None, device=None):
    """Parse and run; CALC_IMG_NORM returns (mean, std)."""
    args = argparse_util().parse_args(argv)
    if args.cmd is None:
        argparse_util().error("missing sub-command")
    return main(args, device=device)


if __name__ == "__main__":
    main_cli()
