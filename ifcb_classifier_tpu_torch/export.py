"""EXPORT of the port (counterpart of ifcb_classifier_tpu/export.py): for
now only the calibration loader the int8 engine shares with it,
``_load_calib_batch``. EXPORT itself (a torch artifact, ``--precision
int8`` included) comes with ROADMAP P11.
"""

from __future__ import annotations

import glob
import os

import torch


def _load_calib_batch(calib_src: str, resize: int, mean, std, n: int,
                      device):
    """One preprocessed calibration batch from a sample of deployment data
    (the JAX package's export.py:40-80): a bin directory (.adc/.roi/.hdr
    filesets; schema-v1 bins give their stitched composites, as RUN serves
    them) or an image folder / .txt list. Returns the [n', resize,
    resize, 3] float32 tensor on ``device`` (n' <= n) that the int8 engine
    calibrates on: bins through the gray preprocess (K1 on the card),
    images through ``HostLoader`` and the RGB preprocess (K2)."""
    from .data.pipeline import pack_canvas_batch
    from .ops.preprocess import preprocess_gray, preprocess_rgb

    adcs = sorted(glob.glob(os.path.join(calib_src, "**", "*.adc"),
                            recursive=True))
    if adcs:
        from .data.ifcb import SCHEMA_VERSION_1, Bin, infilled_images
        images = []
        for adc in adcs:
            b = Bin(adc)
            imgs = (infilled_images(b) if b.schema == SCHEMA_VERSION_1
                    else b.images)
            images.extend(imgs.values())
            if len(images) >= n:
                break
        images = images[:n]
        if not images:
            raise ValueError(f"--calib {calib_src}: no ROIs found in bins")
        canvas, sizes, _ = pack_canvas_batch(images, batch_size=len(images))
        fn = preprocess_gray
    else:
        from .data.datasets import list_image_paths
        from .data.pipeline import HostLoader
        paths = list_image_paths(calib_src)[:n]
        if not paths:
            raise ValueError(f"--calib {calib_src}: no bins or images found")
        batch = next(iter(HostLoader(paths, batch_size=len(paths))))
        canvas, sizes = batch["canvas"], batch["sizes"]  # no pad rows
        fn = preprocess_rgb
    return fn(torch.from_numpy(canvas).to(device),
              torch.from_numpy(sizes).to(device), out_size=resize,
              mean=mean, std=std, dtype=torch.float32)
