"""Host side of the input path: the canvas ladder and canvas packing
(the part of ifcb_classifier_tpu/data/pipeline.py that RUN on bins uses).

The host only packs variable-size uint8 images into a fixed uint8 canvas
batch; resizing and normalising run on the device (ops/preprocess.py).
A few canvas sizes keep the number of distinct shapes small.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CANVAS_LADDER", "MAX_CANVAS", "ladder_size", "shrink_to_fit",
           "pack_canvas_batch"]

# Plankton ROIs are typically < 256 px on a side.
CANVAS_LADDER = (64, 128, 256, 512, 1024)
MAX_CANVAS = CANVAS_LADDER[-1]


def ladder_size(max_dim: int) -> int:
    for s in CANVAS_LADDER:
        if max_dim <= s:
            return s
    return MAX_CANVAS


def shrink_to_fit(img: np.ndarray, S: int) -> np.ndarray:
    """Downscale (PIL bilinear, aspect-preserved) so max(h, w) <= S.

    Used for the rare image larger than the canvas ceiling: the whole image
    is KEPT (the reference resizes the full image in one PIL step,
    neuston_data.py:456-464; cropping would silently discard organism
    pixels). PIL is imported here only, so the rest of the port runs
    without it.
    """
    from PIL import Image
    h, w = img.shape[:2]
    scale = S / max(h, w)
    nh = max(1, int(round(h * scale)))
    nw = max(1, int(round(w * scale)))
    return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR),
                      np.uint8)


def pack_canvas_batch(images, batch_size=None, out=None):
    """Pack a list of 2-D uint8 (grayscale) arrays into one canvas batch,
    into ``out`` = (canvas, sizes) when given (shapes as returned below).

    Returns (canvas, sizes, n_valid):
      canvas  uint8 [B, S, S]; S = ladder size covering the batch
      sizes   int32 [B, 2] true (h, w) per image; pad rows get (1, 1)
      n_valid number of real images (B - n_valid are zero padding rows)
    """
    n = len(images)
    if n == 0:
        raise ValueError("empty batch")
    if any(img.ndim != 2 for img in images):
        raise NotImplementedError(
            "RGB canvases belong to the image-directory slice (ROADMAP P6)")
    B = batch_size or n
    max_dim = max(max(img.shape[0], img.shape[1]) for img in images)
    S = ladder_size(max_dim)
    if out is None:
        out = np.empty((B, S, S), np.uint8), np.empty((B, 2), np.int32)
    canvas, sizes = out
    if canvas.shape != (B, S, S) or sizes.shape != (B, 2):
        raise ValueError("pack_canvas_batch: out must be [{0},{1},{1}] and "
                         "[{0},2]".format(B, S))
    canvas[:] = 0
    sizes[:] = 1
    for k, img in enumerate(images):
        if img.shape[0] > S or img.shape[1] > S:
            img = shrink_to_fit(img, S)  # never crop — see shrink_to_fit
        h, w = img.shape[:2]
        canvas[k, :h, :w] = img
        sizes[k] = (h, w)
    return canvas, sizes, n
