"""Host side of the input path (the port's copy of
ifcb_classifier_tpu/data/pipeline.py): the canvas ladder, decoding, canvas
packing, the batched manifest loader and a prefetch thread.

The host only decodes to uint8 and packs variable-size images into a fixed
uint8 canvas batch; resizing, normalising and flipping run on the device
(ops/preprocess.py). A few canvas sizes keep the number of distinct shapes
small; short batches are padded and masked so every batch has one size.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["CANVAS_LADDER", "MAX_CANVAS", "ladder_size", "shrink_to_fit",
           "decode_image", "canvas_shape", "pack_canvas_batch", "HostLoader",
           "prefetch"]

# Plankton ROIs are typically < 256 px on a side.
CANVAS_LADDER = (64, 128, 256, 512, 1024)
MAX_CANVAS = CANVAS_LADDER[-1]


def ladder_size(max_dim: int) -> int:
    for s in CANVAS_LADDER:
        if max_dim <= s:
            return s
    return MAX_CANVAS


def decode_image(path: str, rgb: bool = True) -> np.ndarray:
    """Decode an image file to uint8 (H,W,3), or (H,W) with ``rgb=False``
    — the reference's `datasets.folder.default_loader` (PIL,
    .convert('RGB')). Only an image over MAX_CANVAS on a side is
    downscaled here (PIL thumbnail, bilinear) so canvases stay bounded.
    (The JAX package decodes 8-bit PNG/JPEG with its native decoder first,
    byte-identical to PIL; that decoder is not ported yet, ROADMAP.)"""
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB" if rgb else "L")
        if max(im.size) > MAX_CANVAS:
            im.thumbnail((MAX_CANVAS, MAX_CANVAS), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


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


def canvas_shape(images, batch_size, rgb=None):
    """The canvas batch that holds ``images``: (B, S, S) gray or (B, S, S,
    3) RGB, S the ladder rung of the largest side. ``rgb=None`` is RGB
    when any image is."""
    if not images:
        raise ValueError("empty batch")
    if rgb is None:
        rgb = any(img.ndim == 3 for img in images)
    elif not rgb and any(img.ndim != 2 for img in images):
        raise ValueError("pack_canvas_batch: a gray canvas (rgb=False) "
                         "cannot hold 3-D (RGB) images")
    S = ladder_size(max(max(img.shape[0], img.shape[1]) for img in images))
    return (batch_size, S, S, 3) if rgb else (batch_size, S, S)


def pack_canvas_batch(images, batch_size=None, rgb=None, out=None):
    """Pack a list of uint8 arrays (2-D gray or 3-D RGB) into one canvas
    batch, into ``out`` = (canvas, sizes) when given (shapes as returned
    below). ``rgb=None`` gives a 3-channel canvas when any image is RGB;
    gray images on a 3-channel canvas are broadcast to its channels.

    Returns (canvas, sizes, n_valid):
      canvas  uint8 [B, S, S] (gray) or [B, S, S, 3] (RGB); S = ladder size
              covering the batch
      sizes   int32 [B, 2] true (h, w) per image; pad rows get (1, 1)
      n_valid number of real images (B - n_valid are zero padding rows)
    """
    n = len(images)
    B = batch_size or n
    shape = canvas_shape(images, B, rgb)
    rgb, S = len(shape) == 4, shape[1]
    if out is None:
        out = np.empty(shape, np.uint8), np.empty((B, 2), np.int32)
    canvas, sizes = out
    if canvas.shape != shape or sizes.shape != (B, 2):
        raise ValueError("pack_canvas_batch: out must be {} and [{},2]"
                         .format(list(shape), B))
    canvas[:] = 0
    sizes[:] = 1
    for k, img in enumerate(images):
        if img.shape[0] > S or img.shape[1] > S:
            if rgb and img.ndim == 2:  # the JAX package's order: the
                img = np.stack([img] * 3, axis=-1)  # RGB image shrinks
            img = shrink_to_fit(img, S)  # never crop — see shrink_to_fit
        h, w = img.shape[:2]
        canvas[k, :h, :w] = img[..., None] if rgb and img.ndim == 2 \
            else img
        sizes[k] = (h, w)
    return canvas, sizes, n


class HostLoader:
    """Batched manifest loader with threaded decode and padded static shapes.

    items: list of image paths (decoded with decode_image, to RGB or with
           ``rgb=False`` to gray) OR in-memory uint8 arrays.
    labels: optional int targets parallel to items.

    Yields dicts: canvas uint8[B,S,S(,3)], sizes int32[B,2], labels int32[B],
    mask bool[B] (False on padding rows), indices of the items in this batch.
    With ``pin_memory`` the canvas and sizes are page-locked torch tensors
    (what an engine copies to the card without draining its stream; CUDA's
    host allocator caches them, so a batch's buffer is reused once its copy
    has run), else numpy arrays.
    """

    def __init__(self, items, labels=None, batch_size=108, num_workers=4,
                 shuffle=False, seed=0, rgb=True, balanced=False,
                 n_real=None, cache=False, pin_memory=False):
        self.items = list(items)
        self.labels = list(labels) if labels is not None else None
        # items[n_real:] are manifest pads (the multi-process slice,
        # ROADMAP P10): decoded and fed to the model but masked out of
        # loss/metrics like batch pads.
        self.n_real = len(self.items) if n_real is None else int(n_real)
        self.batch_size = int(batch_size)
        self.num_workers = max(1, int(num_workers))
        self.shuffle = shuffle
        self.seed = seed
        self.rgb = rgb
        self.pin_memory = pin_memory
        self.balanced = balanced and labels is not None
        # --cache-images: keep decoded uint8 arrays in RAM after the first
        # epoch (epochs 2+ skip decoding). Opt-in (memory ~ the decoded
        # dataset size); ndarray items bypass the cache.
        self._decoded = {} if cache else None
        self._epoch = 0

    def __len__(self):
        return (len(self.items) + self.batch_size - 1) // self.batch_size

    def _materialize(self, i):
        item = self.items[i]
        if isinstance(item, np.ndarray):
            return item
        if self._decoded is not None:
            img = self._decoded.get(i)
            if img is None:  # races only duplicate a decode, never corrupt
                img = decode_image(item, rgb=self.rgb)
                self._decoded[i] = img
            return img
        return decode_image(item, rgb=self.rgb)

    def __iter__(self):
        rng = np.random.default_rng((self.seed or 0) + self._epoch)
        if self.balanced and self.n_real == 0:
            # an all-pads manifest: serve the pad rows in order like the
            # unbalanced path (every row is masked out anyway)
            order = np.arange(len(self.items))
        elif self.balanced:
            # class-balanced sampling (with replacement, inverse-frequency
            # weights) over the real items: one "epoch" still draws
            # len(items) samples, each class contributing ~equally
            labels = np.asarray(self.labels[:self.n_real])
            counts = np.bincount(labels)
            weights = 1.0 / counts[labels]
            order = rng.choice(self.n_real, size=len(self.items),
                               replace=True, p=weights / weights.sum())
        else:
            order = np.arange(len(self.items))
            if self.shuffle:
                rng.shuffle(order)
        self._epoch += 1
        B = self.batch_size
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for start in range(0, len(order), B):
                idx = order[start:start + B]
                images = list(pool.map(self._materialize, idx))
                # pad short batches by CYCLING real images, not zeros:
                # masked rows are excluded from loss/metrics, but BatchNorm
                # statistics see every row — zero images would poison them
                n = len(images)
                while len(images) < B:
                    images.append(images[len(images) % n])
                canvas, sizes = self._pack(images, B)
                labels = np.zeros(B, dtype=np.int32)
                if self.labels is not None:
                    labels[:n] = [self.labels[i] for i in idx]
                mask = np.zeros(B, dtype=bool)
                mask[:n] = idx < self.n_real
                yield dict(canvas=canvas, sizes=sizes, labels=labels,
                           mask=mask, indices=idx)

    def _pack(self, images, B):
        if not self.pin_memory:
            return pack_canvas_batch(images, batch_size=B)[:2]
        import torch
        canvas = torch.empty(canvas_shape(images, B), dtype=torch.uint8,
                             pin_memory=True)
        sizes = torch.empty((B, 2), dtype=torch.int32, pin_memory=True)
        pack_canvas_batch(images, batch_size=B,
                          out=(canvas.numpy(), sizes.numpy()))
        return canvas, sizes


def prefetch(iterable, depth: int = 2):
    """Run `iterable` in a background thread, keeping `depth` items ready —
    overlaps host decode/pack with device compute.

    The producer checks a stop event around every blocking put, so if the
    consumer abandons the generator early (exception in the loop body,
    break, GC) the thread exits instead of blocking on a full queue forever
    and leaking decoded canvas batches in a long-lived process."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    err = []
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # surfaced in consumer
            err.append(e)
        finally:
            _put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
