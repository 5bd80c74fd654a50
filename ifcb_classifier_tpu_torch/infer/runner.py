"""The RUN engine and verb on bins (counterpart of
ifcb_classifier_tpu/infer/runner.py; the reference's `do_run`,
neuston_net.py:163-308).

One engine persists across all bins: the checkpoint is read, its BNs are
folded into the convolutions, and the model sits on the device. ROIs are
packed straight from each bin's .roi buffer into uint8 canvases on a
64/128/256/512/1024 ladder, preprocessed on the device by kernel K1
(ops/preprocess.py), classified, and fetched once per bin. Per-bin output
files and per-bin error isolation follow the reference.

Served here: ``RUN --type bin``, single process, one pass. The other modes
raise naming the slice that ports them (see UNPORTED_RUN_FLAGS).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..data.datasets import parse_imgnorm
from ..data.ifcb import SCHEMA_VERSION_1, DataDirectory, infilled_images
from ..data.pipeline import MAX_CANVAS, ladder_size, pack_canvas_batch
from ..models import get_namebrand_model
from ..models.fold import fold_state_dict, supports_fold
from ..models.torch_port import params_from_jax
from ..ops.preprocess import preprocess_gray
from ..results.run import save_run_results, validate_outfiles
from ..train.checkpoint import load_checkpoint
from ..train.state import make_predict_step
from ..utils.config import resolve_device, resolve_dtype

SCORE_HIST_BINS = 50  # the JAX package's results/plots.py:194

# (args attribute, the values this slice serves, what ports the others)
UNPORTED_RUN_FLAGS = (
    ("src_type", ("bin",), "--type img: the image-directory slice, P6"),
    ("precision", (None, "auto", "bf16", "fp32"),
     "--precision int8: the int8 tier, P8"),
    ("calib", (None,), "--calib: the int8 tier, P8"),
    ("calib_batches", (None, 1), "--calib-batches: the int8 tier, P8"),
    ("calib_count", (None, 128), "--calib-count: the int8 tier, P8"),
    ("gobig", (None, False), "--gobig: serving extras, P9"),
    ("watch", (None,), "--watch: serving extras, P9"),
    ("watch_settle", (None,), "--watch-settle: serving extras, P9"),
    ("watch_passes", (None,), "--watch-passes: serving extras, P9"),
    ("profile", (None, 0), "--profile: serving extras, P9"),
    ("plot_files", (None, []), "--plot: the plots slice, P6"),
    ("mesh", (None, "auto"), "--mesh: parallelism, P10"),
)


def reject_unported(args):
    """Raise for any RUN flag value this slice does not serve — never
    ignore one silently."""
    for attr, served, what in UNPORTED_RUN_FLAGS:
        if getattr(args, attr, None) not in served:
            raise NotImplementedError(f"not ported yet: {what} (ROADMAP)")


def _batch_buckets(batch_size, enabled=True):
    """Halving ladder of dispatch batch sizes, floor 16: batch_size=256 →
    (16,32,64,128,256); batch_size≤16 or enabled=False degenerate to the
    single full batch."""
    if not enabled or batch_size <= 16:
        return (batch_size,)
    buckets = {batch_size}
    b = batch_size
    while True:
        b = -(-b // 2)
        if b < 16 or b in buckets:
            break
        buckets.add(b)
    return tuple(sorted(buckets))


class InferenceEngine:
    """Persistent predict pipeline: uint8 canvas batch → probs, on one
    device. ``dispatches`` counts the batches sent to the device."""

    def __init__(self, ckpt_path, batch_size=108, dtype=None,
                 batch_ladder=True, device=None):
        self.device = resolve_device(device)
        params, batch_stats, hparams = load_checkpoint(ckpt_path)
        self.classes = hparams["classes"]
        self.resize = hparams["resize"]
        self.model_id = hparams.get("model_id") or \
            os.path.splitext(os.path.basename(ckpt_path))[0]
        img_norm = hparams.get("img_norm")
        self.batch_size = batch_size
        self.dtype = dtype if dtype is not None else \
            resolve_dtype(None, self.device)

        name = hparams["MODEL"]
        # the aux head runs only in training (ROADMAP P5)
        sd = {k: v for k, v in params_from_jax(params, batch_stats).items()
              if not k.startswith("AuxLogits.")}
        # eval-time BN folding (models/fold.py): exact algebra on the frozen
        # running stats, applied once here for every family that has it
        self.folded = supports_fold(name)
        if self.folded:
            sd = fold_state_dict(name, sd)
        # pretrained must round-trip: torchvision's inception_v3
        # (pretrained=True) forces transform_input=True at inference too
        model = get_namebrand_model(
            name, len(self.classes),
            pretrained=bool(hparams.get("pretrained")),
            fold_bn=self.folded)
        model.load_state_dict(sd, strict=True)
        self.model = model.to(device=self.device, dtype=self.dtype,
                              memory_format=torch.channels_last).eval()
        self._predict = make_predict_step(self.model)
        self._mean_std = (parse_imgnorm(img_norm) if img_norm
                          else (None, None))
        self.batch_buckets = _batch_buckets(self.batch_size, batch_ladder)
        self.dispatches = 0

    @classmethod
    def from_args(cls, args, device=None):
        """The one mapping from RUN flags to constructor kwargs."""
        device = resolve_device(device)
        return cls(args.MODEL, batch_size=args.batch_size,
                   dtype=resolve_dtype(getattr(args, "precision", None),
                                       device),
                   batch_ladder=getattr(args, "batch_ladder", None)
                   is not False,
                   device=device)

    def bucket_for(self, n):
        """Smallest dispatch batch covering n rows (pad-waste control)."""
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_size

    def _host_buffers(self, B, S):
        """Host tensors for one dispatch: uint8 canvas [B,S,S] and int32
        sizes [B,2]. On CUDA they are page-locked, so the packers write
        straight into memory the H2D copy reads asynchronously (from
        pageable memory CUDA drains the stream before it copies, which would
        serialise packing the next batch with computing this one)."""
        pin = self.device.type == "cuda"
        return (torch.empty((B, S, S), dtype=torch.uint8, pin_memory=pin),
                torch.empty((B, 2), dtype=torch.int32, pin_memory=pin))

    def _dispatch(self, canvas, sizes):
        """Host uint8 canvas [B,S,S] + int32 sizes [B,2] tensors (from
        _host_buffers) → device probs [B, n_classes], without waiting for
        the device."""
        canvas = canvas.to(self.device, non_blocking=True)
        sizes = sizes.to(self.device, non_blocking=True)
        mean, std = self._mean_std
        x = preprocess_gray(canvas, sizes, out_size=self.resize, mean=mean,
                            std=std, dtype=self.dtype)
        self.dispatches += 1
        return self._predict(x)

    def _fetch(self, pending):
        """One device→host copy for a list of (device probs, n rows)."""
        if not pending:
            return []
        rows = torch.cat([p[:n] for p, n in pending]).cpu().numpy()
        return np.split(rows, np.cumsum([n for _, n in pending])[:-1])

    def predict_images(self, images):
        """images: list of 2-D uint8 arrays. Returns [N, n_classes] float32
        softmax scores in input order. Images are grouped by canvas ladder
        size before chunking, so one large image cannot inflate a chunk of
        small ones."""
        if not images:
            return np.zeros((0, len(self.classes)), np.float32)
        B = self.batch_size
        ladders = np.asarray(
            [ladder_size(int(max(img.shape[0], img.shape[1])))
             for img in images])
        out = np.zeros((len(images), len(self.classes)), np.float32)
        pending, sels = [], []
        for S in np.unique(ladders):
            idx = np.nonzero(ladders == S)[0]
            for c0 in range(0, idx.size, B):
                sel = idx[c0:c0 + B]
                canvas, sizes = self._host_buffers(self.bucket_for(sel.size),
                                                   int(S))
                pack_canvas_batch([images[j] for j in sel],
                                  batch_size=canvas.shape[0],
                                  out=(canvas.numpy(), sizes.numpy()))
                pending.append((self._dispatch(canvas, sizes), sel.size))
                sels.append(sel)
        for probs, sel in zip(self._fetch(pending), sels):
            out[sel] = probs
        return out

    def predict_bin(self, bin):
        """ROIs of a schema-v2 bin are packed straight from the .roi buffer
        by the native packer; schema-v1 bins (stitched) go through
        predict_images. Returns (targets, probs) aligned, targets
        ascending."""
        from .. import native

        if bin.schema == SCHEMA_VERSION_1:
            images_dict = infilled_images(bin)
            if not images_dict:
                return [], np.zeros((0, len(self.classes)), np.float32)
            targets = list(images_dict.keys())
            return targets, self.predict_images(list(images_dict.values()))

        adc = bin.adc
        keep = np.nonzero((adc["roiWidth"] > 0) & (adc["roiHeight"] > 0))[0]
        if keep.size == 0:
            return [], np.zeros((0, len(self.classes)), np.float32)
        heights = adc["roiHeight"][keep].astype(np.int64)
        widths = adc["roiWidth"][keep].astype(np.int64)
        starts = adc["startByte"][keep].astype(np.int64)
        roi_buf = bin._roi_bytes
        err = _roi_bounds_error(roi_buf, keep, heights, widths, starts)
        if err is not None:
            raise err

        big_rows, keep, heights, widths, starts = _split_oversized(
            self.predict_images, roi_buf, keep, heights, widths, starts)
        targets = keep + 1
        if keep.size == 0:
            ordered = sorted(big_rows)
            return ordered, np.stack([big_rows[t] for t in ordered])
        ladders = np.asarray([ladder_size(int(max(h, w)))
                              for h, w in zip(heights, widths)])

        B = self.batch_size
        pending, sels = [], []  # fetched once at bin end: the next chunk's
        # pack and copy overlap this chunk's compute
        for S in np.unique(ladders):
            idx = np.nonzero(ladders == S)[0]
            for c0 in range(0, idx.size, B):
                sel = idx[c0:c0 + B]
                canvas, sizes = self._host_buffers(self.bucket_for(sel.size),
                                                   int(S))
                native.pack_rois_native(
                    roi_buf, starts[sel], heights[sel], widths[sel],
                    batch_size=canvas.shape[0], canvas_size=int(S),
                    out=(canvas.numpy(), sizes.numpy()))
                # the packer marks out-of-bounds ROIs (truncated .roi) as
                # (0,0): fail the whole bin so it lands in the error report
                bad = np.nonzero(sizes[:len(sel), 0].numpy() == 0)[0]
                if bad.size:
                    raise ValueError(
                        "corrupt bin: ROI byte range out of bounds for "
                        "target(s) {}".format(
                            [int(targets[sel[j]]) for j in bad[:5]]))
                pending.append((self._dispatch(canvas, sizes), sel.size))
                sels.append(sel)
        probs_by_target = dict(big_rows)
        for probs, sel in zip(self._fetch(pending), sels):
            for k, j in enumerate(sel):
                probs_by_target[int(targets[j])] = probs[k]
        ordered = sorted(probs_by_target)
        return ordered, np.stack([probs_by_target[t] for t in ordered])


def _roi_bounds_error(roi_buf, keep, heights, widths, starts):
    """Whole-bin ROI byte-range validation: returns a ValueError to raise,
    or None. Overflow-safe like the native packer (roipack.cpp)."""
    size = np.int64(roi_buf.size)
    wpos = np.maximum(widths, 1)
    bad = np.nonzero((heights <= 0) | (widths <= 0) | (starts < 0) |
                     (starts > size) |
                     (heights > (size - starts) // wpos))[0]
    if bad.size:
        return ValueError(
            "corrupt bin: ROI byte range out of bounds for target(s) "
            "{}".format([int(keep[j] + 1) for j in bad[:5]]))
    return None


def _split_oversized(predict_images, roi_buf, keep, heights, widths, starts):
    """ROIs whose longer side exceeds the canvas ceiling go through the
    shrink-to-fit path (the native packer would crop them; the reference
    classifies the full image, neuston_data.py:456-464). Returns
    ({target: probs_row} for those, and keep/heights/widths/starts of the
    rest)."""
    big = np.maximum(heights, widths) > MAX_CANVAS
    if not big.any():
        return {}, keep, heights, widths, starts
    bsel = np.nonzero(big)[0]
    imgs = [roi_buf[int(starts[j]):int(starts[j]) +
                    int(heights[j]) * int(widths[j])]
            .reshape(int(heights[j]), int(widths[j]))
            for j in bsel]
    bprobs = predict_images(imgs)
    big_rows = {int(keep[j] + 1): bprobs[k] for k, j in enumerate(bsel)}
    norm = np.nonzero(~big)[0]
    return (big_rows, keep[norm], heights[norm], widths[norm], starts[norm])


def _bin_fmt(bin_obj):
    """The outfile templating fields for one bin
    (neuston_callbacks.py:180-184)."""
    return dict(BIN_ID=bin_obj.pid, BIN_YEAR=bin_obj.year,
                BIN_DATE=bin_obj.yearday, INPUT_SUBDIRS=bin_obj.namespace)


def parse_filter(filter_arg):
    """IN/OUT + keywords or keyword-files (neuston_net.py:199-207). The
    mode is validated loudly and blank keyword lines are dropped (both
    fixed reference quirks, as in the JAX package)."""
    if not filter_arg:
        return None, []
    mode = filter_arg[0]
    if mode not in ("IN", "OUT"):
        raise ValueError('--filter mode must be "IN" or "OUT" (got {!r})'
                         .format(mode))
    keywords = []
    for keyword in filter_arg[1:]:
        if os.path.isfile(keyword):
            with open(keyword) as f:
                keywords.extend(k for k in
                                (line.strip() for line in f) if k)
        else:
            keywords.append(keyword)
    if not keywords:
        raise ValueError("--filter {} needs at least one KEYWORD "
                         "(or a non-empty keyword file)".format(mode))
    return mode, keywords


def do_run(args, engine=None):
    """RUN --type bin over a bin directory, a .txt bin list or one bin."""
    reject_unported(args)
    if engine is None:
        engine = InferenceEngine.from_args(args)

    if os.path.isdir(args.SRC) and not args.SRC.endswith(os.sep):
        args.SRC = args.SRC + os.sep
    if not args.outfile:
        args.outfile = ["D{BIN_YEAR}/D{BIN_DATE}/{BIN_ID}_class.h5"]
    validate_outfiles(args.outfile, src_type="bin")
    filter_mode, filter_keywords = parse_filter(args.filter)

    summary_file = getattr(args, "summary", None)
    agg_counts = np.zeros(len(engine.classes), np.int64)
    agg_hist = np.zeros(SCORE_HIST_BINS, np.int64)
    agg_total = 0
    error_bins = []
    n_done = 0

    def make_dd():
        if os.path.isdir(args.SRC):
            wl = filter_keywords if filter_mode == "IN" else None
            bl = filter_keywords if filter_mode == "OUT" else None
            return DataDirectory(args.SRC, whitelist=wl, blacklist=bl)
        if os.path.isfile(args.SRC) and args.SRC.endswith(".txt"):
            with open(args.SRC) as f:
                bins = [b.strip() for b in f.read().splitlines()
                        if b.strip()]
            if not bins:
                raise ValueError(f"{args.SRC}: bin list is empty")
            return DataDirectory.from_basepaths(bins)
        return DataDirectory.from_basepaths([args.SRC])

    def emit_result(bin_obj, targets, probs):
        nonlocal n_done, agg_total
        input_images = [bin_obj.with_target(t) for t in targets]
        for outfile in args.outfile:
            save_run_results(input_images, probs, engine.classes,
                             args.cmd_timestamp, args.outdir, outfile,
                             engine.model_id, bin_obj)
        cls = np.argmax(probs, axis=1)
        agg_counts[:] += np.bincount(cls, minlength=len(engine.classes))
        agg_hist[:] += np.histogram(np.max(probs, axis=1),
                                    bins=SCORE_HIST_BINS, range=(0, 1))[0]
        agg_total += len(cls)
        n_done += 1
        print(".", end="", flush=True)

    for bin in make_dd():
        # namespace = the bin's subdirs under SRC, prefix-anchored
        bp = bin.fileset.basepath
        rel = os.path.dirname(
            bp[len(args.SRC):] if bp.startswith(args.SRC) else bp)
        bin.pid.namespace = rel + os.sep if rel else ""
        bin_obj = bin.pid

        if args.filter:  # keyword filter on the pid (neuston_net.py:236-240)
            if filter_mode == "IN" and not any(
                    k in str(bin_obj) for k in filter_keywords):
                continue
            if filter_mode == "OUT" and any(
                    k in str(bin_obj) for k in filter_keywords):
                continue

        if not args.clobber:
            fmt = _bin_fmt(bin_obj)
            ofiles = [os.path.join(args.outdir, o).format(**fmt)
                      .replace(2 * os.sep, os.sep) for o in args.outfile]
            if all(os.path.isfile(o) for o in ofiles):
                print("{} result-file(s) already exist - skipping this bin"
                      .format(bin_obj))
                continue

        try:
            targets, probs = engine.predict_bin(bin)
            if not targets:
                error_bins.append((bin_obj, AssertionError("Bin is Empty")))
                continue
            emit_result(bin_obj, targets, probs)
        except Exception as e:  # per-bin isolation (neuston_net.py:266-268)
            error_bins.append((bin_obj, e))

    if summary_file:
        path = os.path.join(args.outdir, summary_file)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = dict(
            version="v3", run_id=args.RUN_ID, model_id=engine.model_id,
            timestamp=args.cmd_timestamp, updated_at=time.time(),
            src_type="bin", n_images=None, n_bins_done=n_done,
            n_rois=int(agg_total),
            class_counts={c: int(n) for c, n in
                          zip(engine.classes, agg_counts)},
            score_histogram=dict(bins=len(agg_hist), range=[0, 1],
                                 counts=[int(x) for x in agg_hist]),
            n_errors=len(error_bins),
            errors=[dict(bin=str(b), type=type(e).__name__, message=str(e))
                    for b, e in error_bins[-100:]])
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)

    print("\nRUN IS DONE ({} bins)".format(n_done))
    if error_bins:
        print("Bins that errored and produced no output:")
        for bin_obj, err in error_bins:
            print(bin_obj, type(err), err)
