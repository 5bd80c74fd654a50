#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ifcb_classifier_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. device: needs CUDA; prints the card's name and power limit.
  2. K1 (csrc/preprocess_gray.cu) is built from the checkout (ptxas's
     registers and shared memory printed per kernel) and held against its
     plain PyTorch version on the card at every canvas rung S in
     {64..1024}, r=299, B in {16, 256}: f32 within 1e-5 before the norm
     (1e-4 after it, std >= 0.161), bf16 equal to the kernel's f32 result
     rounded once to bf16, and the tap tables of its prologue equal to
     their plain twin. A batch of sizes outside [0, S] (0, S, 2S, -3) runs
     through K1 at every rung and must finish with finite output, and a
     canvas its 16-byte loads cannot read (S not a multiple of 16, or data
     not 16-byte aligned) must be refused. Per rung at B=256 it times the
     kernel on uniform sizes (ms between events around calls enqueued as
     the host makes them; beside it the device time alone, the calls queued
     behind a device-side sleep, and the wrapper's host us per call; the
     plain version and
     F.interpolate(bilinear, antialias) on full-canvas images beside it: a
     yardstick of the resize alone; the port never calls it), and again on
     the main path's size mix (ROI sides drawn as phase 3 draws them, with
     the share of (1,1) pad rows the engine's dispatch buckets leave).
     K2 (csrc/preprocess_rgb.cu), built beside K1 (one nvcc per source,
     started together), is held the same way against its plain version on
     RGB canvases at every rung, B in {16, 128}, with and without the norm
     and flips: f32 within 1e-5 before the norm and 1e-4 after it, bf16
     equal to its f32 result rounded once; sizes outside [0, S] finish
     finite and unreadable canvases are refused. Per rung it prints K2's
     tile plan and launch shape in bf16 and f32 (fails if bf16 has fewer
     than two blocks an SM, or if the card's plan differs from its Python
     mirror k2_plan, which the CPU tests walk). Per rung at B=128, bf16
     with norm and flips, it is timed as K1 is (F.interpolate on the full
     RGB canvas as the yardstick), and again on TRAIN's own size mix (the
     batches phase 4's loader forms from roi_sides images, each on the
     rung of its largest side; the 64 and 128 rungs, which no batch
     reaches, from their own pools), after holding it there to its plain
     version as above. Then K2 at the shapes its serving callers give it,
     every rung: B=256 without flips with the norm (RUN --type img in bf16;
     VAL and the int8 engine in f32) and B=108 f32 without the norm at
     r=299 and r=224 (CALC_IMG_NORM), held the same way against its plain
     version, the card's plan at r=224 equal to k2_plan's, and timed at
     B=256 bf16 and at B=108 f32 r=224.
  2c. K3 (csrc/qconv_s8.cu), built beside K1 and K2, is held against its
     plain version (ops/qconv.qconv_plain: a float64 convolution of the
     int8 values, exact, then the f32 epilogue) on the card at every
     distinct conv geometry of inception_v3 @299 (Ci, Co, kernel, stride,
     pads, H, W, from a shape-only pass of the int8 graph), inputs from a
     seed: B=8 emitting s8, bf16 and f32 and B=1 emitting s8 (most of these
     M are no multiple of the 128-row tile), with the weights packed per
     call and packed once (ops/qconv.pack_k3_weights): bitwise equal, also
     when it writes its channels of a wider concat buffer at channel offset
     32, and at 8 in rows of Co + 40 bytes (no 16-byte alignment); a CPU
     tensor and a misaligned one are refused. At B=256 (the RUN's batch,
     where the persistent grid walks several tiles a block) it is held
     bitwise to the plain version and timed on five
     shapes of the main path (ms, device ms, host us per call, bound and
     what bounds it, the plain version's ms; beside them the bf16 cuDNN
     conv + bias + relu of the same shape, the float path K3 replaces, and
     for the 1x1 shape torch._int_mm on the same s8 GEMM without an
     epilogue: neither computes K3's function and the port calls neither),
     and once over a dispatch: each geometry at B=256, held bitwise to the
     plain version and timed (device time) with the emit the graph gives
     it (s8, or bf16 for Mixed_7c's branch ends), weighted by how many of
     the 94 convs have it, summed beside the summed bound (the kernels
     line's dispatch_ms, dispatch_bound_ms).
  3. the RUN path: synthetic IFCB bins (a realistic ROI size mix over the
     64..1024 rungs, one bin of 1,500 ROIs) are classified by
     ``RUN --batch 256`` of the port's CLI with a random-init full-width
     inception_v3 (50 classes, resize 299, BN folded, bf16). It checks every
     bin's result file, that K1 launched once per engine dispatch, the
     fp32 card result (TF32 off) against the port's CPU path on a small bin
     (scores within 1e-5), and prints the bf16-vs-fp32 score delta and the
     RUN's img/s.
  3b. ``RUN --batch 256 --precision int8`` of the CLI on the same bins and
     checkpoint: the engine calibrates on its first dispatch and serves
     every dispatch in int8. It checks every result file, K1 launches =
     dispatches, K3 launches = 94 x the int8 dispatches, the int8 scores
     against phase 3's fp32 ones (max |d p| < 2e-2, the JAX package's
     int8 gate against full precision, tests/test_quant.py:48; argmax
     agreement and the int8-vs-bf16 delta printed), and the card against
     the CPU path at batch 8 on the small bin with the same absmax pinned
     into both engines and their float parts in f32 (TF32 off): scores
     within TOL_INT8_CPU, argmax equal. It prints the warm int8 RUN img/s
     beside the bf16 one and profiles the warm int8 RUN as phase 3 does.
  4. the TRAIN path: ``TRAIN --batch 128`` of the port's CLI: a
     folder-per-class PNG dataset written here (ROI sides drawn as phase 3
     draws them, so the batches land on the rungs a real dataset's do) is
     trained for 2 epochs, full-width inception_v3 @299, bf16, batch 128,
     flips on. It checks finite losses, K2 calls = train + validation
     steps, the .ptl written, and serves that .ptl with RUN on a bin (the
     TRAIN→RUN round trip); it prints the train img/s and the rung of each
     train batch. Then one train step in fp32 (TF32 off, dropout 0) on the
     card against the port's CPU path on the same batch: loss within 1e-4
     relative; every parameter's gradient within 3x the CPU f32
     gradient's distance to a CPU float64 step's, plus 1e-3 of its norm
     (the f32 noise-floor rule of tests/test_train_dynamics_parity.py: at
     this untrained init the BN gradients of the early layers cancel so
     far that f32 alone moves them by a few percent). Before it, the
     port's avg_pool backward in channels_last on the card within 1e-5 of
     a float64 CPU reference (PyTorch's own channels_last CUDA kernel,
     which it avoids, is printed beside it).
  5. the verbs that serve a trained model, full-width inception_v3 @299:
     5a. ``RUN --type img --batch 256`` (bf16) of phase 3's checkpoint on
     1,024 PNGs written under 4 subfolders (roi_sides' sides, every third
     one gray): every image scored once in img_results.json, one
     ``{INPUT_SUBDIRS}img.json`` per subfolder, ``--summary`` src_type
     img; K2 launches = engine dispatches, K1 none; fp32 on the card (TF32
     off) against the CPU path on 16 images (scores within 1e-5); the
     warm img/s. 5b. the same with ``--precision int8``: K3 launches = 94
     x the int8 dispatches, scores within 2e-2 of 5a's fp32 ones (argmax
     agreement printed), the warm img/s beside bf16's. 5c. a reference
     Lightning .ptl of phase 3's weights (model.-prefixed torchvision
     keys, num_batches_tracked, an aux head, hparams an AttributeDict of
     a throwaway module) served by RUN fp32 on phase 3's two smallest
     bins: scores within 1e-6 of the port's own checkpoint's; a .ptl
     holding a class outside the unpickler's allowlist refused. 5d.
     ``VAL --batch 128`` of phase 4's .ptl on phase 4's dataset: every
     image listed, K2 launches = batches, the warm img/s; fp32 on the card
     against the CPU path on 32 images (scores within 1e-5, val_loss
     within 1e-5 relative). 5e. ``CALC_IMG_NORM`` of phase 4's dataset at
     --resize 299 and 224 (K2 once per batch of 108); the card against the
     CPU path on 64 images within 1e-5. 5f. ``PORT_WEIGHTS`` of phase 4's
     checkpoint to a .pth and on to an .npz, bitwise the checkpoint; the
     trunk that TRAIN --weights' loader returns from the .pth bitwise the
     file with fresh heads; ``TRAIN --weights --emax 1`` to finite losses.
  6. prints the kernels line (K2's launches keep counting TRAIN's calls;
     its launches_by_path count each verb's, its run_img row is K2 at B=256
     bf16 without flips on the rung most 5a batches land on) and, last,
     the device line.

Weights and bins are made from fixed seeds; nothing is downloaded.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LADDER = (64, 128, 256, 512, 1024)
R = 299
MEAN = (0.667, 0.667, 0.667)
STD = (0.161, 0.161, 0.161)
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12    # f32 outside the tensor cores
N_CLASSES = 50
BIN_SIZES = (1500, 700, 300, 24)   # ROIs per synthetic bin
TOL_F32 = 1e-5
TOL_F32_NORM = 1e-4
TOL_CPU_SCORES = 1e-5
SLEEP_CYCLES_PER_CALL = 400_000  # ~0.2 ms of the card's clock per queued call
RGB_MEAN = (0.667, 0.6, 0.55)
RGB_STD = (0.161, 0.2, 0.25)
TRAIN_CLASSES = 4
TRAIN_IMAGES = 160          # per class: 512 train + 128 val images
TRAIN_BATCH = 128
TOL_TRAIN_LOSS = 1e-4       # card fp32 vs CPU, relative
TOL_TRAIN_GRAD = 1e-3       # card fp32 vs f64 truth beyond 3x CPU f32's
H100_S8_OP_PER_S = 1.979e15  # s8 dense tensor cores
TOL_INT8_FP32 = 2e-2        # int8 vs fp32 scores (tests/test_quant.py:48)
# card vs CPU int8 scores with one pinned absmax: about twice the change
# that +-1e-5 noise on the CPU's preprocessed images makes (9.4e-3 on this
# checkpoint's small bin): a few inputs land one s8 step apart and the
# steps grow through the 94 requantized layers
TOL_INT8_CPU = 2e-2
K3_CONVS = 94
K3_BATCH = 256
# (name, Ci, Co, kh, kw, stride, pads, H): the shapes phase 2c times
K3_SHAPES = (
    ("Conv2d_2b_3x3", 32, 64, 3, 3, 1, ((1, 1), (1, 1)), 147),
    ("Conv2d_4a_3x3", 80, 192, 3, 3, 1, ((0, 0), (0, 0)), 73),
    ("Mixed_5b/branch1x1", 192, 64, 1, 1, 1, ((0, 0), (0, 0)), 35),
    ("Mixed_6b/branch7x7_2", 128, 128, 1, 7, 1, ((0, 0), (3, 3)), 17),
    ("Mixed_7b/branch3x3dbl_2", 448, 384, 3, 3, 1, ((1, 1), (1, 1)), 8))
K3_MAIN = "Conv2d_4a_3x3"  # the kernels line's row: the most operations
R_224 = 224                 # CALC_IMG_NORM --resize 224
RUN_BATCH = 256             # RUN --type img's batch (phase 5a)
NORM_BATCH = 108            # CALC_IMG_NORM's default batch
IMG_DIRS = 4                # phase 5a's image tree: subfolders
IMG_COUNT = 1024            # ... and PNGs in all
TOL_PTL = 1e-6              # .ptl vs the port's checkpoint, same weights
TOL_VAL_LOSS = 1e-5         # card fp32 vs CPU val_loss, relative


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters, warmup=2, queued=False):
    """ms per call of fn between two events on the card. By default the
    calls are enqueued as the host makes them, so a wrapper slower than its
    kernels is timed at the host's rate. queued=True puts them behind a
    device-side sleep, so the card runs them back to back: the device time
    alone."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters=50):
    """Host microseconds per call of fn while the card is kept busy behind a
    device-side sleep, so no call waits for it: the wrapper's own cost."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def make_canvas(B, S, rng, full=False):
    """uint8 [B,S,S] zero outside each image, int32 sizes in [1, S] with
    (1,1) pad rows at the end (full=True: every image fills the canvas)."""
    if full:
        sizes = np.full((B, 2), S, np.int32)
    else:
        sizes = rng.integers(1, S + 1, size=(B, 2)).astype(np.int32)
        sizes[-max(1, B // 8):] = 1  # pad rows, as the packer leaves them
    canvas = np.zeros((B, S, S), np.uint8)
    for b, (h, w) in enumerate(sizes):
        canvas[b, :h, :w] = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    return canvas, sizes


def k1_bound(sizes, S, r, out_bytes, channels=1, flips=False):
    """(bound ms, 'bytes'|'operations') for one K1 call (channels=1) or K2
    call (channels=3) on these inputs: the bytes it needs (each image's
    true h x w x channels canvas bytes, the sizes and the flip mask read
    once, each output written once) against the multiply-adds of the taps
    these sizes need."""
    import torch
    from ifcb_classifier_tpu_torch.ops.preprocess import resize_weights
    B = sizes.shape[0]
    in_bytes = int((sizes[:, 0].astype(np.int64) * sizes[:, 1]).sum()) \
        * channels
    nbytes = in_bytes + sizes.nbytes + B * r * r * 3 * out_bytes \
        + (2 * B if flips else 0)
    nnz_h = (resize_weights(torch.from_numpy(sizes[:, 0]), S, r) > 0) \
        .sum(dim=(1, 2)).numpy()
    nnz_w = (resize_weights(torch.from_numpy(sizes[:, 1]), S, r) > 0) \
        .sum(dim=(1, 2)).numpy()
    ops = float(channels * np.sum(2 * sizes[:, 1] * nnz_h + 2 * r * nnz_w)
                + B * r * r * 8)  # /255, clip, 3x (x-m)/s
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_taps(sizes, s, S):
    """K1's prologue on the card against its plain twin: equal tables (the
    same float32 operations in the same order on both sides)."""
    import torch
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        tap_tables_cuda, tap_tables_plain)
    got = tap_tables_cuda(s, S, R)
    ref = tap_tables_plain(torch.from_numpy(sizes), S, R)
    torch.cuda.synchronize()
    for name, g, want in zip(("lo", "n", "weights"), got, ref):
        if not torch.equal(g.cpu(), want):
            raise AssertionError(
                f"K1 tap table {name} S={S}: max |d| "
                f"{float((g.cpu().double() - want.double()).abs().max())}")


def check_out_of_range(S, rng, rgb=False):
    """Sizes outside [0, S]: outside the contract, but K1 (K2 with
    rgb=True, flips on) must stay inside its buffers (it clamps them) and
    finish with finite output."""
    import torch
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        preprocess_gray_cuda, preprocess_rgb_cuda)
    sizes = np.array([(0, S), (S, 0), (2 * S, S), (S, 2 * S), (2 * S, 2 * S),
                      (0, 0), (-3, S), (S, S)], np.int32)
    shape = (len(sizes), S, S) + ((3,) if rgb else ())
    c = torch.from_numpy(rng.integers(0, 256, size=shape,
                                      dtype=np.uint8)).cuda()
    s = torch.from_numpy(sizes).cuda()
    if rgb:
        f = torch.ones((len(sizes), 2), dtype=torch.uint8, device="cuda")
        fn = lambda dtype: preprocess_rgb_cuda(
            c, s, out_size=R, mean=RGB_MEAN, std=RGB_STD, flips=f,
            dtype=dtype)
    else:
        fn = lambda dtype: preprocess_gray_cuda(
            c, s, out_size=R, mean=MEAN, std=STD, dtype=dtype)
    for dtype in (torch.float32, torch.bfloat16):
        out = fn(dtype)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{'K2' if rgb else 'K1'} sizes outside "
                                 f"[0, {S}]: non-finite output ({dtype})")


def check_rejects(S, rgb=False):
    """The wrapper refuses a canvas that its 16-byte loads cannot read: S
    not a multiple of 16, or data not 16-byte aligned."""
    import torch
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        preprocess_gray_cuda, preprocess_rgb_cuda)
    fn = preprocess_rgb_cuda if rgb else preprocess_gray_cuda
    ch = (3,) if rgb else ()
    sizes = torch.ones((2, 2), dtype=torch.int32, device="cuda")
    odd = torch.zeros((2, S - 8, S - 8) + ch, dtype=torch.uint8,
                      device="cuda")
    n = 2 * S * S * (3 if rgb else 1)
    flat = torch.zeros(n + 16, dtype=torch.uint8, device="cuda")
    shifted = flat[8:8 + n].view((2, S, S) + ch)
    before = fn.launches
    for bad in (odd, shifted):
        try:
            fn(bad, sizes, out_size=R)
        except ValueError:
            continue
        raise AssertionError(f"{fn.__name__} accepted a canvas "
                             f"{tuple(bad.shape)} at address "
                             f"{bad.data_ptr():#x}")
    if fn.launches != before:
        raise AssertionError(f"{fn.__name__} counted a launch it refused")


def roi_sides(n, rng):
    """IFCB-like ROI sides: log-normal (median ~48 px), so most land on the
    64/128 rungs and a tail reaches 256..1024; none over 1024."""
    sides = np.clip(np.round(rng.lognormal(np.log(48), 0.75, (n, 2))),
                    8, 1024).astype(int)
    if n >= 1000:  # make sure every rung is fed
        sides[:4] = [(300, 200), (180, 450), (700, 90), (1000, 1024)]
    return sides


def main_path_mix(rng):
    """{rung: (ROI sides landing there, share of pad rows)} for bins of
    BIN_SIZES ROIs drawn as phase 3 draws them: the engine puts each ROI on
    the rung that holds it and sends each bin's ROIs of a rung in chunks of
    256, the last padded with (1,1) rows up to its dispatch bucket."""
    from ifcb_classifier_tpu_torch.data.pipeline import ladder_size
    from ifcb_classifier_tpu_torch.infer.runner import _batch_buckets
    buckets = _batch_buckets(256)
    pools = {S: [] for S in LADDER}
    real = {S: 0 for S in LADDER}
    sent = {S: 0 for S in LADDER}
    for n in BIN_SIZES:
        sides = roi_sides(n, rng)
        rungs = np.array([ladder_size(int(max(h, w))) for h, w in sides])
        for S in LADDER:
            on = sides[rungs == S]
            pools[S].extend(map(tuple, on))
            full, rest = divmod(len(on), 256)
            real[S] += len(on)
            sent[S] += 256 * full + (min(b for b in buckets if b >= rest)
                                     if rest else 0)
    return {S: (np.array(pools[S], np.int32).reshape(-1, 2),
                1.0 - real[S] / sent[S] if sent[S] else 1.0) for S in LADDER}


def mix_canvas(B, S, pool, pad_share, rng):
    """uint8 [B,S,S] + sizes: real rows drawn from the rung's pool, then
    (1,1) pad rows in the engine's share."""
    n_pad = int(round(B * pad_share))
    sizes = np.ones((B, 2), np.int32)
    sizes[:B - n_pad] = pool[rng.integers(0, len(pool), B - n_pad)]
    canvas = np.zeros((B, S, S), np.uint8)
    for b, (h, w) in enumerate(sizes):
        canvas[b, :h, :w] = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    return canvas, sizes


def check_k1(rng):
    """Phase 2. Returns (per-rung timing rows, main-path-mix rows, max f32
    error)."""
    import torch
    import torch.nn.functional as F
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        k1_resize_shape, preprocess_gray_cuda, preprocess_gray_plain)
    dev = torch.device("cuda")
    # own generators: phase 3's bins stay those of earlier runs
    side_rng = np.random.default_rng(1)
    mix = main_path_mix(side_rng)
    max_err = 0.0
    rows, mix_rows = [], []
    for S in LADDER:
        check_out_of_range(S, side_rng)
        check_rejects(S)
        for B in (16, 256):
            canvas, sizes = make_canvas(B, S, rng)
            c = torch.from_numpy(canvas).to(dev)
            s = torch.from_numpy(sizes).to(dev)
            check_taps(sizes, s, S)
            for mean, std, tol in ((None, None, TOL_F32),
                                   (MEAN, STD, TOL_F32_NORM)):
                ref = preprocess_gray_plain(c, s, out_size=R, mean=mean,
                                            std=std)
                got = preprocess_gray_cuda(c, s, out_size=R, mean=mean,
                                           std=std, dtype=torch.float32)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                if not err <= tol:
                    raise AssertionError(
                        f"K1 f32 S={S} B={B} norm={mean is not None}: "
                        f"max|err| {err} > {tol}")
                if mean is not None:
                    max_err = max(max_err, err)
                bf = preprocess_gray_cuda(c, s, out_size=R, mean=mean,
                                          std=std, dtype=torch.bfloat16)
                torch.cuda.synchronize()
                # one rounding of the same f32 value: exactly equal
                if not torch.equal(bf, got.to(torch.bfloat16)):
                    n_diff = int((bf != got.to(torch.bfloat16)).sum())
                    raise AssertionError(
                        f"K1 bf16 S={S} B={B}: {n_diff} values differ from "
                        "the f32 result rounded to bf16")
            print(f"K1 check S={S} B={B}: ok (f32 max|err| with norm "
                  f"{err:.3g}; tap tables equal; sizes outside [0, S] "
                  "finite; unaligned canvas refused)", flush=True)
        # timing at the main path's full batch, bf16 + norm
        B = 256
        kernel = lambda: preprocess_gray_cuda(c, s, out_size=R, mean=MEAN,
                                              std=STD, dtype=torch.bfloat16)
        plain = lambda: preprocess_gray_plain(c, s, out_size=R, mean=MEAN,
                                              std=STD, dtype=torch.bfloat16)
        full, _ = make_canvas(B, S, rng, full=True)
        xf = torch.from_numpy(full).to(dev).float()[:, None]
        lib = lambda: F.interpolate(xf, (R, R), mode="bilinear",
                                    antialias=True, align_corners=False)
        row = dict(S=S, B=B, ms=cuda_ms(kernel, 20),
                   device_ms=cuda_ms(kernel, 20, queued=True),
                   host_us=host_us(kernel), plain_ms=cuda_ms(plain, 5),
                   library_ms=cuda_ms(lib, 10))
        row["bound_ms"], row["bound_by"] = k1_bound(sizes, S, R, 2)
        (row["smem"], row["per_sm"], row["grid"], row["threads"],
         row["step"]) = k1_resize_shape(B, S, R)
        rows.append(row)
        print("K1 time S={S} B={B} bf16: kernel {ms:.4f} ms (device "
              "alone {device_ms:.4f} ms; wrapper host {host_us:.1f} us per "
              "call), plain "
              "{plain_ms:.4f} ms, F.interpolate (resize only, full canvas) "
              "{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              "({bound_by}); resize grid {grid} x {threads} threads, "
              "{step} rows per item, {per_sm} blocks per SM, {smem} B shared "
              "memory each".format(**row), flush=True)
        pool, pad_share = mix[S]
        mc, ms = mix_canvas(B, S, pool, pad_share, side_rng)
        c, s = torch.from_numpy(mc).to(dev), torch.from_numpy(ms).to(dev)
        mrow = dict(S=S, B=B, pad_share=pad_share, ms=cuda_ms(kernel, 20),
                    device_ms=cuda_ms(kernel, 20, queued=True))
        mrow["bound_ms"], mrow["bound_by"] = k1_bound(ms, S, R, 2)
        mix_rows.append(mrow)
        print("K1 time S={S} B={B} bf16, main-path size mix ({pad_share:.3f}"
              " pad rows): kernel {ms:.4f} ms (device alone {device_ms:.4f}"
              " ms), bound {bound_ms:.4f} ms "
              "({bound_by})".format(**mrow), flush=True)
        del c, s, xf
    return rows, mix_rows, max_err


def rgb_canvas_of(sizes, S, rng):
    """uint8 [B,S,S,3], each image's (h, w) filled from rng, zero beyond."""
    canvas = np.zeros((len(sizes), S, S, 3), np.uint8)
    for b, (h, w) in enumerate(sizes):
        canvas[b, :h, :w] = rng.integers(0, 256, size=(h, w, 3),
                                         dtype=np.uint8)
    return canvas


def make_rgb_canvas(B, S, rng, full=False):
    """uint8 [B,S,S,3] zero outside each image, int32 sizes as make_canvas
    draws them."""
    gray, sizes = make_canvas(B, S, rng, full=full)
    return rgb_canvas_of(sizes, S, rng), sizes


def train_mix(rng, n_batches=200):
    """{rung: (int32 sides [TRAIN_BATCH, 2], where from)} of the batches
    TRAIN's loader forms from roi_sides images: batches of TRAIN_BATCH
    drawn as phase 4's dataset is, each on the rung of its largest side;
    a rung's first such batch ("batch", with the count of batches that
    landed there), or, on a rung no batch reached (64, 128), TRAIN_BATCH
    sides from the images whose own rung it is ("pool", as K1's
    mix_canvas)."""
    from ifcb_classifier_tpu_torch.data.pipeline import ladder_size
    batches = {S: [] for S in LADDER}
    pools = {S: [] for S in LADDER}
    for _ in range(n_batches):
        sides = roi_sides(TRAIN_BATCH, rng).astype(np.int32)
        batches[ladder_size(int(sides.max()))].append(sides)
        for hw in sides:
            pools[ladder_size(int(hw.max()))].append(hw)
    mix = {}
    for S in LADDER:
        if batches[S]:
            mix[S] = (batches[S][0], f"batch (1 of {len(batches[S])})")
        else:
            pool = np.array(pools[S], np.int32)
            mix[S] = (pool[rng.integers(0, len(pool), TRAIN_BATCH)],
                      f"pool ({len(pool)} images)")
    return mix


def check_k2_against_plain(c, s, f, S, B, what):
    """K2 f32 against its plain version, with and without the norm and
    the flips (TOL_F32, TOL_F32_NORM), and its bf16 output equal to the f32
    one rounded once. Returns the f32 error with the norm and flips."""
    import torch
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        preprocess_rgb_cuda, preprocess_rgb_plain)
    for mean, std, tol in ((None, None, TOL_F32),
                           (RGB_MEAN, RGB_STD, TOL_F32_NORM)):
        for flips in (None, f):
            ref = preprocess_rgb_plain(c, s, out_size=R, mean=mean, std=std,
                                       flips=flips)
            got = preprocess_rgb_cuda(c, s, out_size=R, mean=mean, std=std,
                                      flips=flips, dtype=torch.float32)
            bf = preprocess_rgb_cuda(c, s, out_size=R, mean=mean, std=std,
                                     flips=flips, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not err <= tol:
                raise AssertionError(
                    f"K2 f32 S={S} B={B} {what} norm={mean is not None} "
                    f"flips={flips is not None}: max|err| {err} > {tol}")
            if not torch.equal(bf, got.to(torch.bfloat16)):
                n_diff = int((bf != got.to(torch.bfloat16)).sum())
                raise AssertionError(
                    f"K2 bf16 S={S} B={B} {what}: {n_diff} values differ "
                    "from the f32 result rounded to bf16")
    return err


# what K2's plan fixes, in k2_resize_shape and k2_plan alike
K2_PLAN_KEYS = ("rows", "cols", "nbuf", "window_rows", "window_bytes",
                "smem", "threads")


def check_k2(rng):
    """Phase 2, K2. Returns (per-rung timing rows, TRAIN-mix rows, max f32
    error after the norm)."""
    import torch
    import torch.nn.functional as F
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        k2_plan, k2_resize_shape, preprocess_rgb_cuda, preprocess_rgb_plain)
    dev = torch.device("cuda")
    side_rng = np.random.default_rng(2)
    mix = train_mix(np.random.default_rng(3))
    max_err, rows, mix_rows = 0.0, [], []
    for S in LADDER:
        check_out_of_range(S, side_rng, rgb=True)
        check_rejects(S, rgb=True)
        for B in (16, TRAIN_BATCH):
            canvas, sizes = make_rgb_canvas(B, S, side_rng)
            c = torch.from_numpy(canvas).to(dev)
            s = torch.from_numpy(sizes).to(dev)
            f = torch.from_numpy(side_rng.integers(0, 2, (B, 2))
                                 .astype(np.uint8)).to(dev)
            err = check_k2_against_plain(c, s, f, S, B, "uniform sizes")
            max_err = max(max_err, err)
            print(f"K2 check S={S} B={B}: ok (f32 max|err| with norm and "
                  f"flips {err:.3g}; sizes outside [0, S] finite; "
                  "unaligned canvas refused)", flush=True)
        # the plan and its launch shape; two blocks an SM at least in bf16;
        # the card's plan (C) the same as its mirror that the CPU tests
        # walk (ops/preprocess.k2_plan)
        dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
        shapes = {name: k2_resize_shape(TRAIN_BATCH, S, R, dtype)
                  for name, dtype in dtypes.items()}
        for name, sh in shapes.items():
            plan = k2_plan(S, R, dtypes[name])
            differ = {k: (sh[k], plan[k]) for k in K2_PLAN_KEYS
                      if sh[k] != plan[k]}
            if differ:
                raise AssertionError(
                    f"K2 plan S={S} {name}: the card's plan and k2_plan "
                    f"differ (card, mirror): {differ}")
        if shapes["bf16"]["per_sm"] < 2:
            raise AssertionError(f"K2 S={S} bf16: {shapes['bf16']['per_sm']}"
                                 " block per SM, the plan needs 2 or more")
        for name, sh in shapes.items():
            print("K2 plan S={S} {name}: tiles of {rows} x {cols} (one "
                  "row step: {ncol} tiles), {nbuf} canvas buffer(s) of "
                  "{window_rows} rows x {window_bytes} B, {smem} B shared "
                  "memory, {threads} threads, {per_sm} blocks per SM, grid "
                  "{grid} at B={B}".format(S=S, name=name, B=TRAIN_BATCH,
                                           ncol=-(-R // sh["cols"]), **sh),
                  flush=True)
        # timing at the training batch, bf16 + norm + flips
        B = TRAIN_BATCH
        kernel = lambda: preprocess_rgb_cuda(
            c, s, out_size=R, mean=RGB_MEAN, std=RGB_STD, flips=f,
            dtype=torch.bfloat16)
        plain = lambda: preprocess_rgb_plain(
            c, s, out_size=R, mean=RGB_MEAN, std=RGB_STD, flips=f,
            dtype=torch.bfloat16)
        xf = torch.empty((B, 3, S, S), device=dev).uniform_(0, 255)
        lib = lambda: F.interpolate(xf, (R, R), mode="bilinear",
                                    antialias=True, align_corners=False)
        row = dict(S=S, B=B, ms=cuda_ms(kernel, 20),
                   device_ms=cuda_ms(kernel, 20, queued=True),
                   host_us=host_us(kernel), plain_ms=cuda_ms(plain, 3),
                   library_ms=cuda_ms(lib, 5))
        row["bound_ms"], row["bound_by"] = k1_bound(sizes, S, R, 2,
                                                    channels=3, flips=True)
        row.update(shapes["bf16"])
        rows.append(row)
        print("K2 time S={S} B={B} bf16 norm flips: kernel {ms:.4f} ms "
              "(device alone {device_ms:.4f} ms; wrapper host {host_us:.1f} "
              "us per call), plain {plain_ms:.4f} ms, F.interpolate "
              "(resize only, full RGB canvas) {library_ms:.4f} ms, bound "
              "{bound_ms:.4f} ms ({bound_by}); resize grid {grid} x "
              "{threads} threads, tiles of {rows} x {cols}, {per_sm} blocks "
              "per SM, {smem} B shared memory each".format(**row),
              flush=True)
        del c, s, f, xf
        # TRAIN's own size mix: held to the plain version, then timed
        msizes, where = mix[S]
        c = torch.from_numpy(rgb_canvas_of(msizes, S, side_rng)).to(dev)
        s = torch.from_numpy(msizes).to(dev)
        f = torch.from_numpy(side_rng.integers(0, 2, (B, 2))
                             .astype(np.uint8)).to(dev)
        err = check_k2_against_plain(c, s, f, S, B, "TRAIN mix")
        max_err = max(max_err, err)
        mrow = dict(S=S, B=B, sides_from=where,
                    median_side=float(np.median(msizes)),
                    max_side=int(msizes.max()), ms=cuda_ms(kernel, 20),
                    device_ms=cuda_ms(kernel, 20, queued=True))
        mrow["bound_ms"], mrow["bound_by"] = k1_bound(msizes, S, R, 2,
                                                      channels=3, flips=True)
        mix_rows.append(mrow)
        print("K2 time S={S} B={B} bf16 norm flips, TRAIN size mix "
              "({sides_from}; median side {median_side:.0f}, largest "
              "{max_side}): held to the plain version, kernel {ms:.4f} ms "
              "(device alone {device_ms:.4f} ms), bound {bound_ms:.4f} ms "
              "({bound_by})".format(**mrow), flush=True)
        del c, s, f
    return rows, mix_rows, max_err


def check_k2_serving(side_rng):
    """Phase 2, K2 at the shapes its serving callers give it: RUN --type
    img and VAL (B=256, no flips, norm; bf16 as RUN serves, f32 as VAL and
    the int8 engine preprocess) and CALC_IMG_NORM (B=108, f32, no norm, at
    r=299 and r=224), every rung, held against the plain version (f32
    within TOL_F32_NORM / TOL_F32, bf16 equal to the f32 result rounded
    once); the card's plan at r=224 equal to k2_plan's. Times K2 at each
    rung for B=256 bf16 norm (RUN img) and B=108 f32 r=224
    (CALC_IMG_NORM). Returns ({S: RUN-img row}, {S: r=224 row}, max
    f32 error)."""
    import torch
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        k2_plan, k2_resize_shape, preprocess_rgb_cuda, preprocess_rgb_plain)
    dev = torch.device("cuda")
    run_rows, norm_rows, max_err = {}, {}, 0.0
    for S in LADDER:
        for name, dtype in (("bf16", torch.bfloat16),
                            ("f32", torch.float32)):
            sh = k2_resize_shape(NORM_BATCH, S, R_224, dtype)
            plan = k2_plan(S, R_224, dtype)
            differ = {k: (sh[k], plan[k]) for k in K2_PLAN_KEYS
                      if sh[k] != plan[k]}
            if differ:
                raise AssertionError(
                    f"K2 plan S={S} r={R_224} {name}: the card's plan and "
                    f"k2_plan differ (card, mirror): {differ}")
        for B, r, norm, what in ((RUN_BATCH, R, True, "RUN img / VAL"),
                                 (NORM_BATCH, R_224, False,
                                  "CALC_IMG_NORM 224"),
                                 (NORM_BATCH, R, False,
                                  "CALC_IMG_NORM 299")):
            canvas, sizes = make_rgb_canvas(B, S, side_rng)
            c = torch.from_numpy(canvas).to(dev)
            s = torch.from_numpy(sizes).to(dev)
            mean, std = (RGB_MEAN, RGB_STD) if norm else (None, None)
            tol = TOL_F32_NORM if norm else TOL_F32
            ref = preprocess_rgb_plain(c, s, out_size=r, mean=mean, std=std)
            got = preprocess_rgb_cuda(c, s, out_size=r, mean=mean, std=std,
                                      dtype=torch.float32)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not err <= tol:
                raise AssertionError(f"K2 f32 S={S} B={B} r={r} {what}: "
                                     f"max|err| {err} > {tol}")
            max_err = max(max_err, err) if norm else max_err
            if norm:
                bf = preprocess_rgb_cuda(c, s, out_size=r, mean=mean,
                                         std=std, dtype=torch.bfloat16)
                if not torch.equal(bf, got.to(torch.bfloat16)):
                    raise AssertionError(
                        f"K2 bf16 S={S} B={B} {what}: differs from the "
                        "f32 result rounded to bf16")
            dtype = torch.bfloat16 if norm else torch.float32
            kernel = (lambda c=c, s=s, r=r, mean=mean, std=std, dtype=dtype:
                      preprocess_rgb_cuda(c, s, out_size=r, mean=mean,
                                          std=std, dtype=dtype))
            if r == R_224 or norm:
                row = dict(S=S, B=B, r=r, ms=cuda_ms(kernel, 10),
                           device_ms=cuda_ms(kernel, 10, queued=True))
                row["bound_ms"], row["bound_by"] = k1_bound(
                    sizes, S, r, 2 if norm else 4, channels=3)
                if norm:
                    row["plain_ms"] = cuda_ms(lambda: preprocess_rgb_plain(
                        c, s, out_size=r, mean=mean, std=std,
                        dtype=torch.bfloat16), 2)
                    run_rows[S] = row
                else:
                    norm_rows[S] = row
                print("K2 time S={S} B={B} r={r} {what}: kernel {ms:.4f} ms "
                      "(device alone {device_ms:.4f} ms), bound {bound_ms:.4f}"
                      " ms ({bound_by})".format(what=what, **row), flush=True)
            del c, s, ref, got
        print(f"K2 check S={S} serving shapes: ok (B={RUN_BATCH} no flips "
              f"bf16/f32 with the norm; B={NORM_BATCH} f32 no norm at r="
              f"{R} and {R_224}; the card's r={R_224} plan is k2_plan's)",
              flush=True)
    return run_rows, norm_rows, max_err


def inception_conv_shapes():
    """The distinct (Ci, Co, kh, kw, stride, pads, H, W) of inception_v3's
    94 convs at 299 px, from a shape-only pass (meta tensors) of the int8
    graph's calibration topology: each with the first conv path that has
    it, how many of the 94 have it and how many of those emit floats
    (Mixed_7c's branch ends, which feed the head) rather than s8."""
    import torch
    from ifcb_classifier_tpu_torch.models import get_namebrand_model
    from ifcb_classifier_tpu_torch.models import quant_graph as QG
    found = {}

    class ShapeCtx(QG._CalibCtx):
        def conv(self, x, path, stride=1, padding=0, emit="self", dst=None):
            y = super().conv(x, path, stride, padding, emit, dst)
            w = self.p[".".join(path) + ".weight"]
            g = self.geoms[tuple(path)]
            key = (x.shape[1], w.shape[0], w.shape[2], w.shape[3],
                   g["strides"][0], g["padding"], x.shape[2], x.shape[3])
            first, n, n_float = found.get(key, ("/".join(path), 0, 0))
            found[key] = (first, n + 1, n_float + (emit is None))
            return y

        def group(self, out_keys, extra=()):
            # a stand-in for the block's shared output scale, so that only
            # the convs the int8 graph gives emit=None (Mixed_7c's branch
            # ends) count as emitting floats
            return "group"

    model = get_namebrand_model("inception_v3", N_CLASSES, fold_bn=True)
    params = {k: v.to("meta") for k, v in model.state_dict().items()}
    records, geoms = {}, {}
    QG._graph(ShapeCtx(params, records, geoms, torch.float32),
              torch.empty((1, R, R, 3), device="meta"), False)
    if len(geoms) != K3_CONVS or sum(n for _, n, _ in found.values()) \
            != K3_CONVS:
        raise AssertionError(f"shape pass saw {len(geoms)} convs")
    return found


def k3_bound(B, H, W, ci, co, kh, kw, Ho, Wo, out_bytes):
    """(bound ms, 'bytes'|'operations') of one K3 call: its input, weights,
    scale and bias read once and its output written once at 3.35 TB/s,
    against 2*M*N*K s8 operations at 1,979 TOPS."""
    M, K = B * Ho * Wo, kh * kw * ci
    nbytes = B * H * W * ci + co * K + 8 * co + M * co * out_bytes
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * M * co * K / H100_S8_OP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k3_inputs(B, H, W, ci, co, kh, kw, gen):
    """s8 x [B,H,W,Ci] and weights [Co,kh,kw,Ci], f32 scale and bias [Co]
    on the card, from ``gen``; the scale puts acc*scale at O(1), so the
    s8 emit at inv_out 127/4 spans the grid and clips a little."""
    import torch
    x = torch.randint(-127, 128, (B, H, W, ci), dtype=torch.int8,
                      generator=gen)
    w = torch.randint(-127, 128, (co, kh, kw, ci), dtype=torch.int8,
                      generator=gen)
    std = 127.0 * 127.0 / 3.0 * (kh * kw * ci) ** 0.5
    scale = (0.5 + torch.rand(co, generator=gen)) / std
    bias = 0.5 * torch.randn(co, generator=gen)
    return tuple(t.cuda() for t in (x, w, scale, bias))


K3_INV_OUT = 127.0 / 4.0


def k3_expect(ref, co, width, c_off, fill=77):
    """The concat buffer K3 must leave: ``fill`` everywhere but channels
    c_off..c_off+co, which hold ``ref``."""
    import torch
    buf = torch.full((*ref.shape[:3], width), fill, dtype=ref.dtype,
                     device=ref.device)
    buf[..., c_off:c_off + co] = ref
    return buf


def check_k3():
    """Phase 2c. Returns (timing rows of K3_SHAPES, number of geometries
    checked, the per-dispatch sweep)."""
    import torch
    import torch.nn.functional as F
    from ifcb_classifier_tpu_torch.ops.qconv import (
        conv_out_size, pack_k3_weights, qconv_cuda, qconv_plain)
    gen = torch.Generator().manual_seed(4)
    shapes = inception_conv_shapes()
    ragged = 0
    for (ci, co, kh, kw, st, pads, H, W), (path, _, _) in sorted(
            shapes.items()):
        stride = (st, st)
        Ho, Wo = conv_out_size(H, W, kh, kw, stride, pads)
        where = f"K3 {path} Ci={ci} Co={co} {kh}x{kw}/{st} {pads} {H}x{W}"
        for B in (8, 1):
            x, w, scale, bias = k3_inputs(B, H, W, ci, co, kh, kw, gen)
            packed = pack_k3_weights(w)
            emits = ((K3_INV_OUT, torch.int8), (None, torch.bfloat16),
                     (None, torch.float32)) if B == 8 else \
                ((K3_INV_OUT, torch.int8),)
            for inv, dtype in emits:
                ref = qconv_plain(x, w, scale, bias, stride, pads, inv,
                                  out_dtype=dtype)
                if dtype == torch.int8:
                    ref_s8 = ref
                got = [qconv_cuda(x, w, scale, bias, stride, pads, inv,
                                  out_dtype=dtype, pack=pk)
                       for pk in (None, packed)]
                torch.cuda.synchronize()
                for g, how in zip(got, ("packed per call", "packed once")):
                    if not torch.equal(g, ref):
                        n = int((g != ref).sum())
                        raise AssertionError(
                            f"{where} B={B} emit {dtype} ({how}): {n} "
                            "values differ from the plain version")
            # its channels of a wider concat buffer, the rest untouched: at
            # offset 32 (B=8), and at 8 in rows of co + 40 (no 16-byte
            # alignment: the kernel's narrower stores)
            c_off, width = (32, co + 48) if B == 8 else (8, co + 40)
            buf = torch.full((B, Ho, Wo, width), 77, dtype=torch.int8,
                             device="cuda")
            qconv_cuda(x, w, scale, bias, stride, pads, K3_INV_OUT, out=buf,
                       c_off=c_off, pack=packed)
            torch.cuda.synchronize()
            if not torch.equal(buf, k3_expect(ref_s8, co, width, c_off)):
                raise AssertionError(f"{where} B={B}: concat-buffer write "
                                     f"at channel {c_off} differs")
            ragged += (B * Ho * Wo) % 128 != 0
    print(f"K3 check: bitwise equal to the plain version at all "
          f"{len(shapes)} distinct conv geometries of inception_v3 @299: "
          "B=8 emitting s8, bf16 and f32 and B=1 emitting s8, each with the "
          "weights packed per call and packed once; into a concat buffer at "
          "channel offset 32 (B=8) and 8 in rows of Co + 40 bytes (B=1); "
          f"{ragged} of the {2 * len(shapes)} cases have an M that is not "
          "a multiple of the 128-row tile", flush=True)
    # refusals: a CPU tensor, a misaligned x
    x, w, scale, bias = k3_inputs(2, 9, 9, 32, 16, 1, 1, gen)
    flat = torch.zeros(x.numel() + 16, dtype=torch.int8, device="cuda")
    shifted = flat[8:8 + x.numel()].view(x.shape)
    n = qconv_cuda.launches
    for bad in (x.cpu(), shifted):
        try:
            qconv_cuda(bad, w, scale, bias, (1, 1), ((0, 0), (0, 0)), 1.0)
        except ValueError:
            continue
        raise AssertionError(f"K3 accepted x on {bad.device} at "
                             f"{bad.data_ptr():#x}")
    if qconv_cuda.launches != n:
        raise AssertionError("K3 counted a launch it refused")

    rows = []
    for name, ci, co, kh, kw, st, pads, H in K3_SHAPES:
        B = K3_BATCH
        x, w, scale, bias = k3_inputs(B, H, H, ci, co, kh, kw, gen)
        stride = (st, st)
        Ho, Wo = conv_out_size(H, H, kh, kw, stride, pads)
        packed = pack_k3_weights(w)
        kernel = lambda: qconv_cuda(x, w, scale, bias, stride, pads,
                                    K3_INV_OUT, pack=packed)
        plain = lambda: qconv_plain(x, w, scale, bias, stride, pads,
                                    K3_INV_OUT)
        xb = torch.randn((B, ci, H, H), device="cuda", dtype=torch.bfloat16
                         ).contiguous(memory_format=torch.channels_last)
        wb = torch.randn((co, ci, kh, kw), device="cuda",
                         dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bb = torch.randn(co, device="cuda", dtype=torch.bfloat16)
        padding = (pads[0][0], pads[1][0])
        lib = lambda: F.relu(F.conv2d(xb, wb, bb, stride, padding))
        got, ref = kernel(), plain()
        if not torch.equal(got, ref):
            raise AssertionError(f"K3 {name} B={B} s8 emit: "
                                 f"{int((got != ref).sum())} values differ "
                                 "from the plain version")
        del got, ref
        row = dict(name=name, B=B, ms=cuda_ms(kernel, 20),
                   device_ms=cuda_ms(kernel, 20, queued=True),
                   host_us=host_us(kernel),
                   plain_ms=cuda_ms(plain, 2, warmup=1),
                   library_ms=cuda_ms(lib, 20), int_mm_ms=None)
        if kh == kw == 1:
            a, b = x.view(-1, ci), w.view(co, ci).t()
            row["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(a, b), 20)
        row["bound_ms"], row["bound_by"] = k3_bound(
            B, H, H, ci, co, kh, kw, Ho, Wo, 1)
        rows.append(row)
        print("K3 time {name} B={B} s8 emit: kernel {ms:.4f} ms (device "
              "alone {device_ms:.4f} ms; wrapper host {host_us:.1f} us per "
              "call), bound {bound_ms:.4f} ms ({bound_by}), {x:.1f}x the "
              "bound; plain {plain_ms:.2f} ms; bf16 cuDNN conv+bias+relu "
              "{library_ms:.4f} ms{mm}".format(
                  x=row["ms"] / row["bound_ms"],
                  mm="" if row["int_mm_ms"] is None else
                  "; torch._int_mm (s8 GEMM, no epilogue) "
                  f"{row['int_mm_ms']:.4f} ms", **row), flush=True)
        del x, w, xb, wb
    return rows, len(shapes), k3_dispatch_sweep(shapes)


def k3_dispatch_sweep(shapes):
    """K3 over one int8 dispatch at B=256: each distinct geometry held
    bitwise to the plain version, then timed (device time, the calls
    queued) with the emit the graph gives its convs, s8 or bf16 (Mixed_7c's
    branch ends), weighted by how many of the 94 convs have it. Returns
    dict(ms, bound_ms, rows)."""
    import torch
    from ifcb_classifier_tpu_torch.ops.qconv import (
        conv_out_size, pack_k3_weights, qconv_cuda, qconv_plain)
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, total, bound, rows = K3_BATCH, 0.0, 0.0, []
    for (ci, co, kh, kw, st, pads, H, W), (path, n, n_float) in sorted(
            shapes.items()):
        x = torch.randint(-127, 128, (B, H, W, ci), dtype=torch.int8,
                          device="cuda", generator=gen)
        w = torch.randint(-127, 128, (co, kh, kw, ci), dtype=torch.int8,
                          device="cuda", generator=gen)
        std = 127.0 * 127.0 / 3.0 * (kh * kw * ci) ** 0.5
        scale = (0.5 + torch.rand(co, device="cuda", generator=gen)) / std
        bias = 0.5 * torch.randn(co, device="cuda", generator=gen)
        stride = (st, st)
        Ho, Wo = conv_out_size(H, W, kh, kw, stride, pads)
        packed = pack_k3_weights(w)
        for inv, dtype, convs in ((K3_INV_OUT, torch.int8, n - n_float),
                                  (None, torch.bfloat16, n_float)):
            if not convs:
                continue
            out = torch.empty((B, Ho, Wo, co), dtype=dtype, device="cuda")
            call = lambda: qconv_cuda(x, w, scale, bias, stride, pads, inv,
                                      out_dtype=dtype, out=out, pack=packed)
            call()
            ref = qconv_plain(x, w, scale, bias, stride, pads, inv,
                              out_dtype=dtype)
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"K3 {path} B={B} emit {dtype}: "
                    f"{int((out != ref).sum())} values differ from the plain "
                    "version")
            del ref
            ms = cuda_ms(call, 10, queued=True)
            b, by = k3_bound(B, H, W, ci, co, kh, kw, Ho, Wo,
                             out.element_size())
            total += convs * ms
            bound += convs * b
            rows.append(dict(path=path, convs=convs, emit=str(dtype)[6:],
                             ms=ms, bound_ms=b, bound_by=by))
            del out
        del x
    print(f"K3 per dispatch (the 94 convs of inception_v3 @299 at B={B}, "
          f"{len(shapes)} geometries, each held bitwise to the plain version "
          f"and timed once (device time) with the emit the graph gives it, "
          f"s8 or bf16, weighted by its convs): {total:.4f} ms against a "
          f"summed bound of {bound:.4f} ms ({total / bound:.2f}x); slowest "
          "against their bound: " + "; ".join(
              f"{r['path']} {r['emit']} x{r['convs']} {r['ms']:.4f} ms / "
              f"{r['bound_ms']:.4f}"
              for r in sorted(rows, key=lambda r: -(r['ms'] - r['bound_ms'])
                              * r['convs'])[:8]), flush=True)
    return dict(ms=total, bound_ms=bound, rows=rows)


def write_train_dataset(root, rng):
    """Folder-per-class PNGs (RGB) with ROI sides drawn as phase 3 draws
    them: a plankton-like blob of a per-class tint in noise."""
    from PIL import Image
    for k in range(TRAIN_CLASSES):
        d = os.path.join(root, f"class{k}")
        os.makedirs(d)
        tint = np.array([1.0, 0.6 + 0.1 * k, 1.0 - 0.15 * k])
        for i, (h, w) in enumerate(roi_sides(TRAIN_IMAGES, rng)):
            yy, xx = np.mgrid[0:h, 0:w]
            blob = 200 - 120 * np.exp(-(((yy - h / 2) / (h / 4)) ** 2
                                        + ((xx - w / 2) / (w / 4)) ** 2))
            img = blob[..., None] * tint + rng.normal(0, 12, (h, w, 3))
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(d, f"{i:04d}.png"))


def train_step_card_vs_cpu(ds_root, seed=0):
    """One fp32 train step (TF32 off, dropout 0, channels_last as TRAIN
    lays the model out) on the card and on the CPU from the same weights
    and batch, and a float64 one on the CPU as the truth: (loss rel.
    difference card vs CPU, per-tensor gradient rows (name, card distance
    to the truth, CPU f32 distance) over the tensor's norm)."""
    import torch
    from ifcb_classifier_tpu_torch.data.datasets import NeustonDataset
    from ifcb_classifier_tpu_torch.data.pipeline import HostLoader
    from ifcb_classifier_tpu_torch.models.inception import InceptionV3
    from ifcb_classifier_tpu_torch.ops.preprocess import preprocess_rgb
    from ifcb_classifier_tpu_torch.train.state import (
        init_params, make_optimizer, make_train_step)
    from ifcb_classifier_tpu_torch.utils.config import resolve_dtype
    nd = NeustonDataset(ds_root)
    batch = next(iter(HostLoader(nd.images[::40], nd.targets[::40],
                                 batch_size=8, seed=seed)))
    resolve_dtype("fp32", "cuda")  # turns TF32 off
    out = {}
    for name, dev, dtype in (("card", "cuda", torch.float32),
                             ("cpu", "cpu", torch.float32),
                             ("cpu64", "cpu", torch.float64)):
        model = init_params(InceptionV3(TRAIN_CLASSES, aux_logits=True,
                                        dropout_rate=0.0), seed)
        model = model.to(device=dev, dtype=dtype,
                         memory_format=torch.channels_last)
        step = make_train_step(model, make_optimizer(model.parameters()),
                               dtype=dtype)
        c = torch.from_numpy(batch["canvas"]).to(dev)
        s = torch.from_numpy(batch["sizes"]).to(dev)
        x = preprocess_rgb(c, s, out_size=R, mean=RGB_MEAN, std=RGB_STD,
                           dtype=torch.float32).to(dtype)
        loss = float(step(x, torch.from_numpy(batch["labels"]).to(dev),
                          torch.from_numpy(batch["mask"]).to(dev)))
        out[name] = (loss, {n: p.grad.detach().double().cpu()
                            for n, p in model.named_parameters()})
    (lg, gg), (lc, gc), (_, g64) = out["card"], out["cpu"], out["cpu64"]
    rel = abs(lg - lc) / max(abs(lc), 1e-30)
    rows = []
    for n, truth in g64.items():
        tn = max(float(truth.norm()), 1e-30)
        rows.append((n, float((gg[n] - truth).norm()) / tn,
                     float((gc[n] - truth).norm()) / tn))
    return rel, rows


def train_profile(ds, work, card):
    """One more TRAIN epoch of the same dataset (4 train + 1 validation
    steps) under torch.profiler, after the cuDNN warm-up. Read inside the
    loop's ``train_pass`` span alone (the train steps, without the dataset
    scan, model build, validation and writes): its wall, the card's busy
    share, the host's time waiting on the loader, in the copies in
    (``h2d`` spans) and launching the steps (``step`` spans), the top
    kernels and K2's share; and, beside it, the busy share of the whole
    invocation. Informational, like phase 3's profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ifcb_classifier_tpu_torch.cli import main_cli
    from ifcb_classifier_tpu_torch.train.loop import do_training
    argv = ["--batch", str(TRAIN_BATCH), "TRAIN", ds, "inception_v3",
            "smoke_prof", "--emax", "1", "--estop", "0", "--outdir",
            os.path.join(work, "train_prof"), "--seed", "1", "--flip", "xy",
            "--img-norm", ",".join(map(str, RGB_MEAN)),
            ",".join(map(str, RGB_STD))]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        main_cli(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kern = [e for e in device_events(prof)
            if not e.name.startswith(("Memcpy", "Memset"))]
    spans = [e for e in prof.events() if e.name == "train_pass"
             and e.device_type == torch.autograd.DeviceType.CPU]
    if not kern or len(spans) != 1:
        print(f"train profile: {len(kern)} device events and {len(spans)} "
              "train_pass spans recorded; no breakdown", flush=True)
        return
    a, b = spans[0].time_range.start, spans[0].time_range.end
    busy_all = union_us((e.time_range.start, e.time_range.end) for e in kern)
    inside = [e for e in kern if a <= e.time_range.start < b]
    copy_ms = union_us(
        (e.time_range.start, min(e.time_range.end, b))
        for e in device_events(prof) if e.name.startswith("Memcpy")
        and a <= e.time_range.start < b) / 1e3
    busy = union_us((e.time_range.start, min(e.time_range.end, b))
                    for e in inside)
    by_name = {}
    for e in inside:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    k2 = sum(v for k, v in by_name.items() if "preprocess_rgb" in k
             or "preprocess_gray_taps" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    wait_ms = 1e3 * do_training.stats["epoch_wait_seconds"][-1]
    pass_ms = (b - a) / 1e3
    host_ms = {n: sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.name == n and a <= e.time_range.start < b
                      and e.device_type == torch.autograd.DeviceType.CPU)
               / 1e3 for n in ("h2d", "step")}
    print(f"train profile, train pass alone (4 warm steps, wall "
          f"{pass_ms:.1f} ms): kernels busy {busy / 1e3:.1f} ms = "
          f"{100 * busy / (b - a):.1f}% (idle "
          f"{100 - 100 * busy / (b - a):.1f}%), waiting on the host loader "
          f"{wait_ms:.1f} ms = {100 * wait_ms / pass_ms:.1f}% of the pass, "
          f"in the copies in {host_ms['h2d']:.1f} ms = "
          f"{100 * host_ms['h2d'] / pass_ms:.1f}%, launching the steps "
          f"{host_ms['step']:.1f} ms = {100 * host_ms['step'] / pass_ms:.1f}%, "
          f"memcpy on the card {copy_ms:.1f} ms, "
          f"{len(inside)} kernel launches, K2 (taps + resize) "
          f"{k2 / 1e3:.2f} ms; the whole 1-epoch invocation (dataset scan, "
          f"model build, validation, writes): wall {wall_s * 1e3:.1f} ms, "
          f"busy {busy_all / 1e3:.1f} ms = "
          f"{100 * busy_all / (wall_s * 1e6):.1f}%; on {card}", flush=True)
    print("train profile, train pass top kernels (ms): " + "; ".join(
        f"{k[:60]} {v / 1e3:.2f}" for k, v in top), flush=True)


def check_avg_pool_backward():
    """The port's avg_pool backward on the card, channels_last f32, for
    inception's two pool shapes, against PyTorch's native backward in
    float64 on the CPU (within 1e-5 of its norm); beside it the error of
    PyTorch's own channels_last CUDA avg_pool2d backward, which the port
    does not use. Returns {geometry: (port error, native error)}."""
    import torch
    import torch.nn.functional as F
    from ifcb_classifier_tpu_torch.models.layers import avg_pool
    g = torch.Generator().manual_seed(0)
    out = {}
    for (w, st, p), shape in (((3, 1, 1), (8, 192, 35, 35)),
                              ((5, 3, 0), (8, 768, 17, 17))):
        x = torch.randn(shape, generator=g, dtype=torch.float64)
        x64 = x.clone().requires_grad_(True)
        y64 = F.avg_pool2d(x64, w, st, p, count_include_pad=True)
        dy = torch.randn(y64.shape, generator=g, dtype=torch.float64)
        y64.backward(dy)
        ref = x64.grad
        errs = []
        for fn in (avg_pool, lambda t, *a: F.avg_pool2d(
                t, *a, count_include_pad=True)):
            xc = x.float().cuda().contiguous(
                memory_format=torch.channels_last).requires_grad_(True)
            fn(xc, w, st, p).backward(dy.float().cuda().contiguous(
                memory_format=torch.channels_last))
            errs.append(float((xc.grad.double().cpu() - ref).norm()
                              / ref.norm()))
        out[(w, st, p)] = tuple(errs)
        if not errs[0] <= 1e-5:
            raise AssertionError(f"avg_pool {w}/{st}/{p} backward on the "
                                 f"card: rel. error {errs[0]}")
    return out


def train_path(work, bins_dir, card):
    """Phase 4. Returns the TRAIN numbers (K2 launches among them)."""
    import torch
    from ifcb_classifier_tpu_torch.cli import main_cli
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        preprocess_gray_cuda, preprocess_rgb_cuda)
    from ifcb_classifier_tpu_torch.train.loop import do_training

    ds = os.path.join(work, "train_ds")
    t0 = time.perf_counter()
    write_train_dataset(ds, np.random.default_rng(3))
    print(f"TRAIN dataset: {TRAIN_CLASSES} classes x {TRAIN_IMAGES} PNGs "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    out = os.path.join(work, "train")
    argv = ["--batch", str(TRAIN_BATCH), "TRAIN", ds, "inception_v3",
            "smoke_train", "--emax", "2", "--estop", "0", "--outdir", out,
            "--seed", "1", "--flip", "xy", "--img-norm",
            ",".join(map(str, RGB_MEAN)), ",".join(map(str, RGB_STD))]
    preprocess_gray_cuda.launches = 0
    preprocess_rgb_cuda.launches = 0
    t0 = time.perf_counter()
    main_cli(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    k2 = preprocess_rgb_cuda.launches
    k1 = preprocess_gray_cuda.launches
    st = dict(do_training.stats)
    steps = st["train_steps"] + st["val_steps"]
    if not (k2 > 0 and k2 == steps and k1 == 0):
        raise AssertionError(f"K2 launched {k2} times (K1 {k1}) for "
                             f"{steps} train + validation steps")
    with open(os.path.join(out, "epochs.csv")) as f:
        rows = f.read().splitlines()[1:]
    losses = [float(v) for r in rows for v in r.split(",")[2:4]]
    if len(rows) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"TRAIN epochs.csv: {rows}")
    ptl = os.path.join(out, "smoke_train.ptl")
    if not os.path.isfile(ptl):
        raise AssertionError("TRAIN wrote no .ptl")
    img_s = st["train_images"] / st["train_seconds"]
    warm_img_s = st["epoch_images"][-1] / st["epoch_seconds"][-1]
    rungs = dict(sorted(st["rungs"].items()))
    print(f"TRAIN (inception_v3 @299 bf16, batch {TRAIN_BATCH}, 2 epochs, "
          f"flips xy): {st['train_steps']} train + {st['val_steps']} "
          f"validation steps, K2 launches {k2} ({k2 // 2} per epoch), wall "
          f"{wall_s:.1f} s incl. model build; train passes "
          f"{st['train_images']} images in {st['train_seconds']:.2f} s = "
          f"{img_s:.1f} img/s (the first step's warm-up included; second "
          f"epoch alone {warm_img_s:.1f} img/s); waits on the host loader "
          f"per epoch {[round(w, 3) for w in st['epoch_wait_seconds']]} s "
          f"of {[round(t, 3) for t in st['epoch_seconds']]} s; train-batch "
          f"canvas rungs {rungs}; losses {losses} on {card}", flush=True)
    train_profile(ds, work, card)

    # TRAIN -> RUN: the trained checkpoint serves a bin
    run_out = os.path.join(work, "train_run")
    preprocess_gray_cuda.launches = 0
    engine = main_cli(["--batch", "256", "RUN", bins_dir, ptl, "smoke",
                       "--outdir", run_out, "--outfile",
                       "{BIN_ID}_class.json"])
    torch.cuda.synchronize()
    if not (preprocess_gray_cuda.launches == engine.dispatches > 0):
        raise AssertionError("TRAIN->RUN: K1 launches "
                             f"{preprocess_gray_cuda.launches} for "
                             f"{engine.dispatches} dispatches")
    n_json = 0
    for name in os.listdir(run_out):
        if name.endswith("_class.json"):
            with open(os.path.join(run_out, name)) as f:
                res = json.load(f)
            scores = np.asarray(res["output_scores"])
            if scores.shape[1] != TRAIN_CLASSES \
                    or not np.isfinite(scores).all():
                raise AssertionError(f"TRAIN->RUN {name}: {scores.shape}")
            n_json += 1
    if n_json != len(BIN_SIZES):
        raise AssertionError(f"TRAIN->RUN wrote {n_json} result files")
    print(f"TRAIN->RUN: the trained .ptl classified {len(BIN_SIZES)} bins "
          f"({engine.dispatches} dispatches through K1)", flush=True)

    pools = check_avg_pool_backward()
    print("avg_pool backward on the card, channels_last f32, vs float64: "
          + "; ".join(f"{w}/{st}/{p}: the port's {e[0]:.3g}, PyTorch's "
                      f"channels_last CUDA kernel {e[1]:.3g}"
                      for (w, st, p), e in pools.items()), flush=True)
    rel, rows = train_step_card_vs_cpu(ds)
    bad = [r for r in rows if r[1] > 3 * r[2] + TOL_TRAIN_GRAD]
    worst = max(rows, key=lambda r: r[1] - 3 * r[2])
    if not (rel <= TOL_TRAIN_LOSS) or bad:
        raise AssertionError(f"train step card fp32 vs CPU: loss rel {rel}, "
                             f"gradients off the f64 truth {bad[:5]}")
    print(f"train step card fp32 (TF32 off) vs CPU path, batch 8: loss "
          f"rel. diff {rel:.3g} (tolerance {TOL_TRAIN_LOSS}); every "
          f"gradient within 3x the CPU f32 distance to the f64 truth + "
          f"{TOL_TRAIN_GRAD} of its norm (closest to the limit: {worst[0]} "
          f"card {worst[1]:.3g}, CPU f32 {worst[2]:.3g}; largest card "
          f"distance {max(r[1] for r in rows):.3g})", flush=True)
    return dict(k2_launches=k2, img_s=img_s, warm_img_s=warm_img_s,
                rungs=rungs, wall_s=wall_s, steps=steps, ds=ds, ptl=ptl)


def ptxas_report(log):
    """'ptxas <kernel>: <registers, static shared memory>' per compiled
    kernel."""
    lines, kernel = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
            rows = re.search(r"Li(\d+)E", name)
            k3 = re.search(r"qconv_s8_kernelILi(\d+)E", name)
            kernel = (f"qconv_s8<BN={k3.group(1)}>" if k3
                      else "preprocess_gray_taps" if "taps" in name else
                      "preprocess_rgb_resize<{}, 16-row tiles>".format(
                          "bf16" if "bfloat16" in name else "f32")
                      if "rgb_resize" in name else
                      "preprocess_gray_resize<{}, {} rows>".format(
                          "bf16" if "bfloat16" in name else "f32",
                          rows.group(1) if rows else "?")
                      if "resize" in name else name)
        elif "Used" in ln and "registers" in ln and kernel:
            lines.append(f"ptxas {kernel}: {ln.split(':', 1)[-1].strip()}")
    return lines


def write_bin(dirpath, pid, rois):
    """A schema-2 IFCB .adc/.roi/.hdr triplet (24 ADC columns; roiX 13,
    roiY 14, roiWidth 15, roiHeight 16, startByte 17)."""
    lines, offset = [], 0
    with open(os.path.join(dirpath, pid + ".roi"), "wb") as f:
        for k, roi in enumerate(rois):
            h, w = roi.shape
            row = [0] * 24
            row[0], row[15], row[16], row[17] = k + 1, w, h, offset
            lines.append(",".join(str(v) for v in row))
            f.write(roi.tobytes())
            offset += h * w
    with open(os.path.join(dirpath, pid + ".adc"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(dirpath, pid + ".hdr"), "w") as f:
        f.write("softwareVersion: smoke\n")


def make_rois(n, rng):
    """IFCB-like ROIs of roi_sides' sizes: a dark blob in noise."""
    rois = []
    for h, w in roi_sides(n, rng):
        yy, xx = np.mgrid[0:h, 0:w]
        blob = 200 - 120 * np.exp(-(((yy - h / 2) / (h / 4)) ** 2
                                    + ((xx - w / 2) / (w / 4)) ** 2))
        noise = rng.normal(0, 12, (h, w))
        rois.append(np.clip(blob + noise, 0, 255).astype(np.uint8))
    return rois


def random_inception_checkpoint(path, seed):
    """Full-width inception_v3 (50 classes) with He-normal convs
    and randomised BN statistics, saved in the ifcbnn-ckpt-v1 format."""
    import torch
    from ifcb_classifier_tpu_torch.models import get_namebrand_model
    from ifcb_classifier_tpu_torch.models.torch_port import params_to_jax
    from ifcb_classifier_tpu_torch.train.checkpoint import save_checkpoint
    g = torch.Generator().manual_seed(seed)
    model = get_namebrand_model("inception_v3", N_CLASSES)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("conv.weight") or k.endswith("fc.weight"):
            fan_in = v[0].numel()
            gain = 4.0 if k.endswith("fc.weight") else 1.0
            t = torch.randn(v.shape, generator=g) * gain * (2.0 / fan_in) ** 0.5
        elif k.endswith("bn.weight"):
            t = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith("running_mean") or k.endswith("bias"):
            t = 0.2 * torch.randn(v.shape, generator=g)
        elif k.endswith("running_var"):
            t = 0.3 + 2.7 * torch.rand(v.shape, generator=g)
        else:
            raise KeyError(k)
        sd[k] = t
    params, stats = params_to_jax(sd)
    save_checkpoint(path, params, stats, dict(
        MODEL="inception_v3", classes=[f"c{i:02d}" for i in range(N_CLASSES)],
        resize=R, img_norm=["0.667", "0.161"], pretrained=False,
        model_id="smoke_inception_v3", seed=seed))


def read_scores(outdir, pid):
    with open(os.path.join(outdir, pid + "_class.json")) as f:
        res = json.load(f)
    return np.asarray(res["output_scores"], np.float64), res["roi_numbers"]


def device_events(prof):
    """The profile's events on the card, without the user-annotation spans
    (such as ``Optimizer.step#Adam.step``) that cover kernels and are none."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def union_us(spans):
    """Length of the union of (start, end) spans: the card's busy time."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_breakdown(run, card, what="warm RUN"):
    """The warm RUN once more under torch.profiler: the card's busy share
    (union of kernel spans over the wall time) and the kernels that take
    it. Informational: a profiler that records no device events is said
    so, not treated as a failure of the path."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s = run()
    dev = device_events(prof)
    if not dev:
        print("profile: the profiler recorded no device events", flush=True)
        return

    kern = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    copy = [e for e in dev if e.name.startswith("Memcpy")]
    busy = union_us((e.time_range.start, e.time_range.end) for e in kern)
    copy_us = union_us((e.time_range.start, e.time_range.end) for e in copy)
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # K1 and K2 share the taps kernel; a RUN launches one of the two
    k2 = sum(v for k, v in by_name.items() if "preprocess_rgb" in k)
    k1 = sum(v for k, v in by_name.items() if "preprocess_gray" in k)
    k3 = [v for k, v in by_name.items() if "qconv_s8" in k]
    k1_parts = {}
    for e in kern:
        for part in ("preprocess_gray_taps", "preprocess_gray_resize",
                     "preprocess_rgb"):
            if part in e.name:
                k1_parts.setdefault(part, []).append(
                    e.time_range.elapsed_us())
    print(f"profile ({what} under torch.profiler, wall {wall_s * 1e3:.1f} "
          f"ms): kernels busy {busy / 1e3:.1f} ms = "
          f"{100 * busy / (wall_s * 1e6):.1f}% of wall (idle "
          f"{100 - 100 * busy / (wall_s * 1e6):.1f}%), memcpy "
          f"{copy_us / 1e3:.1f} ms, {len(kern)} kernel launches, "
          + (f"K2 (taps + resize) {(k1 + k2) / 1e3:.2f} ms" if k2
             else f"K1 {k1 / 1e3:.2f} ms") + (
              f", K3 {sum(k3) / 1e3:.2f} ms = "
              f"{100 * sum(k3) / busy:.1f}% of the busy time" if k3 else "")
          + f"; on {card}", flush=True)
    print(f"profile {'K2' if k2 else 'K1'} per launch (us): " + "; ".join(
        f"{k} {np.mean(v):.2f} mean, {np.min(v):.2f}..{np.max(v):.2f} over "
        f"{len(v)} launches" for k, v in sorted(k1_parts.items())),
        flush=True)
    print("profile top kernels (ms): " + "; ".join(
        f"{k[:60]} {v / 1e3:.2f}" for k, v in top), flush=True)


def warm_run(work, bins_dir, ckpt, engine, tag, extra=()):
    """The same engine's RUN over the same bins into a fresh outdir
    (``extra``: global flags); returns its wall seconds."""
    import torch
    from ifcb_classifier_tpu_torch.cli import argparse_nn, main
    from ifcb_classifier_tpu_torch.utils.config import (
        add_runtime_params, proc_outdir)
    args = argparse_nn().parse_args(
        ["--batch", "256", *extra, "RUN", bins_dir, ckpt, "smoke",
         "--outdir", os.path.join(work, tag),
         "--outfile", "{BIN_ID}_class.json"])
    add_runtime_params(args)
    proc_outdir(args, model_id_for_run=engine.model_id)
    t0 = time.perf_counter()
    main(args, engine=engine)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main_path(work, rng, card):
    """Phase 3. Returns (K1 launches in the RUN, RUN numbers). The bins
    stay in ``work``/bins for phase 4."""
    import torch
    from ifcb_classifier_tpu_torch.cli import main_cli
    from ifcb_classifier_tpu_torch.data.ifcb import Bin
    from ifcb_classifier_tpu_torch.infer.runner import InferenceEngine
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        preprocess_gray_cuda, preprocess_rgb_cuda)
    from ifcb_classifier_tpu_torch.utils.config import resolve_dtype

    bins_dir = os.path.join(work, "bins")
    os.makedirs(bins_dir)
    pids = [f"D20250{k + 1}01T120000_IFCB199" for k in range(len(BIN_SIZES))]
    for pid, n in zip(pids, BIN_SIZES):
        write_bin(bins_dir, pid, make_rois(n, rng))
    ckpt = os.path.join(work, "smoke_inception_v3.ptl")
    random_inception_checkpoint(ckpt, seed=0)
    n_rois = sum(BIN_SIZES)

    out = os.path.join(work, "run")
    argv = ["--batch", "256", "RUN", bins_dir, ckpt, "smoke",
            "--outdir", out, "--outfile", "{BIN_ID}_class.json",
            "--summary", "summary.json"]
    preprocess_gray_cuda.launches = 0
    preprocess_rgb_cuda.launches = 0
    t0 = time.perf_counter()
    engine = main_cli(argv)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = preprocess_gray_cuda.launches
    if preprocess_rgb_cuda.launches:
        raise AssertionError("RUN on bins launched K2")
    dispatches = engine.dispatches
    if not (launches > 0 and launches == dispatches):
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{dispatches} engine dispatches")
    for pid, n in zip(pids, BIN_SIZES):
        scores, rois = read_scores(out, pid)
        if scores.shape != (n, N_CLASSES) or rois != list(range(1, n + 1)):
            raise AssertionError(f"{pid}: result shape {scores.shape}")
        if not np.isfinite(scores).all():
            raise AssertionError(f"{pid}: non-finite scores")
        if np.abs(scores.sum(axis=1) - 1).max() > 1e-3:
            raise AssertionError(f"{pid}: score rows do not sum to 1")
    print(f"RUN (cold, incl. checkpoint read and engine build): {n_rois} "
          f"ROIs in {cold_s:.3f} s; K1 launches {launches} = engine "
          f"dispatches {dispatches}", flush=True)

    warm_s = warm_run(work, bins_dir, ckpt, engine, "run_warm")
    img_s = n_rois / warm_s
    print(f"RUN img/s (warm, inception_v3 @299 bf16, batch 256, "
          f"{n_rois} ROIs in {len(pids)} bins, bins read + packed + "
          f"classified + written): {img_s:.1f} on {card}", flush=True)
    profile_breakdown(lambda: warm_run(work, bins_dir, ckpt, engine,
                                       "run_prof"), card)

    # fp32 on the card (TF32 off) vs the bf16 RUN, and vs the CPU path
    e32 = InferenceEngine(ckpt, batch_size=256,
                          dtype=resolve_dtype("fp32", "cuda"))
    delta, agree, total = 0.0, 0, 0
    scores32 = {}
    for pid in pids:
        _, p32 = e32.predict_bin(Bin(os.path.join(bins_dir, pid + ".adc")))
        scores32[pid] = p32
        bf16, _ = read_scores(out, pid)
        delta = max(delta, float(np.abs(bf16 - p32).max()))
        agree += int((bf16.argmax(1) == p32.argmax(1)).sum())
        total += len(p32)
    print(f"bf16 vs fp32 (card): max |d score| {delta:.4g}, argmax "
          f"agreement {agree}/{total} on {card}", flush=True)
    small = Bin(os.path.join(bins_dir, pids[-1] + ".adc"))
    ecpu = InferenceEngine(ckpt, batch_size=256, device="cpu")
    t_gpu, p_gpu = e32.predict_bin(small)
    t_cpu, p_cpu = ecpu.predict_bin(small)
    cpu_err = float(np.abs(p_gpu - p_cpu).max())
    if t_gpu != t_cpu or not cpu_err <= TOL_CPU_SCORES:
        raise AssertionError(f"card fp32 vs CPU: max |d score| {cpu_err}")
    print(f"card fp32 vs CPU path ({len(t_cpu)} ROIs): max |d score| "
          f"{cpu_err:.4g} (tolerance {TOL_CPU_SCORES})", flush=True)
    return launches, dict(img_s=img_s, cold_s=cold_s, warm_s=warm_s,
                          ckpt=ckpt, pids=pids, bins_dir=bins_dir,
                          bf16_out=out, scores32=scores32)


def int8_path(work, run, card):
    """Phase 3b. Returns (K3 launches in the int8 RUN, its numbers)."""
    import torch
    from ifcb_classifier_tpu_torch.cli import main_cli
    from ifcb_classifier_tpu_torch.data.ifcb import Bin
    from ifcb_classifier_tpu_torch.infer.runner import InferenceEngine
    from ifcb_classifier_tpu_torch.ops.preprocess import preprocess_gray_cuda
    from ifcb_classifier_tpu_torch.ops.qconv import qconv_cuda
    from ifcb_classifier_tpu_torch.utils.config import resolve_dtype

    bins_dir, ckpt, pids = run["bins_dir"], run["ckpt"], run["pids"]
    out = os.path.join(work, "run_int8")
    argv = ["--batch", "256", "--precision", "int8", "RUN", bins_dir, ckpt,
            "smoke", "--outdir", out, "--outfile", "{BIN_ID}_class.json"]
    preprocess_gray_cuda.launches = 0
    qconv_cuda.launches = 0
    t0 = time.perf_counter()
    engine = main_cli(argv)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    k3, k1 = qconv_cuda.launches, preprocess_gray_cuda.launches
    n8, n = engine.int8_dispatches, engine.dispatches
    if not (engine.quant and n8 == n > 0 and k3 == K3_CONVS * n8
            and k1 == n):
        raise AssertionError(f"int8 RUN: K3 launched {k3} times, K1 {k1}, "
                             f"for {n8} int8 of {n} dispatches")
    d32, d16, agree, total = 0.0, 0.0, 0, 0
    for pid, n_rois in zip(pids, BIN_SIZES):
        s8, rois = read_scores(out, pid)
        if s8.shape != (n_rois, N_CLASSES) or rois != list(
                range(1, n_rois + 1)) or not np.isfinite(s8).all():
            raise AssertionError(f"int8 {pid}: result {s8.shape}")
        p32 = run["scores32"][pid]
        bf16, _ = read_scores(run["bf16_out"], pid)
        d32 = max(d32, float(np.abs(s8 - p32).max()))
        d16 = max(d16, float(np.abs(s8 - bf16).max()))
        agree += int((s8.argmax(1) == p32.argmax(1)).sum())
        total += len(p32)
    print(f"RUN --precision int8 (cold, incl. engine build and the "
          f"calibration pass on the first dispatch): {total} ROIs in "
          f"{cold_s:.3f} s; K3 launches {k3} = {K3_CONVS} x {n8} int8 "
          f"dispatches (all {n}); K1 launches {k1}", flush=True)
    if not d32 < TOL_INT8_FP32:
        raise AssertionError(f"int8 vs fp32 scores: max |d p| {d32}")
    print(f"int8 vs fp32 (card, TF32 off): max |d score| {d32:.4g} "
          f"(gate {TOL_INT8_FP32}), argmax agreement {agree}/{total}; "
          f"int8 vs bf16: max |d score| {d16:.4g}; on {card}", flush=True)

    warm_s = warm_run(work, bins_dir, ckpt, engine, "run_int8_warm",
                      ("--precision", "int8"))
    img_s = total / warm_s
    print(f"RUN img/s (warm, inception_v3 @299, batch 256, {total} ROIs): "
          f"int8 {img_s:.1f}, bf16 {run['img_s']:.1f} (phase 3) on {card}",
          flush=True)
    profile_breakdown(lambda: warm_run(work, bins_dir, ckpt, engine,
                                       "run_int8_prof",
                                       ("--precision", "int8")), card)

    # card vs CPU, batch 8, one pinned absmax, float parts f32 (TF32 off)
    absmax, geoms = engine._calib_absmax, engine._calib_geoms
    e_card = InferenceEngine(ckpt, batch_size=8, quant=True,
                             dtype=resolve_dtype("fp32", "cuda"))
    e_cpu = InferenceEngine(ckpt, batch_size=8, quant=True, device="cpu")
    small = Bin(os.path.join(bins_dir, pids[-1] + ".adc"))
    got = []
    for e in (e_card, e_cpu):
        e._swap_to_quant(absmax, geoms)
        got.append(e.predict_bin(small))
    (t_card, p_card), (t_cpu, p_cpu) = got
    err = float(np.abs(p_card - p_cpu).max())
    n_flip = int((p_card.argmax(1) != p_cpu.argmax(1)).sum())
    if t_card != t_cpu or not err <= TOL_INT8_CPU or n_flip:
        raise AssertionError(f"int8 card vs CPU: max |d score| {err}, "
                             f"{n_flip} argmax differ")
    print(f"int8 card (f32 float parts, TF32 off) vs CPU path, one pinned "
          f"absmax, batch 8 ({len(t_cpu)} ROIs): max |d score| {err:.4g} "
          f"(tolerance {TOL_INT8_CPU}), argmax equal", flush=True)
    return k3, dict(img_s=img_s, cold_s=cold_s, warm_s=warm_s, d32=d32,
                    d16=d16, agree=agree, total=total, cpu_err=err)

def write_image_tree(root, rng):
    """Phase 5a's RUN --type img input: IMG_COUNT PNGs with roi_sides'
    sides under IMG_DIRS subfolders, every third one gray (mode L), the
    rest RGB. Returns {path: (h, w)}."""
    from PIL import Image
    sides = {}
    for i, (h, w) in enumerate(roi_sides(IMG_COUNT, rng)):
        d = os.path.join(root, f"sub{i % IMG_DIRS}")
        os.makedirs(d, exist_ok=True)
        yy, xx = np.mgrid[0:h, 0:w]
        blob = 200 - 120 * np.exp(-(((yy - h / 2) / (h / 4)) ** 2
                                    + ((xx - w / 2) / (w / 4)) ** 2))
        if i % 3 == 1:
            img = Image.fromarray(np.clip(blob + rng.normal(0, 12, (h, w)),
                                          0, 255).astype(np.uint8), "L")
        else:
            tint = np.array([1.0, 0.8, 0.6])
            img = Image.fromarray(np.clip(
                blob[..., None] * tint + rng.normal(0, 12, (h, w, 3)), 0,
                255).astype(np.uint8))
        path = os.path.join(d, f"img{i:04d}.png")
        img.save(path)
        sides[path] = (int(h), int(w))
    return sides


def batch_rungs(paths, sides, B):
    """{rung: batches} of a HostLoader over ``paths`` (in its order) at
    batch B: each batch's canvas is the rung of its largest side."""
    from ifcb_classifier_tpu_torch.data.pipeline import ladder_size
    rungs = {}
    for k in range(0, len(paths), B):
        S = ladder_size(max(max(sides[p]) for p in paths[k:k + B]))
        rungs[S] = rungs.get(S, 0) + 1
    return dict(sorted(rungs.items()))


def img_run(engine, src, outdir, extra=()):
    """RUN --type img of ``engine`` over ``src`` into ``outdir`` (``extra``:
    global flags); returns its wall seconds."""
    import torch
    from ifcb_classifier_tpu_torch.cli import argparse_nn, main
    from ifcb_classifier_tpu_torch.utils.config import (
        add_runtime_params, proc_outdir)
    args = argparse_nn().parse_args(
        ["--batch", str(RUN_BATCH), *extra, "RUN", src, "m", "smoke",
         "--type", "img", "--outdir", outdir])
    add_runtime_params(args)
    proc_outdir(args, model_id_for_run=engine.model_id)
    t0 = time.perf_counter()
    main(args, engine=engine)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def read_img_scores(path):
    with open(path) as f:
        res = json.load(f)
    return res["input_images"], np.asarray(res["output_scores"], np.float64)


def serving_path(work, run, train, card):
    """Phase 5: the verbs that serve a trained model (5a RUN --type img,
    5b its int8 tier, 5c a reference Lightning .ptl, 5d VAL, 5e
    CALC_IMG_NORM, 5f PORT_WEIGHTS and TRAIN --weights). Returns the K2
    launches by path and the phase's numbers."""
    import torch
    from ifcb_classifier_tpu_torch.cli import main_cli
    from ifcb_classifier_tpu_torch.data.datasets import list_image_paths
    from ifcb_classifier_tpu_torch.data.pipeline import HostLoader, prefetch
    from ifcb_classifier_tpu_torch.infer.runner import InferenceEngine
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        preprocess_gray_cuda, preprocess_rgb_cuda)
    from ifcb_classifier_tpu_torch.ops.qconv import qconv_cuda
    from ifcb_classifier_tpu_torch.utils.config import resolve_dtype

    t_phase = time.perf_counter()
    ckpt = run["ckpt"]
    imgs = os.path.join(work, "imgs")
    t0 = time.perf_counter()
    sides = write_image_tree(imgs, np.random.default_rng(5))
    paths = list_image_paths(imgs)
    rungs = batch_rungs(paths, sides, RUN_BATCH)
    print(f"RUN img tree: {len(paths)} PNGs ({IMG_COUNT // 3} gray) in "
          f"{IMG_DIRS} subfolders written in {time.perf_counter() - t0:.1f} "
          f"s; batches of {RUN_BATCH} by canvas rung {rungs}", flush=True)
    by_path = dict(train=train["k2_launches"])

    def counted(fn):
        preprocess_gray_cuda.launches = 0
        preprocess_rgb_cuda.launches = 0
        qconv_cuda.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, (
            preprocess_rgb_cuda.launches, preprocess_gray_cuda.launches,
            qconv_cuda.launches)

    # 5a. RUN --type img, bf16
    out = os.path.join(work, "run_img")
    engine, cold_s, (k2, k1, _) = counted(lambda: main_cli(
        ["--batch", str(RUN_BATCH), "RUN", imgs, ckpt, "smoke", "--type",
         "img", "--outdir", out, "--outfile", "img_results.json",
         "--outfile", "{INPUT_SUBDIRS}img.json", "--summary",
         "summary.json"]))
    if not (k2 == engine.dispatches > 0 and k1 == 0):
        raise AssertionError(f"RUN img: K2 launched {k2} times, K1 {k1}, "
                             f"for {engine.dispatches} dispatches")
    by_path["run_img"] = k2
    listed, bf16 = read_img_scores(os.path.join(out, "img_results.json"))
    if sorted(listed) != paths or len(set(listed)) != len(paths) \
            or bf16.shape != (len(paths), N_CLASSES) \
            or not np.isfinite(bf16).all():
        raise AssertionError(f"img_results.json: {len(listed)} images, "
                             f"scores {bf16.shape}")
    n_sub = 0
    for k in range(IMG_DIRS):
        names, sc = read_img_scores(os.path.join(out, f"sub{k}img.json"))
        want = sorted(os.path.basename(p) for p in paths
                      if os.path.dirname(p).endswith(f"sub{k}"))
        if sorted(names) != want or sc.shape != (len(want), N_CLASSES):
            raise AssertionError(f"sub{k}img.json: {len(names)} images")
        n_sub += len(names)
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    if not (summary["src_type"] == "img" and summary["n_images"]
            == summary["n_rois"] == len(paths) == n_sub):
        raise AssertionError(f"RUN img summary: {summary['src_type']}, "
                             f"{summary['n_images']} images")
    warm_s = img_run(engine, imgs, os.path.join(work, "run_img_warm"))
    img_s = len(paths) / warm_s
    # where the time goes: the loader alone (decode and pack into pinned
    # canvases, no device work), then the warm RUN under the profiler
    t0 = time.perf_counter()
    for _ in prefetch(iter(HostLoader(paths, batch_size=RUN_BATCH,
                                      pin_memory=engine.pin_memory))):
        pass
    loader_s = time.perf_counter() - t0
    print(f"RUN img loader alone (decode + pack {RUN_BATCH}-image pinned "
          f"canvases, no device work): {loader_s:.3f} s = "
          f"{len(paths) / loader_s:.1f} img/s", flush=True)
    profile_breakdown(lambda: img_run(engine, imgs, os.path.join(
        work, "run_img_prof")), card, "warm RUN --type img")
    print(f"RUN --type img (inception_v3 @299 bf16, batch {RUN_BATCH}): "
          f"{len(paths)} images, each scored once, {IMG_DIRS} per-subfolder "
          f"files, summary src_type img; K2 launches {k2} = engine "
          f"dispatches, K1 none; cold {cold_s:.2f} s incl. engine build, "
          f"warm {warm_s:.3f} s = {img_s:.1f} img/s (decode, pack, "
          f"classify, write) on {card}", flush=True)
    # fp32 (TF32 off) on the card for every image, and the CPU path on 16
    e32 = InferenceEngine(ckpt, batch_size=RUN_BATCH,
                          dtype=resolve_dtype("fp32", "cuda"))
    p32, order = e32.predict_loader(HostLoader(
        paths, batch_size=RUN_BATCH, pin_memory=e32.pin_memory))
    if order != listed:
        raise AssertionError("fp32 engine: another image order")
    ecpu = InferenceEngine(ckpt, batch_size=16, device="cpu")
    pcpu, _ = ecpu.predict_loader(HostLoader(paths[:16], batch_size=16))
    cpu_err = float(np.abs(p32[:16] - pcpu).max())
    if not cpu_err <= TOL_CPU_SCORES:
        raise AssertionError(f"RUN img card fp32 vs CPU: {cpu_err}")
    d16 = float(np.abs(bf16 - p32).max())
    print(f"RUN img card fp32 (TF32 off) vs CPU path (16 images): max |d "
          f"score| {cpu_err:.4g} (tolerance {TOL_CPU_SCORES}); bf16 vs fp32 "
          f"max |d score| {d16:.4g}", flush=True)

    # 5b. the same with --precision int8
    out8 = os.path.join(work, "run_img_int8")
    e8, cold8_s, (k2, k1, k3) = counted(lambda: main_cli(
        ["--batch", str(RUN_BATCH), "--precision", "int8", "RUN", imgs, ckpt,
         "smoke", "--type", "img", "--outdir", out8]))
    n8, n = e8.int8_dispatches, e8.dispatches
    if not (n8 == n == k2 > 0 and k3 == K3_CONVS * n8 and k1 == 0):
        raise AssertionError(f"RUN img int8: K3 {k3}, K2 {k2}, K1 {k1} for "
                             f"{n8} int8 of {n} dispatches")
    by_path["run_img_int8"] = k2
    listed8, s8 = read_img_scores(os.path.join(out8, "img_results.json"))
    d8 = float(np.abs(s8 - p32).max()) if listed8 == listed else np.inf
    agree = int((s8.argmax(1) == p32.argmax(1)).sum())
    if not d8 < TOL_INT8_FP32:
        raise AssertionError(f"RUN img int8 vs fp32: max |d p| {d8}")
    warm8_s = img_run(e8, imgs, os.path.join(work, "run_img_int8_warm"),
                      ("--precision", "int8"))
    img8_s = len(paths) / warm8_s
    print(f"RUN --type img --precision int8: K3 launches {k3} = {K3_CONVS} "
          f"x {n8} int8 dispatches (all {n}), K2 {k2}; int8 vs fp32 max |d "
          f"score| {d8:.4g} (gate {TOL_INT8_FP32}), argmax agreement "
          f"{agree}/{len(paths)}; warm {img8_s:.1f} img/s int8 against "
          f"{img_s:.1f} bf16 on {card}", flush=True)

    # 5c. a reference-format Lightning .ptl of phase 3's weights
    ptl_err, two = reference_ptl_run(work, run)
    print(f"reference Lightning .ptl (model.-prefixed torchvision keys, "
          f"num_batches_tracked, AuxLogits, AttributeDict hparams): RUN fp32 "
          f"on {two} ROIs equal to the port's own checkpoint of the same "
          f"weights, max |d score| {ptl_err:.3g} (tolerance {TOL_PTL}); a "
          "class outside the allowlist and a REDUCE through "
          "torch.storage._load_from_bytes refused", flush=True)

    # 5d. VAL of phase 4's TRAIN output on its dataset
    ds, ptl = train["ds"], train["ptl"]
    val = val_path(work, ds, ptl, counted, card)
    by_path["val"] = val["k2"]

    # 5e. CALC_IMG_NORM at --resize 299 and 224
    norm = calc_img_norm_path(work, ds, counted, card)
    by_path["calc_img_norm"] = norm["k2"]

    # 5f. PORT_WEIGHTS round trip and TRAIN --weights
    weights_path(work, ds, ptl, counted, card)
    print(f"phase 5 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return by_path, dict(img_s=img_s, img8_s=img8_s, d8=d8, agree=agree,
                         loader_img_s=len(paths) / loader_s,
                         n_img=len(paths), rungs=rungs, cpu_err=cpu_err,
                         ptl_err=ptl_err, val_img_s=val["img_s"],
                         cold_s=cold_s)


def reference_ptl_run(work, run):
    """5c. Phase 3's weights as the reference's Lightning writes them
    (tests/test_resume_and_port.py:591-639 builds the same): the state dict
    under ``model.``-prefixed torchvision keys with num_batches_tracked
    and an aux head, hparams an AttributeDict of a module that is gone at
    load time. RUN fp32 of it on phase 3's two smallest bins against RUN
    fp32 of the port's own checkpoint; a .ptl with a class outside the
    allowlist, and one whose hparams REDUCE through
    torch.storage._load_from_bytes (an unrestricted torch.load), must be
    refused, the latter's payload never run. Returns (max |d score|,
    ROIs)."""
    import io
    import pickle
    import types

    import torch
    from ifcb_classifier_tpu_torch.cli import main_cli
    from ifcb_classifier_tpu_torch.models import get_namebrand_model
    from ifcb_classifier_tpu_torch.models.torch_port import params_from_jax
    from ifcb_classifier_tpu_torch.train.checkpoint import (load_checkpoint,
                                                            load_hparams)
    params, stats, hp = load_checkpoint(run["ckpt"])
    sd = params_from_jax(params, stats)
    g = torch.Generator().manual_seed(7)
    aux = get_namebrand_model("inception_v3", N_CLASSES, train=True)
    for k, v in aux.state_dict().items():
        if k.startswith("AuxLogits."):
            sd[k] = 0.05 * torch.randn(v.shape, generator=g)
    for k in [k for k in sd if k.endswith("bn.running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = \
            torch.tensor(1234)
    names = ("pytorch_lightning", "pytorch_lightning.utilities",
             "pytorch_lightning.utilities.parsing")
    mods = {n: types.ModuleType(n) for n in names}

    class AttributeDict(dict):
        pass

    AttributeDict.__module__ = names[-1]
    AttributeDict.__qualname__ = "AttributeDict"
    mods[names[-1]].AttributeDict = AttributeDict
    payload = types.ModuleType("ptl_payload")

    class Payload:  # of a module the allowlist does not name
        pass

    Payload.__module__ = payload.__name__
    Payload.__qualname__ = "Payload"
    payload.Payload = Payload
    mods[payload.__name__] = payload
    marker = os.path.join(work, "payload_ran")

    class Inner:  # runs only if the unpickle is unrestricted
        def __reduce__(self):
            return os.mkdir, (marker,)

    inner = io.BytesIO()
    torch.save(Inner(), inner)

    class Outer:  # an unrestricted torch.load of Inner's bytes
        def __reduce__(self):
            return torch.storage._load_from_bytes, (inner.getvalue(),)

    ptl = os.path.join(work, "reference.ptl")
    evil = os.path.join(work, "evil.ptl")
    evil_bytes = os.path.join(work, "evil_bytes.ptl")
    sys.modules.update(mods)
    try:
        torch.save({"state_dict": {"model." + k: v for k, v in sd.items()},
                    "hyper_parameters": AttributeDict(hp), "epoch": 9}, ptl)
        torch.save({"state_dict": {}, "hyper_parameters": Payload()}, evil)
    finally:
        for n in mods:
            sys.modules.pop(n, None)
    torch.save({"state_dict": {}, "hyper_parameters": Outer()}, evil_bytes,
               pickle_protocol=4)
    for path in (evil, evil_bytes):
        for load in (load_checkpoint, load_hparams):
            try:
                load(path)
            except pickle.UnpicklingError as e:
                if "not allowlisted" not in str(e):
                    raise
                continue
            raise AssertionError(f"{load.__name__} read {path}, which "
                                 "names a global outside the allowlist")
    if os.path.exists(marker):
        raise AssertionError("a refused .ptl ran its payload")
    if load_hparams(ptl)["model_id"] != hp["model_id"]:
        raise AssertionError("load_hparams of the reference .ptl")
    lst = os.path.join(work, "two_bins.txt")
    with open(lst, "w") as f:
        f.write("\n".join(os.path.join(run["bins_dir"], pid)
                          for pid in run["pids"][-2:]) + "\n")
    scores = []
    for tag, path in (("ptl", ptl), ("own", run["ckpt"])):
        out = os.path.join(work, "ptl_run_" + tag)
        main_cli(["--batch", "256", "--precision", "fp32", "RUN", lst, path,
                  "smoke", "--outdir", out, "--outfile",
                  "{BIN_ID}_class.json"])
        scores.append(np.concatenate([read_scores(out, pid)[0]
                                      for pid in run["pids"][-2:]]))
    err = float(np.abs(scores[0] - scores[1]).max())
    if not err <= TOL_PTL:
        raise AssertionError(f".ptl vs own checkpoint: max |d score| {err}")
    return err, len(scores[0])


def subset_tree(src, dst, per_class):
    """``per_class`` images of each class folder of ``src``, linked under
    ``dst``. Returns (dst, the number of images)."""
    n = 0
    for cls in sorted(os.listdir(src)):
        os.makedirs(os.path.join(dst, cls))
        for name in sorted(os.listdir(os.path.join(src, cls)))[:per_class]:
            os.symlink(os.path.join(src, cls, name),
                       os.path.join(dst, cls, name))
            n += 1
    return dst, n


def parsed(argv):
    """The CLI's namespace for ``argv``, with its run-time fields and
    outdir filled in as main_cli fills them."""
    from ifcb_classifier_tpu_torch.cli import argparse_nn
    from ifcb_classifier_tpu_torch.utils.config import (
        add_runtime_params, proc_outdir)
    args = argparse_nn().parse_args(argv)
    add_runtime_params(args)
    return proc_outdir(args)


def val_path(work, ds, ptl, counted, card):
    """5d. VAL --batch 128 of phase 4's .ptl on phase 4's dataset: every
    image listed, K2 once per batch; then fp32 on the card against the CPU
    path on 32 of the images."""
    from ifcb_classifier_tpu_torch.train.evaluate import do_validation
    out = os.path.join(work, "val")
    base = ["--batch", str(TRAIN_BATCH), "VAL", ds, ptl, "smoke_val"]
    argv = base + ["--outdir", out, "--results", "val_results.json",
                   "image_fullpaths", "output_scores", "input_classes"]
    res, wall_s, (k2, k1, _) = counted(
        lambda: do_validation(parsed(argv)))
    batches = do_validation.stats["batches"]
    if not (k2 == batches > 0 and k1 == 0):
        raise AssertionError(f"VAL: K2 launched {k2} times, K1 {k1}, for "
                             f"{batches} batches")
    with open(os.path.join(out, "val_results.json")) as f:
        listed = json.load(f)["image_fullpaths"]
    every = sorted(os.path.join(ds, c, n) for c in os.listdir(ds)
                   for n in os.listdir(os.path.join(ds, c)))
    if sorted(listed) != every or res["n_images"] != len(every):
        raise AssertionError(f"VAL listed {len(listed)} of {len(every)}")
    do_validation(parsed(base + ["--outdir", out + "_warm"]))
    warm = do_validation.stats
    img_s = len(every) / warm["seconds"]
    print(f"VAL (inception_v3 @299 bf16, batch {TRAIN_BATCH}, BNs "
          f"unfolded): {len(every)} images listed, K2 launches {k2} = "
          f"{batches} batches, K1 none; val_loss {res['val_loss']:.4f}, "
          f"f1_w {res['f1_weighted']:.3f}; cold {wall_s:.2f} s incl. model "
          f"build; warm eval loop {warm['seconds']:.3f} s = {img_s:.1f} "
          f"img/s (decode, pack, K2, forward, one fetch) on {card}",
          flush=True)
    sub, n_sub = subset_tree(ds, os.path.join(work, "val32"), 8)
    got = {}
    for dev in ("cuda", "cpu"):
        o = os.path.join(work, "val32_" + dev)
        r = do_validation(parsed(["--batch", "32", "--precision", "fp32",
                                  "VAL", sub, ptl, "v32", "--outdir", o]),
                          device=dev)
        with open(os.path.join(o, "val_results.json")) as f:
            got[dev] = (r["val_loss"], np.asarray(json.load(f)[
                "output_scores"], np.float64))
    (lg, sg), (lc, sc) = got["cuda"], got["cpu"]
    err = float(np.abs(sg - sc).max())
    rel = abs(lg - lc) / abs(lc)
    if sg.shape != (n_sub, TRAIN_CLASSES) or not err <= TOL_CPU_SCORES \
            or not rel <= TOL_VAL_LOSS:
        raise AssertionError(f"VAL card fp32 vs CPU: scores {err}, "
                             f"val_loss rel {rel}")
    print(f"VAL card fp32 (TF32 off) vs CPU path ({n_sub} images): max |d "
          f"score| {err:.4g} (tolerance {TOL_CPU_SCORES}), val_loss rel. "
          f"diff {rel:.3g} (tolerance {TOL_VAL_LOSS})", flush=True)
    return dict(k2=k2, img_s=img_s)


def calc_img_norm_path(work, ds, counted, card):
    """5e. CALC_IMG_NORM of phase 4's dataset at --resize 299 and 224 on
    the card (K2 once per batch of 108), and on 64 of its images the card
    against the CPU path (mean and std within TOL_CPU_SCORES)."""
    from ifcb_classifier_tpu_torch.util_cli import main_cli as util_cli
    k2_all = 0
    sub, n_sub = subset_tree(ds, os.path.join(work, "norm64"), 16)
    for r in (R, R_224):
        (mean, std), wall_s, (k2, k1, _) = counted(
            lambda: util_cli(["CALC_IMG_NORM", ds, "--resize", str(r)]))
        n = len(os.listdir(os.path.join(ds, "class0"))) * TRAIN_CLASSES
        if not (k2 == -(-n // NORM_BATCH) and k1 == 0):
            raise AssertionError(f"CALC_IMG_NORM {r}: K2 {k2}, K1 {k1}")
        k2_all += k2
        argv = ["CALC_IMG_NORM", sub, "--resize", str(r)]
        card_ms = util_cli(argv)
        cpu_ms = util_cli(argv, device="cpu")
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(card_ms, cpu_ms))
        if not err <= TOL_CPU_SCORES:
            raise AssertionError(f"CALC_IMG_NORM {r} card vs CPU: {err}")
        print(f"CALC_IMG_NORM --resize {r}: mean {np.round(mean, 4)}, std "
              f"{np.round(std, 4)} over {n} images ({k2} K2 launches, K1 "
              f"none, {wall_s:.2f} s); card vs CPU on {n_sub} images: max "
              f"|d| "
              f"{err:.3g} (tolerance {TOL_CPU_SCORES}) on {card}",
              flush=True)
    return dict(k2=k2_all)


def weights_path(work, ds, ptl, counted, card):
    """5f. PORT_WEIGHTS of phase 4's checkpoint to a torchvision .pth and
    on to an .npz, bitwise equal to the checkpoint; then the trunk that
    TRAIN --weights' loader returns from that .pth equals the file
    bitwise with the heads fresh, and TRAIN --weights --emax 1 trains to
    finite losses."""
    import torch
    from ifcb_classifier_tpu_torch.cli import main_cli
    from ifcb_classifier_tpu_torch.models import get_namebrand_model
    from ifcb_classifier_tpu_torch.models.torch_port import (
        load_state_dict_file, load_torch_weights, params_from_jax)
    from ifcb_classifier_tpu_torch.train.checkpoint import load_checkpoint
    from ifcb_classifier_tpu_torch.train.state import init_params
    from ifcb_classifier_tpu_torch.util_cli import main_cli as util_cli
    pth, npz = (os.path.join(work, "trained" + e) for e in (".pth", ".npz"))
    util_cli(["PORT_WEIGHTS", ptl, "-o", pth])
    util_cli(["PORT_WEIGHTS", pth, "-o", npz])
    want = {k: v.numpy() for k, v in
            params_from_jax(*load_checkpoint(ptl)[:2]).items()}
    got = load_state_dict_file(npz)
    if sorted(got) != sorted(want) or any(
            got[k].dtype != want[k].dtype or not np.array_equal(got[k],
                                                                want[k])
            for k in want):
        raise AssertionError("PORT_WEIGHTS .ptl -> .pth -> .npz is not the "
                             "checkpoint bitwise")
    model = init_params(get_namebrand_model(
        "inception_v3", TRAIN_CLASSES, train=True), 5)
    template = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = load_torch_weights(pth, "inception_v3", template)
    heads = [k for k in loaded if k.startswith(("fc.", "AuxLogits.fc."))]
    bad = [k for k in loaded if (k in heads and not torch.equal(
        loaded[k], template[k])) or (k not in heads and not np.array_equal(
            loaded[k].numpy(), want[k]))]
    if bad or len(heads) != 4:
        raise AssertionError(f"--weights loader: {bad[:5]} differ")
    out = os.path.join(work, "train_weights")
    _, wall_s, (k2, _, _) = counted(lambda: main_cli(
        ["--batch", str(TRAIN_BATCH), "TRAIN", ds, "inception_v3",
         "smoke_weights", "--emax", "1", "--estop", "0", "--outdir", out,
         "--seed", "2", "--weights", pth]))
    with open(os.path.join(out, "epochs.csv")) as f:
        row = f.read().splitlines()[1].split(",")
    losses = [float(v) for v in row[2:4]]
    if not np.isfinite(losses).all():
        raise AssertionError(f"TRAIN --weights losses {losses}")
    print(f"PORT_WEIGHTS .ptl -> .pth -> .npz: {len(got)} tensors bitwise "
          f"the checkpoint's; --weights loader: trunk bitwise the .pth, "
          f"{len(heads)} head tensors fresh; TRAIN --weights --emax 1: "
          f"losses {losses} ({k2} K2 launches, {wall_s:.1f} s) on {card}",
          flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from concurrent.futures import ThreadPoolExecutor

    from ifcb_classifier_tpu_torch import native
    from ifcb_classifier_tpu_torch.ops.preprocess import build_k1, build_k2
    from ifcb_classifier_tpu_torch.ops.qconv import build_k3

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in f32

    # one compiler process per source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(f) for f in (build_k1, build_k2, build_k3)]
        packer = pool.submit(native.available)
        logs = [j.result()[1] for j in jobs]
        if not packer.result():
            raise RuntimeError("the native ROI packer did not build")
    print(f"built K1, K2, K3 and roipack in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    for log in logs:
        for line in ptxas_report(log):
            print(line, flush=True)

    rng = np.random.default_rng(0)
    # 2. K1 and K2 against their plain versions
    rows, mix_rows, max_err = check_k1(rng)
    k2_rows, k2_mix_rows, k2_err = check_k2(rng)
    k2_run_rows, k2_norm_rows, k2_serve_err = check_k2_serving(
        np.random.default_rng(4))
    k2_err = max(k2_err, k2_serve_err)
    k3_rows, n_geoms, k3_sweep = check_k3()

    # 3. the RUN path, 3b. its int8 tier, 4. the TRAIN path, 5. the verbs
    # that serve a trained model
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, run = main_path(work, rng, card)
        k3_launches, run8 = int8_path(work, run, card)
        train = train_path(work, os.path.join(work, "bins"), card)
        k2_by_path, serve = serving_path(work, run, train, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 6. result lines
    main_row = next(r for r in rows if r["S"] == 128)
    k3_row = next(r for r in k3_rows if r["name"] == K3_MAIN)
    # K2's row: the rung most of this run's train batches landed on
    k2_S = max(train["rungs"], key=train["rungs"].get)
    k2_row = next(r for r in k2_rows if r["S"] == k2_S)
    print(f"K1 at S=128 B=256 bf16 (main path): {main_row['ms']:.4f} ms "
          f"(device alone {main_row['device_ms']:.4f} ms, wrapper host "
          f"{main_row['host_us']:.1f} us per call); "
          f"RUN {run['img_s']:.1f} img/s; card {card}", flush=True)
    print(f"K2 at S={k2_S} B={TRAIN_BATCH} bf16 norm flips (the TRAIN "
          f"batches' most common rung): {k2_row['ms']:.4f} ms (device "
          f"alone {k2_row['device_ms']:.4f} ms, wrapper host "
          f"{k2_row['host_us']:.1f} us per call), bound "
          f"{k2_row['bound_ms']:.4f} ms; TRAIN {train['img_s']:.1f} img/s "
          f"(second epoch {train['warm_img_s']:.1f}); card {card}",
          flush=True)
    # K2's serving row: the rung most RUN img batches landed on
    k2_img_S = max(serve["rungs"], key=serve["rungs"].get)
    k2_img = k2_run_rows[k2_img_S]
    print(f"K2 at S={k2_img_S} B={RUN_BATCH} bf16 norm, no flips (the RUN "
          f"img batches' most common rung): {k2_img['ms']:.4f} ms (device "
          f"alone {k2_img['device_ms']:.4f} ms), bound "
          f"{k2_img['bound_ms']:.4f} ms; RUN img {serve['img_s']:.1f} img/s "
          f"bf16, {serve['img8_s']:.1f} int8; VAL {serve['val_img_s']:.1f} "
          f"img/s; .ptl vs own checkpoint max |d score| "
          f"{serve['ptl_err']:.3g}; K2 launches by path {k2_by_path}; card "
          f"{card}", flush=True)
    print(f"K3 at {K3_MAIN} B={K3_BATCH} s8: {k3_row['ms']:.4f} ms (device "
          f"alone {k3_row['device_ms']:.4f} ms), bound "
          f"{k3_row['bound_ms']:.4f} ms ({k3_row['bound_by']}); "
          f"{k3_launches} launches in the int8 RUN; int8 RUN "
          f"{run8['img_s']:.1f} img/s; card {card}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "k1_preprocess_gray", "route": "cuda",
        "source": "ifcb_classifier_tpu_torch/csrc/preprocess_gray.cu",
        "replaces": "tools/bench_pallas.py:51",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        # launches counts K1 calls; each call launches two kernels (taps,
        # resize). device_ms: the calls queued back to back on the card;
        # host_us: the wrapper's host time per call
        "kernels_per_launch": 2, "device_ms": main_row["device_ms"],
        "host_us": main_row["host_us"]}, {
        "name": "k2_preprocess_rgb", "route": "cuda",
        "source": "ifcb_classifier_tpu_torch/csrc/preprocess_rgb.cu",
        # an XLA fusion on the TPU, no pallas_call: the RGB branch of
        # preprocess_batch (resize_bilinear_matmul, _flip_batch)
        "replaces": "ifcb_classifier_tpu/ops/preprocess.py:57",
        "launches": train["k2_launches"], "max_abs_err": k2_err,
        "ms": k2_row["ms"], "plain_ms": k2_row["plain_ms"],
        "bound_ms": k2_row["bound_ms"], "bound_by": k2_row["bound_by"],
        "library_ms": k2_row["library_ms"], "S": k2_S,
        "kernels_per_launch": 2, "device_ms": k2_row["device_ms"],
        "host_us": k2_row["host_us"], "per_sm": k2_row["per_sm"],
        "tile_cols": k2_row["cols"],
        # B=128 canvases of the batches TRAIN forms from roi_sides images
        # (bf16, norm, flips): the rungs its batches land on
        "train_mix": [{k: r[k] for k in ("S", "ms", "device_ms", "bound_ms",
                                         "bound_by", "sides_from")}
                      for r in k2_mix_rows if r["S"] in (512, 1024)],
        # launches keeps counting TRAIN's calls (phase 4); the serving
        # verbs' calls, each counted from 0 around its own run (phase 5)
        "launches_by_path": k2_by_path,
        # B=256 bf16 norm, no flips (RUN --type img) at the rung most of
        # phase 5a's batches landed on; CALC_IMG_NORM's f32 r=224 by rung
        "run_img": dict(k2_img, batches_by_rung=serve["rungs"]),
        "calc_img_norm_r224": [k2_norm_rows[S] for S in LADDER]}, {
        "name": "k3_qconv_s8", "route": "cuda",
        "source": "ifcb_classifier_tpu_torch/csrc/qconv_s8.cu",
        # an XLA fusion on the TPU, no pallas_call: _QuantCtx.conv's s8
        # conv into s32 and its epilogue
        "replaces": "ifcb_classifier_tpu/models/quant_graph.py:96",
        "launches": k3_launches, "max_abs_err": 0,
        "ms": k3_row["ms"], "plain_ms": k3_row["plain_ms"],
        "bound_ms": k3_row["bound_ms"], "bound_by": k3_row["bound_by"],
        # bf16 cuDNN conv + bias + relu of the same shape: the float path
        # K3 replaces, not the same function
        "library_ms": k3_row["library_ms"], "shape": K3_MAIN,
        "device_ms": k3_row["device_ms"], "host_us": k3_row["host_us"],
        "geometries_checked": n_geoms,
        # K3 over one int8 dispatch (94 convs, B=256, each conv's own emit,
        # device time):
        # the summed ms and summed bound of k3_dispatch_sweep
        "dispatch_ms": k3_sweep["ms"],
        "dispatch_bound_ms": k3_sweep["bound_ms"],
        "shapes": [{k: r[k] for k in ("name", "ms", "device_ms", "host_us",
                                      "bound_ms", "bound_by", "plain_ms",
                                      "library_ms", "int_mm_ms")}
                   for r in k3_rows]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
