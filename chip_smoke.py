#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ifcb_classifier_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. device: needs CUDA; prints the card's name and power limit.
  2. K1 (csrc/preprocess_gray.cu) is built from the checkout and held
     against its plain PyTorch version on the card at every canvas rung
     S in {64..1024}, r=299, B in {16, 256}: f32 within 1e-5 before the
     norm (1e-4 after it, std >= 0.161), bf16 equal to the kernel's f32
     result rounded once to bf16. Per rung at B=256 it times the kernel, the plain
     version and F.interpolate(bilinear, antialias) on full-canvas images
     (a yardstick of the resize alone; the port never calls it).
  3. the main path: synthetic IFCB bins (a realistic ROI size mix over the
     64..1024 rungs, one bin of 1,500 ROIs) are classified by
     ``RUN --batch 256`` of the port's CLI with a random-init full-width
     inception_v3 (50 classes, resize 299, BN folded, bf16). It checks every
     bin's result file, that K1 launched once per engine dispatch, the
     fp32 card result (TF32 off) against the port's CPU path on a small bin
     (scores within 1e-5), and prints the bf16-vs-fp32 score delta and the
     RUN's img/s.
  4. prints the kernels line and, last, the device line.

Weights and bins are made from fixed seeds; nothing is downloaded.
"""

import json
import os
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


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def k1_bound(sizes, S, r, out_bytes):
    """(bound ms, 'bytes'|'operations') for one K1 call on these inputs:
    the bytes it needs (each image's true h x w canvas bytes and the sizes
    read once, each output written once) against the multiply-adds of the
    taps these sizes need."""
    import torch
    from ifcb_classifier_tpu_torch.ops.preprocess import resize_weights
    B = sizes.shape[0]
    in_bytes = int((sizes[:, 0].astype(np.int64) * sizes[:, 1]).sum())
    nbytes = in_bytes + sizes.nbytes + B * r * r * 3 * out_bytes
    nnz_h = (resize_weights(torch.from_numpy(sizes[:, 0]), S, r) > 0) \
        .sum(dim=(1, 2)).numpy()
    nnz_w = (resize_weights(torch.from_numpy(sizes[:, 1]), S, r) > 0) \
        .sum(dim=(1, 2)).numpy()
    ops = float(np.sum(2 * sizes[:, 1] * nnz_h + 2 * r * nnz_w)
                + B * r * r * 8)  # /255, clip, 3x (x-m)/s
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k1(rng):
    """Phase 2. Returns (per-rung timing rows, max f32 error)."""
    import torch
    import torch.nn.functional as F
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        preprocess_gray_cuda, preprocess_gray_plain)
    dev = torch.device("cuda")
    max_err = 0.0
    rows = []
    for S in LADDER:
        for B in (16, 256):
            canvas, sizes = make_canvas(B, S, rng)
            c = torch.from_numpy(canvas).to(dev)
            s = torch.from_numpy(sizes).to(dev)
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
                  f"{err:.3g})", flush=True)
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
                   plain_ms=cuda_ms(plain, 5), library_ms=cuda_ms(lib, 10))
        row["bound_ms"], row["bound_by"] = k1_bound(sizes, S, R, 2)
        rows.append(row)
        print("K1 time S={S} B={B} bf16: kernel {ms:.4f} ms, plain "
              "{plain_ms:.4f} ms, F.interpolate (resize only, full canvas) "
              "{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              "({bound_by})".format(**row), flush=True)
        del c, s, xf
    return rows, max_err


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
    """IFCB-like ROI sizes: log-normal sides (median ~48 px), so most land
    on the 64/128 rungs and a tail reaches 256..1024; none over 1024."""
    sides = np.clip(np.round(rng.lognormal(np.log(48), 0.75, (n, 2))),
                    8, 1024).astype(int)
    if n >= 1000:  # make sure every rung is fed
        sides[:4] = [(300, 200), (180, 450), (700, 90), (1000, 1024)]
    rois = []
    for h, w in sides:
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


def profile_breakdown(run, card):
    """The warm RUN once more under torch.profiler: the card's busy share
    (union of kernel spans over the wall time) and the kernels that take
    it. Informational: a profiler that records no device events is said
    so, not treated as a failure of the path."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s = run()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("profile: the profiler recorded no device events", flush=True)
        return

    def union_us(spans):
        total, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    kern = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    copy = [e for e in dev if e.name.startswith("Memcpy")]
    busy = union_us((e.time_range.start, e.time_range.end) for e in kern)
    copy_us = union_us((e.time_range.start, e.time_range.end) for e in copy)
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    k1 = sum(v for k, v in by_name.items() if "preprocess_gray" in k)
    print(f"profile (warm RUN under torch.profiler, wall {wall_s * 1e3:.1f} "
          f"ms): kernels busy {busy / 1e3:.1f} ms = "
          f"{100 * busy / (wall_s * 1e6):.1f}% of wall (idle "
          f"{100 - 100 * busy / (wall_s * 1e6):.1f}%), memcpy "
          f"{copy_us / 1e3:.1f} ms, {len(kern)} kernel launches, K1 "
          f"{k1 / 1e3:.2f} ms; on {card}", flush=True)
    print("profile top kernels (ms): " + "; ".join(
        f"{k[:60]} {v / 1e3:.2f}" for k, v in top), flush=True)


def main_path(work, rng, card):
    """Phase 3. Returns (K1 launches in the RUN, RUN numbers)."""
    import torch
    from ifcb_classifier_tpu_torch.cli import argparse_nn, main, main_cli
    from ifcb_classifier_tpu_torch.data.ifcb import Bin
    from ifcb_classifier_tpu_torch.infer.runner import InferenceEngine
    from ifcb_classifier_tpu_torch.ops.preprocess import preprocess_gray_cuda
    from ifcb_classifier_tpu_torch.utils.config import (
        add_runtime_params, proc_outdir, resolve_dtype)

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
    t0 = time.perf_counter()
    engine = main_cli(argv)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = preprocess_gray_cuda.launches
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

    # warm: the same engine over the same bins into a fresh outdir
    def warm_run(tag):
        args = argparse_nn().parse_args(
            ["--batch", "256", "RUN", bins_dir, ckpt, "smoke",
             "--outdir", os.path.join(work, tag),
             "--outfile", "{BIN_ID}_class.json"])
        add_runtime_params(args)
        proc_outdir(args, model_id_for_run=engine.model_id)
        t0 = time.perf_counter()
        main(args, engine=engine)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm_s = warm_run("run_warm")
    img_s = n_rois / warm_s
    print(f"RUN img/s (warm, inception_v3 @299 bf16, batch 256, "
          f"{n_rois} ROIs in {len(pids)} bins, bins read + packed + "
          f"classified + written): {img_s:.1f} on {card}", flush=True)
    profile_breakdown(lambda: warm_run("run_prof"), card)

    # fp32 on the card (TF32 off) vs the bf16 RUN, and vs the CPU path
    e32 = InferenceEngine(ckpt, batch_size=256,
                          dtype=resolve_dtype("fp32", "cuda"))
    delta, agree, total = 0.0, 0, 0
    for pid in pids:
        _, p32 = e32.predict_bin(Bin(os.path.join(bins_dir, pid + ".adc")))
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
    return launches, dict(img_s=img_s, cold_s=cold_s, warm_s=warm_s)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ifcb_classifier_tpu_torch import native
    from ifcb_classifier_tpu_torch.ops.preprocess import build_k1

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in f32

    t0 = time.perf_counter()
    _, log = build_k1()
    if not native.available():
        raise RuntimeError("the native ROI packer did not build")
    print(f"built K1 and roipack in {time.perf_counter() - t0:.1f} s; "
          f"ptxas: {' | '.join(ln.strip() for ln in log.splitlines() if 'registers' in ln or 'smem' in ln)}",
          flush=True)

    rng = np.random.default_rng(0)
    # 2. K1 against its plain version
    rows, max_err = check_k1(rng)

    # 3. the main path
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, run = main_path(work, rng, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 4. result lines
    main_row = next(r for r in rows if r["S"] == 128)
    print(f"K1 at S=128 B=256 bf16 (main path): {main_row['ms']:.4f} ms; "
          f"RUN {run['img_s']:.1f} img/s; card {card}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "k1_preprocess_gray", "route": "cuda",
        "source": "ifcb_classifier_tpu_torch/csrc/preprocess_gray.cu",
        "replaces": "tools/bench_pallas.py:51",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
