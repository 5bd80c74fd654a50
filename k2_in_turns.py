#!/usr/bin/env python3
"""Hold K2 (ifcb_classifier_tpu_torch/csrc/preprocess_rgb.cu) bitwise to
an older build of it, then time the two in turns, and the current K2
against the design options it was weighed against, on one CUDA GPU.

Run from the root of a checkout:

  python3 k2_in_turns.py --extract REV     # with git: the older source
  python3 k2_in_turns.py [--old DIR] [--options]

--extract writes REV's preprocess_rgb.cu and its own preprocess_common.cuh
into the gitignored _compare/k2_REV/ (git show), for a later run without
git. --old DIR builds the two files of DIR with the port's nvcc command;
its C entry point k2_preprocess_rgb has the current one's arguments. At
every canvas rung S = 64..1024 (r=299), on two size mixes (chip_smoke's
uniform draw, and the batches TRAIN forms from roi_sides images,
chip_smoke.train_mix), at B = 1, 16 and 128, with and without the norm
and the flips, the older K2's f32 and bf16 outputs must equal the current
one's bit for bit, the bf16 one must be the f32 one rounded once, and the
f32 one must lie within 1e-5 (1e-4 after the norm) of
preprocess_rgb_plain. Then each rung and mix is timed at B=128, bf16,
norm, flips: old, new, new, old (device time: the calls queued behind a
device-side sleep, as chip_smoke's device_ms).

--options builds each design option in OPTIONS from the current source
with a few of its lines rewritten (in the gitignored _compare/k2_NAME/),
and, at each rung and mix where the option changes the launch or the
code that runs, holds its f32 output bitwise to the current K2's and
times the two in turns: current, option, option, current.

All builds start together. Prints one line per comparison and, last, a
JSON object of all the numbers.
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = "ifcb_classifier_tpu_torch/csrc"
BATCHES = (1, 16, 128)

# the current K2's unit hand-out: a block's first two units fixed, the
# rest from a counter that the taps kernel zeroes
FIRST_UNITS = ("    if ((int)blockIdx.x >= units) return;  "
               "// the grid is at most units\n"
               "    Tile cur;\n"
               "    start_unit(cur, blockIdx.x);\n"
               "    int nu = blockIdx.x + gridDim.x;\n")
NEXT_UNIT = "asked = 2 * (int)gridDim.x + atomicAdd(work, 1);"
TAPS = ("    cudaError_t e = launch_taps<true>(sz, ln, w, B, S, r, T, st, "
        "work);")
NO_COUNTER_TAPS = ("    cudaError_t e =\n"
                   "        launch_taps<false>(sz, ln, w, B, S, r, T, st, "
                   "nullptr);")

# name: (what it is, [(text of the current source, its replacement, how
# often the text occurs)], where it is timed: "launch" where its launch
# shape differs from the current one's, "whole" where the current plan
# stages whole rows, "always")
OPTIONS = {
    "static": (
        "persistent blocks over equal static ranges of units (image, row "
        "step), no counter",
        [(FIRST_UNITS,
          "    const long long per = (long long)units;\n"
          "    const int u_end = (int)(per * (blockIdx.x + 1) / gridDim.x);\n"
          "    int u_next = (int)(per * blockIdx.x / gridDim.x);\n"
          "    auto take = [&]() {\n"
          "        return u_next < u_end ? u_next++ : units;\n"
          "    };\n"
          "    if ((int)blockIdx.x >= units) return;\n"
          "    Tile cur;\n"
          "    start_unit(cur, take());\n"
          "    int nu = take();\n", 1),
         (NEXT_UNIT, "asked = take();", 1),
         (TAPS, NO_COUNTER_TAPS, 1)],
        "always"),
    "memset": (
        "every unit from the counter, zeroed by a cudaMemsetAsync of its "
        "own before the taps kernel",
        [(FIRST_UNITS,
          "    if (tid == 0) {\n"
          "        s_unit[0] = atomicAdd(work, 1);\n"
          "        s_unit[1] = atomicAdd(work, 1);\n"
          "    }\n"
          "    __syncthreads();\n"
          "    if (s_unit[0] >= units) return;\n"
          "    Tile cur;\n"
          "    start_unit(cur, s_unit[0]);\n"
          "    int nu = s_unit[1];\n", 1),
         (NEXT_UNIT, "asked = atomicAdd(work, 1);", 1),
         (TAPS, "    cudaError_t e = cudaMemsetAsync(work, 0, sizeof(int), "
                "st);\n"
                "    if (e == cudaSuccess)\n"
                "        e = launch_taps<false>(sz, ln, w, B, S, r, T, st, "
                "nullptr);", 1)],
        "always"),
    "min3": (
        "tiles narrow enough to leave room for three blocks an SM at every "
        "rung (kK2MinBlocks = 3)",
        [("kK2MinBlocks = 2;", "kK2MinBlocks = 3;", 1)], "launch"),
    "onebuf": (
        "one canvas buffer at every rung",
        [("for (int nb = 2; nb >= 1 &&", "for (int nb = 1; nb >= 1 &&", 1)],
        "launch"),
    "twobuf": (
        "two canvas buffers at every rung, whatever they cost in tile "
        "width or blocks",
        [("for (int nb = 2; nb >= 1 &&", "for (int nb = 2; nb >= 2 &&", 1)],
        "launch"),
    "t256": (
        "256 threads a block at every rung",
        [("sh->threads = kK2SmThreads / blocks;", "sh->threads = 256;", 1)],
        "launch"),
    "direct": (
        "whole-row tiles stored straight from registers instead of staged "
        "for 16-byte stores",
        [("        if (cols == r) {\n            horizontal(",
          "        if (false) {\n            horizontal(", 1)],
        "whole"),
}
# what the timing compares of two launch shapes
SHAPE_KEYS = ("cols", "nbuf", "threads", "smem", "per_sm")


def extract(rev):
    """REV's K2 source and header into _compare/k2_REV/; returns the
    directory."""
    out = os.path.join(HERE, "_compare", f"k2_{rev}")
    os.makedirs(out, exist_ok=True)
    for name in ("preprocess_rgb.cu", "preprocess_common.cuh"):
        src = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"],
                             cwd=HERE, check=True, capture_output=True).stdout
        with open(os.path.join(out, name), "wb") as f:
            f.write(src)
    return out


def rewritten(name, edits):
    """The current K2 source with ``edits`` applied, and its header, in
    _compare/k2_NAME/; returns the directory."""
    from ifcb_classifier_tpu_torch.ops.preprocess import _COMMON_H, _K2_SRC
    with open(_K2_SRC) as f:
        src = f.read()
    for old, new, count in edits:
        if src.count(old) != count:
            raise RuntimeError(f"k2_in_turns: option {name}: {old!r} is not "
                               "in preprocess_rgb.cu as it was")
        src = src.replace(old, new)
    out = os.path.join(HERE, "_compare", f"k2_{name}")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "preprocess_rgb.cu"), "w") as f:
        f.write(src)
    shutil.copy(_COMMON_H, out)
    return out


def build(name, path):
    """(bound ctypes library, compiler output) of the K2 source in
    directory ``path``."""
    from ifcb_classifier_tpu_torch._build import build_shared_library
    from ifcb_classifier_tpu_torch.ops.preprocess import (_bind_k2,
                                                          _nvcc_command)
    so, log = build_shared_library(
        f"k2_{name}", [os.path.join(path, "preprocess_rgb.cu")],
        _nvcc_command(), headers=[os.path.join(path,
                                               "preprocess_common.cuh")])
    return _bind_k2(ctypes.CDLL(so)), log


def launcher(lib):
    """call(c, s, f, out, norm) of a K2 library's entry point, into
    ``out``."""
    import torch
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        K2_SCRATCH_EXTRA, _c_norm, _stream, _tap_scratch)

    def call(c, s, f, out, norm):
        B, S = c.shape[0], c.shape[1]
        scratch, lo_n, wt, T = _tap_scratch(B, S, cs.R, c.device,
                                            extra=K2_SCRATCH_EXTRA)
        mean, std = (_c_norm(cs.RGB_MEAN, cs.RGB_STD) if norm
                     else _c_norm(None, None))
        err = lib.k2_preprocess_rgb(
            c.data_ptr(), s.data_ptr(), None if f is None else f.data_ptr(),
            out.data_ptr(), B, S, cs.R, int(out.dtype == torch.bfloat16),
            int(norm), mean, std, lo_n, wt, T, _stream(c.device))
        del scratch
        if err:
            raise RuntimeError(f"K2 launch failed with cudaError_t {err}")
        return out
    return call


def in_turns(a, b, iters=20):
    """(a ms, b ms): device time of each, timed a, b, b, a; each the mean
    of its two turns."""
    t = [cs.cuda_ms(f, iters, queued=True) for f in (a, b, b, a)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def inputs(S, mix, sizes_mix, rng):
    """(canvas, sizes, flips) on the card at B=128 for one rung and mix;
    the checks at smaller B take their first images."""
    import torch
    if mix == "uniform":
        canvas, sizes = cs.make_rgb_canvas(cs.TRAIN_BATCH, S, rng)
    else:
        sizes = sizes_mix[S][0]
        canvas = cs.rgb_canvas_of(sizes, S, rng)
    flips = rng.integers(0, 2, (cs.TRAIN_BATCH, 2)).astype(np.uint8)
    return (torch.from_numpy(canvas).cuda(), torch.from_numpy(sizes).cuda(),
            torch.from_numpy(flips).cuda(), sizes)


def hold(new, old, c, s, f, S, what):
    """The older K2 bitwise equal to the current one in f32 and bf16 at
    each B, with and without the norm and the flips; the bf16 output the
    f32 one rounded once; the f32 one within the tolerances of the plain
    version. Returns the number of configurations held."""
    import torch
    from ifcb_classifier_tpu_torch.ops.preprocess import preprocess_rgb_plain
    n = 0
    for B in BATCHES:
        cb, sb, fb = c[:B], s[:B], f[:B]
        for norm in (False, True):
            for flips in (None, fb):
                got = {}
                for dtype in (torch.float32, torch.bfloat16):
                    for name, call in (("new", new), ("old", old)):
                        out = torch.empty((B, cs.R, cs.R, 3), dtype=dtype,
                                          device="cuda")
                        got[name, dtype] = call(cb, sb, flips, out, norm)
                ref = preprocess_rgb_plain(
                    cb, sb, out_size=cs.R,
                    mean=cs.RGB_MEAN if norm else None,
                    std=cs.RGB_STD if norm else None, flips=flips)
                torch.cuda.synchronize()
                tag = (f"S={S} {what} B={B} norm={norm} "
                       f"flips={flips is not None}")
                for dtype in (torch.float32, torch.bfloat16):
                    a, b = got["new", dtype], got["old", dtype]
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"K2 {tag} {dtype}: {int((a != b).sum())} values"
                            " differ between the current and the older K2")
                f32 = got["new", torch.float32]
                if not torch.equal(got["new", torch.bfloat16],
                                   f32.to(torch.bfloat16)):
                    raise AssertionError(f"K2 {tag}: bf16 is not the f32 "
                                         "result rounded once")
                tol = cs.TOL_F32_NORM if norm else cs.TOL_F32
                err = float((f32 - ref).abs().max())
                if not err <= tol:
                    raise AssertionError(f"K2 {tag}: max|err| {err} against "
                                         f"the plain version > {tol}")
                n += 1
    return n


def main():
    import torch
    from ifcb_classifier_tpu_torch.ops.preprocess import _k2_shape, build_k2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extract", metavar="REV",
                    help="write REV's K2 source into _compare/k2_REV/ and "
                         "stop")
    ap.add_argument("--old", metavar="DIR",
                    help="an older K2 source (preprocess_rgb.cu and its "
                         "preprocess_common.cuh) to hold and time against")
    ap.add_argument("--options", action="store_true",
                    help="time the current K2 against the design options "
                         "in OPTIONS")
    args = ap.parse_args()
    if args.extract:
        print(extract(args.extract))
        return 0
    if not torch.cuda.is_available():
        print("k2_in_turns: needs a CUDA GPU", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    # every build at once: the current K2, the older one, the options
    dirs = dict((name, rewritten(name, edits))
                for name, (_, edits, _) in OPTIONS.items()
                if args.options)
    if args.old:
        dirs["old"] = args.old
    with concurrent.futures.ThreadPoolExecutor(len(dirs) + 1) as pool:
        current = pool.submit(build_k2)
        built = {name: pool.submit(build, name, path)
                 for name, path in dirs.items()}
        lib, log = current.result()
        built = {name: f.result() for name, f in built.items()}
    for line in cs.ptxas_report(log):
        print(line, flush=True)
    for name, (_, olog) in built.items():
        for line in cs.ptxas_report(olog):
            print(f"{name} {line}", flush=True)
    new = launcher(lib)
    old = launcher(built["old"][0]) if args.old else None
    rng = np.random.default_rng(5)
    sizes_mix = cs.train_mix(np.random.default_rng(3))
    rows, n_held = [], 0
    for S in cs.LADDER:
        for mix in ("uniform", "train"):
            c, s, f, sizes = inputs(S, mix, sizes_mix, rng)
            bound, by = cs.k1_bound(sizes, S, cs.R, 2, channels=3,
                                    flips=True)
            sh = _k2_shape(lib, cs.TRAIN_BATCH, S, cs.R, torch.bfloat16)
            row = dict(S=S, mix=mix, bound_ms=bound, bound_by=by,
                       **{k: sh[k] for k in SHAPE_KEYS})
            out = torch.empty((cs.TRAIN_BATCH, cs.R, cs.R, 3),
                              dtype=torch.bfloat16, device="cuda")

            def run(call):
                return lambda: call(c, s, f, out, True)
            if old is not None:
                n_held += hold(new, old, c, s, f, S, mix)
                row["old_ms"], row["new_ms"] = in_turns(run(old), run(new))
                print(f"S={S} {mix}: old {row['old_ms']:.4f} ms, new "
                      f"{row['new_ms']:.4f} ms "
                      f"({row['old_ms'] / row['new_ms']:.2f}x), bound "
                      f"{bound:.4f} ms ({by}), new/bound "
                      f"{row['new_ms'] / bound:.2f}; tiles of 16 x "
                      f"{sh['cols']}, {sh['nbuf']} canvas buffer(s), "
                      f"{sh['threads']} threads, {sh['per_sm']} blocks per "
                      f"SM; in turns on {card}", flush=True)
            row["options"] = {}
            for name, (what, _, where) in OPTIONS.items():
                if name not in built:
                    continue
                olib = built[name][0]
                osh = _k2_shape(olib, cs.TRAIN_BATCH, S, cs.R,
                                torch.bfloat16)
                same = all(osh[k] == sh[k] for k in SHAPE_KEYS)
                if ((where == "launch" and same)
                        or (where == "whole" and sh["cols"] != cs.R)):
                    continue  # the same launch and code path here
                call = launcher(olib)
                f32 = torch.empty(out.shape, dtype=torch.float32,
                                  device="cuda")
                a = new(c, s, f, f32, True)
                b = call(c, s, f, f32.clone(), True)
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise AssertionError(f"S={S} {mix}: option {name} "
                                         "differs from the current K2")
                cur_ms, opt_ms = in_turns(run(new), run(call))
                row["options"][name] = dict(
                    ms=opt_ms, current_ms=cur_ms,
                    **{k: osh[k] for k in SHAPE_KEYS})
                print(f"S={S} {mix}: current (16 x {sh['cols']}, "
                      f"{sh['nbuf']} buffer(s), {sh['threads']} threads, "
                      f"{sh['per_sm']} blocks per SM) {cur_ms:.4f} ms; "
                      f"{name}, {what} (16 x {osh['cols']}, {osh['nbuf']} "
                      f"buffer(s), {osh['threads']} threads, "
                      f"{osh['per_sm']} blocks per SM) {opt_ms:.4f} ms; in "
                      f"turns on {card}", flush=True)
            rows.append(row)
            del c, s, f, out
    print(json.dumps({"card": card, "configurations_held": n_held,
                      "rungs": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
