#!/usr/bin/env python3
"""Time K3 (ifcb_classifier_tpu_torch/csrc/qconv_s8.cu) against an older
build of it, and against the launch options it does not take, in turns on
one CUDA GPU: the shapes of chip_smoke.K3_SHAPES at B=256, s8 emit, each
pair timed a, b, b, a (device time: the calls queued behind a device-side
sleep, as chip_smoke's device_ms).

Run from the root of a checkout:

  python3 k3_in_turns.py [--old OLD.cu] [--options]

--old takes an older K3 source, built with the port's nvcc command and
held bitwise to the current K3 before it is timed. Its interface is read
from what it exports: one with k3_weight_map reads packed weights as the
current K3 does (it is given the current pack and launch plan, and encodes
its own descriptor); one without is the interface from before the weights
were packed: k3_qconv_s8(x, w [Co,kh,kw,Ci], scale, bias, out, B, H, W,
Ci, Co, KH, KW, SH, SW, PH, PW, Ho, Wo, out_stride, out_off, out_kind,
inv_out, stream). --options times the current K3 against the same kernel
launched with K padded to a multiple of 128 bytes (a whole ring stage)
rather than of ops/qconv.K3_K_ALIGN, and with ring depths 3 and 4 against
the plan's. Prints one line per comparison and, last, a JSON object of
all the numbers.
"""

import argparse
import ctypes
import json
import sys

import chip_smoke as cs


def old_kernel(path):
    """(call(x, w, pack, scale, bias, stride, pads, inv_out, out), compiler
    output) of an older K3 source."""
    import torch
    from ifcb_classifier_tpu_torch._build import build_shared_library
    from ifcb_classifier_tpu_torch.ops.preprocess import (_nvcc_command,
                                                          _stream)
    so, log = build_shared_library("k3_old", [path], _nvcc_command())
    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.k3_qconv_s8.restype = i32
    if hasattr(lib, "k3_weight_map"):
        lib.k3_qconv_s8.argtypes = [ptr] * 6 + [ctypes.c_longlong, i32, i32,
                                                ctypes.c_float, ptr]
        lib.k3_weight_map.restype = i32
        lib.k3_weight_map.argtypes = [ptr, i32, i32, i32, ptr]
        maps = {}

        def call(x, w, pack, scale, bias, stride, pads, inv_out, out):
            B, H, W, ci = x.shape
            co, kh, kw, _ = w.shape
            if id(pack) not in maps:
                m = ctypes.create_string_buffer(128)
                err = lib.k3_weight_map(pack.w.data_ptr(), pack.w.shape[0],
                                        pack.k_pad, pack.bn,
                                        ctypes.addressof(m))
                if err:
                    raise RuntimeError(f"old K3 descriptor failed ({err})")
                maps[id(pack)] = (pack, m, (ctypes.c_int * 17)(
                    B, H, W, ci, co, kh, kw, stride[0], stride[1],
                    pads[0][0], pads[1][0], out.shape[1], out.shape[2],
                    pack.k_pad, pack.bn, pack.stages, pack.smem))
            _, m, geom = maps[id(pack)]
            err = lib.k3_qconv_s8(
                x.data_ptr(), ctypes.addressof(m), scale.data_ptr(),
                bias.data_ptr(), out.data_ptr(), geom, out.shape[3], 0, 0,
                inv_out, _stream(x.device))
            if err:
                raise RuntimeError(f"old K3 launch failed ({err})")
        return call, log
    lib.k3_qconv_s8.argtypes = [ptr] * 5 + [i32] * 16 + [ctypes.c_float,
                                                          ptr]

    def call(x, w, pack, scale, bias, stride, pads, inv_out, out):
        B, H, W, ci = x.shape
        co, kh, kw, _ = w.shape
        err = lib.k3_qconv_s8(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, W, ci, co, kh, kw, stride[0], stride[1],
            pads[0][0], pads[1][0], out.shape[1], out.shape[2], out.shape[3],
            0, 0, inv_out, _stream(x.device))
        if err:
            raise RuntimeError(f"old K3 launch failed ({err})")
    return call, log


def repacked(w, k_align=None, stages=None):
    """``pack_k3_weights(w)`` with K_pad rounded up to ``k_align`` and/or a
    ring of ``stages`` (launch options the port's plan does not take)."""
    import torch
    from ifcb_classifier_tpu_torch.ops.qconv import (SMEM_PER_BLOCK,
                                                     build_k3,
                                                     k3_smem_bytes,
                                                     pack_k3_weights)
    pack = pack_k3_weights(w)
    if k_align is not None:
        co, kh, kw, ci = w.shape
        k = kh * kw * ci
        pack.k_pad = -(-k // k_align) * k_align
        pack.w = torch.zeros((pack.w.shape[0], pack.k_pad),
                             dtype=torch.int8, device=w.device)
        pack.w[:co, :k] = w.reshape(co, k)
        err = build_k3()[0].k3_weight_map(pack.w.data_ptr(), pack.w.shape[0],
                                          pack.k_pad, pack.bn, pack.map_ptr)
        if err:
            raise RuntimeError(f"K3 descriptor failed ({err})")
    if stages is not None:
        pack.stages = stages
        pack.smem = k3_smem_bytes(pack.bn, stages, pack.w.shape[0])
        if pack.smem > SMEM_PER_BLOCK:
            raise ValueError(f"{stages} stages of BN={pack.bn} take "
                             f"{pack.smem} bytes of shared memory")
    return pack


def in_turns(a, b, iters=20):
    """(a ms, b ms): device time of each, timed a, b, b, a; each the mean
    of its two turns."""
    t = [cs.cuda_ms(f, iters, queued=True) for f in (a, b, b, a)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="an older K3 source to time against")
    ap.add_argument("--options", action="store_true",
                    help="time K3 against K_pad 128 and ring depths 3, 4")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_in_turns: needs a CUDA GPU", file=sys.stderr)
        return 2
    from ifcb_classifier_tpu_torch.ops.qconv import (
        K3_STAGES, build_k3, conv_out_size, pack_k3_weights, qconv_cuda)
    card = cs.card_line()
    print(card, flush=True)
    for line in cs.ptxas_report(build_k3()[1]):
        print(line, flush=True)
    old = None
    if args.old:
        old, log = old_kernel(args.old)
        for line in cs.ptxas_report(log):
            print("old " + line, flush=True)
    gen = torch.Generator().manual_seed(4)
    rows = []
    for name, ci, co, kh, kw, st, pads, H in cs.K3_SHAPES:
        B = cs.K3_BATCH
        x, w, scale, bias = cs.k3_inputs(B, H, H, ci, co, kh, kw, gen)
        stride = (st, st)
        Ho, Wo = conv_out_size(H, H, kh, kw, stride, pads)
        out = torch.empty((B, Ho, Wo, co), dtype=torch.int8, device="cuda")
        bound, by = cs.k3_bound(B, H, H, ci, co, kh, kw, Ho, Wo, 1)

        def new(pack):
            return lambda: qconv_cuda(x, w, scale, bias, stride, pads,
                                      cs.K3_INV_OUT, out=out, pack=pack)
        packed = pack_k3_weights(w)
        row = dict(name=name, bound_ms=bound, bound_by=by,
                   stages=packed.stages, k_pad=packed.k_pad)
        if old is not None:
            ref = out.clone()
            new(packed)()
            old(x, w, packed, scale, bias, stride, pads, cs.K3_INV_OUT, ref)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"{name}: old and new K3 differ")
            row["old_ms"], row["new_ms"] = in_turns(
                lambda: old(x, w, packed, scale, bias, stride, pads,
                            cs.K3_INV_OUT, out), new(packed))
            print(f"{name}: old {row['old_ms']:.4f} ms, new "
                  f"{row['new_ms']:.4f} ms ({row['old_ms'] / row['new_ms']:.2f}x"
                  f"), bound {bound:.4f} ms ({by}); in turns on {card}",
                  flush=True)
        if args.options:
            k128 = repacked(w, k_align=128)
            row["k32_ms"], row["k128_ms"] = in_turns(new(packed), new(k128))
            print(f"{name}: K_pad {packed.k_pad} (32-aligned) "
                  f"{row['k32_ms']:.4f} ms, K_pad {k128.k_pad} (128-aligned) "
                  f"{row['k128_ms']:.4f} ms; in turns on {card}", flush=True)
            for depth in (3, 4):
                if depth == packed.stages:
                    continue
                other = repacked(w, stages=depth)
                a, b = in_turns(new(packed), new(other))
                row[f"stages{other.stages}_ms"] = b
                print(f"{name}: {packed.stages} stages {a:.4f} ms, "
                      f"{other.stages} stages {b:.4f} ms; in turns on "
                      f"{card}", flush=True)
        rows.append(row)
        del x, w, out
    print(json.dumps({"card": card, "default_stages": K3_STAGES,
                      "shapes": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
