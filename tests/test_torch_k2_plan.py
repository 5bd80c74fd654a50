"""K2's tiling (ifcb_classifier_tpu_torch/csrc/preprocess_rgb.cu) on the
CPU, through its Python mirrors in ops/preprocess.py: ``k2_plan`` (the
tile's columns, canvas buffers, staged window and shared memory per rung),
``k2_tile_walk`` (the kernel's tiles, in its order) and ``k2_tiles_plain``
(the output computed tile by tile in the kernel's pass order).

For every canvas rung at r=299 and both output types: the windows that
the tap tables of ``tap_tables_plain`` need fit the rows and bytes the
plan stages, for every image size from 1 to S on both axes (so the
kernel's caps never bind); the tiles cover each output (b, i, j) exactly
once, flipped or not; the plan's shared memory fits one block and leaves
room for two blocks an SM in bf16. ``k2_tiles_plain`` agrees with
``preprocess_rgb_plain`` within 1e-5 (1e-4 after the norm, std >= 0.161),
K2's tolerances against its plain version: the two sum the same taps in
another order (a matmul against separable loops).

Inputs are made from seeds with numpy; nothing here needs a GPU or JAX.
"""

import numpy as np
import pytest
import torch

from ifcb_classifier_tpu_torch.ops.preprocess import (
    K2_MIN_BLOCKS, SMEM_PER_BLOCK, k2_plan, k2_tile_dest, k2_tile_walk,
    k2_tiles_plain, preprocess_rgb_plain, tap_tables_plain)

R = 299
RUNGS = (64, 128, 256, 512, 1024)
MEAN = (0.667, 0.6, 0.55)
STD = (0.161, 0.2, 0.25)
TOL, TOL_NORM = 1e-5, 1e-4
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
RUNG_CASES = [pytest.param(S, name, id=f"S{S}-{name}") for S in RUNGS
              for name in DTYPES]


@pytest.mark.parametrize("S,dtype", RUNG_CASES)
def test_tile_windows_fit_the_plan(S, dtype):
    """Every tile's taps lie inside the canvas rows and row bytes it
    stages, and those fit the plan's window, for h and w from 1 to S."""
    plan = k2_plan(S, R, DTYPES[dtype])
    sides = np.arange(1, S + 1, dtype=np.int32)
    sizes = torch.from_numpy(np.stack([sides, sides[::-1].copy()], axis=1))
    lo, n, _ = tap_tables_plain(sizes, S, R)
    lo, n = lo.numpy(), n.numpy()
    ends = lo + n
    for t in k2_tile_walk(sizes, S, R, plan["cols"]):
        b = t["b"]
        assert t["nrows"] <= plan["window_rows"]
        assert t["wb"] <= plan["window_bytes"] and t["wb"] % 16 == 0
        assert t["xb0"] % 16 == 0 and t["xb0"] + t["wb"] <= 3 * S
        rs = slice(t["i0"], t["i0"] + t["rows"])
        cs = slice(t["j0"], t["j0"] + t["cols"])
        taps = n[b, 0, rs] > 0
        assert (lo[b, 0, rs][taps] >= t["ymin"]).all()
        assert (ends[b, 0, rs][taps] <= t["ymin"] + t["nrows"]).all()
        taps = n[b, 1, cs] > 0
        assert (3 * lo[b, 1, cs][taps] >= t["xb0"]).all()
        assert (3 * ends[b, 1, cs][taps] <= t["xb0"] + t["wb"]).all()


@pytest.mark.parametrize("S,dtype", RUNG_CASES)
def test_tiles_cover_the_output_once(S, dtype):
    """Each (b, i, j) of the output is written by exactly one tile, with
    each flip combination, for images one tile wide (small) and several
    tiles wide (filling the canvas)."""
    plan = k2_plan(S, R, DTYPES[dtype])
    flips = [(0, 0), (1, 0), (0, 1), (1, 1)] * 2
    sizes = torch.tensor([(S, S)] * 4 + [(S, 8)] * 4, dtype=torch.int32)
    hits = torch.zeros((len(flips), R, R), dtype=torch.int32)
    for t in k2_tile_walk(sizes, S, R, plan["cols"]):
        rows, cols = k2_tile_dest(t, R, *flips[t["b"]])
        hits[t["b"], rows[:, None], cols[None, :]] += 1
    assert bool((hits == 1).all())


@pytest.mark.parametrize("S,dtype", RUNG_CASES)
def test_plan_fits_the_card(S, dtype):
    """One block's shared memory within the card's limit per block, and
    room for two blocks an SM in bf16 (the plan keeps room for
    K2_MIN_BLOCKS in both types)."""
    plan = k2_plan(S, R, DTYPES[dtype])
    assert plan["smem"] <= SMEM_PER_BLOCK
    assert plan["blocks_by_smem"] >= (2 if dtype == "bf16" else 1)
    assert plan["blocks_by_smem"] >= K2_MIN_BLOCKS
    assert 1 <= plan["cols"] <= R and plan["ncol"] * plan["cols"] >= R
    assert plan["nbuf"] in (1, 2)


def _canvas(B, S, seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, S + 1, size=(B, 2)).astype(np.int32)
    sizes[:4] = [(1, 1), (S, S), (S, 1), (1, S)]
    canvas = np.zeros((B, S, S, 3), np.uint8)
    for b, (h, w) in enumerate(sizes):
        canvas[b, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    flips = rng.integers(0, 2, (B, 2)).astype(np.uint8)
    flips[:4] = [(0, 0), (1, 0), (0, 1), (1, 1)]
    return (torch.from_numpy(canvas), torch.from_numpy(sizes),
            torch.from_numpy(flips))


# (S, r, tile columns or None for the plan's, norm, flips): up- and
# down-scaling, whole-row and narrow tiles, ragged last tiles
PLAIN_CASES = [
    pytest.param(16, 37, None, False, False, id="S16-r37-plan"),
    pytest.param(32, 20, None, True, True, id="S32-r20-plan-norm-flips"),
    pytest.param(64, 40, 7, True, True, id="S64-r40-J7-norm-flips"),
    pytest.param(48, 50, 16, False, True, id="S48-r50-J16-flips"),
    pytest.param(64, 23, 5, True, False, id="S64-r23-J5-norm"),
]


@pytest.mark.parametrize("S,r,cols,norm,flip", PLAIN_CASES)
def test_tiles_plain_matches_plain(S, r, cols, norm, flip):
    c, s, f = _canvas(6, S, seed=S * 100 + r)
    kw = dict(out_size=r, mean=MEAN if norm else None,
              std=STD if norm else None, flips=f if flip else None)
    got = k2_tiles_plain(c, s, cols=cols, **kw)
    ref = preprocess_rgb_plain(c, s, **kw)
    assert got.shape == ref.shape == (6, r, r, 3)
    assert got.dtype == ref.dtype == torch.float32
    err = float((got - ref).abs().max())
    assert err <= (TOL_NORM if norm else TOL), err


def test_card_plan_is_the_mirror():
    """On a CUDA card only: the plan that K2's C source computes (reported
    by ``k2_resize_shape``) is ``k2_plan``'s at every rung and output type,
    so the tiles the tests above walk are the kernel's (chip_smoke.py
    phase 2 checks the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2's C plan is built with nvcc")
    from ifcb_classifier_tpu_torch.ops.preprocess import k2_resize_shape
    keys = ("rows", "cols", "nbuf", "window_rows", "window_bytes", "smem",
            "threads")
    for S in RUNGS:
        for name, dtype in DTYPES.items():
            card = k2_resize_shape(128, S, R, dtype)
            plan = k2_plan(S, R, dtype)
            assert ({k: card[k] for k in keys}
                    == {k: plan[k] for k in keys}), (S, name)
