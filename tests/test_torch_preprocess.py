"""The port's gray preprocess (ifcb_classifier_tpu_torch/ops/preprocess.py)
against the JAX package: its XLA form (ops/preprocess.preprocess_batch)
and the Pallas kernel K1 replaces (tools/bench_pallas.py, run in interpret
mode on the CPU).

Inputs are made from a seed with numpy. Tolerances: the three versions
compute the same f32 weights and sum the same products in other orders,
so values in [0, 1] agree to a few f32 ulps (measured max 1.8e-7; pinned
at 1e-6). (x - mean)/std with std ≈ 0.16 scales the error by ~6
(measured max 1.2e-6; pinned at 1e-5).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

ATOL_CLIP = 1e-6
ATOL_NORM = 1e-5
MEAN = (0.667, 0.5, 0.4)
STD = (0.161, 0.2, 0.25)


def _inputs(B, S, seed):
    """A canvas batch with a (1,1) pad row, a full-canvas image, h != w
    images and random sizes; zero outside each image like the packer."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, S + 1, size=(B, 2)).astype(np.int32)
    sizes[0] = (1, 1)
    sizes[1] = (S, S)
    sizes[2] = (S, max(1, S // 3))
    canvas = np.zeros((B, S, S), np.uint8)
    for b, (h, w) in enumerate(sizes):
        canvas[b, :h, :w] = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    return canvas, sizes


def _port(canvas, sizes, r, norm):
    from ifcb_classifier_tpu_torch.ops.preprocess import preprocess_gray
    mean, std = (MEAN, STD) if norm else (None, None)
    out = preprocess_gray(torch.from_numpy(canvas), torch.from_numpy(sizes),
                          out_size=r, mean=mean, std=std,
                          dtype=torch.float32)
    assert out.shape == (canvas.shape[0], r, r, 3) and out.is_contiguous()
    return out.numpy()


@pytest.mark.parametrize("S,r", [(64, 75), (64, 96), (128, 75), (128, 96)])
@pytest.mark.parametrize("norm", [False, True])
def test_matches_jax_preprocess_batch(S, r, norm):
    import jax.numpy as jnp
    from ifcb_classifier_tpu.ops.preprocess import preprocess_batch
    canvas, sizes = _inputs(5, S, seed=S + r)
    mean, std = (MEAN, STD) if norm else (None, None)
    ref = np.asarray(preprocess_batch(jnp.asarray(canvas), jnp.asarray(sizes),
                                      out_size=r, mean=mean, std=std,
                                      dtype=jnp.float32))
    got = _port(canvas, sizes, r, norm)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=ATOL_NORM if norm else ATOL_CLIP)


@pytest.mark.parametrize("S,r", [(64, 75), (128, 96)])
def test_matches_pallas_kernel_interpret(S, r):
    """The Pallas kernel stops after the clip; the port's channels are
    that value broadcast."""
    import jax.numpy as jnp
    from bench_pallas import preprocess_gray_pallas_factory
    canvas, sizes = _inputs(3, S, seed=7)
    pallas = preprocess_gray_pallas_factory()
    ref = np.asarray(pallas(jnp.asarray(canvas), jnp.asarray(sizes),
                            out_size=r, interpret=True))
    got = _port(canvas, sizes, r, norm=False)
    for c in range(3):
        np.testing.assert_allclose(got[..., c], ref, rtol=0, atol=ATOL_CLIP)


def test_resize_weights_match_jax():
    import jax.numpy as jnp
    from ifcb_classifier_tpu.ops.preprocess import resize_weights as jw
    from ifcb_classifier_tpu_torch.ops.preprocess import resize_weights
    for src, S, r in [(1, 64, 75), (37, 64, 96), (128, 128, 75),
                      (1000, 1024, 299)]:
        ref = np.asarray(jw(src, S, r, jnp.float32))
        got = resize_weights(torch.tensor([src]), S, r)[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_bf16_output_is_one_rounding_of_f32():
    from ifcb_classifier_tpu_torch.ops.preprocess import preprocess_gray
    canvas, sizes = _inputs(4, 64, seed=3)
    args = (torch.from_numpy(canvas), torch.from_numpy(sizes))
    f32 = preprocess_gray(*args, out_size=75, mean=MEAN, std=STD,
                          dtype=torch.float32)
    bf16 = preprocess_gray(*args, out_size=75, mean=MEAN, std=STD,
                           dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))


def test_non_cpu_tensor_never_takes_the_plain_path():
    """The kernel's wrapper refuses a tensor that is not on a CUDA device
    instead of computing it elsewhere; a 'meta' tensor stands in for a
    device tensor on a machine without a GPU."""
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        preprocess_gray, preprocess_gray_cuda)
    canvas = torch.empty((2, 64, 64), dtype=torch.uint8, device="meta")
    sizes = torch.empty((2, 2), dtype=torch.int32, device="meta")
    before = preprocess_gray_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        preprocess_gray(canvas, sizes, out_size=75)
    assert preprocess_gray_cuda.launches == before


def test_cuda_request_without_gpu_raises(monkeypatch):
    """device='cuda' on a machine without a usable GPU raises; it never
    runs on the CPU instead."""
    from ifcb_classifier_tpu_torch.utils.config import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_cuda_kernel_matches_plain_on_the_card():
    """Runs where a GPU and nvcc exist (chip_smoke.py covers every ladder
    rung at the main path's shapes); skips on a machine without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        preprocess_gray_cuda, preprocess_gray_plain)
    canvas, sizes = _inputs(6, 128, seed=11)
    c, s = torch.from_numpy(canvas).cuda(), torch.from_numpy(sizes).cuda()
    got = preprocess_gray_cuda(c, s, out_size=96, mean=MEAN, std=STD,
                               dtype=torch.float32)
    torch.cuda.synchronize()
    ref = preprocess_gray_plain(c, s, out_size=96, mean=MEAN, std=STD)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=0, atol=ATOL_NORM)
