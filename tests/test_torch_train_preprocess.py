"""The port's RGB preprocess (preprocess_rgb, the CPU path of kernel K2)
against the JAX package's preprocess_batch on RGB canvases, at every rung
of the canvas ladder, with and without the norm and with flips.

Inputs are made from a seed with numpy. Tolerance 1e-5 on values in f32:
both compute the same f32 PIL-bilinear weights and sum the same products
in another order (einsum vs matmul); (x - mean)/std with std >= 0.16 scales
that by up to ~6. Flips are exact: the port takes an explicit [B,2] mask,
and the test draws it exactly as _flip_batch draws it from the same key,
so a wrong permutation moves whole rows and fails by far more than 1e-5.
"""

import numpy as np
import pytest
import torch

R = 299
ATOL = 1e-5
MEAN = (0.667, 0.5, 0.4)
STD = (0.161, 0.2, 0.25)


def _inputs(B, S, seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, S + 1, size=(B, 2)).astype(np.int32)
    sizes[0] = (1, 1)
    sizes[1] = (S, S)
    sizes[2] = (S, max(1, S // 3))
    canvas = np.zeros((B, S, S, 3), np.uint8)
    for b, (h, w) in enumerate(sizes):
        canvas[b, :h, :w] = rng.integers(0, 256, size=(h, w, 3),
                                         dtype=np.uint8)
    return canvas, sizes


def _jax(canvas, sizes, norm, key=None, flip_x=False, flip_y=False):
    import jax
    import jax.numpy as jnp
    from ifcb_classifier_tpu.ops.preprocess import preprocess_batch
    mean, std = (MEAN, STD) if norm else (None, None)
    rng = None if key is None else jax.random.PRNGKey(key)
    return np.asarray(preprocess_batch(
        jnp.asarray(canvas), jnp.asarray(sizes), rng, out_size=R,
        mean=mean, std=std, flip_x=flip_x, flip_y=flip_y))


def _jax_flip_mask(B, key, flip_x, flip_y):
    """The mask _flip_batch (ops/preprocess.py:73-84) draws from ``key``."""
    import jax
    kx, ky = jax.random.split(jax.random.PRNGKey(key))
    mask = np.zeros((B, 2), np.uint8)
    if flip_x:
        mask[:, 0] = np.asarray(jax.random.bernoulli(kx, 0.5, (B, 1, 1, 1))
                                ).reshape(B)
    if flip_y:
        mask[:, 1] = np.asarray(jax.random.bernoulli(ky, 0.5, (B, 1, 1, 1))
                                ).reshape(B)
    return mask


def _port(canvas, sizes, norm, flips=None):
    from ifcb_classifier_tpu_torch.ops.preprocess import preprocess_rgb
    mean, std = (MEAN, STD) if norm else (None, None)
    out = preprocess_rgb(torch.from_numpy(canvas), torch.from_numpy(sizes),
                         out_size=R, mean=mean, std=std,
                         flips=None if flips is None
                         else torch.from_numpy(flips), dtype=torch.float32)
    assert out.shape == (canvas.shape[0], R, R, 3) and out.is_contiguous()
    return out.numpy()


@pytest.mark.parametrize("S", [64, 128, 256, 512, 1024])
@pytest.mark.parametrize("norm", [False, True])
def test_rgb_matches_jax_at_every_rung(S, norm):
    canvas, sizes = _inputs(4, S, seed=S)
    err = np.abs(_port(canvas, sizes, norm) - _jax(canvas, sizes, norm)).max()
    assert err <= ATOL, err


@pytest.mark.parametrize("flip", ["x", "y", "xy"])
def test_flips_match_jax_flip_batch(flip):
    B, S, key = 8, 128, 7
    canvas, sizes = _inputs(B, S, seed=3)
    fx, fy = "x" in flip, "y" in flip
    mask = _jax_flip_mask(B, key, fx, fy)
    assert mask.any() and not mask.all()
    ref = _jax(canvas, sizes, True, key=key, flip_x=fx, flip_y=fy)
    got = _port(canvas, sizes, True, flips=mask)
    assert np.abs(got - ref).max() <= ATOL
    # the flips are the exact permutation of the unflipped output
    plain = _port(canvas, sizes, True)
    for b in range(B):
        want = plain[b]
        if mask[b, 0]:
            want = want[::-1]
        if mask[b, 1]:
            want = want[:, ::-1]
        assert np.array_equal(got[b], want), (b, mask[b])


def test_bf16_is_the_f32_result_rounded_once():
    from ifcb_classifier_tpu_torch.ops.preprocess import preprocess_rgb
    canvas, sizes = _inputs(3, 64, seed=11)
    c, s = torch.from_numpy(canvas), torch.from_numpy(sizes)
    f32 = preprocess_rgb(c, s, out_size=R, mean=MEAN, std=STD)
    bf = preprocess_rgb(c, s, out_size=R, mean=MEAN, std=STD,
                        dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, f32.to(torch.bfloat16))


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    from ifcb_classifier_tpu_torch.ops.preprocess import preprocess_rgb_cuda
    canvas, sizes = _inputs(3, 64, seed=1)
    with pytest.raises(ValueError):
        preprocess_rgb_cuda(torch.from_numpy(canvas),
                            torch.from_numpy(sizes), out_size=R)
    assert preprocess_rgb_cuda.launches == 0


def test_rgb_kernel_matches_plain_on_the_card():
    """Runs on a CUDA card only (chip_smoke.py holds K2 at every rung)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 has no CPU form")
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        preprocess_rgb_cuda, preprocess_rgb_plain)
    canvas, sizes = _inputs(6, 128, seed=5)
    flips = np.array([[0, 0], [1, 0], [0, 1], [1, 1], [1, 0], [0, 1]],
                     np.uint8)
    c = torch.from_numpy(canvas).cuda()
    s = torch.from_numpy(sizes).cuda()
    f = torch.from_numpy(flips).cuda()
    got = preprocess_rgb_cuda(c, s, out_size=R, mean=MEAN, std=STD, flips=f,
                              dtype=torch.float32)
    ref = preprocess_rgb_plain(c, s, out_size=R, mean=MEAN, std=STD, flips=f)
    assert float((got - ref).abs().max()) <= 1e-4
