"""The plain twin of K1's tap tables (ifcb_classifier_tpu_torch/ops/
preprocess.py ``tap_tables_plain``, the compact (lo, n, weights) windows
that K1's prologue builds once per image and axis) against the dense
PIL-BILINEAR matrices: the port's ``resize_weights`` and the JAX package's
(ifcb_classifier_tpu/ops/preprocess.py:39).

Sizes are made from a seed with numpy and include 1, S and h != w.
Tolerance 2e-7: the twin and the dense matrices compute the same float32
weights but sum each row in another order, so a normalised weight may
differ by an ulp of a value below 1 (measured max 1.2e-7).
"""

import numpy as np
import pytest
import torch

ATOL = 2e-7
SHAPES = [(64, 75), (128, 96), (1024, 299)]


def _sizes(S, seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, S + 1, size=(6, 2)).astype(np.int32)
    sizes[0] = (1, 1)
    sizes[1] = (S, S)
    sizes[2] = (S, max(1, S // 3))
    sizes[3] = (1, S)
    return sizes


def _dense(lo, n, w, S):
    """[B,2,r,S] matrices from the compact tables."""
    B, _, r = lo.shape
    out = torch.zeros(B, 2, r, S, dtype=torch.float32)
    for k in range(w.shape[-1]):
        col = (lo + k).clamp(max=S - 1).long()
        val = torch.where(k < n, w[..., k], torch.zeros(()))
        out.scatter_add_(-1, col[..., None], val[..., None])
    return out


@pytest.mark.parametrize("S,r", SHAPES)
def test_tap_tables_expand_to_the_resize_matrices(S, r):
    import jax.numpy as jnp
    from ifcb_classifier_tpu.ops.preprocess import resize_weights as jax_rw
    from ifcb_classifier_tpu_torch.ops.preprocess import (
        resize_weights, tap_count, tap_tables_plain)
    sizes = _sizes(S, seed=S + r)
    lo, n, w = tap_tables_plain(torch.from_numpy(sizes), S, r)
    T = tap_count(S, r)
    assert lo.shape == n.shape == (len(sizes), 2, r)
    assert w.shape == (len(sizes), 2, r, T)
    assert lo.dtype == n.dtype == torch.int32 and w.dtype == torch.float32
    dense = _dense(lo, n, w, S)
    for axis in range(2):
        ref = resize_weights(torch.from_numpy(sizes[:, axis]), S, r)
        # T covers every window: no row has more positive weights
        assert int((ref > 0).sum(dim=-1).max()) <= T
        np.testing.assert_allclose(dense[:, axis].numpy(), ref.numpy(),
                                   rtol=0, atol=ATOL)
        for b, src in enumerate(sizes[:, axis]):
            jref = np.asarray(jax_rw(int(src), S, r, jnp.float32))
            np.testing.assert_allclose(dense[b, axis].numpy(), jref,
                                       rtol=0, atol=ATOL)
    # each window holds exactly its positive taps: nothing past n, no
    # zero weight inside it
    k = torch.arange(T)
    assert bool((w[k >= n[..., None]] == 0).all())
    assert bool((w[k < n[..., None]] > 0).all())
    assert bool((lo >= 0).all()) and bool((lo + n <= torch.from_numpy(
        sizes)[:, :, None]).all())


@pytest.mark.parametrize("S,r", [(64, 75), (1024, 299)])
def test_tap_tables_clamp_sizes_outside_the_canvas(S, r):
    """Sizes outside [0, S] are outside K1's contract; the twin, like the
    kernel, clamps them, so no window reaches past the canvas."""
    from ifcb_classifier_tpu_torch.ops.preprocess import tap_tables_plain
    wild = torch.tensor([[0, 2 * S], [-3, S], [2 * S, 0]], dtype=torch.int32)
    lo, n, w = tap_tables_plain(wild, S, r)
    ref = tap_tables_plain(wild.clamp(0, S), S, r)
    for got, want in zip((lo, n, w), ref):
        assert torch.equal(got, want)
    assert bool((lo + n <= S).all())
    assert bool((n[0, 0] == 0).all()) and bool((n[2, 1] == 0).all())


@pytest.mark.parametrize("S,r,T", [(64, 299, 2), (256, 299, 2),
                                   (512, 299, 4), (1024, 299, 8),
                                   (1024, 224, 10), (128, 96, 4)])
def test_tap_count(S, r, T):
    from ifcb_classifier_tpu_torch.ops.preprocess import tap_count
    assert tap_count(S, r) == T
