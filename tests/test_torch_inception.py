"""The port's inception_v3 (ifcb_classifier_tpu_torch/models) against the
JAX package's, on the same weights: a JAX create_train_state tree
(structure from eval_shape, values drawn from a seed with numpy, BN
statistics randomised so folding is not a no-op) carried across with
params_from_jax.

Sizes: 96 px, batch 2, f32 (tests/test_fold.py's size for this model).
Tolerance on logits (|logits| ≈ 5): 1e-4, tightened from the repo's
torch-vs-flax pin of 5e-4 to about 8x the measured 1.2e-5 (oneDNN and XLA
sum the convolutions in other orders). The folded tensors are compared
exactly: both packages fold in float64 and cast once.
"""

import numpy as np
import pytest
import torch

N_CLASSES = 5
SIZE = 96
ATOL_LOGITS = 1e-4


def random_inception_trees(n_classes, seed, pretrained=False):
    """(params, batch_stats) numpy trees of the JAX inception_v3, shaped
    by create_train_state (aux head included), filled from ``seed``."""
    import jax
    from ifcb_classifier_tpu.models import get_namebrand_model
    from ifcb_classifier_tpu.train.state import create_train_state

    model = get_namebrand_model("inception_v3", n_classes,
                                pretrained=pretrained)
    shapes = jax.eval_shape(
        lambda: create_train_state(model, jax.random.PRNGKey(0), 299)[0])
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            # He-normal; the heads 10x wider so the scores are decisive
            fan_in = int(np.prod(s.shape[:-1]))
            gain = 10.0 if path[-2].key == "fc" else 1.0
            v = rng.normal(0.0, gain * np.sqrt(2.0 / fan_in), s.shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "bias":
            v = rng.normal(0.0, 0.2, s.shape)
        elif name == "mean":
            v = rng.normal(0.0, 0.5, s.shape)
        elif name == "var":
            v = rng.uniform(0.3, 3.0, s.shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    tu = jax.tree_util
    return (tu.tree_map_with_path(fill, shapes.params),
            tu.tree_map_with_path(fill, shapes.batch_stats))


@pytest.fixture(scope="module")
def trees():
    return random_inception_trees(N_CLASSES, seed=0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).uniform(
        0.0, 1.0, (2, SIZE, SIZE, 3)).astype(np.float32)


def _jax_logits(params, stats, x, fold=False, pretrained=False):
    import jax
    import jax.numpy as jnp
    from ifcb_classifier_tpu.models import get_namebrand_model
    model = get_namebrand_model("inception_v3", N_CLASSES,
                                pretrained=pretrained, fold_bn=fold)
    apply = jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, train=False))
    return np.asarray(apply(params, stats, jnp.asarray(x)))


def _port_logits(sd, x, fold=False, pretrained=False):
    from ifcb_classifier_tpu_torch.models import get_namebrand_model
    model = get_namebrand_model("inception_v3", N_CLASSES,
                                pretrained=pretrained, fold_bn=fold)
    # the port builds no aux head (it runs only in training)
    model.load_state_dict({k: v for k, v in sd.items()
                           if not k.startswith("AuxLogits.")}, strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()


@pytest.mark.parametrize("pretrained", [False, True])
def test_unfolded_logits_match_jax(trees, images, pretrained):
    """pretrained=True covers transform_input."""
    from ifcb_classifier_tpu_torch.models.torch_port import params_from_jax
    params, stats = trees
    ref = _jax_logits(params, stats, images, pretrained=pretrained)
    got = _port_logits(params_from_jax(params, stats), images,
                       pretrained=pretrained)
    assert got.shape == (2, N_CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL_LOGITS)


def test_folded_tensors_equal_jax_fold(trees):
    from ifcb_classifier_tpu.models.fold import fold_params
    from ifcb_classifier_tpu_torch.models.fold import fold_state_dict
    from ifcb_classifier_tpu_torch.models.torch_port import params_from_jax
    params, stats = trees
    ref = params_from_jax(*fold_params("inception_v3", params, stats))
    got = fold_state_dict("inception_v3", params_from_jax(params, stats))
    assert sorted(got) == sorted(ref)
    assert not any(".bn." in k for k in got)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_folded_logits_match_jax(trees, images):
    from ifcb_classifier_tpu.models.fold import fold_params
    from ifcb_classifier_tpu_torch.models.fold import fold_state_dict
    from ifcb_classifier_tpu_torch.models.torch_port import params_from_jax
    params, stats = trees
    fparams, _ = fold_params("inception_v3", params, stats)
    ref = _jax_logits(fparams, {}, images, fold=True)
    got = _port_logits(
        fold_state_dict("inception_v3", params_from_jax(params, stats)),
        images, fold=True)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL_LOGITS)


def test_other_families_name_their_roadmap_item():
    from ifcb_classifier_tpu_torch.models import get_namebrand_model
    with pytest.raises(NotImplementedError, match="P7"):
        get_namebrand_model("resnet18", 3)
    with pytest.raises(KeyError):
        get_namebrand_model("no_such_net", 3)


def test_eval_only_for_now(trees):
    from ifcb_classifier_tpu_torch.models import get_namebrand_model
    model = get_namebrand_model("inception_v3", N_CLASSES)
    with pytest.raises(NotImplementedError, match="P5"):
        model.train()(torch.zeros(1, 3, SIZE, SIZE))
