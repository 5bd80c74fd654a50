"""The port's training semantics against the JAX package, on the same
numpy-seeded weights and inputs (CPU, f32 unless stated):

* TorchBN in train mode (f32 two-pass, bf16 one-pass clamped): output and
  running statistics after one update;
* InceptionAux on a 17x17x768 input in train mode;
* cross_entropy / loss_fn with a mask and class weights;
* Adam, AdamW and SGD after 3 steps against optax;
* --accum 2 (interleaved micro-batches, sequential BN, valid-row-weighted
  gradient) and --accum 1 on a small BN model;
* one full inception_v3 @299 train step at batch 2 with dropout 0.

Tolerances, each with its reason:
* BN output, f32: 1e-5 absolute (inputs reach ~20, whose f32 ulp is
  1.9e-6, and the mean is summed in another order); its stats 2e-6
  relative; bf16: the outputs may
  differ by one bf16 rounding of the same f32 value (2^-7 relative) and
  the stats, kept in f32, by 1e-5 relative.
* InceptionAux logits: 1e-4 (|logits| ~ 5; oneDNN and XLA sum the convs
  in other orders, as in test_torch_inception.py); its BN running stats
  1e-5 relative plus 2e-6 absolute (means of O(0.1) summed over 50-578
  values in another order).
* Losses: 1e-6 (a few f32 ulps).
* Optimizers: 2e-6 on O(1) parameters (tests/test_train_dynamics_parity's
  Adam rule: f32 roundoff of the same update math).
* accum: loss 1e-5, parameters after the step 2e-6 (SGD, so a gradient
  error shows undistorted), BN stats 1e-5 relative.
* Full step (He-normal weights, heads included, as an untrained net has
  them; the 10x heads of the serving tests multiply f32 noise in the loss
  by their logit scale): the JAX and port f32 losses within 5e-4 relative
  of the port's float64 loss (the pin of
  tests/test_train_dynamics_parity.py);
  the JAX gradient of each tensor within the f32 noise-floor rule of
  tests/test_train_dynamics_parity.py:139 (distance to the float64
  gradient at most 3x the port's own f32 distance + 3e-5 of its norm).
  The tensors of the last block, Mixed_7c, get 5e-3 of their norm in
  place of 3e-5, for a measured cause: there, at batch 2, both f32
  forwards are already ~1.1-2.2e-4 (relative) off their float64 values
  and each side flips 0-5 ReLU signs per branch, at other positions
  than the other side; a flipped ReLU moves a gradient by a discrete
  step, not by roundoff, so the JAX distance need not stay within 3x the
  port's (Mixed_7c.branch_pool.conv.weight: 2.5e-3 against the port's
  1.1e-4). A float64 run of the JAX model (dtype float64, float32
  casts made float64, in a copy) agrees with the port's float64 forward
  within 4e-12 at every Mixed_7c BN output and with its gradients within
  7e-8 (the port rounds the logits to f32) on all 292 tensors, so the
  step's semantics are the same. A fault in the loss (the aux weight,
  the mask) moves the loss itself past its 5e-4 pin; the BN forms are
  held by the BN test above and the running statistics below;
  after the Adam step BN stats within 5e-4 relative (the aux tower's 1x1
  BNs at batch 2 carry ~3e-4 of f32 noise) and parameters within 2.05 lr,
  with sign flips only where the float64 gradient is below 10x the noise.
"""

import copy

import numpy as np
import pytest
import torch

LR = 1e-3


def _jax_bn(x, scale, bias, mean, var, dtype):
    import jax.numpy as jnp
    from ifcb_classifier_tpu.models.layers import TorchBN
    bn = TorchBN(momentum=0.1, epsilon=1e-3, dtype=dtype)
    y, mut = bn.apply({"params": {"scale": scale, "bias": bias},
                       "batch_stats": {"mean": mean, "var": var}},
                      jnp.asarray(x).astype(dtype),
                      use_running_average=False, mutable=["batch_stats"])
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(mut["batch_stats"]["mean"]),
            np.asarray(mut["batch_stats"]["var"]))


@pytest.mark.parametrize("low", [False, True], ids=["f32", "bf16"])
def test_torch_bn_train_mode_matches_jax(low):
    import jax.numpy as jnp
    from ifcb_classifier_tpu_torch.models.layers import TorchBN
    rng = np.random.default_rng(0)
    C = 7
    # a channel mean far above its spread: the one-pass form's cancellation
    x = (rng.normal(0, 1, (4, 6, 5, C)) + np.arange(C) * 3.0) \
        .astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.2, C).astype(np.float32)
    mean = rng.normal(0, 0.5, C).astype(np.float32)
    var = rng.uniform(0.3, 3.0, C).astype(np.float32)
    dtype = jnp.bfloat16 if low else jnp.float32
    y_ref, m_ref, v_ref = _jax_bn(x, scale, bias, mean, var, dtype)

    bn = TorchBN(C, eps=1e-3)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    if low:
        xt = xt.to(torch.bfloat16)
    y = bn.train()(xt)
    assert y.dtype == xt.dtype
    y = y.detach().float().numpy().transpose(0, 2, 3, 1)
    if low:
        assert np.all(np.abs(y - y_ref) <= 2.0 ** -7 * np.abs(y_ref) + 1e-6)
        rtol = 1e-5
    else:
        assert np.abs(y - y_ref).max() <= 1e-5
        rtol = 2e-6
    np.testing.assert_allclose(bn.running_mean.numpy(), m_ref, rtol=rtol,
                               atol=2e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), v_ref, rtol=rtol,
                               atol=2e-6)


def _fill_tree(shapes, rng):
    import jax

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.normal(0.0, np.sqrt(2.0 / fan_in), s.shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name in ("bias", "mean"):
            v = rng.normal(0.0, 0.2, s.shape)
        elif name == "var":
            v = rng.uniform(0.3, 3.0, s.shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_inception_aux_matches_jax():
    import jax
    import jax.numpy as jnp
    from ifcb_classifier_tpu.models.inception import InceptionAux as JAux
    from ifcb_classifier_tpu_torch.models.inception import InceptionAux
    from ifcb_classifier_tpu_torch.models.torch_port import params_from_jax
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 2, (2, 17, 17, 768)).astype(np.float32)
    jm = JAux(num_classes=5)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x), True))
    params = _fill_tree(shapes["params"], rng)
    stats = _fill_tree(shapes["batch_stats"], rng)
    ref, mut = jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), True, mutable=["batch_stats"])
    aux = InceptionAux(768, 5)
    aux.load_state_dict(params_from_jax(params, stats), strict=True)
    out = aux.train()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert np.abs(out.detach().numpy() - np.asarray(ref)).max() <= 1e-4
    for name in ("conv0", "conv1"):
        for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
            want = np.asarray(mut["batch_stats"][name]["bn"][leaf])
            got = getattr(getattr(aux, name).bn, key).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tup", [False, True], ids=["logits", "aux"])
def test_loss_fn_matches_jax(weighted, tup):
    import jax.numpy as jnp
    from ifcb_classifier_tpu.train.state import loss_fn as jloss
    from ifcb_classifier_tpu_torch.train.state import loss_fn
    rng = np.random.default_rng(3)
    main = rng.normal(0, 3, (6, 4)).astype(np.float32)
    aux = rng.normal(0, 3, (6, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 6).astype(np.int32)
    mask = np.array([1, 1, 0, 1, 1, 0], bool)
    cw = rng.uniform(0.2, 3.0, 4).astype(np.float32) if weighted else None
    jout = (jnp.asarray(main), jnp.asarray(aux)) if tup \
        else jnp.asarray(main)
    tout = (torch.from_numpy(main), torch.from_numpy(aux)) if tup \
        else torch.from_numpy(main)
    want = float(jloss(jout, jnp.asarray(labels), jnp.asarray(mask), cw))
    got = float(loss_fn(tout, torch.from_numpy(labels),
                        torch.from_numpy(mask),
                        None if cw is None else torch.from_numpy(cw)))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("name,wd", [("Adam", 0.0), ("Adam", 0.01),
                                     ("AdamW", 0.01), ("SGD", 0.0),
                                     ("SGD", 0.01)])
def test_optimizers_match_optax(name, wd):
    import jax
    import jax.numpy as jnp
    import optax
    from ifcb_classifier_tpu.train.state import make_optimizer as jopt
    from ifcb_classifier_tpu_torch.train.state import make_optimizer
    rng = np.random.default_rng(4)
    p0 = {"a": rng.normal(0, 1, (8, 5)).astype(np.float32),
          "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1 + k_, v.shape).astype(np.float32)
              for k, v in p0.items()} for k_ in range(3)]
    tx = jopt(name, 0.01, wd)
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    s = tx.init(pj)
    for g in grads:
        upd, s = tx.update(jax.tree_util.tree_map(jnp.asarray, g), s, pj)
        pj = optax.apply_updates(pj, upd)
    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = make_optimizer(list(pt.values()), name, 0.01, wd)
    for g in grads:
        for k, p in pt.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in p0:
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]),
                                   atol=2e-6, rtol=0)


# --- --accum on a small BN model -------------------------------------------

def _small_models(rng):
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from ifcb_classifier_tpu.models.layers import TorchBN as JBN
    from ifcb_classifier_tpu_torch.models.layers import TorchBN

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            x = fnn.Conv(4, (3, 3), padding="VALID", use_bias=False,
                         name="conv")(x)
            x = JBN(momentum=0.1, epsilon=1e-3, name="bn")(
                x, use_running_average=not train)
            x = jnp.mean(fnn.relu(x), axis=(1, 2))
            return fnn.Dense(3, name="fc")(x)

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 4, 3, bias=False)
            self.bn = TorchBN(4, eps=1e-3)
            self.fc = torch.nn.Linear(4, 3)

        def forward(self, x):
            x = torch.relu(self.bn(self.conv(x))).mean(dim=(2, 3))
            return self.fc(x)

    jm = JNet()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), True))
    params = _fill_tree(shapes["params"], rng)
    stats = _fill_tree(shapes["batch_stats"], rng)
    return jm, TNet(), params, stats


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_accum_matches_jax(accum, weighted):
    import jax
    import jax.numpy as jnp
    import optax  # noqa: F401 (the JAX step's optimizer)
    from ifcb_classifier_tpu.train.state import TrainState
    from ifcb_classifier_tpu.train.state import make_optimizer as jopt
    from ifcb_classifier_tpu.train.state import make_train_step as jstep
    from ifcb_classifier_tpu_torch.models.torch_port import (
        params_from_jax, params_to_jax)
    from ifcb_classifier_tpu_torch.train.state import (make_optimizer,
                                                       make_train_step)
    rng = np.random.default_rng(5)
    jm, tm, params, stats = _small_models(rng)
    x = rng.uniform(0, 1, (6, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 6).astype(np.int32)
    mask = np.array([1, 1, 1, 1, 0, 1], bool)  # a pad row in micro 0
    cw = np.array([0.5, 2.0, 1.0], np.float32) if weighted else None

    tx = jopt("SGD", 0.1)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state1, jloss = jax.jit(jstep(jm, tx, class_weights=cw, accum=accum))(
        state, dict(images=jnp.asarray(x), labels=jnp.asarray(labels),
                    mask=jnp.asarray(mask)), jax.random.PRNGKey(0))

    tm.load_state_dict(params_from_jax(params, stats), strict=True)
    step = make_train_step(tm, make_optimizer(tm.parameters(), "SGD", 0.1),
                           class_weights=cw, accum=accum)
    loss = step(torch.from_numpy(x), torch.from_numpy(labels),
                torch.from_numpy(mask))
    assert abs(float(loss) - float(jloss)) <= 1e-5
    p1, s1 = params_to_jax(tm.state_dict())
    flat = lambda t: {"/".join(str(k.key) for k in path): np.asarray(v)
                      for path, v in jax.tree_util.tree_leaves_with_path(t)}
    for k, v in flat(state1.params).items():
        np.testing.assert_allclose(flat(p1)[k], v, atol=2e-6, rtol=0,
                                   err_msg=k)
    for k, v in flat(state1.batch_stats).items():
        np.testing.assert_allclose(flat(s1)[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# --- one full inception_v3 @299 train step -----------------------------------

N_CLASSES = 5


@pytest.fixture(scope="module")
def inception_step():
    """The JAX step once per module: (params, stats, inputs, loss, state
    after one Adam step, gradients recovered from Adam's first moment)."""
    import jax
    import jax.numpy as jnp
    from ifcb_classifier_tpu.models.inception import InceptionV3
    from ifcb_classifier_tpu.train.state import (TrainState,
                                                 create_train_state,
                                                 make_optimizer,
                                                 make_train_step)
    model = InceptionV3(num_classes=N_CLASSES, aux_logits=True,
                        transform_input=False, dropout_rate=0.0)
    shapes = jax.eval_shape(lambda: create_train_state(
        model, jax.random.PRNGKey(0), 299)[0])
    fill_rng = np.random.default_rng(7)
    params = _fill_tree(shapes.params, fill_rng)
    stats = _fill_tree(shapes.batch_stats, fill_rng)
    rng = np.random.RandomState(3)
    x = rng.rand(2, 299, 299, 3).astype(np.float32)
    y = rng.randint(0, N_CLASSES, 2).astype(np.int32)
    tx = make_optimizer("Adam", LR)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state1, loss = jax.jit(make_train_step(model, tx))(
        state, dict(images=jnp.asarray(x), labels=jnp.asarray(y),
                    mask=jnp.ones(2, bool)), jax.random.PRNGKey(9))
    # optax.adam's first step leaves mu = (1 - b1) * g
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                   jax.device_get(state1.opt_state[0].mu))
    return dict(params=params, stats=stats, x=x, y=y, loss=float(loss),
                state1=jax.device_get(state1), grads=grads)


def _port_model(params, stats, dtype=torch.float32):
    from ifcb_classifier_tpu_torch.models.inception import InceptionV3
    from ifcb_classifier_tpu_torch.models.torch_port import params_from_jax
    m = InceptionV3(N_CLASSES, aux_logits=True, dropout_rate=0.0)
    m.load_state_dict(params_from_jax(params, stats), strict=True)
    return m.to(dtype)


def _grads64(inc):
    from ifcb_classifier_tpu_torch.train.state import loss_fn
    m = _port_model(inc["params"], inc["stats"], torch.float64).train()
    x = torch.from_numpy(inc["x"].transpose(0, 3, 1, 2).copy()).double()
    loss = loss_fn(m(x), torch.from_numpy(inc["y"]), torch.ones(2, dtype=bool))
    loss.backward()
    return float(loss), {n: p.grad.numpy() for n, p in m.named_parameters()}


def test_full_inception_train_step_matches_jax(inception_step):
    from ifcb_classifier_tpu_torch.models.torch_port import (
        params_from_jax, params_to_jax)
    from ifcb_classifier_tpu_torch.train.state import (make_optimizer,
                                                       make_train_step)
    inc = inception_step
    loss64, g64 = _grads64(inc)
    m = _port_model(inc["params"], inc["stats"])
    step = make_train_step(m, make_optimizer(m.parameters(), "Adam", LR))
    loss32 = float(step(torch.from_numpy(inc["x"]),
                        torch.from_numpy(inc["y"]),
                        torch.ones(2, dtype=torch.bool)))
    g32 = {n: p.grad.numpy() for n, p in m.named_parameters()}
    gj = params_from_jax(inc["grads"], {})

    assert abs(inc["loss"] - loss64) <= 5e-4 * max(1.0, abs(loss64))
    assert abs(loss32 - loss64) <= 5e-4 * max(1.0, abs(loss64))
    assert set(gj) == set(g64)
    bad = []
    for n, truth in g64.items():
        tn = max(np.linalg.norm(truth), 1e-30)
        floor = np.linalg.norm(g32[n] - truth) / tn
        dist = np.linalg.norm(gj[n].numpy() - truth) / tn
        # Mixed_7c: ReLU sign flips of either f32 forward (docstring)
        if dist > 3 * floor + (5e-3 if n.startswith("Mixed_7c.") else 3e-5):
            bad.append((n, dist, floor))
    assert not bad, f"JAX grads off the port's f64 truth: {bad[:5]}"

    p1, s1 = params_to_jax(m.state_dict())
    after = params_from_jax(p1, s1)
    want = params_from_jax(inc["state1"].params, inc["state1"].batch_stats)
    strong_flips, total = 0, 0
    for n, w in want.items():
        got, w = after[n].numpy(), w.numpy()
        if "running" in n:
            rel = np.linalg.norm(got - w) / max(np.linalg.norm(w), 1e-30)
            assert rel < 5e-4, (n, rel)
        else:
            d = np.abs(got - w)
            assert d.max() <= 2.05 * LR, (n, float(d.max()))
            noise = max(np.abs(g32[n] - g64[n]).max(), 1e-30)
            strong_flips += int(((d > LR) & (np.abs(g64[n]) > 10 * noise))
                                .sum())
            total += d.size
    assert strong_flips / total < 1e-5, (strong_flips, total)


def test_full_step_in_bf16_runs_and_keeps_f32_master_weights(inception_step):
    """The bf16 policy on the CPU: a finite loss, parameters and Adam
    moments f32."""
    from ifcb_classifier_tpu_torch.train.state import (make_optimizer,
                                                       make_train_step)
    inc = inception_step
    m = _port_model(inc["params"], inc["stats"])
    opt = make_optimizer(m.parameters(), "Adam", LR)
    step = make_train_step(m, opt, dtype=torch.bfloat16)
    x = torch.from_numpy(inc["x"]).to(torch.bfloat16)
    loss = float(step(x, torch.from_numpy(inc["y"]),
                      torch.ones(2, dtype=torch.bool)))
    assert np.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert all(v.dtype == torch.float32 for st in opt.state.values()
               for k, v in st.items() if k != "step")
    copy.deepcopy(m)  # the model stays an ordinary module


@pytest.mark.parametrize("geometry", [(3, 1, 1), (5, 3, 0)])
@pytest.mark.parametrize("channels_last", [False, True])
def test_avg_pool_backward_matches_the_native_one(geometry, channels_last):
    """layers.avg_pool's own backward (the channels_last CUDA kernel it
    avoids returned wrong gradients on the card) against PyTorch's native
    backward on the CPU, in float64: 1e-12 (sums of 9 or 25 values in
    another order)."""
    import torch.nn.functional as F
    from ifcb_classifier_tpu_torch.models.layers import avg_pool
    w, st, p = geometry
    x = torch.randn(2, 8, 17, 17, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ya = avg_pool(a, w, st, p)
    yb = F.avg_pool2d(b, w, st, p, count_include_pad=True)
    dy = torch.randn(ya.shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(1))
    ya.backward(dy)
    yb.backward(dy)
    assert torch.equal(ya, yb)
    assert float((a.grad - b.grad).abs().max()) <= 1e-12
    assert a.grad.is_contiguous(
        memory_format=torch.channels_last if channels_last
        else torch.contiguous_format)
