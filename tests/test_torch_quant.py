"""The port's int8 tier (ifcb_classifier_tpu_torch/models/quant*.py and
ops/qconv.py) against the JAX package's (models/quant.py,
quant_resident.py, quant_graph.py), on the same folded inception_v3
(random_inception_trees, BNs folded by each package) and the same images.

Sizes: 96 px, batch 2, f32, as tests/test_torch_inception.py.
Tolerances, and why:
  * quantize_params: bitwise (the same float32 numpy arithmetic on the same
    folded weights, which both packages fold to the same float32 values).
  * calibration absmax: 1e-5 relative (oneDNN and XLA sum the float convs
    in other orders; measured 9.5e-7).
  * qconv_plain against lax.conv_general_dilated(int32) plus the JAX
    epilogue, every distinct conv geometry of inception_v3 @299: the s32
    products equal. XLA on the CPU contracts the epilogue's acc * scale +
    bias into one fused multiply-add (its f32 emit equals that form,
    rounded once, at every value), where the port rounds the product and
    the sum apart as K3 does; the f32 emits are each held exactly to their
    own form, and to within one ulp of the product acc * scale plus one
    of the result of each other. The s8 emits are equal:
    over these inputs (1.39 million values) the one-ulp differences never
    cross a rounding boundary of the s8 grid (measured: 0 differ).
  * the whole int8 forward fed the JAX package's absmax: probabilities
    within ATOL_INT8_VS_JAX = 5e-3 and argmax equal. The two graphs quantize
    the same tensors with the same scales, but their float parts (the entry
    quantize of the avg-pooled branches, the f32 convolutions' sums) round
    in other orders, so a value at a rounding boundary of the s8 grid can
    land one step apart and carry on through the net; measured 1.3e-3.
  * the port's int8 against its own fp32: 2e-2 and argmax equal (the JAX
    package's int8 gate against full precision, tests/test_quant.py:48).
"""

import numpy as np
import pytest
import torch

from test_torch_inception import random_inception_trees

N_CLASSES = 5
SIZE = 96
ATOL_INT8_VS_JAX = 5e-3
TOL_INT8_VS_FP32 = 2e-2
RTOL_ABSMAX = 1e-5

# every distinct (Ci, Co, kh, kw, stride, pad_h, pad_w) of inception_v3's 94
# convs, each at a small input size
GEOMETRIES = [
    (3, 32, 3, 3, 2, 0, 0), (32, 32, 3, 3, 1, 0, 0), (32, 64, 3, 3, 1, 1, 1),
    (48, 64, 5, 5, 1, 2, 2), (64, 80, 1, 1, 1, 0, 0), (64, 96, 3, 3, 1, 1, 1),
    (80, 192, 3, 3, 1, 0, 0), (96, 96, 3, 3, 1, 1, 1), (96, 96, 3, 3, 2, 0, 0),
    (128, 128, 1, 7, 1, 0, 3), (128, 128, 7, 1, 1, 3, 0),
    (128, 192, 1, 7, 1, 0, 3), (128, 192, 7, 1, 1, 3, 0),
    (160, 160, 1, 7, 1, 0, 3), (160, 160, 7, 1, 1, 3, 0),
    (160, 192, 1, 7, 1, 0, 3), (160, 192, 7, 1, 1, 3, 0),
    (192, 32, 1, 1, 1, 0, 0), (192, 48, 1, 1, 1, 0, 0),
    (192, 64, 1, 1, 1, 0, 0), (192, 192, 1, 7, 1, 0, 3),
    (192, 192, 3, 3, 2, 0, 0), (192, 192, 7, 1, 1, 3, 0),
    (192, 320, 3, 3, 2, 0, 0), (256, 48, 1, 1, 1, 0, 0),
    (256, 64, 1, 1, 1, 0, 0), (288, 48, 1, 1, 1, 0, 0),
    (288, 64, 1, 1, 1, 0, 0), (288, 384, 3, 3, 2, 0, 0),
    (384, 384, 1, 3, 1, 0, 1), (384, 384, 3, 1, 1, 1, 0),
    (448, 384, 3, 3, 1, 1, 1), (768, 128, 1, 1, 1, 0, 0),
    (768, 160, 1, 1, 1, 0, 0), (768, 192, 1, 1, 1, 0, 0),
    (1280, 192, 1, 1, 1, 0, 0), (1280, 320, 1, 1, 1, 0, 0),
    (1280, 384, 1, 1, 1, 0, 0), (1280, 448, 1, 1, 1, 0, 0),
    (2048, 192, 1, 1, 1, 0, 0), (2048, 320, 1, 1, 1, 0, 0),
    (2048, 384, 1, 1, 1, 0, 0), (2048, 448, 1, 1, 1, 0, 0),
]



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six test
    processes on eight cores, and the CPU int8 path's float64
    convolutions slow down many times over when every process spreads
    them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def trees():
    return random_inception_trees(N_CLASSES, seed=0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).uniform(
        0.0, 1.0, (2, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_side(trees, images):
    """The JAX package's calibration, quantized leaves and int8 probs."""
    import jax
    import jax.numpy as jnp
    from ifcb_classifier_tpu.models import get_namebrand_model
    from ifcb_classifier_tpu.models import quant as Q
    from ifcb_classifier_tpu.models.fold import fold_params
    params, stats = trees
    fparams, fstats = fold_params("inception_v3", params, stats)
    model = get_namebrand_model("inception_v3", N_CLASSES, fold_bn=True)
    x = jnp.asarray(images)
    calib_fn, geoms = Q.make_calib_fn(model)
    absmax = {k: float(v) for k, v in
              jax.device_get(jax.jit(calib_fn)(fparams, fstats, x)).items()}
    pruned, qconv = Q.quantize_params(fparams, geoms)
    pruned["__quant__"] = qconv
    probs = jax.jit(Q.make_quant_predict(model, absmax, geoms))(
        pruned, fstats, x)
    return dict(absmax=absmax, geoms=geoms, qconv=qconv,
                probs=np.asarray(probs))


@pytest.fixture(scope="module")
def port_model(trees):
    from ifcb_classifier_tpu_torch.models import get_namebrand_model
    from ifcb_classifier_tpu_torch.models.fold import fold_state_dict
    from ifcb_classifier_tpu_torch.models.torch_port import params_from_jax
    sd = {k: v for k, v in params_from_jax(*trees).items()
          if not k.startswith("AuxLogits.")}
    model = get_namebrand_model("inception_v3", N_CLASSES, fold_bn=True)
    model.load_state_dict(fold_state_dict("inception_v3", sd))
    return model.eval()


@pytest.fixture(scope="module")
def port_side(port_model, images):
    """The port's calibration and quantized leaves."""
    from ifcb_classifier_tpu_torch.models import quant as Q
    calib_fn, geoms = Q.make_calib_fn(port_model)
    sd = port_model.state_dict()
    absmax = {k: float(v) for k, v in
              calib_fn(sd, torch.from_numpy(images)).items()}
    pruned, qconv = Q.quantize_params(sd, geoms)
    return dict(absmax=absmax, geoms=geoms, qconv=qconv, pruned=pruned)


def _port_probs(model, port_side, absmax, images):
    from ifcb_classifier_tpu_torch.models import quant as Q
    from ifcb_classifier_tpu_torch.models.torch_port import qconv_from_jax
    params = dict(port_side["pruned"])
    params[Q._QUANT_KEY] = qconv_from_jax(port_side["qconv"])
    predict = Q.make_quant_predict(model, absmax, port_side["geoms"])
    return predict(params, torch.from_numpy(images)).numpy()


def test_quantize_params_bitwise(jax_side, port_side):
    jq, pq = jax_side["qconv"], port_side["qconv"]
    assert len(pq) == 94 and set(pq) == set(jq)
    for key, q in jq.items():
        for field in ("w_int8", "w_scale", "bias"):
            want, got = np.asarray(q[field]), pq[key][field]
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (key, field)
            np.testing.assert_array_equal(got, want, err_msg=key + field)
    assert sorted(port_side["pruned"]) == ["fc.bias", "fc.weight"]


def test_calibration_matches(jax_side, port_side):
    ja, pa = jax_side["absmax"], port_side["absmax"]
    assert set(pa) == set(ja) and len(pa) == 2 * 94
    for k, v in ja.items():
        assert abs(pa[k] - v) <= RTOL_ABSMAX * v, k
    want = {k: dict(strides=tuple(g["strides"]),
                    padding=tuple(tuple(p) for p in g["padding"]))
            for k, g in jax_side["geoms"].items()}
    assert port_side["geoms"] == want


def test_qconv_from_jax_layout(jax_side):
    from ifcb_classifier_tpu_torch.models.torch_port import qconv_from_jax
    q = qconv_from_jax(jax_side["qconv"])
    for key, leaf in jax_side["qconv"].items():
        w = q[key]["w"]
        assert w.dtype == torch.int8 and w.is_contiguous()
        np.testing.assert_array_equal(
            w.numpy(), np.asarray(leaf["w_int8"]).transpose(3, 0, 1, 2))
        assert q[key]["w_scale"].dtype == q[key]["bias"].dtype \
            == torch.float32


@pytest.mark.parametrize("geom", GEOMETRIES,
                         ids=["x".join(map(str, g)) for g in GEOMETRIES])
def test_qconv_plain_matches_lax(geom):
    """qconv_plain against lax.conv_general_dilated(int32) and the JAX
    package's epilogue (quant_graph.py:107-113), both emits."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from ifcb_classifier_tpu.models.quant_resident import _q8
    from ifcb_classifier_tpu_torch.ops.qconv import (qconv_acc_plain,
                                                     qconv_plain)
    ci, co, kh, kw, st, ph, pw = geom
    H = 17 if ci == 3 else 9
    rng = np.random.default_rng(ci * 7 + co + kh * 3 + st)
    x = rng.integers(-127, 128, (2, H, H + 1, ci), dtype=np.int8)
    w_hwio = rng.integers(-127, 128, (kh, kw, ci, co), dtype=np.int8)
    w_scale = rng.uniform(0.5, 1.5, co).astype(np.float32) / 127.0 * 0.05
    bias = rng.normal(0, 0.5, co).astype(np.float32)
    s_x, s_out = 0.0173, 0.0291 * np.sqrt(kh * kw * ci / 9.0)
    pads = ((ph, ph), (pw, pw))

    def ref(xq, w):
        acc = lax.conv_general_dilated(
            xq, w, (st, st), pads, dimension_numbers=("NHWC", "HWIO",
                                                      "NHWC"),
            preferred_element_type=jnp.int32)
        y = jnp.maximum(acc.astype(jnp.float32) * (w_scale * s_x) + bias,
                        0.0)
        return acc, y, _q8(y, 1.0 / s_out)

    acc, y, q = (np.asarray(a) for a in jax.jit(ref)(x, w_hwio))
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 0, 1, 2)))
    scale = torch.from_numpy(w_scale) * float(np.float32(s_x))
    bt = torch.from_numpy(bias)
    got_acc = qconv_acc_plain(xt, wt, (st, st), pads)
    np.testing.assert_array_equal(got_acc.numpy().astype(np.int64),
                                  acc.astype(np.int64))
    got_y = qconv_plain(xt, wt, scale, bt, (st, st), pads, None,
                        out_dtype=torch.float32).numpy()
    acc32, m = acc.astype(np.float32), scale.numpy()
    fused = (acc32.astype(np.float64) * m.astype(np.float64)
             + bias.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(y, np.maximum(fused, 0))
    np.testing.assert_array_equal(got_y, np.maximum(acc32 * m + bias, 0))
    assert (np.abs(got_y - y) <= np.spacing(np.abs(acc32 * m))
            + np.spacing(y)).all()
    got_q = qconv_plain(xt, wt, scale, bt, (st, st), pads,
                        float(np.float32(1.0 / s_out)))
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), q)
    assert 0 < (q != 0).mean() < 1  # the grid is exercised, not saturated


def test_qconv_writes_its_channel_slot():
    """With ``out`` and ``c_off`` the conv fills exactly its channels of a
    concat buffer, with the values it returns on its own."""
    from ifcb_classifier_tpu_torch.ops.qconv import qconv
    g = torch.Generator().manual_seed(3)
    x = torch.randint(-127, 128, (2, 7, 7, 32), dtype=torch.int8,
                      generator=g)
    w = torch.randint(-127, 128, (48, 3, 3, 32), dtype=torch.int8,
                      generator=g)
    scale, bias = torch.rand(48, generator=g) * 1e-4, torch.randn(
        48, generator=g)
    alone = qconv(x, w, scale, bias, (1, 1), ((1, 1), (1, 1)), 3.0)
    buf = torch.full((2, 7, 7, 80), 99, dtype=torch.int8)
    out = qconv(x, w, scale, bias, (1, 1), ((1, 1), (1, 1)), 3.0, out=buf,
                c_off=16)
    assert out is buf
    assert torch.equal(buf[..., 16:64], alone)
    assert (buf[..., :16] == 99).all() and (buf[..., 64:] == 99).all()
    with pytest.raises(ValueError, match="out must be"):
        qconv(x, w, scale, bias, (1, 1), ((1, 1), (1, 1)), 3.0, out=buf,
              c_off=40)


def _k3_weights(geom, seed):
    ci, co, kh, kw = geom[:4]
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -127, 128, (co, kh, kw, ci), dtype=np.int8))


@pytest.mark.parametrize("geom", GEOMETRIES,
                         ids=["x".join(map(str, g)) for g in GEOMETRIES])
def test_k3_pack_holds_the_weights(geom):
    """K3's packed weights (ops/qconv.pack_k3_weights): the K-major
    [Co_pad, K_pad] matrix unpacks to w in (kh, kw, ci) order, and its
    padding is zero; K_pad is K rounded up to the plan's K3_K_ALIGN."""
    from ifcb_classifier_tpu_torch.ops.qconv import (K3_K_ALIGN, k3_plan,
                                                     pack_k3_weights)
    ci, co, kh, kw = geom[:4]
    w = _k3_weights(geom, seed=sum(geom))
    K = kh * kw * ci
    pack = pack_k3_weights(w)
    co_pad, k_pad = pack.w.shape
    plan = k3_plan(1, 1, 1, co, K, ci)
    assert (co_pad, k_pad, pack.bn) == (plan["co_pad"], plan["k_pad"],
                                        plan["bn"])
    assert (pack.stages, pack.smem) == (plan["stages"], plan["smem"])
    assert pack.w.dtype == torch.int8 and pack.map is None  # CPU: none
    assert k_pad % K3_K_ALIGN == 0 and K <= k_pad < K + K3_K_ALIGN
    assert co_pad % pack.bn == 0 and co <= co_pad < co + pack.bn
    assert torch.equal(pack.w[:co, :K].reshape(co, kh, kw, ci), w)
    assert not pack.w[co:].any() and not pack.w[:, K:].any()


@pytest.mark.parametrize("geom", GEOMETRIES,
                         ids=["x".join(map(str, g)) for g in GEOMETRIES])
def test_k3_launch_plan(geom):
    """K3's launch plan (ops/qconv.k3_plan) at every conv geometry: a tile
    width wgmma takes for s8 and K3 instantiates, tiles that cover every
    (m, co) exactly once, ragged edges included, and a ring that fits the
    227 KB of shared memory a block may use (half an SM's 228 KB, less the
    1 KB each block reserves, where two blocks share an SM)."""
    from ifcb_classifier_tpu_torch.ops import qconv as Q
    ci, co, kh, kw, st, ph, pw = geom
    for B, H in ((1, 8), (3, 17), (256, 35)):
        Ho, Wo = Q.conv_out_size(H, H, kh, kw, (st, st), ((ph, ph), (pw, pw)))
        M = B * Ho * Wo
        plan = Q.k3_plan(B, Ho, Wo, co, kh * kw * ci, ci)
        bn, rows = plan["bn"], plan["rows"]
        assert bn in Q.WGMMA_S8_N and bn in Q.K3_TILE_N
        assert plan["n_tiles_n"] * bn == plan["co_pad"]
        assert (plan["n_tiles_n"] - 1) * bn < co <= plan["co_pad"]
        assert (plan["tiles_m"] - 1) * rows < M <= plan["tiles_m"] * rows
        assert plan["tiles"] == plan["tiles_m"] * plan["n_tiles_n"]
        budget = Q.SMEM_PER_BLOCK if Q.k3_blocks_per_sm(bn) == 1 else \
            Q.SMEM_PER_SM // 2 - 1024
        assert Q.K3_MIN_STAGES <= plan["stages"] <= Q.K3_MAX_STAGES
        assert plan["smem"] == Q.k3_smem_bytes(bn, plan["stages"],
                                               plan["co_pad"])
        assert plan["smem"] <= budget <= Q.SMEM_PER_BLOCK
        assert plan["k_pad"] % 32 == 0 and plan["n_kst"] * Q.K3_BK >= \
            plan["k_pad"]
        if M * co <= 1 << 22:  # every (m, co) of the tiles, counted
            seen = np.zeros((plan["tiles_m"] * rows, plan["co_pad"]), int)
            for t in range(plan["tiles"]):
                m0 = (t // plan["n_tiles_n"]) * rows
                n0 = (t % plan["n_tiles_n"]) * bn
                seen[m0:m0 + rows, n0:n0 + bn] += 1
            assert (seen == 1).all()


def _im2col(x, kh, kw, stride, pads):
    """uint8 [M, K] rows of the (kh, kw, ci)-ordered patches of s8 NHWC x,
    zero outside the image."""
    import torch.nn.functional as F
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x.permute(0, 3, 1, 2).float(), (pl, pr, pt, pb))
    cols = F.unfold(xp, (kh, kw), stride=stride)  # [B, ci*kh*kw, L]
    B, ci = x.shape[0], x.shape[3]
    cols = cols.view(B, ci, kh * kw, -1).permute(0, 3, 2, 1)
    return cols.reshape(-1, kh * kw * ci).to(torch.int8).view(torch.uint8)


@pytest.mark.parametrize("geom,B,H", [
    ((48, 64, 5, 5, 1, 2, 2), 2, 9),      # Ci = 48: pieces of 3 per tap
    ((80, 192, 3, 3, 1, 0, 0), 3, 11),    # Ci = 80: 5 per tap, ragged M
    ((32, 64, 3, 3, 1, 1, 1), 1, 13),     # 4 taps a stage, the pads
    ((96, 96, 3, 3, 2, 0, 0), 2, 17),     # stride 2
    ((128, 128, 1, 7, 1, 0, 3), 2, 9),    # the (0, 3) pads
    ((160, 192, 7, 1, 1, 3, 0), 1, 12),   # the (3, 0) pads, K = 1120
], ids=["ci48", "ci80", "ci32pad", "stride2", "pad03", "pad30"])
def test_k3_gather_is_the_im2col(geom, B, H):
    """The plain mirror of K3's producer (ops/qconv.k3_a_stages_plain:
    each 16-byte piece's tap walked without a division, zero-filled off the
    image, past M and past K, written at its 128-byte-swizzled slot)
    unswizzles to the im2col rows of x, every 128-row block, every
    128-byte K stage."""
    from ifcb_classifier_tpu_torch.ops.qconv import k3_a_stages_plain
    ci, co, kh, kw, st, ph, pw = geom
    pads = ((ph, ph), (pw, pw))
    x = torch.from_numpy(np.random.default_rng(H).integers(
        -127, 128, (B, H, H, ci), dtype=np.int8))
    cols = _im2col(x, kh, kw, (st, st), pads)
    M, K = cols.shape
    k_pad = -(-K // 32) * 32
    r = torch.arange(128)[:, None]
    k = torch.arange(128)[None, :]
    slot = ((k // 16) ^ (r % 8)) * 16 + k % 16  # TMA's 128-byte swizzle
    assert bool((slot.sort(dim=1).values == k).all())  # a permutation
    for m0 in range(0, M, 128):
        stages = k3_a_stages_plain(x, kh, kw, (st, st), pads, m0, k_pad)
        n_st = stages.shape[0]
        assert n_st == -(-k_pad // 128)
        flat = torch.gather(stages, 2, slot.expand(n_st, 128, 128))
        got = flat.permute(1, 0, 2).reshape(128, n_st * 128)
        want = torch.zeros_like(got)
        want[:min(128, M - m0), :K] = cols[m0:m0 + 128]
        assert torch.equal(got, want), m0


def test_quant_graph_packs_k3_weights_on_the_card_only():
    """The int8 graph keeps K3's pack with each conv's weights (made once,
    on the card); on the CPU it makes none."""
    from ifcb_classifier_tpu_torch.models.quant_graph import _QuantCtx
    q = {"w": torch.zeros((8, 1, 1, 16), dtype=torch.int8)}
    assert _QuantCtx._pack(q, torch.zeros((1, 2, 2, 16),
                                          dtype=torch.int8)) is None
    assert "k3" not in q


def test_qconv_cuda_refuses_cpu_tensors():
    """The kernel's wrapper never computes on the CPU: a CPU tensor is
    refused (qconv sends it to the plain version instead)."""
    from ifcb_classifier_tpu_torch.ops.qconv import qconv_cuda
    x = torch.zeros((1, 5, 5, 16), dtype=torch.int8)
    w = torch.zeros((8, 1, 1, 16), dtype=torch.int8)
    before = qconv_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        qconv_cuda(x, w, torch.ones(8), torch.zeros(8), (1, 1),
                   ((0, 0), (0, 0)), 1.0)
    assert qconv_cuda.launches == before


def test_int8_forward_matches_jax(jax_side, port_side, port_model, images):
    """The JAX package's absmax fed to the port's int8 graph."""
    got = _port_probs(port_model, port_side, jax_side["absmax"], images)
    want = jax_side["probs"]
    assert got.shape == want.shape == (2, N_CLASSES)
    assert np.abs(got - want).max() <= ATOL_INT8_VS_JAX
    assert (got.argmax(1) == want.argmax(1)).all()


def test_int8_close_to_fp32(port_side, port_model, images):
    from ifcb_classifier_tpu_torch.train.state import make_predict_step
    got = _port_probs(port_model, port_side, port_side["absmax"], images)
    ref = make_predict_step(port_model)(torch.from_numpy(images)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() < TOL_INT8_VS_FP32
    assert (got.argmax(1) == ref.argmax(1)).all()


def test_supports_quant():
    from ifcb_classifier_tpu.models.quant import supports_quant as jax_sq
    from ifcb_classifier_tpu_torch.models import MODEL_FAMILIES
    from ifcb_classifier_tpu_torch.models.quant import supports_quant
    assert [supports_quant(m) for m in MODEL_FAMILIES] == \
        [jax_sq(m) for m in MODEL_FAMILIES]
    assert supports_quant("inception_v3")
    assert not supports_quant("efficientnet_b0")


def test_k3_matches_plain_on_the_card():
    """Runs where a GPU and nvcc exist (chip_smoke.py covers every conv
    geometry at the main path's shapes); skips on a machine without a
    GPU. K3's output is bitwise equal to the plain version's, with the
    weights packed per call and packed once, at B=1, at an M that is no
    multiple of the 128-row tile, and into a concat buffer at a channel
    offset that is no multiple of 16; Ci = 5 takes the byte-wise gather."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    from ifcb_classifier_tpu_torch.ops.qconv import (
        pack_k3_weights, qconv_cuda, qconv_plain)
    g = torch.Generator().manual_seed(5)
    for (ci, co, kh, kw, st, ph, pw), B in (((3, 32, 3, 3, 2, 0, 0), 3),
                                          ((80, 192, 3, 3, 1, 0, 0), 3),
                                          ((160, 192, 1, 7, 1, 0, 3), 3),
                                          ((64, 96, 3, 3, 1, 1, 1), 1),
                                          ((48, 64, 5, 5, 1, 2, 2), 1),
                                          ((5, 24, 3, 3, 1, 1, 1), 1)):
        x = torch.randint(-127, 128, (B, 17, 19, ci), dtype=torch.int8,
                          generator=g).cuda()
        w = torch.randint(-127, 128, (co, kh, kw, ci), dtype=torch.int8,
                          generator=g).cuda()
        scale = (torch.rand(co, generator=g) * 1e-4).cuda()
        bias = torch.randn(co, generator=g).cuda()
        pads = ((ph, ph), (pw, pw))
        pack = pack_k3_weights(w)
        for inv, dtype in ((0.5, torch.int8), (None, torch.bfloat16)):
            ref = qconv_plain(x, w, scale, bias, (st, st), pads, inv,
                              out_dtype=dtype)
            for pk in (None, pack):
                got = qconv_cuda(x, w, scale, bias, (st, st), pads, inv,
                                 out_dtype=dtype, pack=pk)
                torch.cuda.synchronize()
                assert torch.equal(got, ref), (ci, co, kh, kw, inv, pk)
        assert (B * ref.shape[1] * ref.shape[2]) % 128
        buf = torch.full((*ref.shape[:3], co + 40), 77, dtype=torch.int8,
                         device="cuda")
        qconv_cuda(x, w, scale, bias, (st, st), pads, 0.5, out=buf, c_off=8,
                   pack=pack)
        want = torch.full_like(buf, 77)
        want[..., 8:8 + co] = qconv_plain(x, w, scale, bias, (st, st), pads,
                                          0.5)
        torch.cuda.synchronize()
        assert torch.equal(buf, want), (ci, co, kh, kw)
