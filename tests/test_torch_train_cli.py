"""The port's TRAIN verb on the CPU (python -m ifcb_classifier_tpu_torch
TRAIN, here through cli.main_cli with device="cpu"): a 2-epoch drive on a
folder-per-class PNG dataset writes the JAX package's outputs; a resumed
run (1 epoch, then --resume to 2) ends with the same epochs.csv and the
same parameters as the uninterrupted one, bit for bit (same process, same
CPU kernels, generator states carried in last.state); the checkpoints
cross-load both ways with the JAX package (eval logits within 1e-4, the
inception tolerance of test_torch_inception.py); the port's RUN engine
serves the trained model; --weights (a torchvision .pth from PORT_WEIGHTS)
seeds the trunk and --plot draws the best epoch; flags of later slices
raise.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from fixtures import write_image_folder_dataset

N_IMG = {"alpha": 5, "beta": 5, "gamma": 4}
ATOL_LOGITS = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six test
    processes on eight cores, and the CPU training steps slow down many
    times over when every process spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _train(src, outdir, *extra, emax=2):
    from ifcb_classifier_tpu_torch.cli import main_cli
    main_cli(["--batch", "4", "--loaders", "2", "TRAIN", src, "inception_v3",
              "t1", "--emax", str(emax), "--estop", "0", "--outdir", outdir,
              "--seed", "3", "--flip", "xy+V", "--img-norm", "0.5", "0.25",
              *extra], device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    src = write_image_folder_dataset(str(root / "ds"), N_IMG, size=(40, 30))
    full, part = str(root / "full"), str(root / "part")
    _train(src, full)
    _train(src, part, emax=1)
    _train(src, part, "--resume")
    return dict(src=src, full=full, part=part, root=root)


def test_train_writes_the_jax_outputs(runs):
    out = runs["full"]
    for name in ("training_images.list", "validation_images.list",
                 "logs_epochs.csv", "epochs.csv", "args.yml", "t1.ptl",
                 "results.mat", os.path.join("chkpts", "last.state")):
        assert os.path.isfile(os.path.join(out, name)), name
    assert any(f.startswith("epoch=") and f.endswith(".ckpt")
               for f in os.listdir(os.path.join(out, "chkpts")))
    rows = open(os.path.join(out, "epochs.csv")).read().splitlines()
    assert rows[0].split(",")[:4] == ["epoch", "best", "train_loss",
                                      "val_loss"] and len(rows) == 3
    train = open(os.path.join(out, "training_images.list")).read().split()
    val = open(os.path.join(out, "validation_images.list")).read().split()
    assert len(train) + len(val) == sum(N_IMG.values())
    assert not set(train) & set(val)


def test_resume_matches_the_uninterrupted_run(runs):
    from ifcb_classifier_tpu_torch.train.checkpoint import (
        restore_trainstate_payload)
    full, part = runs["full"], runs["part"]
    assert open(os.path.join(full, "epochs.csv")).read() == \
        open(os.path.join(part, "epochs.csv")).read()
    a = restore_trainstate_payload(os.path.join(full, "chkpts", "last.state"))
    b = restore_trainstate_payload(os.path.join(part, "chkpts", "last.state"))

    def leaves(t, p=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, p + (k,))
            else:
                yield p + (k,), v
    for tree in ("params", "batch_stats", "moments"):
        la, lb = dict(leaves(a[tree])), dict(leaves(b[tree]))
        assert la.keys() == lb.keys()
        for k in la:
            assert np.array_equal(la[k], lb[k]), (tree, k)


def test_resume_of_a_finished_run_trains_nothing(runs, tmp_path):
    out = str(tmp_path / "again")
    shutil.copytree(runs["full"], out)
    state = os.path.join(out, "chkpts", "last.state")
    before = open(state, "rb").read()
    _train(runs["src"], out, "--resume")
    assert open(state, "rb").read() == before
    assert open(os.path.join(out, "epochs.csv")).read() == \
        open(os.path.join(runs["full"], "epochs.csv")).read()


def test_resume_refuses_another_seed(runs, tmp_path):
    out = str(tmp_path / "seed")
    shutil.copytree(runs["full"], out)
    from ifcb_classifier_tpu_torch.cli import main_cli
    with pytest.raises(ValueError, match="seed"):
        main_cli(["--batch", "4", "TRAIN", runs["src"], "inception_v3", "t1",
                  "--emax", "2", "--outdir", out, "--seed", "4",
                  "--resume"], device="cpu")


def _jax_logits(params, stats, x, n):
    import jax
    import jax.numpy as jnp
    from ifcb_classifier_tpu.models import get_namebrand_model
    model = get_namebrand_model("inception_v3", n, pretrained=True)
    return np.asarray(jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, train=False))(
            params, stats, jnp.asarray(x)))


def _port_logits(sd, x, n):
    from ifcb_classifier_tpu_torch.models import get_namebrand_model
    m = get_namebrand_model("inception_v3", n, pretrained=True, train=True)
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        return m.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
                        ).numpy()


def test_port_checkpoint_loads_in_jax(runs):
    from ifcb_classifier_tpu.train.checkpoint import load_checkpoint as J
    from ifcb_classifier_tpu_torch.models.torch_port import params_from_jax
    from ifcb_classifier_tpu_torch.train.checkpoint import load_checkpoint
    ptl = os.path.join(runs["full"], "t1.ptl")
    params, stats, hp = J(ptl)
    assert hp["MODEL"] == "inception_v3" and hp["resize"] == 299
    assert hp["classes"] == sorted(N_IMG) and "AuxLogits" in params
    x = np.random.default_rng(0).uniform(-1, 1, (2, 96, 96, 3)) \
        .astype(np.float32)
    pp, ps, _ = load_checkpoint(ptl)
    got = _port_logits(params_from_jax(pp, ps), x, len(N_IMG))
    want = _jax_logits(params, stats, x, len(N_IMG))
    assert np.abs(got - want).max() <= ATOL_LOGITS


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    from ifcb_classifier_tpu.train.checkpoint import save_checkpoint as J
    from ifcb_classifier_tpu_torch.models.torch_port import params_from_jax
    from ifcb_classifier_tpu_torch.train.checkpoint import load_checkpoint
    from test_torch_inception import random_inception_trees
    params, stats = random_inception_trees(3, seed=4, pretrained=True)
    path = str(tmp_path / "jax.ckpt")
    J(path, params, stats, dict(MODEL="inception_v3", classes=["a", "b", "c"],
                                resize=299, pretrained=True))
    pp, ps, hp = load_checkpoint(path)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 96, 96, 3)) \
        .astype(np.float32)
    got = _port_logits(params_from_jax(pp, ps), x, 3)
    want = _jax_logits(params, stats, x, 3)
    assert np.abs(got - want).max() <= ATOL_LOGITS


def test_run_serves_the_trained_model(runs):
    """TRAIN → RUN on the CPU: the engine reads the .ptl (dropping the aux
    head) and scores gray ROIs."""
    from ifcb_classifier_tpu_torch.infer.runner import InferenceEngine
    eng = InferenceEngine(os.path.join(runs["full"], "t1.ptl"), batch_size=4,
                          device="cpu")
    rois = [np.random.default_rng(k).integers(0, 256, (30 + k, 50),
                                              dtype=np.uint8)
            for k in range(3)]
    probs = eng.predict_images(rois)
    assert probs.shape == (3, len(N_IMG)) and np.isfinite(probs).all()
    assert np.abs(probs.sum(axis=1) - 1).max() < 1e-5


@pytest.fixture(scope="module")
def seeded(runs):
    """One epoch at learning rate 0 from the trunk of the 2-epoch run's
    model (PORT_WEIGHTS of its .ptl into a torchvision .pth), with a plot
    on the best epoch: {outdir, the .pth, stdout}."""
    import io
    from contextlib import redirect_stdout

    from ifcb_classifier_tpu_torch.util_cli import main_cli as util_cli
    root = runs["root"]
    pth = str(root / "trunk.pth")
    util_cli(["PORT_WEIGHTS", os.path.join(runs["full"], "t1.ptl"), "-o",
              pth])
    out = str(root / "seeded")
    buf = io.StringIO()
    with redirect_stdout(buf):
        _train(runs["src"], out, "--weights", pth, "--learning-rate", "0",
               "--plot", "plots/p{epoch}.png", "curves", "confusion",
               emax=1)
    return dict(out=out, pth=pth, stdout=buf.getvalue())


@pytest.mark.parametrize("flag", ["--plot", "--weights"])
def test_flags_of_this_slice_are_served(seeded, flag):
    """--plot writes the figure of the best epoch; --weights seeds the
    trunk (with Adam at learning rate 0 the trained parameters stay the
    file's), the heads stay fresh (not the file's)."""
    from ifcb_classifier_tpu_torch.models.torch_port import (
        load_state_dict_file, params_from_jax)
    from ifcb_classifier_tpu_torch.train.checkpoint import load_checkpoint
    out = seeded["out"]
    if flag == "--plot":
        assert os.path.getsize(os.path.join(out, "plots", "p0.png")) > 0
        return
    assert "Loaded ported weights from " + seeded["pth"] in seeded["stdout"]
    sd = params_from_jax(*load_checkpoint(os.path.join(out, "t1.ptl"))[:2])
    src = load_state_dict_file(seeded["pth"])
    for k, v in sd.items():
        if k.startswith(("fc.", "AuxLogits.fc.")):
            assert not np.array_equal(v.numpy(), src[k]), k
        elif not k.endswith(("running_mean", "running_var")):
            assert np.array_equal(v.numpy(), src[k]), k


@pytest.mark.parametrize("argv", [
    ["--remat"], ["--mesh", "2"], ["--precision", "int8"],
    ["TRAIN:--onnx"], ["TRAIN:--export"],
    ["TRAIN:--profile", "2"], ["MODEL:resnet18"]])
def test_flags_of_later_slices_raise(argv, tmp_path):
    """Each raises before anything is written: NotImplementedError naming
    its ROADMAP item, or, for --precision int8 (an inference-engine mode),
    the JAX package's ValueError."""
    from ifcb_classifier_tpu_torch.cli import main_cli
    model, pre, post = "inception_v3", [], []
    for a in argv:
        if a.startswith("MODEL:"):
            model = a[len("MODEL:"):]
        elif a.startswith("TRAIN:"):
            post.append(a[len("TRAIN:"):])
        elif post:
            post.append(a)
        else:
            pre.append(a)
    exc, match = (ValueError, "applies to RUN only") \
        if argv == ["--precision", "int8"] else \
        (NotImplementedError, "ROADMAP")
    with pytest.raises(exc, match=match):
        main_cli([*pre, "TRAIN", str(tmp_path), model, "x", "--outdir",
                  str(tmp_path / "o"), *post], device="cpu")
    assert not os.path.exists(tmp_path / "o")


def test_train_needs_a_card_unless_the_cpu_is_asked_for(tmp_path):
    from ifcb_classifier_tpu_torch.cli import main_cli
    if torch.cuda.is_available():
        pytest.skip("a card is present: TRAIN would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        main_cli(["TRAIN", str(tmp_path), "inception_v3", "x", "--outdir",
                  str(tmp_path / "o")])
