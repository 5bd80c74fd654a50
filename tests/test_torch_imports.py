"""The port stands alone: importing every module of
ifcb_classifier_tpu_torch pulls in neither JAX nor the JAX package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import ifcb_classifier_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "ifcb_classifier_tpu"))
print(len(names), bad)
print(" ".join(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    first, names = proc.stdout.split("\n", 1)
    n, bad = first.split(" ", 1)
    assert int(n) >= 25, proc.stdout  # every module was found and imported
    assert bad.strip() == "[]", proc.stdout
    # the TRAIN and int8 slices' modules among them
    for mod in ("data.datasets", "data.pipeline", "ops.preprocess",
                "models.layers", "models.inception", "train.state",
                "train.checkpoint", "train.loop", "results.validation",
                "utils.config", "cli", "ops.qconv", "models.quant",
                "models.quant_resident", "models.quant_graph", "export"):
        assert "ifcb_classifier_tpu_torch." + mod in names.split(), mod
