"""ifcb_classifier_tpu_torch — the PyTorch/CUDA port of ifcb_classifier_tpu.

The JAX package beside it is the reference; every module here keeps the
name of its counterpart there so a reader can find each pair, and imports
nothing of it (nor of JAX). Where the JAX package has a Pallas kernel on
this port's path, the port has a hand-written CUDA kernel for Hopper
(sm_90a) under ``csrc/`` with a plain PyTorch version beside it.

Ported so far: ``RUN --type bin`` with the BN-folded inception_v3, and
``TRAIN`` of inception_v3 through kernel K2.

Subpackages:
  data/     IFCB bin reader, dataset manifests, canvas ladder, loader
            (host side)
  native/   C++ ROI canvas packer, loaded through ctypes
  ops/      device preprocessing (kernels K1, K2 + their plain versions)
  models/   inception_v3 (torchvision layout), BN folding, JAX weight carry-over
  train/    checkpoint codec (ifcbnn-ckpt-v1 msgpack), resume state,
            optimizer, loss and steps, the TRAIN loop
  infer/    RUN engine and verb
  results/  .json/.mat/.h5 result writers (RUN and validation)
  utils/    outdir templating, device and dtype policy
"""

__version__ = "0.1.0"
