"""The predict step of RUN (make_predict_step of
ifcb_classifier_tpu/train/state.py); the training steps come with the
TRAIN slice (ROADMAP P5)."""

from __future__ import annotations

import torch


def make_predict_step(model):
    """Forward + softmax in f32 (test_step parity,
    neuston_models.py:152-157). Takes NHWC images [B,r,r,3] and returns
    [B, n_classes] f32 probabilities on the images' device."""

    def predict_step(images):
        with torch.inference_mode():
            logits = model(images.permute(0, 3, 1, 2))
            return torch.softmax(logits.float(), dim=-1)

    return predict_step
