"""Dataset helpers (the part of ifcb_classifier_tpu/data/datasets.py that
RUN uses)."""

from __future__ import annotations


def parse_imgnorm(img_norm_arg):
    """1-or-3 comma-separated floats broadcast to 3 channels
    (neuston_data.py:331-339)."""
    mean = [float(m) for m in img_norm_arg[0].split(',')]
    if len(mean) == 1:
        mean = 3 * mean
    std = [float(s) for s in img_norm_arg[1].split(',')]
    if len(std) == 1:
        std = 3 * std
    if not len(mean) == len(std) == 3:
        raise ValueError('--img-norm invalid: {}'.format(img_norm_arg))
    return mean, std
