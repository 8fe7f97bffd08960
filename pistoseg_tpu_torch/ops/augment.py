"""Input normalisation (the inference part of ``pistoseg_tpu/ops/augment.py``).

The training augmentations come with the stage-2 slice.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """uint8/float [0,255] (N, H, W, 3) → normalized float32.

    ``mean``/``std`` in [0, 1] units (dataset profiles carry them)."""
    m = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return (x.float() - m) / s


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    return normalize(x)
