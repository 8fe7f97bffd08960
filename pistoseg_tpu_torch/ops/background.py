"""Background (non-tissue) extraction for WSSS4LUAD.

Reimplements ``get_background`` (``utils.py:155-163``): grayscale > 200
threshold, then removal of connected bright components smaller than 50
pixels (4-connectivity) — i.e. ``skimage.morphology.remove_small_objects``
semantics, here via ``scipy.ndimage`` (skimage is not in the image).
Host-side numpy: runs in the offline data-prep and PNG-emission paths.
The port's own copy of ``pistoseg_tpu/ops/background.py``.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

# ITU-R 601 luma, the convention cv2.cvtColor(RGB2GRAY) uses.
_LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """cv2-compatible RGB→gray with round-half-away rounding."""
    g = rgb.astype(np.float32) @ _LUMA
    return np.clip(np.floor(g + 0.5), 0, 255).astype(np.uint8)


def extract_background(
    rgb: np.ndarray, threshold: int = 200, min_size: int = 50
) -> np.ndarray:
    """Return uint8 {0, 255} mask of background (bright, non-tissue) pixels."""
    gray = rgb_to_gray_u8(rgb)
    binary = gray > threshold
    # remove_small_objects(connectivity=1): drop 4-connected components < min_size
    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)
    labels, n = ndimage.label(binary, structure=structure)
    if n:
        sizes = np.bincount(labels.ravel())
        keep = sizes >= min_size
        keep[0] = False
        binary = keep[labels]
    return binary.astype(np.uint8) * 255
