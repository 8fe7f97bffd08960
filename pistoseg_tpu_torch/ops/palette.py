"""Palette-PNG codec for class-index masks.

The reference's inter-stage artifact contract is palette PNGs holding class
indices (SURVEY.md Appendix B); downstream stages read indices back with
``np.asarray(Image.open(...))``.  Host-side (PIL); the port's own copy of
``pistoseg_tpu/ops/palette.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Union

import numpy as np
from PIL import Image


def _full_palette(palette: Sequence[int]) -> list:
    pal = list(palette)
    pal += [0] * (768 - len(pal))
    return pal


def encode_palette_png(
    mask: np.ndarray, palette: Sequence[int], path: Union[str, Path]
) -> None:
    """Write a class-index mask (H, W) uint8 as a P-mode PNG."""
    if mask.ndim != 2:
        raise ValueError(f"mask must be 2-D, got {mask.shape}")
    img = Image.fromarray(mask.astype(np.uint8), mode="P")
    img.putpalette(_full_palette(palette))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    img.save(path)


def decode_palette_png(path: Union[str, Path]) -> np.ndarray:
    """Read a palette PNG back as a class-index array (H, W) uint8."""
    with Image.open(path) as img:
        if img.mode not in ("P", "L"):
            raise ValueError(f"{path}: expected P/L mode PNG, got {img.mode}")
        return np.asarray(img, dtype=np.uint8)
