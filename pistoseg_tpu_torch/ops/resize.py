"""Deterministic resampling as dense interpolation-matrix matmuls.

The reference resizes under three conventions (SURVEY.md §7.3-1): torch
half-pixel bilinear, ``align_corners=True`` bilinear, and PIL resizes of
palette images.  A 1-D resample along an axis is a dense matrix
``R ∈ (out, in)`` built on the host in numpy; a 2-D separable resize is
``R_h · X · R_wᵀ``, two float32 matmuls.  ``F.interpolate`` is not used:
its CUDA backward is nondeterministic, and the matrices are the same ones
the JAX package builds (``pistoseg_tpu/ops/resize.py``), so both packages
resample identically.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

Method = str  # 'linear' | 'linear_align_corners' | 'pil' | 'nearest'


@lru_cache(maxsize=None)
def _resize_matrix_np(in_size: int, out_size: int, method: Method) -> np.ndarray:
    if in_size < 1 or out_size < 1:
        raise ValueError(f"bad resize {in_size}->{out_size}")
    R = np.zeros((out_size, in_size), dtype=np.float64)
    j = np.arange(out_size, dtype=np.float64)

    if method == "nearest":
        # bit-exact Pillow NEAREST convention (see _pil_nearest_indices)
        idx = _pil_nearest_indices(in_size, out_size)
        R[np.arange(out_size), idx] = 1.0

    elif method == "linear_align_corners":
        # torch align_corners=True: src = j * (in-1)/(out-1)
        src = j * ((in_size - 1) / (out_size - 1)) if out_size > 1 else j * 0.0
        i0 = np.floor(src).astype(np.int64)
        frac = src - i0
        i0c = np.clip(i0, 0, in_size - 1)
        i1c = np.clip(i0 + 1, 0, in_size - 1)
        np.add.at(R, (np.arange(out_size), i0c), 1.0 - frac)
        np.add.at(R, (np.arange(out_size), i1c), frac)

    elif method == "linear":
        # torch align_corners=False (half-pixel): src = (j+0.5)*scale - 0.5
        scale = in_size / out_size
        src = (j + 0.5) * scale - 0.5
        i0 = np.floor(src).astype(np.int64)
        frac = src - i0
        i0c = np.clip(i0, 0, in_size - 1)
        i1c = np.clip(i0 + 1, 0, in_size - 1)
        np.add.at(R, (np.arange(out_size), i0c), 1.0 - frac)
        np.add.at(R, (np.arange(out_size), i1c), frac)

    elif method == "pil":
        # PIL BILINEAR: triangle filter, antialiased when downscaling
        # (support scaled by in/out), per-row weight normalization, indices
        # clipped into range (boundary accumulates).
        scale = in_size / out_size
        filterscale = max(scale, 1.0)
        support = 1.0 * filterscale
        center = (j + 0.5) * scale
        xmin = np.maximum(np.floor(center - support + 0.5).astype(np.int64), 0)
        xmax = np.minimum(np.floor(center + support + 0.5).astype(np.int64), in_size)
        for row in range(out_size):
            ks = np.arange(xmin[row], xmax[row], dtype=np.float64)
            w = 1.0 - np.abs((ks + 0.5 - center[row]) / filterscale)
            w = np.maximum(w, 0.0)
            s = w.sum()
            if s > 0:
                w /= s
            R[row, xmin[row]:xmax[row]] = w

    else:
        raise ValueError(f"unknown resize method: {method}")

    return np.ascontiguousarray(R.astype(np.float32))


def resize_matrix(in_size: int, out_size: int, method: Method = "linear") -> np.ndarray:
    """The dense (out, in) 1-D resample matrix for ``method`` (cached)."""
    return _resize_matrix_np(in_size, out_size, method)


def resize(
    x: torch.Tensor,
    out_hw: Tuple[int, int],
    method: Method = "linear",
    channel_last: bool = True,
) -> torch.Tensor:
    """Separable 2-D resize of the two spatial dims, in float32.

    ``channel_last=True``  : x is (..., H, W, C) — NHWC, the JAX layout.
    ``channel_last=False`` : x is (..., H, W)    — NCHW maps, index masks.

    The caller sets TF32 off for matmuls to keep this in full float32, as
    the JAX package pins ``Precision.HIGHEST`` here.
    """
    oh, ow = out_hw
    if channel_last:
        h, w = x.shape[-3], x.shape[-2]
    else:
        h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (oh, ow):
        return x
    Rh = torch.from_numpy(resize_matrix(h, oh, method)).to(x.device)
    Rw = torch.from_numpy(resize_matrix(w, ow, method)).to(x.device)
    xf = x.float()
    if channel_last:
        y = torch.einsum("oh,...hwc->...owc", Rh, xf)
        y = torch.einsum("pw,...owc->...opc", Rw, y)
    else:
        y = torch.matmul(torch.matmul(Rh, xf), Rw.T)
    return y.to(x.dtype) if x.is_floating_point() else y


def resize_palette_pil(mask: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Reproduce the reference's ``Image.resize(..., BILINEAR)`` on *palette
    index images* (``infer_revise_masks.py:154,165,174``).

    Resizing a P-mode image in Pillow falls back to NEAREST whatever the
    filter, so label values never mix: nearest with PIL's center
    convention.  Host-side numpy, PNG-emission path.
    """
    h, w = mask.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return mask.astype(np.uint8)
    iy = _pil_nearest_indices(h, oh)
    ix = _pil_nearest_indices(w, ow)
    return mask[np.ix_(iy, ix)].astype(np.uint8)


@lru_cache(maxsize=None)
def _pil_nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's affine-nearest source indices, bit-exact.

    Pillow walks an *incremental* double accumulator (``xin = scale/2;
    xin += scale`` per output pixel) and truncates — the sequential
    rounding drift is observable at integer boundaries, so a closed-form
    ``(j+0.5)*scale`` does NOT reproduce it.  We replicate the accumulator.
    """
    s = in_size / out_size
    xin = 0.5 * s
    idx = np.empty(out_size, dtype=np.int64)
    for j in range(out_size):
        idx[j] = min(int(xin), in_size - 1)
        xin += s
    return idx
