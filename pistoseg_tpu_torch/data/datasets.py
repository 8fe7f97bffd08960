"""Host-side datasets: decode, resize to a static shape, parse metadata.

The stage-4 ``RefineDataset`` (reference ``revise_pseudo_labels.py:35-70``)
and the helpers it needs, copied from ``pistoseg_tpu/data/datasets.py``.
Images are resized on the host with the same deterministic matrices as
the device path (``ops/resize.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch
from PIL import Image

from pistoseg_tpu_torch.core.config import DatasetProfile
from pistoseg_tpu_torch.data.labels import parse_label
from pistoseg_tpu_torch.ops.resize import resize_matrix


def load_image(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.array(im.convert("RGB"), dtype=np.uint8)


def _resize_np(img: np.ndarray, out_hw: Tuple[int, int], method: str) -> np.ndarray:
    """Host resize via the same deterministic matrices as the device path."""
    h, w = img.shape[:2]
    if (h, w) == tuple(out_hw):
        return img.astype(np.float32)
    Rh = resize_matrix(h, out_hw[0], method)
    Rw = resize_matrix(w, out_hw[1], method)
    x = img.astype(np.float32)
    if x.ndim == 2:
        return Rh @ x @ Rw.T
    return np.einsum("oh,hwc,pw->opc", Rh, x, Rw, optimize=True)


class RefineDataset:
    """Stage-4 triplets (reference ``RefineDataset``,
    ``revise_pseudo_labels.py:35-70``): image resized to ``size``²,
    32×32 pseudo-mask logits, 32×32 CAM, and the filename label."""

    def __init__(
        self,
        train_dir: str | Path,
        pmask_dir: str | Path,
        cam_dir: str | Path,
        profile: DatasetProfile,
        size: int = 224,
    ):
        self.train_dir = Path(train_dir)
        self.pmask_dir = Path(pmask_dir)
        self.cam_dir = Path(cam_dir)
        self.profile = profile
        self.size = size
        self.paths = sorted(self.train_dir.glob("*.png"))
        if not self.paths:
            raise FileNotFoundError(f"no training patches under {train_dir}")

    def __len__(self):
        return len(self.paths)

    @staticmethod
    def _load_logits(base: Path, stem: str) -> np.ndarray:
        # artifact format rule: this framework writes .npy, the reference
        # wrote torch .pt (infer_pseudo_masks.py:126-127)
        npy = base / f"{stem}.npy"
        if npy.exists():
            arr = np.load(npy)
        else:
            arr = torch.load(base / f"{stem}.pt", map_location="cpu").numpy()
        # stored [C, 32, 32] (reference contract) → NHWC
        return np.ascontiguousarray(arr.transpose(1, 2, 0)).astype(np.float32)

    def __getitem__(self, i):
        p = self.paths[i]
        stem = p.stem
        image = _resize_np(load_image(p), (self.size, self.size), "linear")
        pmask = self._load_logits(self.pmask_dir, stem)
        cam = self._load_logits(self.cam_dir, stem)
        label = np.asarray(parse_label(p, self.profile.label_grammar), np.float32)
        return {
            "image": image.astype(np.float32),
            "pmask": pmask,
            "cam": cam,
            "label": label,
            "name": p.name,
        }
