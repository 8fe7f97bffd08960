"""The port's RFM checkpoint: ``rfm.pt`` beside ``rfm.meta.json``.

The JAX package writes Orbax trees, which need JAX to read.  The port
keeps a torch ``state_dict`` file instead, with the same metadata sidecar
(``{"epoch", "step", "metric", ...}``) that the JAX ``CheckpointManager``
writes, so the stage-4b manifest hashes ``rfm.meta.json`` in both
packages.  ``models/weights.py::state_dict_from_flax`` carries a JAX tree
across.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

WEIGHTS = "rfm.pt"
META = "rfm.meta.json"


def save_rfm(ckpt_dir: str | Path, state_dict: Dict[str, torch.Tensor], *,
             epoch: int = -1, step: int = -1, metric: float = float("nan"),
             extra: Optional[dict] = None) -> Path:
    """Write ``rfm.pt`` (tensors moved to the CPU) and ``rfm.meta.json``."""
    root = Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f"{WEIGHTS}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, root / WEIGHTS)
    meta = {"epoch": epoch, "step": step, "metric": metric, **(extra or {})}
    (root / META).write_text(json.dumps(meta, indent=2))
    return root / WEIGHTS


def load_rfm(ckpt_dir: str | Path,
             map_location: str | torch.device = "cpu") -> Tuple[Dict[str, torch.Tensor], dict]:
    """Return (state_dict, metadata) of the checkpoint in ``ckpt_dir``."""
    root = Path(ckpt_dir)
    if not (root / WEIGHTS).exists():
        raise FileNotFoundError(
            f"{root / WEIGHTS} not found (a JAX Orbax checkpoint must first be "
            f"carried across with models/weights.py::state_dict_from_flax)")
    sd = torch.load(root / WEIGHTS, map_location=map_location, weights_only=True)
    meta_path = root / META
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return sd, meta
