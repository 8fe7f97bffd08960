"""The port's checkpoints: ``rfm.pt`` and ``train_state.pt``, each
beside its ``.meta.json``.

The JAX package writes Orbax trees, which need JAX to read.  The port
keeps torch files instead, with the same metadata sidecar
(``{"epoch", "step", "metric", ...}``) that the JAX ``CheckpointManager``
writes, so the stage-4b manifest hashes ``rfm.meta.json`` in both
packages.  ``models/weights.py::state_dict_from_flax`` carries a JAX tree
across.  ``train_state.pt`` is the full train state for an exact resume
(port of ``pistoseg_tpu/core/checkpoint.py:145-187``): the model's
state_dict, the optimizer's momentum buffers and lrs, and the step; its
sidecar says which epoch it belongs to and, for a snapshot taken
mid-epoch, how many of the epoch's batches were consumed.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

RFM = "rfm"
WEIGHTS = f"{RFM}.pt"
META = f"{RFM}.meta.json"
TRAIN_STATE = "train_state"


def _write(root: Path, name: str, payload, meta: dict) -> Path:
    """``{name}.pt`` (atomically, via a temporary file) and ``{name}.meta.json``."""
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f"{name}.pt.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, root / f"{name}.pt")
    (root / f"{name}.meta.json").write_text(json.dumps(meta, indent=2))
    return root / f"{name}.pt"


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_rfm(ckpt_dir: str | Path, state_dict: Dict[str, torch.Tensor], *,
             epoch: int = -1, step: int = -1, metric: float = float("nan"),
             extra: Optional[dict] = None) -> Path:
    """Write ``rfm.pt`` (tensors moved to the CPU) and ``rfm.meta.json``."""
    meta = {"epoch": epoch, "step": step, "metric": metric, **(extra or {})}
    return _write(Path(ckpt_dir), RFM, _cpu(dict(state_dict)), meta)


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


def save_train_state(ckpt_dir: str | Path, state: Dict, *, epoch: int,
                     step_in_epoch: int = -1, metric: float = float("nan")) -> Path:
    """Write ``train_state.pt`` (``TrainState.state_dict()``, on the CPU)
    and its sidecar.  ``step_in_epoch >= 0`` marks a mid-epoch snapshot:
    ``epoch`` is the epoch in progress and ``step_in_epoch`` the number of
    its batches already consumed."""
    meta = {"epoch": epoch, "step": int(state["step"]), "metric": metric,
            "step_in_epoch": step_in_epoch}
    return _write(Path(ckpt_dir), TRAIN_STATE, _cpu(state), meta)


def load_train_state(ckpt_dir: str | Path,
                     map_location: str | torch.device = "cpu") -> Tuple[Dict, int, int]:
    """Return (state, start_epoch, start_step_in_epoch): resume at
    ``start_epoch``, skipping its first ``start_step_in_epoch`` batches
    (0 after an end-of-epoch snapshot)."""
    root = Path(ckpt_dir)
    state = torch.load(root / f"{TRAIN_STATE}.pt", map_location=map_location,
                       weights_only=True)
    meta = json.loads((root / f"{TRAIN_STATE}.meta.json").read_text())
    epoch, step_in_epoch = int(meta["epoch"]), int(meta["step_in_epoch"])
    if step_in_epoch >= 0:
        return state, epoch, step_in_epoch
    return state, epoch + 1, 0


def has_train_state(ckpt_dir: str | Path) -> bool:
    return (Path(ckpt_dir) / f"{TRAIN_STATE}.pt").exists()
