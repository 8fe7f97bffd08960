"""Shared stage plumbing: CLI parsing, the device an entry point runs on,
its float32 precision, and pretrained trunk weights."""

from __future__ import annotations

import sys
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple

import torch

from pistoseg_tpu_torch.core.config import Config


def parse_cli(argv: Optional[Sequence[str]] = None) -> Tuple[Config, Dict[str, str]]:
    """Split ``--key=value`` args into Config overrides and stage extras.

    Keys containing '.' or matching top-level Config fields go to the
    config tree; everything else (paths like ``--pmask_dir=...``, and
    ``--device``) is returned as a string dict for the stage main.
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = Config()
    extras: Dict[str, str] = {}
    overridden = set()
    for arg in argv:
        if not arg.startswith("--") or "=" not in arg:
            raise ValueError(f"expected --key=value, got {arg}")
        key, value = arg[2:].split("=", 1)
        key_norm = key.replace("-", "_")
        try:
            cfg.override(key_norm, value)
            overridden.add(key_norm)
        except KeyError:
            extras[key_norm] = value
    cfg.cli_overridden = frozenset(overridden)
    return cfg, extras


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a usable card
    is an error: the port never carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            f"pass device='cpu' (CLI: --device=cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@contextmanager
def float32_precision(precision: str):
    """TF32 on the card follows ``revise.precision``: off for ``fp32``.
    With ``bf16`` the float32 head convs may use TF32 in cuDNN, as the
    TPU's default precision rounds them; matmuls stay full float32
    because the only ones are the resizes, which the JAX package pins
    to ``Precision.HIGHEST``.  The previous flags are restored."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = precision != "fp32"
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


_TRUNK = ("conv1a", "bn7")


def _is_trunk_key(key: str) -> bool:
    head = key.split(".")[0]
    return head in _TRUNK or (head[0] == "b" and head[1:2].isdigit())


def apply_pretrained(model: torch.nn.Module, path: str) -> int:
    """Overlay ResNet38d ImageNet weights from ``--pretrained=<path.pth>``
    onto ``model``'s trunk (stage 4, ``revise_pseudo_labels.py:179-185``;
    JAX counterpart ``pistoseg_tpu/stages/common.py:56-83``).

    The file's keys carry the reference's names, which the port's trunk
    uses (a ``state_dict`` wrapper and ``module.`` prefixes are taken
    off).  Every trunk key of the file (``conv1a``, ``b*``, ``bn7``) must
    exist in the model with the same shape; other keys (classifier heads)
    are skipped, and the model's heads keep their initialisation.  The
    reference's mxnet ``.params`` files need the JAX package's importer.
    Returns the number of tensors loaded."""
    if path.endswith(".params"):
        raise ValueError(f"{path}: mxnet .params weights are not read by the PyTorch "
                         f"port; convert them to a .pth state_dict first")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    own = model.state_dict()
    loaded = {}
    for key, value in sd.items():
        key = key.replace("module.", "")
        if not _is_trunk_key(key):
            continue
        if key not in own:
            raise ValueError(f"{path}: trunk key {key} is not in the model")
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"{path}: {key} has shape {tuple(value.shape)}, the model "
                             f"{tuple(own[key].shape)}")
        loaded[key] = value
    if not loaded:
        raise ValueError(f"{path}: no ResNet38d trunk keys found")
    with torch.no_grad():
        for key, value in loaded.items():
            own[key].copy_(value)
    return len(loaded)


def apply_stage0_trunk(model: torch.nn.Module, ckpt_dir: str) -> None:
    """``--pretrained_stage0``: the JAX package warm-starts the trunk from
    the stage-0 classifier's Orbax tree, which needs JAX to read; the port
    raises until stage 0 is ported."""
    raise NotImplementedError(
        f"--pretrained_stage0={ckpt_dir}: the stage-0 checkpoint is an Orbax tree "
        f"that the PyTorch port cannot read until stage 0 is ported (ROADMAP "
        f"item 9); pass --pretrained=<res38d.pth> or no initialisation")
