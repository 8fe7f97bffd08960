"""Shared stage plumbing: CLI parsing and the device an entry point runs on."""

from __future__ import annotations

import sys
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
