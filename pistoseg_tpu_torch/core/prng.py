"""Deterministic seeds for ``torch.Generator`` streams.

Counterpart of ``pistoseg_tpu/core/prng.py``: every random decision is
keyed explicitly by (seed, name, epoch, step), so any stage, epoch or step
is reproducible on its own, a resumed run included.  The JAX package
folds the key into threefry; this port hashes it into a 63-bit seed for a
``torch.Generator``.  The bits differ between the packages: tests that
compare them inject the same random numbers into both.
"""

from __future__ import annotations

import hashlib

import torch


def stage_seed(seed: int, name: str, epoch: int = 0, step: int = 0) -> int:
    """A 63-bit seed that depends only on (seed, name, epoch, step)."""
    digest = hashlib.sha256(f"{seed}/{name}/{epoch}/{step}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def stage_generator(seed: int, name: str, epoch: int = 0, step: int = 0,
                    device: str | torch.device = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``stage_seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stage_seed(seed, name, epoch, step))
    return gen
