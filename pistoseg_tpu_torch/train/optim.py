"""The reference's ``PolyOptimizer`` with stage 4's parameter groups.

Port of ``pistoseg_tpu/train/optim.py`` (``poly_sgd_grouped``,
``rfm_group_fn``, ``RFM_MULTIPLIERS``; reference ``utils.py:166-187`` and
``revise_pseudo_labels.py:171-177``): ``torch.optim.SGD`` with momentum
0.9 and coupled weight decay (g ← g + wd·θ before the momentum buffer, as
torch's SGD does and the JAX package's optax chain is ordered to match),
one param group per label with lr ``lr·mult·(1 − t/max_step)^power``, t
counted from 0 as optax's step count.  ``set_poly_lr`` sets the lrs for
step t; ``train/state.py`` calls it before every step.  A multiplier of 0
freezes a group: its parameters get ``requires_grad=False`` and no
optimizer entry, so they get neither update nor weight decay.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import torch

RFM_MULTIPLIERS = {
    "pre_w": 1.0, "pre_b": 2.0, "scratch_w": 10.0, "scratch_b": 20.0,
    "frozen": 0.0,
}

_SCRATCH = ("fc8", "f8_3", "f8_4", "f9_1", "f9_2")


def poly_lr(base_lr: float, step: int, max_step: int, power: float) -> float:
    """``base_lr·(1 − t/max_step)^power`` with t/max_step clipped to [0, 1]."""
    frac = min(max(step / max_step, 0.0), 1.0)
    return base_lr * (1.0 - frac) ** power


def rfm_group_fn(name: str) -> str:
    """Stage-4 label of a ReviseNet parameter, by its PyTorch name.

    Every BatchNorm (``bn*``) and all of ``conv1a``, ``b2``, ``b2_1``,
    ``b2_2`` are frozen (``revise_net.py:26-27``, ``resnet38d.py:191-213``);
    the heads trained from scratch are fc8, f8_3, f8_4, f9_1, f9_2; the
    rest is the pretrained trunk.  Weights and biases split each group.
    """
    parts = name.split(".")
    if any(p.startswith("bn") for p in parts[:-1]):
        return "frozen"
    if parts[0] in ("conv1a", "b2", "b2_1", "b2_2"):
        return "frozen"
    is_weight = parts[-1] == "weight"
    if parts[0] in _SCRATCH:
        return "scratch_w" if is_weight else "scratch_b"
    return "pre_w" if is_weight else "pre_b"


def poly_sgd_grouped(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    lr: float,
    max_step: int,
    group_fn: Callable[[str], str],
    multipliers: Dict[str, float],
    power: float = 0.9,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
) -> torch.optim.SGD:
    """SGD over the labelled groups; frozen labels (multiplier 0) get
    ``requires_grad=False``.  Prints the group counts once, as the JAX
    package's labeler does, so an accidental freeze is visible."""
    groups: Dict[str, List[torch.nn.Parameter]] = {}
    counts: Dict[str, int] = {}
    for name, param in named_params:
        label = group_fn(name)
        if label not in multipliers:
            raise KeyError(f"{name}: group {label!r} has no multiplier")
        counts[label] = counts.get(label, 0) + 1
        if multipliers[label] == 0.0:
            param.requires_grad_(False)
        else:
            groups.setdefault(label, []).append(param)
    print(f"[optim] param groups: {counts}")
    param_groups = [
        {"params": params, "label": label, "base_lr": lr * multipliers[label],
         "lr": lr * multipliers[label], "max_step": max_step, "power": power}
        for label, params in groups.items()
    ]
    return torch.optim.SGD(param_groups, lr=lr, momentum=momentum,
                           weight_decay=weight_decay)


def set_poly_lr(optimizer: torch.optim.Optimizer, step: int) -> None:
    """Set every group's lr for step ``step`` (0 = the first update)."""
    for group in optimizer.param_groups:
        group["lr"] = poly_lr(group["base_lr"], step, group["max_step"], group["power"])
