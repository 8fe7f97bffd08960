"""Carry flax parameters into the port's ``state_dict``.

The JAX package keeps ReviseNet/ResNet38d weights as nested dicts
(``params`` and ``batch_stats``); the port's modules use the reference's
PyTorch names.  The mapping, per leaf path:

* a leading ``backbone`` level is dropped (the port's ReviseNet keeps the
  trunk at its top level, as the reference does), and so is the extra
  ``bn`` level of ``FrozenBN`` (``resnet38d.py:53-58``);
* ``kernel`` (HWIO) → ``weight`` (OIHW);
* BN ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var``.

So ``b2.bn_branch2a.bn.scale`` becomes ``b2.bn_branch2a.weight`` and
``fc8.kernel`` becomes ``fc8.weight``: the keys of the reference's
``res38d.pth`` plus the heads ``fc8``, ``f8_3``, ``f8_4``, ``f9_1``,
``f9_2``.  Takes numpy arrays; no JAX is needed.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _walk(tree: Mapping, prefix, out: Dict[str, torch.Tensor]) -> None:
    for key, val in tree.items():
        path = prefix + [str(key)]
        if isinstance(val, Mapping):
            _walk(val, path, out)
            continue
        *mods, leaf = path
        mods = [m for i, m in enumerate(mods)
                if not (m == "backbone" and i == 0) and m != "bn"]
        arr = np.asarray(val, dtype=np.float32)
        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{'.'.join(path)}: expected an HWIO kernel, "
                                 f"got shape {arr.shape}")
            name, arr = "weight", np.transpose(arr, (3, 2, 0, 1))
        elif leaf in _LEAF:
            name = _LEAF[leaf]
        else:
            raise KeyError(f"unmapped flax leaf: {'.'.join(path)}")
        key_t = ".".join(mods + [name])
        if key_t in out:
            raise KeyError(f"two flax leaves map to {key_t}")
        out[key_t] = torch.tensor(arr)  # a copy: flax leaves may be read-only


def state_dict_from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """``params``/``batch_stats`` (nested dicts of arrays) → state_dict."""
    out: Dict[str, torch.Tensor] = {}
    _walk(params, [], out)
    _walk(batch_stats, [], out)
    return out
