"""Wide dilated ResNet-38 ("ResNet38d", SEAM lineage) trunk, NCHW.

Port of ``pistoseg_tpu/models/resnet38d.py`` (reference
``models/resnet38d.py``): pre-activation residual blocks (BN → ReLU →
conv), ``conv1a`` 3→64, stride-2 stages b2–b4 (→ /8), b5 at dilation 2
(1024ch), bottleneck b6 at dilation 4 (2048ch), b7 at dilation
``b7_dilation`` (4096ch), final BN+ReLU, and the conv3–conv6 feature taps.

BatchNorm always uses its running statistics, in training too (the
reference freezes every BN, ``resnet38d.py:191-213``).  The spatial
dropout of b6 (0.3) and b7 (0.5), one mask per (sample, channel)
broadcast over H and W, takes its masks as arguments: the caller draws
them up front with ``spatial_dropout_masks`` from an explicit
``torch.Generator`` (none given = the identity, as at inference), so a
test can inject them and ``remat=True`` (each block under
``torch.utils.checkpoint``) recomputes with the same masks.  Parameter
names are the reference's (``conv1a.weight``,
``b2.bn_branch2a.running_mean``, …), so its ``res38d.pth`` keys load as
they are.

Parameters stay float32.  The trunk computes in the dtype of its input
(``act_dtype``): with bfloat16, activations and conv weights are cast on
use, as flax's ``dtype=bfloat16`` does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# drawn spatial-dropout masks by site name ("b6.0": b6's first site)
Masks = Optional[Mapping[str, torch.Tensor]]


def spatial_dropout_masks(sites: Mapping[str, Tuple[int, float]], n: int,
                          generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One (n, channels, 1, 1) float32 mask per site, on the generator's
    device: 0 where a channel is dropped, 1/(1 − rate) where it is kept
    (flax ``nn.Dropout(rate, broadcast_dims=(1, 2))``).  The sites are
    drawn in their mapping order."""
    dev = generator.device
    masks = {}
    for name, (channels, rate) in sites.items():
        keep = torch.rand(n, channels, 1, 1, generator=generator, device=dev) >= rate
        masks[name] = keep.float() / (1.0 - rate)
    return masks


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Spatial dropout with a drawn mask, in x's dtype; None = identity."""
    return x if mask is None else x * mask.to(x.dtype)


class Conv(nn.Module):
    """Bias-free conv with symmetric padding ``dilation·(k−1)//2``; the
    weight is cast to the input's dtype on use."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.stride = stride
        self.dilation = dilation
        self.padding = dilation * (kernel - 1) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                        self.padding, self.dilation)


class FrozenBN(nn.Module):
    """BatchNorm locked to running statistics (eps 1e-5), computed in f32
    and returned in the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, training=False, eps=self.eps)
        return y.to(x.dtype)


class ResBlock(nn.Module):
    """Pre-activation 3×3/3×3 block (reference ``ResBlock``)."""

    def __init__(self, cin: int, mid: int, cout: int, stride: int = 1,
                 first_dilation: int = 1, dilation: int = 1):
        super().__init__()
        self.same_shape = cin == cout and stride == 1
        self.bn_branch2a = FrozenBN(cin)
        if not self.same_shape:
            self.conv_branch1 = Conv(cin, cout, 1, stride)
        self.conv_branch2a = Conv(cin, mid, 3, stride, first_dilation)
        self.bn_branch2b1 = FrozenBN(mid)
        self.conv_branch2b1 = Conv(mid, cout, 3, 1, dilation)

    def forward(self, x: torch.Tensor):
        """Returns (out, bn_relu(x)): the second is the feature tap."""
        branch2 = F.relu(self.bn_branch2a(x))
        x_bn_relu = branch2
        branch1 = x if self.same_shape else self.conv_branch1(branch2)
        branch2 = self.conv_branch2a(branch2)
        branch2 = F.relu(self.bn_branch2b1(branch2))
        branch2 = self.conv_branch2b1(branch2)
        return branch1 + branch2, x_bn_relu


class ResBlockBot(nn.Module):
    """Pre-activation bottleneck 1×1/3×3/1×1 (reference ``ResBlock_bot``)
    with spatial dropout after each inner BN+ReLU; ``mask_a``/``mask_b``
    are the drawn masks of the two sites (None = identity)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.widths = (cout // 4, cout // 2)   # channels at the two sites
        self.bn_branch2a = FrozenBN(cin)
        self.conv_branch1 = Conv(cin, cout, 1, stride)
        self.conv_branch2a = Conv(cin, cout // 4, 1, stride)
        self.bn_branch2b1 = FrozenBN(cout // 4)
        self.conv_branch2b1 = Conv(cout // 4, cout // 2, 3, 1, dilation)
        self.bn_branch2b2 = FrozenBN(cout // 2)
        self.conv_branch2b2 = Conv(cout // 2, cout, 1)

    def forward(self, x: torch.Tensor, mask_a: Optional[torch.Tensor] = None,
                mask_b: Optional[torch.Tensor] = None):
        branch2 = F.relu(self.bn_branch2a(x))
        x_bn_relu = branch2
        branch1 = self.conv_branch1(branch2)
        branch2 = self.conv_branch2a(branch2)
        branch2 = apply_mask(F.relu(self.bn_branch2b1(branch2)), mask_a)
        branch2 = self.conv_branch2b1(branch2)
        branch2 = apply_mask(F.relu(self.bn_branch2b2(branch2)), mask_b)
        branch2 = self.conv_branch2b2(branch2)
        return branch1 + branch2, x_bn_relu


class ResNet38d(nn.Module):
    """Trunk; ``forward_as_dict`` returns the conv3–conv6 taps (NCHW).
    ``remat=True`` recomputes each block's activations in the backward
    (``torch.utils.checkpoint``) instead of keeping them."""

    def __init__(self, b7_dilation: int = 4, act_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.act_dtype = act_dtype
        self.remat = remat
        self.conv1a = Conv(3, 64, 3)
        self.b2 = ResBlock(64, 128, 128, stride=2)
        self.b2_1 = ResBlock(128, 128, 128)
        self.b2_2 = ResBlock(128, 128, 128)
        self.b3 = ResBlock(128, 256, 256, stride=2)
        self.b3_1 = ResBlock(256, 256, 256)
        self.b3_2 = ResBlock(256, 256, 256)
        self.b4 = ResBlock(256, 512, 512, stride=2)
        self.b4_1 = ResBlock(512, 512, 512)
        self.b4_2 = ResBlock(512, 512, 512)
        self.b4_3 = ResBlock(512, 512, 512)
        self.b4_4 = ResBlock(512, 512, 512)
        self.b4_5 = ResBlock(512, 512, 512)
        self.b5 = ResBlock(512, 512, 1024, first_dilation=1, dilation=2)
        self.b5_1 = ResBlock(1024, 512, 1024, dilation=2)
        self.b5_2 = ResBlock(1024, 512, 1024, dilation=2)
        self.b6 = ResBlockBot(1024, 2048, dilation=4, dropout=0.3)
        self.b7 = ResBlockBot(2048, 4096, dilation=b7_dilation, dropout=0.5)
        self.bn7 = FrozenBN(4096)

    def dropout_sites(self) -> Dict[str, Tuple[int, float]]:
        """Mask name → (channels, rate) of every spatial-dropout site."""
        return {f"{name}.{i}": (width, block.dropout)
                for name, block in (("b6", self.b6), ("b7", self.b7))
                for i, width in enumerate(block.widths)}

    def _block(self, name: str, x: torch.Tensor, masks: Masks):
        block = getattr(self, name)
        args = (x,)
        if isinstance(block, ResBlockBot) and masks is not None:
            args = (x, masks[f"{name}.0"], masks[f"{name}.1"])
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward_as_dict(self, x: torch.Tensor, masks: Masks = None) -> Dict[str, torch.Tensor]:
        """``masks``: the drawn dropout masks of ``dropout_sites`` (None =
        no dropout)."""
        x = self.conv1a(x.to(self.act_dtype))
        for name in ("b2", "b2_1", "b2_2", "b3", "b3_1", "b3_2"):
            x, _ = self._block(name, x, masks)
        x, conv3 = self._block("b4", x, masks)
        for name in ("b4_1", "b4_2", "b4_3", "b4_4", "b4_5"):
            x, _ = self._block(name, x, masks)
        x, conv4 = self._block("b5", x, masks)
        x, _ = self._block("b5_1", x, masks)
        x, _ = self._block("b5_2", x, masks)
        x, conv5 = self._block("b6", x, masks)
        x, _ = self._block("b7", x, masks)
        conv6 = F.relu(self.bn7(x))
        return {"conv3": conv3, "conv4": conv4, "conv5": conv5, "conv6": conv6}

    def forward(self, x: torch.Tensor, masks: Masks = None) -> Dict[str, torch.Tensor]:
        return self.forward_as_dict(x, masks)
