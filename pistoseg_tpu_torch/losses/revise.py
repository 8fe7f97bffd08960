"""Stage-4 (RFM revise) loss stack, PyTorch port.

Port of ``pistoseg_tpu/losses/revise.py`` (reference
``revise_pseudo_labels.py:114-135,238-282``), in NHWC with channel 0 the
background:

* ``loss_cls`` = multilabel soft margin on GAP(cam) foreground channels
  + adaptive-min-pooling loss on ``cam_rv·label`` foreground channels;
* ``loss_rfm`` = mean L1 between label-masked foreground ``pmask_rv`` and
  ``pcam_rv``;
* ``loss_ecr`` = mean of the top-20% |max_onehot(x) − y_rv| entries,
  symmetric in (pmask, pcam).

Parity notes kept from the reference: the ECR top-k count is
``int(4 * h * w * 0.2)`` with a hard-coded 4 whatever the channel count,
and the ``max_onehot`` inputs are detached.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def multilabel_soft_margin_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``F.multilabel_soft_margin_loss``: mean over batch of the per-class
    mean of −[y·log σ(x) + (1−y)·log σ(−x)]."""
    logits = logits.float()
    target = target.float()
    loss = target * F.logsigmoid(logits) + (1.0 - target) * F.logsigmoid(-logits)
    return -loss.mean(dim=-1).mean()


def adaptive_min_pooling_loss(x: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, C) foreground maps.  Max over classes, then the mean of
    the ReLU'd h·w/4 smallest spatial values (``revise_pseudo_labels.py:114-122``)."""
    n, h, w, _ = x.shape
    k = (h * w) // 4
    m = x.amax(dim=-1).reshape(n, -1)                  # (N, H*W)
    smallest = torch.topk(m, k, dim=-1, largest=False).values
    return F.relu(smallest).sum() / (k * n)


def max_norm(p: torch.Tensor, e: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel) spatial min-max normalisation
    (``revise_pseudo_labels.py:132-138``)."""
    mx = p.amax(dim=(1, 2), keepdim=True)
    mn = p.amin(dim=(1, 2), keepdim=True)
    return (p - mn) / (mx - mn + e)


def max_onehot(x: torch.Tensor) -> torch.Tensor:
    """Zero foreground entries that are not the per-pixel foreground max
    (``revise_pseudo_labels.py:124-129``); background channel 0 untouched."""
    fg = x[..., 1:]
    fg_max = fg.amax(dim=-1, keepdim=True)
    fg = torch.where(fg == fg_max, fg, torch.zeros_like(fg))
    return torch.cat([x[..., :1], fg], dim=-1)


def _topk_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    flat = x.reshape(x.shape[0], -1)
    return torch.topk(flat, k, dim=-1).values.mean()


def ecr_loss(
    pmask_up: torch.Tensor,   # (N, H, W, C) normed, label-masked input pmask, upsampled
    pcam_up: torch.Tensor,    # (N, H, W, C) the same for pcam
    pmask_rv: torch.Tensor,   # (N, H, W, C) refined pmask from the RFM
    pcam_rv: torch.Tensor,    # (N, H, W, C) refined pcam from the RFM
    topk_frac: float = 0.2,
) -> torch.Tensor:
    _, h, w, _ = pmask_up.shape
    # the reference hard-codes the factor 4 (not C): int(4*h*w*0.2)
    k = int(4 * h * w * topk_frac)
    t1 = (max_onehot(pmask_up.detach()) - pcam_rv).abs()
    t2 = (max_onehot(pcam_up.detach()) - pmask_rv).abs()
    return _topk_mean(t1, k) + _topk_mean(t2, k)


def rfm_l1_loss(pmask_rv: torch.Tensor, pcam_rv: torch.Tensor) -> torch.Tensor:
    """Mean |pmask_rv − pcam_rv| over foreground channels
    (``revise_pseudo_labels.py:263-265``); inputs already label-masked."""
    return (pmask_rv[..., 1:] - pcam_rv[..., 1:]).abs().mean()


def revise_losses(
    cam: torch.Tensor,        # (N, H, W, C) upsampled CAM logits
    cam_rv: torch.Tensor,     # (N, H, W, C) refined CAM
    pmask_rv: torch.Tensor,   # (N, H, W, C) refined pseudo-mask
    pcam_rv: torch.Tensor,    # (N, H, W, C) refined pseudo-CAM
    pmask_up: torch.Tensor,   # (N, H, W, C) normed input pmask upsampled (for ECR)
    pcam_up: torch.Tensor,    # (N, H, W, C) normed input pcam upsampled (for ECR)
    label: torch.Tensor,      # (N, C) image-level label incl. bg_score=1 at 0
    topk_frac: float = 0.2,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    lbl = label[:, None, None, :].float()
    # classification head: GAP over the upsampled CAM (the reference GAPs
    # the (H, W) map after interpolation, revise_pseudo_labels.py:252-256)
    label_cam = cam.mean(dim=(1, 2))                    # (N, C)
    loss_rvmin = adaptive_min_pooling_loss((cam_rv * lbl)[..., 1:])
    loss_cls = multilabel_soft_margin_loss(label_cam[:, 1:], label[:, 1:]) + loss_rvmin

    pmask_rv_m = pmask_rv * lbl
    pcam_rv_m = pcam_rv * lbl
    loss_rfm = rfm_l1_loss(pmask_rv_m, pcam_rv_m)

    loss_ecr = ecr_loss(pmask_up, pcam_up, pmask_rv_m, pcam_rv_m, topk_frac)

    total = loss_cls + loss_rfm + loss_ecr
    return total, {
        "loss_cls": loss_cls,
        "loss_rfm": loss_rfm,
        "loss_ecr": loss_ecr,
        "loss": total,
    }
