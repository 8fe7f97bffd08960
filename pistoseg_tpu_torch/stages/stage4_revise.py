"""Stage 4 (RFM revise) — the batch preparation that stage 4b shares.

The trainer of ``pistoseg_tpu/stages/stage4_revise.py`` comes with the
stage-4 training slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def prepare_batch(batch: Dict, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Zero bg channel onto pmask/pcam; bg_score=1 onto label (NHWC)
    (``revise_pseudo_labels.py:238-244``)."""
    pmask = torch.as_tensor(batch["pmask"], device=device)
    pcam = torch.as_tensor(batch["cam"], device=device)
    zeros = pmask.new_zeros(pmask.shape[:-1] + (1,))
    pmask = torch.cat([zeros, pmask], dim=-1)
    pcam = torch.cat([zeros, pcam], dim=-1)
    label = torch.as_tensor(batch["label"], device=device)
    label = torch.cat([label.new_ones((label.shape[0], 1)), label], dim=-1)
    return pmask, pcam, label
