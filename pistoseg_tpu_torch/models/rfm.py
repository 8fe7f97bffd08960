"""Revise-Feature Module network (stage 4), PyTorch port.

Port of ``pistoseg_tpu/models/rfm.py`` (reference ``models/revise_net.py``):
the ResNet38d trunk, ``fc8`` 4096→C CAM head on conv6, the projections
``f8_3`` (512→64, on conv4) and ``f8_4`` (1024→128, on conv5), a pixel
affinity ``A = softmax(qᵀk, over rows)`` built from ``f = [x↓, f8_3,
f8_4]`` (195ch) through ``f9_1``/``f9_2`` (192ch), and the refinement
``RFM(m, A) = reshape(m_flat · A)`` of the three maps.  Every resize is
the deterministic align-corners matrix resize.

The modules compute in NCHW; ``ReviseNet.forward`` and ``get_norm_cam_d``
keep the JAX package's NHWC layout at their boundary so the two packages
compare like with like.  The heads and the attention run in float32
whatever the trunk's dtype.  Training passes the drawn spatial-dropout
masks (``ReviseNet.dropout_sites``: b6, b7 and ``dropout7``, 0.5 on
conv6 before ``fc8``); the attention is differentiable in q and k, and
``get_norm_cam_d`` stays detached.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from pistoseg_tpu_torch.models.resnet38d import Conv, Masks, ResNet38d, apply_mask
from pistoseg_tpu_torch.ops.cuda.rfm_attention import rfm_attention
from pistoseg_tpu_torch.ops.resize import resize


def get_norm_cam_d(cam: torch.Tensor) -> torch.Tensor:
    """Per-channel spatial min-max norm, background = 1 − max(fg), and
    foreground non-max suppression (strictly-less entries zeroed) —
    ``revise_net.py:29-41``.  Never differentiated (reference no_grad).

    cam: (N, H, W, C), channel 0 = background.
    """
    cam = cam.detach()
    c_min = cam.amin(dim=(1, 2), keepdim=True)
    c_max = cam.amax(dim=(1, 2), keepdim=True) + 1e-5
    norm = (cam - c_min) / (c_max - c_min)
    fg = norm[..., 1:]
    fg_max = fg.amax(dim=-1, keepdim=True)
    bg = 1.0 - fg_max
    fg = torch.where(fg < fg_max, torch.zeros_like(fg), fg)
    return torch.cat([bg, fg], dim=-1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class ReviseNet(ResNet38d):
    """Returns (cam, cam_rv, pmask_rv, pcam_rv), all (N, H, W, C).

    The trunk's parameters sit at the top level beside the heads, with the
    reference's names.  ``use_kernel=True`` runs the affinity and the
    three refinements as one fused, differentiable kernel call over the
    three maps concatenated on channels (``ops/cuda/rfm_attention.py``:
    forward and backward kernels on the card); ``False`` materialises the
    affinity with einsums, as the JAX package's ``use_pallas=False`` path
    does.
    """

    def __init__(self, num_classes: int, use_kernel: bool = True,
                 act_dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__(b7_dilation=4, act_dtype=act_dtype, remat=remat)
        self.num_classes = num_classes
        self.use_kernel = use_kernel
        self.fc8 = Conv(4096, num_classes, 1)
        self.f8_3 = Conv(512, 64, 1)
        self.f8_4 = Conv(1024, 128, 1)
        self.f9_1 = Conv(195, 192, 1)
        self.f9_2 = Conv(195, 192, 1)

    def dropout_sites(self) -> Dict[str, Tuple[int, float]]:
        """The trunk's sites plus ``dropout7`` on conv6 (``rfm.py:87-88``)."""
        return {**super().dropout_sites(), "dropout7": (4096, 0.5)}

    def forward(
        self,
        x: torch.Tensor,      # (N, H, W, 3) normalized image
        pmask: torch.Tensor,  # (N, h, w, C) pseudo-mask logits incl. bg ch 0
        pcam: torch.Tensor,   # (N, h, w, C) CAM scores incl. bg ch 0
        masks: Masks = None,  # drawn dropout masks of dropout_sites(); None = eval
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        N, H, W, _ = x.shape
        C = self.num_classes
        x = _nchw(x.float())
        d = self.forward_as_dict(x, masks)
        conv6 = apply_mask(d["conv6"], None if masks is None else masks["dropout7"])
        # CAM head and attention projections in f32 (parity-sensitive)
        cam = self.fc8(conv6.float())                          # (N, C, h, w)
        h, w = cam.shape[2:]
        L = h * w

        cam_d_norm = _nchw(get_norm_cam_d(_nhwc(cam)))
        pmask_d_norm = _nchw(get_norm_cam_d(pmask.float()))
        pcam_d_norm = _nchw(get_norm_cam_d(pcam.float()))

        f8_3 = F.relu(self.f8_3(d["conv4"].float()))
        f8_4 = F.relu(self.f8_4(d["conv5"].float()))
        x_s = resize(x, (h, w), method="linear_align_corners", channel_last=False)
        f = torch.cat([x_s, f8_3, f8_4], dim=1)                # (N, 195, h, w)
        # tokens row-major over (y, x), as the JAX reshape(N, h*w, 192)
        q = self.f9_1(f).reshape(N, 192, L).transpose(1, 2).contiguous()
        k = self.f9_2(f).reshape(N, 192, L).transpose(1, 2).contiguous()

        maps = [resize(m, (h, w), method="linear_align_corners", channel_last=False)
                for m in (pmask_d_norm, pcam_d_norm, cam_d_norm)]
        v = torch.cat(maps, dim=1).reshape(N, 3 * C, L).transpose(1, 2).contiguous()
        if self.use_kernel:
            out = rfm_attention(q, k, v)                        # (N, L, 3C)
        else:
            attn = torch.softmax(torch.einsum("nic,njc->nij", q, k), dim=1)
            out = torch.einsum("nic,nij->njc", v, attn)
        out = out.transpose(1, 2).reshape(N, 3 * C, h, w)

        def up(m: torch.Tensor) -> torch.Tensor:
            return _nhwc(resize(m, (H, W), method="linear_align_corners",
                                channel_last=False))

        pmask_rv = up(out[:, :C])
        pcam_rv = up(out[:, C:2 * C])
        cam_rv = up(out[:, 2 * C:])
        return up(cam), cam_rv, pmask_rv, pcam_rv
