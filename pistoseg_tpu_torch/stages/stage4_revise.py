"""Stage 4: RFM pseudo-mask revision training.

Port of ``pistoseg_tpu/stages/stage4_revise.py`` (reference
``revise_pseudo_labels.py``): ReviseNet (ResNet38d + affinity RFM)
trained with the three-part loss (cls + rfm + ecr,
``revise_pseudo_labels.py:253-282``) and PolySGD over the 1×/2×/10×/20×
groups with BN, conv1a and b2 frozen (``:171-177``).  Batch preparation
(zero bg channel onto pmask/pcam, bg_score=1 onto the label, ``:238-244``)
and the ECR inputs (max_norm·label, bg = 1 − max fg, align-corners
upsample, ``:268-274``) run on the device.  The trunk computes in
``revise.precision`` (bf16 by default), the heads, the attention and
the losses in float32; the fused attention runs forward and backward
through its kernels on the card.

Writes ``{log_dir}/checkpoints/rfm.pt`` + ``rfm.meta.json`` (read by
``stage4b_infer_revise``), ``train_state.pt`` for ``--resume=true``, and
the per-epoch rows of ``stage4_metrics.csv``.

    python -m pistoseg_tpu_torch.stages.stage4_revise --dataset=wsss4luad \\
        --train_data=… --pmask_dir=… --cam_dir=… --log_dir=… [--device=cpu]
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from pistoseg_tpu_torch.core.checkpoint import (
    has_train_state,
    load_train_state,
    save_rfm,
    save_train_state,
)
from pistoseg_tpu_torch.core.config import Config
from pistoseg_tpu_torch.core.logging import MetricsLogger, snapshot_code
from pistoseg_tpu_torch.core.manifest import check_lineage, check_upstream
from pistoseg_tpu_torch.core.prng import stage_seed
from pistoseg_tpu_torch.data.datasets import RefineDataset
from pistoseg_tpu_torch.data.loader import BatchLoader
from pistoseg_tpu_torch.losses.revise import max_norm, revise_losses
from pistoseg_tpu_torch.models.resnet38d import spatial_dropout_masks
from pistoseg_tpu_torch.models.rfm import ReviseNet
from pistoseg_tpu_torch.ops.augment import imagenet_normalize
from pistoseg_tpu_torch.ops.resize import resize
from pistoseg_tpu_torch.stages.common import (
    apply_pretrained,
    apply_stage0_trunk,
    float32_precision,
    parse_cli,
    resolve_device,
)
from pistoseg_tpu_torch.train.loop import Trainer, make_train_step
from pistoseg_tpu_torch.train.optim import RFM_MULTIPLIERS, poly_sgd_grouped, rfm_group_fn
from pistoseg_tpu_torch.train.state import TrainState


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


def ecr_inputs(pmask: torch.Tensor, pcam: torch.Tensor, label: torch.Tensor,
               out_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference ``revise_pseudo_labels.py:268-274``: max_norm·label with
    bg = 1 − max(fg), then align-corners bilinear upsample (NHWC)."""

    def prep(m):
        m = max_norm(m) * label[:, None, None, :]
        bg = 1.0 - m[..., 1:].amax(dim=-1, keepdim=True)
        m = torch.cat([bg, m[..., 1:]], dim=-1)
        return resize(m, out_hw, method="linear_align_corners")

    return prep(pmask), prep(pcam)


def build_loss_fn(size: int, topk_frac: float, device: torch.device):
    """loss_fn(model, batch, generator) → (total, parts).  The generator
    draws the step's dropout masks; padded tail samples (``valid`` false)
    get a zero label, so every loss term ignores them."""

    def loss_fn(model: ReviseNet, batch: Dict, generator: torch.Generator):
        pmask, pcam, label = prepare_batch(batch, device)
        x = imagenet_normalize(torch.as_tensor(batch["image"], device=device))
        masks = spatial_dropout_masks(model.dropout_sites(), x.shape[0], generator)
        outs = model(x, pmask, pcam, masks=masks)
        cam, cam_rv, pmask_rv, pcam_rv = (o.float() for o in outs)
        pmask_up, pcam_up = ecr_inputs(pmask, pcam, label, (size, size))
        valid = torch.as_tensor(batch["valid"], device=device).float()[:, None]
        total, parts = revise_losses(cam, cam_rv, pmask_rv, pcam_rv, pmask_up, pcam_up,
                                     label * valid, topk_frac=topk_frac)
        return total, {k: v.detach() for k, v in parts.items() if k != "loss"}

    return loss_fn


def init_model(cfg: Config) -> ReviseNet:
    """The stage's ReviseNet on the CPU, initialised from ``cfg.seed``.  The
    heads take the initialisers of the JAX package's ``models/rfm.py``:
    fc8 Xavier-uniform, f8_3/f8_4 Kaiming-normal, f9_1/f9_2 Xavier-uniform
    with gain 4 (variance scaling 16, fan_avg).  The trunk keeps PyTorch's
    default; ``--pretrained`` replaces it."""
    rc = cfg.revise
    act_dtype = torch.bfloat16 if rc.precision == "bf16" else torch.float32
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(stage_seed(cfg.seed, "stage4/init"))
        model = ReviseNet(num_classes=cfg.profile.num_classes + 1,
                          use_kernel=rc.use_pallas, act_dtype=act_dtype, remat=rc.remat)
        torch.nn.init.xavier_uniform_(model.fc8.weight)
        torch.nn.init.kaiming_normal_(model.f8_3.weight)
        torch.nn.init.kaiming_normal_(model.f8_4.weight)
        torch.nn.init.xavier_uniform_(model.f9_1.weight, gain=4.0)
        torch.nn.init.xavier_uniform_(model.f9_2.weight, gain=4.0)
    return model


def train_stage4(
    cfg: Config,
    train_data: str,
    pmask_dir: str,
    cam_dir: str,
    log_dir: str = "logs/stage4",
    max_steps_per_epoch: Optional[int] = None,
    pretrained: Optional[str] = None,
    pretrained_stage0: Optional[str] = None,
    trust_inputs: bool = False,
    resume: bool = False,
    device: str = "cuda",
) -> Dict:
    t_setup = time.perf_counter()
    dev = resolve_device(device)
    profile = cfg.profile
    rc = cfg.revise

    # refuse stale or incomplete upstream artifacts, and check that both
    # producers derive from the same training set
    check_lineage(
        {
            "pmask_dir": check_upstream(pmask_dir, "stage3", what="pmask_dir",
                                        trust=trust_inputs),
            "cam_dir": check_upstream(cam_dir, "stage0_export", what="cam_dir",
                                      trust=trust_inputs),
        },
        "train_data", trust=trust_inputs,
    )

    model = init_model(cfg)
    if pretrained:
        # ImageNet ResNet38d trunk (revise_pseudo_labels.py:179-185)
        apply_pretrained(model, pretrained)
    elif pretrained_stage0:
        apply_stage0_trunk(model, pretrained_stage0)
    model.to(dev).train()

    ds = RefineDataset(train_data, pmask_dir, cam_dir, profile, rc.train_size)
    loader = BatchLoader(ds, rc.batch_size, shuffle=True, seed=cfg.seed)
    steps_per_epoch = (len(loader) if max_steps_per_epoch is None
                       else min(len(loader), max_steps_per_epoch))
    max_step = steps_per_epoch * rc.epochs
    optimizer = poly_sgd_grouped(
        model.named_parameters(), rc.lr, max_step, rfm_group_fn, RFM_MULTIPLIERS,
        power=rc.poly_power, momentum=rc.momentum, weight_decay=rc.weight_decay,
    )
    state = TrainState(model, optimizer)

    ckpt_dir = Path(log_dir) / "checkpoints"
    logger = MetricsLogger(log_dir, "stage4")
    snapshot_code(log_dir)
    cfg.save(Path(log_dir) / "config.json")

    def train_iter(epoch):
        for i, batch in enumerate(loader.epoch(epoch)):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            yield {k: batch[k] for k in ("image", "pmask", "cam", "label", "valid")}

    def checkpoint(state, epoch, metric, is_best):
        save_rfm(ckpt_dir, state.model.state_dict(), epoch=epoch, metric=metric,
                 extra={"stage": "stage4", "config": cfg.to_dict()})
        # the full state, for a resume after a crash
        save_train_state(ckpt_dir, state.state_dict(), epoch=epoch, metric=metric)

    start_epoch, start_step = 0, 0
    if resume and has_train_state(ckpt_dir):
        saved, start_epoch, start_step = load_train_state(ckpt_dir)
        state.load_state_dict(saved)
        del saved

    logs = []

    def log(row):
        logger.log(row)
        logs.append(row)

    trainer = Trainer(
        make_train_step(build_loss_fn(rc.train_size, rc.ecr_topk_frac, dev)),
        rc.epochs, train_iter, seed=cfg.seed, stream="stage4/train", device=dev,
        checkpoint_fn=checkpoint, log_fn=log,
        start_epoch=start_epoch, start_step=start_step,
        items_per_batch=rc.batch_size,
        step_checkpoint_every=rc.checkpoint_every_steps,
        step_checkpoint_fn=lambda s, e, i: save_train_state(
            ckpt_dir, s.state_dict(), epoch=e, step_in_epoch=i),
    )
    setup_seconds = time.perf_counter() - t_setup
    with float32_precision(rc.precision):
        trainer.fit(state)
    return {"steps": max_step, "checkpoint_dir": str(ckpt_dir), "logs": logs,
            "setup_seconds": setup_seconds}


def main(argv=None):
    cfg, extras = parse_cli(argv)
    return train_stage4(
        cfg,
        train_data=extras["train_data"],
        pmask_dir=extras["pmask_dir"],
        cam_dir=extras["cam_dir"],
        log_dir=extras.get("log_dir", "logs/stage4"),
        max_steps_per_epoch=(
            int(extras["max_steps_per_epoch"]) if "max_steps_per_epoch" in extras else None
        ),
        pretrained=extras.get("pretrained"),
        pretrained_stage0=extras.get("pretrained_stage0"),
        trust_inputs=extras.get("trust_inputs", "false").lower() in ("1", "true", "yes"),
        resume=extras.get("resume", "false").lower() in ("1", "true", "yes"),
        device=extras.get("device", "cuda"),
    )


if __name__ == "__main__":
    main()
