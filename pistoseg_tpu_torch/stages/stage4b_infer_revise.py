"""Stage 4b: emit refined masks with the trained RFM.

Port of ``pistoseg_tpu/stages/stage4b_infer_revise.py`` (reference
``infer_revise_masks.py``): images at 256² (the inference size differs
from the 224² training size by design, ``infer_revise_masks.py:46`` vs
``revise_pseudo_labels.py:53``); forward the RFM; **foreground-only**
argmax of the label-masked refined maps (``(x_rv·label)[:, 1:]`` then
argmax, ``:137-143``); nearest-resize the palette mask to native size
(PIL P-mode resize semantics); for WSSS4LUAD re-impose the recomputed
background as the bg class (``:151-155``); write
``refine/{pmask,pcam,cam}/{name}.png`` and the stage manifest, which the
JAX stage 5 accepts.

    python -m pistoseg_tpu_torch.stages.stage4b_infer_revise --dataset=wsss4luad \\
        --train_data=… --pmask_dir=… --cam_dir=… --ckpt_dir=… [--device=cpu]

The checkpoint is the port's ``rfm.pt`` (``core/checkpoint.py``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from pistoseg_tpu_torch.core.checkpoint import load_rfm
from pistoseg_tpu_torch.core.config import Config
from pistoseg_tpu_torch.core.manifest import (
    check_lineage,
    check_upstream,
    hash_tree,
    skip_if_current,
    write_manifest,
)
from pistoseg_tpu_torch.data.datasets import RefineDataset, load_image
from pistoseg_tpu_torch.data.loader import BatchLoader
from pistoseg_tpu_torch.models.rfm import ReviseNet
from pistoseg_tpu_torch.ops.augment import imagenet_normalize
from pistoseg_tpu_torch.ops.background import extract_background
from pistoseg_tpu_torch.ops.palette import encode_palette_png
from pistoseg_tpu_torch.ops.resize import resize_palette_pil
from pistoseg_tpu_torch.stages.common import float32_precision, parse_cli, resolve_device
from pistoseg_tpu_torch.stages.stage4_revise import prepare_batch


def _predict(model: ReviseNet, x, pmask, pcam, label) -> List[np.ndarray]:
    """[pmask, pcam, cam] foreground-class argmaxes, (N, H, W) uint8."""
    _, cam_rv, pmask_rv, pcam_rv = model(imagenet_normalize(x), pmask, pcam)
    lbl = label[:, None, None, :]
    # torch.argmax returns the first maximum, as jnp.argmax does
    return [torch.argmax((m * lbl)[..., 1:], dim=-1).to(torch.uint8).cpu().numpy()
            for m in (pmask_rv, pcam_rv, cam_rv)]


def infer_stage4b(
    cfg: Config,
    train_data: str,
    pmask_dir: str,
    cam_dir: str,
    ckpt_dir: str,
    out_dir: Optional[str] = None,
    limit: Optional[int] = None,
    trust_inputs: bool = False,
    device: str = "cuda",
) -> Dict:
    dev = resolve_device(device)
    profile = cfg.profile
    rc = cfg.revise
    n_ch = profile.num_classes + 1

    check_lineage(
        {
            "pmask_dir": check_upstream(pmask_dir, "stage3", what="pmask_dir",
                                        trust=trust_inputs),
            "cam_dir": check_upstream(cam_dir, "stage0_export", what="cam_dir",
                                      trust=trust_inputs),
        },
        "train_data", trust=trust_inputs,
    )

    out = Path(out_dir) if out_dir else Path(ckpt_dir) / "refine"
    manifest_inputs = {
        "train_data": hash_tree(train_data, "*.png", limit=256),
        "pmask": hash_tree(pmask_dir, "*.npy", limit=256),
        "cam": hash_tree(cam_dir, "*.npy", limit=256),
        "rfm": hash_tree(Path(ckpt_dir) / "rfm.meta.json"),
        "limit": str(limit),
    }
    if skip_if_current(out, "stage4b", manifest_inputs, cfg.to_dict()):
        return {"patches": -1, "out_dir": str(out), "skipped": True}

    act_dtype = torch.bfloat16 if rc.precision == "bf16" else torch.float32
    model = ReviseNet(num_classes=n_ch, use_kernel=rc.use_pallas, act_dtype=act_dtype)
    state_dict, _ = load_rfm(ckpt_dir)
    model.load_state_dict(state_dict)
    model.to(dev).eval()

    ds = RefineDataset(train_data, pmask_dir, cam_dir, profile, rc.infer_size)
    if limit is not None:
        ds.paths = ds.paths[:limit]
    loader = BatchLoader(ds, cfg.infer.batch_size, pad_last=True)

    for sub in ("pmask", "pcam", "cam"):
        (out / sub).mkdir(parents=True, exist_ok=True)

    def emit_one(name, pred_j):
        # re-decode the original for its native size + background mask,
        # then write the three palette masks (infer_revise_masks.py:161-210)
        original = load_image(Path(train_data) / name)
        h, w = original.shape[:2]
        bg = extract_background(original) if profile.has_background_channel else None
        for sub, pred in zip(("pmask", "pcam", "cam"), pred_j):
            mask = resize_palette_pil(pred, (h, w))
            if bg is not None:
                mask[bg > 0] = profile.bg_class
            encode_palette_png(mask, profile.palette, out / sub / name)

    n_done = 0
    futures = []
    # host emission (decode + bg extract + 3 palette PNG writes per patch)
    # overlaps the next batch's device work
    with ThreadPoolExecutor(max_workers=8) as pool, torch.inference_mode(), \
            float32_precision(rc.precision):
        for batch in loader.epoch(0):
            pmask, pcam, label = prepare_batch(batch, dev)
            x = torch.as_tensor(batch["image"], device=dev)
            preds = _predict(model, x, pmask, pcam, label)
            for j, ok in enumerate(batch["valid"]):
                if not ok:
                    continue
                futures.append(pool.submit(
                    emit_one, batch["name"][j], [pred[j] for pred in preds]))
                n_done += 1
        for f in futures:
            f.result()

    write_manifest(
        out, "stage4b",
        inputs=manifest_inputs,
        config=cfg.to_dict(),
        outputs={"patches": n_done},
    )
    return {"patches": n_done, "out_dir": str(out)}


def main(argv=None):
    cfg, extras = parse_cli(argv)
    return infer_stage4b(
        cfg,
        train_data=extras["train_data"],
        pmask_dir=extras["pmask_dir"],
        cam_dir=extras["cam_dir"],
        ckpt_dir=extras["ckpt_dir"],
        out_dir=extras.get("out_dir"),
        limit=int(extras["limit"]) if "limit" in extras else None,
        trust_inputs=extras.get("trust_inputs", "false").lower() in ("1", "true", "yes"),
        device=extras.get("device", "cuda"),
    )


if __name__ == "__main__":
    main()
