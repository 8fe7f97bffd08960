#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure exits non-zero before the result line:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the package from ``pistoseg_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card, in
   float32 with TF32 off (the backward also through the
   ``autograd.Function``), and time kernel, plain version, the PyTorch
   library call that computes the same function, and the card's bound;
4. make a synthetic WSSS4LUAD set from a seed;
5. run stage 4 (training) end to end through its CLI entry point at the
   defaults (224², batch 16, bf16 trunk) from its seeded random
   initialisation for one epoch cut to TRAIN_STEPS steps, and check the
   loss, the kernel launch counts (one forward and one backward per
   step) and that the frozen parameters did not move and the others did;
6. run stage 4b end to end through its CLI entry point at the defaults
   (256², batch 64, bf16 trunk) on the checkpoint stage 4 wrote, and
   check the PNGs, the launch counts and the refined maps against the
   plain attention path on a small input;
7. time a stage-4 step's parts (forward, backward, update on the card;
   host input) and a stage-4b batch's parts (the model forward on the
   card; the per-patch host work of loading and of PNG emission).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 0
N_PATCHES = 256
TRAIN_STEPS = 8
# H100 SXM datasheet rates: HBM bytes/s and non-tensor FP32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rfm_attention_bound_ms(n: int, l: int, d: int, c: int):
    """Least time for the function on an H100 SXM: q, k, v read once and
    out written once against HBM, and 2·L²·(D+C) FLOP plus L² exp per
    image against the FP32 pipes (the kernel computes in IEEE float32)."""
    bytes_moved = 4 * n * l * (2 * d + 2 * c)
    ops = n * (2 * l * l * (d + c) + l * l)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def check_rfm_attention() -> dict:
    """Phase 3 for the one kernel of the slice."""
    import torch
    import torch.nn.functional as F

    from pistoseg_tpu_torch.ops.cuda.rfm_attention import (
        rfm_attention,
        rfm_attention_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(n, l, d, c, scale=0.3):
        q = torch.randn(n, l, d, device=dev, generator=gen) * scale
        k = torch.randn(n, l, d, device=dev, generator=gen) * scale
        v = torch.rand(n, l, c, device=dev, generator=gen)
        return q, k, v

    max_err = 0.0
    # stage-4b infer (L=1024, WSSS4LUAD 3C=12), stage-4 train (L=784,
    # BCSS 3C=15), a small ragged case, peaked scores (q·k ~ ±40), and last
    # the main path's shape, one stage-4b batch, which is then timed
    for shape, scale in (((8, 1024, 192, 12), 0.3), ((8, 784, 192, 15), 0.3),
                         ((2, 100, 192, 4), 0.3), ((8, 1024, 192, 12), 1.0),
                         ((64, 1024, 192, 12), 0.3)):
        q, k, v = inputs(*shape, scale=scale)
        got = rfm_attention(q, k, v)
        err = (got - rfm_attention_reference(q, k, v)).abs().max().item()
        log(f"rfm_attention {shape} scale {scale}: max |kernel - plain| = {err:.3e}")
        if not err <= 1e-4:
            raise AssertionError(f"rfm_attention disagrees at {shape}: {err}")
        max_err = max(max_err, err)
    ones = torch.ones_like(v)
    err1 = (rfm_attention(q, k, ones) - 1.0).abs().max().item()
    log(f"rfm_attention v=1: max |out - 1| = {err1:.3e}")
    if not err1 <= 1e-5:
        raise AssertionError(f"rfm_attention columns not normalised: {err1}")

    n, l, d, c = q.shape + v.shape[2:]
    kernel_ms = time_ms(lambda: rfm_attention(q, k, v))
    plain_ms = time_ms(lambda: rfm_attention_reference(q, k, v), iters=5)
    lib = F.scaled_dot_product_attention(k, q, v, scale=1.0)
    lib_err = (lib - got).abs().max().item()
    log(f"scaled_dot_product_attention(k, q, v, scale=1): max |lib - kernel| = {lib_err:.3e}")
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(k, q, v, scale=1.0))
    bound_ms, bound_by = rfm_attention_bound_ms(n, l, d, c)
    log(f"rfm_attention {(n, l, d, c)}: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return {"name": "rfm_attention", "route": "cuda",
            "source": "pistoseg_tpu_torch/csrc/rfm_attention.cu",
            "replaces": "pistoseg_tpu/ops/pallas/rfm_attention.py:56",
            "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def rfm_attention_backward_bound_ms(n: int, l: int, d: int, c: int):
    """Least time for the backward on an H100 SXM: q, k, v, out, lse and g
    read once and dq, dk, dv written once, and the FLOP the function needs,
    2·L²·(3D + 2C) per image (S, dP, dv, dq, dk once each) plus L² exp,
    against the FP32 pipes.  The kernel's two passes recompute S and dP,
    2·L²·(4D + 3C); the bound does not count that."""
    bytes_moved = 4 * n * l * (4 * d + 5 * c + 1)
    ops = n * (2 * l * l * (3 * d + 2 * c) + l * l)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def check_rfm_attention_backward():
    """Phase 3 for the backward kernel: held against its plain version and
    the ``autograd.Function``'s gradients against autograd through the
    plain forward; then the forward and the backward timed at the stage-4
    train shape (one batch of 16 at 224², L = 784).  Returns the
    backward's entry of the kernels line and the forward's times there."""
    import torch
    import torch.nn.functional as F

    from pistoseg_tpu_torch.ops.cuda.rfm_attention import (
        _launch_forward,
        rfm_attention,
        rfm_attention_backward,
        rfm_attention_backward_reference,
        rfm_attention_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def inputs(n, l, d, c, scale):
        q = torch.randn(n, l, d, device=dev, generator=gen) * scale
        k = torch.randn(n, l, d, device=dev, generator=gen) * scale
        v = torch.rand(n, l, c, device=dev, generator=gen)
        g = torch.randn(n, l, c, device=dev, generator=gen)
        return q, k, v, g

    def rel_err(got, want):
        return ((got - want).abs().max() / max(1.0, want.abs().max().item())).item()

    max_err = 0.0
    # stage-4 train (L=784, WSSS4LUAD 3C=12 and BCSS 15), a small ragged
    # case, peaked scores, and the stage-4b batch; the train shape last
    for shape, scale in (((16, 784, 192, 15), 0.3), ((2, 100, 192, 4), 0.3),
                         ((8, 1024, 192, 12), 1.0), ((64, 1024, 192, 12), 0.3),
                         ((16, 784, 192, 12), 0.3)):
        q, k, v, g = inputs(*shape, scale)
        out, lse = _launch_forward(q, k, v, with_lse=True)
        got = rfm_attention_backward(q, k, v, out, lse, g)
        want = rfm_attention_backward_reference(q, k, v, g)
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        log(f"rfm_attention_backward {shape} scale {scale}: max |kernel - plain| / "
            f"max(1, max |plain|) = dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}")
        if not max(errs) <= 1e-4:
            raise AssertionError(f"rfm_attention_backward disagrees at {shape}: {errs}")
        # max_abs_err in the kernels line is absolute, as the forward's
        max_err = max(max_err, *((a - b).abs().max().item() for a, b in zip(got, want)))
        del got, want

    # the autograd.Function (kernels both ways) against autograd through
    # the plain forward, at the train shape
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(rfm_attention(*leaves), leaves, g)
    leaves_ref = [t.clone().requires_grad_() for t in (q, k, v)]
    grads_ref = torch.autograd.grad(rfm_attention_reference(*leaves_ref), leaves_ref, g)
    errs = [rel_err(a, b) for a, b in zip(grads, grads_ref)]
    log(f"RFMAttention vs autograd through the plain forward {tuple(q.shape + v.shape[2:])}: "
        f"dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} (relative to max(1, max |plain|))")
    if not max(errs) <= 1e-4:
        raise AssertionError(f"RFMAttention gradients disagree: {errs}")

    n, l, d, c = q.shape + v.shape[2:]
    out, lse = _launch_forward(q, k, v, with_lse=True)
    fwd_ms = time_ms(lambda: _launch_forward(q, k, v, with_lse=True))
    fwd_plain_ms = time_ms(lambda: rfm_attention_reference(q, k, v), iters=5)
    fwd_library_ms = time_ms(lambda: F.scaled_dot_product_attention(k, q, v, scale=1.0))
    fwd_bound_ms, fwd_bound_by = rfm_attention_bound_ms(n, l, d, c)
    log(f"rfm_attention (with lse) {(n, l, d, c)}: kernel {fwd_ms:.4f} ms, plain "
        f"{fwd_plain_ms:.4f} ms, library {fwd_library_ms:.4f} ms, bound "
        f"{fwd_bound_ms:.4f} ms ({fwd_bound_by})")

    kernel_ms = time_ms(lambda: rfm_attention_backward(q, k, v, out, lse, g))
    plain_ms = time_ms(lambda: rfm_attention_backward_reference(q, k, v, g), iters=5)
    lk, lq, lv = (t.clone().requires_grad_() for t in (k, q, v))
    lib_out = F.scaled_dot_product_attention(lk, lq, lv, scale=1.0)
    library_ms = time_ms(lambda: torch.autograd.grad(lib_out, (lk, lq, lv), g,
                                                     retain_graph=True))
    bound_ms, bound_by = rfm_attention_backward_bound_ms(n, l, d, c)
    log(f"rfm_attention_backward {(n, l, d, c)}: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (SDPA backward) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, 2·N·L²·(3D+2C) FLOP)")
    return ({"name": "rfm_attention_backward", "route": "cuda",
             "source": "pistoseg_tpu_torch/csrc/rfm_attention_bwd.cu",
             "replaces": "pistoseg_tpu/ops/pallas/rfm_attention.py:102",
             "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms},
            fwd_ms)


def make_dataset(root: Path, n: int) -> None:
    """A WSSS4LUAD-shaped set: patches of 200-300 px named
    ``p0000-[1, 0, 1].png`` with tissue colours and white background
    blobs, and a [3, 32, 32] pseudo-mask and CAM ``.npy`` for each."""
    from PIL import Image

    rng = np.random.RandomState(SEED)
    colours = np.array([[150, 60, 120], [60, 150, 90], [90, 90, 180]], np.int16)
    for sub in ("train", "pmask", "cam"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        label = rng.randint(0, 2, 3)
        if not label.any():
            label[rng.randint(3)] = 1
        h, w = rng.randint(200, 301, 2)
        cls = rng.choice(np.flatnonzero(label), size=(h // 16 + 1, w // 16 + 1))
        img = np.kron(colours[cls], np.ones((16, 16, 1), np.int16))[:h, :w]
        img = img + rng.randint(-25, 25, (h, w, 3))
        y, x = rng.randint(0, h - 40), rng.randint(0, w - 40)
        img[y:y + 40, x:x + 40] = 245                     # background blob
        name = f"p{i:04d}-[{', '.join(str(v) for v in label)}]"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            root / "train" / f"{name}.png")
        np.save(root / "pmask" / f"{name}.npy", rng.randn(3, 32, 32).astype(np.float32))
        np.save(root / "cam" / f"{name}.npy", rng.rand(3, 32, 32).astype(np.float32))


def run_stage4(root: Path) -> dict:
    """Phase 5: the port's stage 4 through ``main`` at its defaults (224²,
    batch 16, bf16 trunk, float32 heads and attention, grouped PolySGD),
    from its seeded initialisation, for one epoch cut to TRAIN_STEPS
    steps; then the frozen parameters must be bit-identical and every
    other parameter must have moved."""
    import torch

    from pistoseg_tpu_torch.core.checkpoint import load_rfm
    from pistoseg_tpu_torch.core.config import Config
    from pistoseg_tpu_torch.ops.cuda.rfm_attention import (
        rfm_attention,
        rfm_attention_backward,
    )
    from pistoseg_tpu_torch.stages import stage4_revise
    from pistoseg_tpu_torch.train.optim import rfm_group_fn

    cfg = Config()
    rc = cfg.revise
    argv = [f"--dataset={cfg.dataset}", f"--train_data={root / 'train'}",
            f"--pmask_dir={root / 'pmask'}", f"--cam_dir={root / 'cam'}",
            f"--log_dir={root / 'stage4'}", f"--max_steps_per_epoch={TRAIN_STEPS}",
            "--revise.epochs=1", "--trust_inputs=true"]
    rfm_attention.launches = 0
    rfm_attention_backward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = stage4_revise.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fwd, bwd = rfm_attention.launches, rfm_attention_backward.launches
    (row,) = res["logs"]
    log(f"stage 4: {row['steps']} steps of batch {rc.batch_size} at {rc.train_size}² "
        f"({rc.precision} trunk) in {seconds:.2f} s; set-up {res['setup_seconds']:.2f} s, "
        f"first step {row['compile_seconds']:.2f} s, then {row['step_ms_p50']:.2f} ms per "
        f"step = {row['items_per_sec']:.2f} images/s over the other {row['steps'] - 1} "
        f"steps; train_loss {row['train_loss']:.6f}; rfm_attention launches {fwd}, "
        f"rfm_attention_backward launches {bwd}")
    if row["steps"] != TRAIN_STEPS or not math.isfinite(row["train_loss"]):
        raise AssertionError(f"stage 4 log row {row}")
    if fwd != TRAIN_STEPS or bwd != TRAIN_STEPS:
        raise AssertionError(f"{TRAIN_STEPS} steps launched the forward kernel {fwd} "
                             f"and the backward kernel {bwd} times")

    trained, meta = load_rfm(res["checkpoint_dir"])
    init = stage4_revise.init_model(cfg)
    frozen = moved = 0
    for name, p in init.named_parameters():
        same = torch.equal(trained[name], p.detach())
        if rfm_group_fn(name) == "frozen":
            if not same:
                raise AssertionError(f"frozen parameter {name} changed")
            frozen += 1
        elif same:
            raise AssertionError(f"parameter {name} did not move")
        else:
            moved += 1
    log(f"stage 4 checkpoint (step {meta['step']}, epoch {meta['epoch']}): {frozen} frozen "
        f"parameters bit-identical to the initialisation, the other {moved} moved")
    return {"ckpt": Path(res["checkpoint_dir"]), "fwd_launches": fwd, "bwd_launches": bwd,
            "step_ms": row["step_ms_p50"]}


def run_stage4b(root: Path, ckpt: Path) -> dict:
    """Phase 6: the port's stage 4b through ``main`` at its defaults, on
    the checkpoint that stage 4 wrote."""
    import torch

    from pistoseg_tpu_torch.core.config import Config
    from pistoseg_tpu_torch.ops.cuda.rfm_attention import rfm_attention
    from pistoseg_tpu_torch.ops.palette import decode_palette_png
    from pistoseg_tpu_torch.stages import stage4b_infer_revise

    cfg = Config()
    argv = [f"--dataset={cfg.dataset}", f"--train_data={root / 'train'}",
            f"--pmask_dir={root / 'pmask'}", f"--cam_dir={root / 'cam'}",
            f"--ckpt_dir={ckpt}", f"--out_dir={root / 'refine'}",
            "--trust_inputs=true"]
    rfm_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = stage4b_infer_revise.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = rfm_attention.launches
    batches = math.ceil(N_PATCHES / cfg.infer.batch_size)
    log(f"stage 4b: {res['patches']} patches in {seconds:.2f} s = "
        f"{res['patches'] / seconds:.2f} patches/s (batch {cfg.infer.batch_size}, "
        f"{cfg.revise.infer_size}², {cfg.revise.precision}); rfm_attention "
        f"launches {launches} for {batches} batches")
    if res["patches"] != N_PATCHES:
        raise AssertionError(f"stage 4b wrote {res['patches']} patches, not {N_PATCHES}")
    if launches != batches:
        raise AssertionError(f"rfm_attention launched {launches} times for {batches} batches")

    natives = {p.name: p for p in (root / "train").glob("*.png")}
    from PIL import Image
    for sub in ("pmask", "pcam", "cam"):
        pngs = sorted((root / "refine" / sub).glob("*.png"))
        if len(pngs) != N_PATCHES:
            raise AssertionError(f"refine/{sub}: {len(pngs)} PNGs, not {N_PATCHES}")
        for p in pngs:
            m = decode_palette_png(p)
            with Image.open(natives[p.name]) as im:
                if m.shape != (im.height, im.width):
                    raise AssertionError(f"{sub}/{p.name}: shape {m.shape} is not native")
            if m.max() > 3:
                raise AssertionError(f"{sub}/{p.name}: class {m.max()} outside 0..3")
    log(f"stage 4b outputs: 3 x {N_PATCHES} palette PNGs at native size, classes in 0..3")
    return {"seconds": seconds, "launches": launches, "batches": batches}


def _device_batch(root: Path, n: int):
    """The first ``n`` patches as the stage feeds them to the model:
    normalised image, pmask and pcam with the bg channel, on the card."""
    import torch

    from pistoseg_tpu_torch.core.config import Config
    from pistoseg_tpu_torch.data.datasets import RefineDataset
    from pistoseg_tpu_torch.data.loader import collate
    from pistoseg_tpu_torch.ops.augment import imagenet_normalize
    from pistoseg_tpu_torch.stages.stage4_revise import prepare_batch

    cfg = Config()
    dev = torch.device("cuda")
    ds = RefineDataset(root / "train", root / "pmask", root / "cam", cfg.profile,
                       cfg.revise.infer_size)
    batch = collate([ds[i] for i in range(n)])
    pmask, pcam, _ = prepare_batch(batch, dev)
    return imagenet_normalize(torch.as_tensor(batch["image"], device=dev)), pmask, pcam


def _model(ckpt: Path, use_kernel: bool, act_dtype):
    import torch

    from pistoseg_tpu_torch.core.checkpoint import load_rfm
    from pistoseg_tpu_torch.models.rfm import ReviseNet

    sd, _ = load_rfm(ckpt)
    model = ReviseNet(sd["fc8.weight"].shape[0], use_kernel=use_kernel, act_dtype=act_dtype)
    model.load_state_dict(sd)
    return model.to(torch.device("cuda")).eval()


def check_forward(root: Path, ckpt: Path) -> None:
    """The refined maps of the kernel path agree with the plain einsum
    path on a small input (8 patches, float32), and every output is finite."""
    import torch

    x, pmask, pcam = _device_batch(root, 8)
    outs = {}
    for use_kernel in (True, False):
        with torch.inference_mode():
            outs[use_kernel] = _model(ckpt, use_kernel, torch.float32)(x, pmask, pcam)
    for name, a, b in zip(("cam", "cam_rv", "pmask_rv", "pcam_rv"), outs[True], outs[False]):
        if a.shape != (8, 256, 256, 4) or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: shape {tuple(a.shape)} or non-finite values")
        err = (a - b).abs().max().item()
        log(f"forward {name}: max |kernel path - plain path| = {err:.3e}")
        if not err <= 1e-4:
            raise AssertionError(f"{name}: kernel path disagrees with the plain path")


def train_breakdown(root: Path, ckpt: Path, step_ms: float) -> None:
    """Where a stage-4 step's time goes: the forward with the losses, the
    backward and the optimizer update on the card (CUDA events, the
    stage's loss function on one batch of 16 at 224², bf16 trunk), beside
    the host input of one batch on one thread and the step time the stage
    measured."""
    import torch

    from pistoseg_tpu_torch.core.checkpoint import load_rfm
    from pistoseg_tpu_torch.core.config import Config
    from pistoseg_tpu_torch.core.prng import stage_generator
    from pistoseg_tpu_torch.data.datasets import RefineDataset
    from pistoseg_tpu_torch.data.loader import BatchLoader, collate
    from pistoseg_tpu_torch.stages import stage4_revise
    from pistoseg_tpu_torch.stages.common import float32_precision
    from pistoseg_tpu_torch.train.optim import RFM_MULTIPLIERS, poly_sgd_grouped, rfm_group_fn
    from pistoseg_tpu_torch.train.state import TrainState

    cfg = Config()
    rc = cfg.revise
    dev = torch.device("cuda")
    model = stage4_revise.init_model(cfg)
    model.load_state_dict(load_rfm(ckpt)[0])
    model.to(dev).train()
    opt = poly_sgd_grouped(model.named_parameters(), rc.lr, 1000, rfm_group_fn,
                           RFM_MULTIPLIERS, power=rc.poly_power, momentum=rc.momentum,
                           weight_decay=rc.weight_decay)
    state = TrainState(model, opt)
    ds = RefineDataset(root / "train", root / "pmask", root / "cam", cfg.profile,
                       rc.train_size)
    t0 = time.perf_counter()
    batch = collate([ds[i] for i in range(rc.batch_size)])
    input_ms = (time.perf_counter() - t0) * 1e3
    loader_ms = {}
    for workers in (8, 1):                      # the stage's loader has 8 threads
        loader = BatchLoader(ds, rc.batch_size, shuffle=True, seed=cfg.seed,
                             num_workers=workers)
        t0 = time.perf_counter()
        for n, _ in enumerate(loader.epoch(0), 1):
            if n == TRAIN_STEPS:
                break
        loader_ms[workers] = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    loss_fn = stage4_revise.build_loss_fn(rc.train_size, rc.ecr_topk_frac, dev)
    gen = stage_generator(cfg.seed, "chip_smoke/breakdown", device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts = np.zeros(3)
    iters = 4
    with float32_precision(rc.precision):
        for it in range(iters + 1):                   # the first is a warm-up
            ev[0].record()
            loss, _ = loss_fn(model, batch, gen)
            ev[1].record()
            loss.backward()
            ev[2].record()
            state.apply_gradients()
            ev[3].record()
            torch.cuda.synchronize()
            if it:
                parts += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    fwd, bwd, upd = parts / iters
    device_ms = fwd + bwd + upd
    log(f"stage 4 breakdown: per batch of {rc.batch_size} at {rc.train_size}²: forward "
        f"and losses {fwd:.2f} ms, backward {bwd:.2f} ms, optimizer {upd:.2f} ms on the "
        f"card = {device_ms:.2f} ms, {100 * device_ms / step_ms:.1f}% of the stage's "
        f"{step_ms:.2f} ms step; host input {input_ms:.1f} ms of one thread's time; "
        f"the stage's loader alone delivers a batch every {loader_ms[8]:.1f} ms with 8 "
        f"threads, {loader_ms[1]:.1f} ms with 1")


def breakdown(root: Path, ckpt: Path, kernel_ms: float) -> None:
    """Where a stage-4b batch's time goes: the model forward on the card
    (bf16 trunk, batch 64) beside the per-patch host work of the input
    loader and of the PNG emission, each timed alone on one thread."""
    import torch

    from pistoseg_tpu_torch.core.config import Config
    from pistoseg_tpu_torch.data.datasets import RefineDataset, load_image
    from pistoseg_tpu_torch.ops.background import extract_background
    from pistoseg_tpu_torch.ops.palette import encode_palette_png
    from pistoseg_tpu_torch.ops.resize import resize_palette_pil

    cfg = Config()
    bs = cfg.infer.batch_size
    t0 = time.perf_counter()
    model = _model(ckpt, True, torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x, pmask, pcam = _device_batch(root, bs)
    torch.backends.cudnn.allow_tf32 = True          # as the stage sets it for bf16
    with torch.inference_mode():
        forward_ms = time_ms(lambda: model(x, pmask, pcam), iters=3, warmup=1)
    torch.backends.cudnn.allow_tf32 = False
    del model, x, pmask, pcam

    ds = RefineDataset(root / "train", root / "pmask", root / "cam", cfg.profile,
                       cfg.revise.infer_size)
    n = 32
    t0 = time.perf_counter()
    for i in range(n):
        ds[i]
    input_ms = (time.perf_counter() - t0) / n * 1e3
    pred = np.random.RandomState(SEED).randint(0, 3, (256, 256)).astype(np.uint8)
    out = root / "breakdown"
    t0 = time.perf_counter()
    for p in ds.paths[:n]:
        original = load_image(p)
        bg = extract_background(original)
        for sub in ("pmask", "pcam", "cam"):
            mask = resize_palette_pil(pred, original.shape[:2])
            mask[bg > 0] = cfg.profile.bg_class
            encode_palette_png(mask, cfg.profile.palette, out / sub / p.name)
    emit_ms = (time.perf_counter() - t0) / n * 1e3
    log(f"breakdown: model set-up {setup_s:.2f} s; per batch of {bs}: forward "
        f"{forward_ms:.2f} ms on the card (rfm_attention {kernel_ms:.2f} ms = "
        f"{100 * kernel_ms / forward_ms:.2f}%), host input {input_ms * bs:.1f} ms "
        f"and emission {emit_ms * bs:.1f} ms of one thread's time "
        f"({input_ms:.2f} + {emit_ms:.2f} ms per patch)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from pistoseg_tpu_torch.ops.cuda import build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = build.build(build.kernel_sources())
    log(f"built {build.kernel_sources()} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        log(f"nvcc {name}:\n{text.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"rfm_attention": check_rfm_attention()}
    kernels["rfm_attention_backward"], fwd_train_ms = check_rfm_attention_backward()

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = time.perf_counter()
        make_dataset(root, N_PATCHES)
        log(f"inputs: {N_PATCHES} synthetic WSSS4LUAD patches "
            f"({time.perf_counter() - t0:.1f} s)")
        s4 = run_stage4(root)
        bwd_ms = kernels["rfm_attention_backward"]["ms"]
        log(f"stage 4 step: rfm_attention forward {fwd_train_ms:.4f} ms + backward "
            f"{bwd_ms:.4f} ms = {100 * (fwd_train_ms + bwd_ms) / s4['step_ms']:.2f}% of "
            f"{s4['step_ms']:.2f} ms")
        run = run_stage4b(root, s4["ckpt"])
        kernels["rfm_attention"]["launches"] = s4["fwd_launches"] + run["launches"]
        kernels["rfm_attention_backward"]["launches"] = s4["bwd_launches"]
        check_forward(root, s4["ckpt"])
        train_breakdown(root, s4["ckpt"], s4["step_ms"])
        breakdown(root, s4["ckpt"], kernels["rfm_attention"]["ms"])
    finally:
        shutil.rmtree(root, ignore_errors=True)

    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in order}
                                  for kern in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
