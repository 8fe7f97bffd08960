#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure exits non-zero before the result line:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the package from ``pistoseg_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card, in
   float32 with TF32 off, and time kernel, plain version, the PyTorch
   library call that computes the same function, and the card's bound;
4. run stage 4b end to end through its CLI entry point at the defaults
   (256² inputs, batch 64, bf16 trunk) on a synthetic WSSS4LUAD set made
   from a seed, with random full-width ReviseNet weights, and check the
   PNGs, the kernel launch counts and the refined maps against the plain
   attention path on a small input;
5. time a stage-4b batch's parts: the model forward on the card and the
   per-patch host work of loading and of PNG emission.

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


def random_weights(model, seed: int) -> dict:
    """Full-width random weights from a ``torch.Generator``: convs
    N(0, 1/fan_in), BN affine and statistics near identity."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, t in model.state_dict().items():
        if t.dim() == 4:
            sd[key] = torch.randn(t.shape, generator=gen) / math.sqrt(t[0].numel())
        elif key.endswith("running_var"):
            sd[key] = 0.5 + torch.rand(t.shape, generator=gen)
        elif key.endswith(".weight"):
            sd[key] = 1.0 + 0.1 * torch.randn(t.shape, generator=gen)
        else:                                   # bias, running_mean
            sd[key] = 0.1 * torch.randn(t.shape, generator=gen)
    return sd


def run_stage4b(root: Path) -> dict:
    """Phase 4: the port's stage 4b through ``main`` at its defaults."""
    import torch

    from pistoseg_tpu_torch.core.checkpoint import save_rfm
    from pistoseg_tpu_torch.core.config import Config
    from pistoseg_tpu_torch.models.rfm import ReviseNet
    from pistoseg_tpu_torch.ops.cuda.rfm_attention import rfm_attention
    from pistoseg_tpu_torch.ops.palette import decode_palette_png
    from pistoseg_tpu_torch.stages import stage4b_infer_revise

    cfg = Config()
    n_ch = cfg.profile.num_classes + 1
    t0 = time.perf_counter()
    make_dataset(root, N_PATCHES)
    save_rfm(root / "ckpt", random_weights(ReviseNet(n_ch), SEED), extra={"seed": SEED})
    log(f"stage 4b inputs: {N_PATCHES} patches, random weights "
        f"({time.perf_counter() - t0:.1f} s)")

    argv = [f"--dataset={cfg.dataset}", f"--train_data={root / 'train'}",
            f"--pmask_dir={root / 'pmask'}", f"--cam_dir={root / 'cam'}",
            f"--ckpt_dir={root / 'ckpt'}", f"--out_dir={root / 'refine'}",
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


def _model(root: Path, use_kernel: bool, act_dtype):
    import torch

    from pistoseg_tpu_torch.core.checkpoint import load_rfm
    from pistoseg_tpu_torch.models.rfm import ReviseNet

    sd, _ = load_rfm(root / "ckpt")
    model = ReviseNet(sd["fc8.weight"].shape[0], use_kernel=use_kernel, act_dtype=act_dtype)
    model.load_state_dict(sd)
    return model.to(torch.device("cuda")).eval()


def check_forward(root: Path) -> None:
    """The refined maps of the kernel path agree with the plain einsum
    path on a small input (8 patches, float32), and every output is finite."""
    import torch

    x, pmask, pcam = _device_batch(root, 8)
    outs = {}
    for use_kernel in (True, False):
        with torch.inference_mode():
            outs[use_kernel] = _model(root, use_kernel, torch.float32)(x, pmask, pcam)
    for name, a, b in zip(("cam", "cam_rv", "pmask_rv", "pcam_rv"), outs[True], outs[False]):
        if a.shape != (8, 256, 256, 4) or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: shape {tuple(a.shape)} or non-finite values")
        err = (a - b).abs().max().item()
        log(f"forward {name}: max |kernel path - plain path| = {err:.3e}")
        if not err <= 1e-4:
            raise AssertionError(f"{name}: kernel path disagrees with the plain path")


def breakdown(root: Path, kernel_ms: float) -> None:
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
    model = _model(root, True, torch.bfloat16)
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

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        run = run_stage4b(root)
        kernels["rfm_attention"]["launches"] = run["launches"]
        check_forward(root)
        breakdown(root, kernels["rfm_attention"]["ms"])
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
