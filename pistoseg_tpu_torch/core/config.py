"""Typed configuration tree for the full PistoSeg pipeline.

The reference scatters configuration across three uncoordinated mechanisms
(bash vars in ``run.sh:1-40``, per-script argparse with drifting defaults,
and OEEM YAML files) — surveyed in SURVEY.md §5.6.  Here a single dataclass
tree holds every stage's hyperparameters (reference Appendix A sheet), with
dataset profiles for the two supported datasets and one CLI that can
override any leaf via ``--section.field=value`` dotted flags.

The port's own copy of ``pistoseg_tpu/core/config.py``, field for field,
so that ``Config().to_dict()`` — and with it every manifest's config
hash — is the same in both packages.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, ClassVar, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Dataset profiles
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DatasetProfile:
    """Static facts about one supported dataset.

    Mirrors the ``if args.dataset == 'wsss4luad'`` branches scattered through
    the reference (e.g. ``dataset.py:84-90``, ``infer_pseudo_masks.py:143-150``,
    ``segmentation_module.py:63-66``).
    """

    name: str
    num_classes: int                     # foreground tissue classes
    class_names: Tuple[str, ...]
    # palette as flat RGB triples, indices 0..num_classes (last = background)
    palette: Tuple[int, ...]
    bg_class: int                        # index of the background class
    # filename label grammar: 'bracket-list' = "name-[1, 0, 1].png"
    #                         'digit-string' = "name[1101].png"
    label_grammar: str
    # stage-1 mosaic grid: (tiles per side, tile pixel size)
    mosaic_grid: Tuple[int, int]
    # OEEM CAM generation (configuration_*.yml)
    cam_scales: Tuple[float, ...]
    cam_stride: int
    # ignore_index for stage-2 Dice / stage-5 CE (None = plain loss)
    loss_ignore_index: Optional[int]
    has_background_channel: bool         # WSSS4LUAD computes tissue/bg masks
    # normalization stats (ImageNet default; GlaS ships its own,
    # OEEM/classification/configuration_glas.yml)
    norm_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    norm_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


# Palettes: reference `infer_pseudo_masks.py:143-150`
_WSSS4LUAD_PALETTE = (0, 64, 128, 64, 128, 0, 243, 152, 0, 255, 255, 255)
_BCSS_PALETTE = (255, 0, 0, 0, 255, 0, 0, 0, 255, 153, 0, 255, 255, 255, 255)

DATASET_PROFILES = {
    "wsss4luad": DatasetProfile(
        name="wsss4luad",
        num_classes=3,
        class_names=("TUM", "STR", "NOM"),
        palette=_WSSS4LUAD_PALETTE,
        bg_class=3,
        label_grammar="bracket-list",
        mosaic_grid=(7, 32),             # run.sh:5
        cam_scales=(1.0, 1.25, 1.5, 1.75, 2.0),
        cam_stride=56,
        loss_ignore_index=3,
        has_background_channel=True,
    ),
    "bcss": DatasetProfile(
        name="bcss",
        num_classes=4,
        class_names=("TUM", "STR", "LYM", "NEC"),
        palette=_BCSS_PALETTE,
        bg_class=4,
        label_grammar="digit-string",
        mosaic_grid=(2, 112),            # run-bcss.sh:5
        cam_scales=(1.0,),
        cam_stride=224,
        loss_ignore_index=None,
        has_background_channel=False,
    ),
}
DATASET_PROFILES["glas"] = DatasetProfile(
    name="glas",
    num_classes=2,
    class_names=("GLAND", "NONGLAND"),
    palette=(64, 128, 0, 0, 64, 128),
    bg_class=2,
    label_grammar="digit-string",
    mosaic_grid=(2, 112),
    cam_scales=(1.0, 1.25, 1.5, 1.75, 2.0),
    cam_stride=56,
    loss_ignore_index=None,
    has_background_channel=False,
    norm_mean=(0.787, 0.511, 0.785),
    norm_std=(0.167, 0.248, 0.131),
)

# Alias used by parts of the reference ('bcss-wsss')
DATASET_PROFILES["bcss-wsss"] = DATASET_PROFILES["bcss"]


# ---------------------------------------------------------------------------
# Per-stage configs (hyperparameters from SURVEY.md Appendix A)
# ---------------------------------------------------------------------------


@dataclass
class MeshConfig:
    """Device-mesh layout.  Single axis 'data' covers the reference's needs
    (models ≤ ~50M params → replicated); the axis list is extensible to
    ('data', 'model') for multi-slice without breaking callers."""

    axes: Tuple[str, ...] = ("data",)
    # -1 = use all visible devices on the first axis
    shape: Tuple[int, ...] = (-1,)


@dataclass
class CAMTrainConfig:
    """Stage 0: OEEM multilabel classifier (OEEM/classification/train.py)."""

    batch_size: int = 20
    epochs: int = 20
    test_every: int = 5
    lr: float = 0.01
    weight_decay: float = 1e-4
    momentum: float = 0.9
    poly_power: float = 0.9
    crop_size: int = 224
    rrc_scale: Tuple[float, float] = (0.7, 1.0)
    # mid-epoch resume granularity (0 = end-of-epoch only), as in stage 2
    checkpoint_every_steps: int = 0


@dataclass
class MosaicSynthConfig:
    """Stage 1: mosaic dataset synthesis (create_dataset*.ipynb)."""

    num_images: int = 20000
    patch_size: int = 224
    bg_reject_frac: float = 0.8          # tile rejected if ≥80% background
    quadrant_split_range: Tuple[float, float] = (0.2, 0.8)
    aug_prob: float = 0.8
    seed: int = 2022
    num_workers: int = 8


@dataclass
class TrainStageConfig:
    """Shared shape for supervised training stages (2 and 5)."""

    model: str = "unetplusplus"
    encoder: str = "efficientnet-b0"
    decoder_attention: str = "scse"
    batch_size: int = 16
    epochs: int = 15
    lr: float = 1e-3
    weight_decay: float = 0.05
    lr_decay: float = 0.9                # ExponentialLR gamma per epoch
    patch_size: int = 224
    loss: str = "dice"                   # stage 2: dice, stage 5: ce
    tta: bool = False                    # d4 TTA at final validation
    cutmix: bool = False
    cutmix_prob: float = 0.8
    val_scales: Tuple[float, ...] = (1.0,)
    precision: str = "bf16"              # activations dtype: 'bf16' | 'fp32'
    # train the UNet++ decoder's low-channel columns in the space-to-depth
    # layout (exact math — see unetpp_fast.fast_train_forward).  Default
    # OFF: measured exactly neutral on v5e (PERF.md round-4 negative
    # result — XLA already space-blocks the training convs); kept as a
    # validated lever for hardware with different lane economics.
    s2d_train: bool = False
    # mid-epoch resume granularity: snapshot the full train state every N
    # steps (0 = end-of-epoch only).  SURVEY.md §5.4's TPU-equivalent bar.
    checkpoint_every_steps: int = 0


@dataclass
class ReviseConfig:
    """Stage 4: RFM revise training (revise_pseudo_labels.py)."""

    batch_size: int = 16
    epochs: int = 25
    lr: float = 1e-3
    weight_decay: float = 5e-4
    poly_power: float = 0.9
    momentum: float = 0.9
    # per-group LR multipliers: (pretrained w, pretrained b, scratch w, scratch b)
    lr_multipliers: Tuple[float, float, float, float] = (1.0, 2.0, 10.0, 20.0)
    train_size: int = 224                # revise_pseudo_labels.py:53
    infer_size: int = 256                # infer_revise_masks.py:46
    ecr_topk_frac: float = 0.2
    precision: str = "bf16"
    # fused affinity attention kernel (ops/cuda/rfm_attention.py in the
    # port; the JAX package's Pallas kernel); off = the plain einsum path
    use_pallas: bool = True
    # rematerialize the ResNet38d backbone (trade FLOPs for HBM; enables
    # larger batches through the 4096-channel blocks)
    remat: bool = False
    # mid-epoch resume granularity (0 = end-of-epoch only) — stage 4 is the
    # longest training stage (25 epochs, run.sh:21), so a crash there loses
    # the most work (VERDICT r2 missing #6)
    checkpoint_every_steps: int = 0


@dataclass
class InferConfig:
    """Stage 3 / stage 4b / stage 5-test inference settings."""

    batch_size: int = 64
    tta: bool = True                     # d4 TTA (infer_pseudo_masks.py:96)
    logits_size: int = 32                # 32×32 logits artifact contract
    test_scales: Tuple[float, ...] = (1.0, 1.25, 1.5, 1.75, 2.0)
    patch_size: int = 224
    stride: int = 112


@dataclass
class Config:
    """Root config."""

    dataset: str = "wsss4luad"
    data_root: str = "data"
    log_root: str = "logs"
    seed: int = 42
    mesh: MeshConfig = field(default_factory=MeshConfig)
    cam: CAMTrainConfig = field(default_factory=CAMTrainConfig)
    synth: MosaicSynthConfig = field(default_factory=MosaicSynthConfig)
    mosaic: TrainStageConfig = field(default_factory=TrainStageConfig)
    revise: ReviseConfig = field(default_factory=ReviseConfig)
    seg: TrainStageConfig = field(
        default_factory=lambda: TrainStageConfig(
            encoder="efficientnet-b3", lr=5e-4, loss="ce"
        )
    )
    infer: InferConfig = field(default_factory=InferConfig)

    # set of dotted keys the user explicitly set on the CLI (ClassVar so it
    # is NOT a dataclass field — excluded from to_dict/serialization; an
    # instance assignment shadows it).  Lets consumers distinguish "user
    # asked for the default" from "user said nothing" (stage5_test
    # checkpoint-arch adoption).
    cli_overridden: ClassVar[frozenset] = frozenset()

    @property
    def profile(self) -> DatasetProfile:
        return DATASET_PROFILES[self.dataset]

    # -- CLI / serialization ------------------------------------------------

    def override(self, dotted: str, value: str) -> None:
        """Set a leaf via a dotted path, e.g. 'mosaic.lr', '0.01'."""
        parts = dotted.split(".")
        obj: Any = self
        for p in parts[:-1]:
            if not hasattr(obj, p):
                raise KeyError(f"unknown config field: {dotted}")
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise KeyError(f"unknown config field: {dotted}")
        current = getattr(obj, leaf)
        setattr(obj, leaf, _coerce(value, current))

    @classmethod
    def from_args(cls, argv: Sequence[str]) -> "Config":
        """Parse ``--a.b=c`` style overrides (plus ``--dataset=...``)."""
        cfg = cls()
        overridden = set()
        for arg in argv:
            if not arg.startswith("--"):
                raise ValueError(f"unrecognized argument: {arg}")
            body = arg[2:]
            if "=" not in body:
                raise ValueError(f"expected --key=value, got: {arg}")
            key, value = body.split("=", 1)
            key = key.replace("-", "_")
            cfg.override(key, value)
            overridden.add(key)
        if cfg.dataset not in DATASET_PROFILES:
            raise ValueError(f"unknown dataset: {cfg.dataset}")
        cfg.cli_overridden = frozenset(overridden)
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())


def _coerce(value: str, current: Any) -> Any:
    """Coerce a CLI string to the type of the current value."""
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        items = [v for v in value.strip("()[] ").split(",") if v.strip()]
        elem = current[0] if current else ""
        return tuple(_coerce(v.strip(), elem) for v in items)
    if current is None:
        lowered = value.lower()
        if lowered in ("none", "null"):
            return None
        try:
            return int(value)
        except ValueError:
            try:
                return float(value)
            except ValueError:
                return value
    return value
