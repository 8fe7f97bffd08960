"""The port's host and tensor ops against the JAX package, its import
boundary, its device policy, and stage 4b end to end.

Inputs are made with numpy from a seed and fed to both packages.  The
resize and normalisation tolerances (1e-5) cover float32 matmuls summed
in different orders; everything integer-valued must be equal.

Stage 4b shares this file, the one with the most tests, because
pytest-xdist's ``--dist loadfile`` starts files in descending order of
their test count.  Its two transient full-width checkpoints (~0.4 GB
each) are then written at the start of a run, not at its end, where the
JAX heavy tests' retained temp dirs (~20 GB) can fill a small disk.
"""

import ast
import shutil
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pistoseg_tpu.core.checkpoint import CheckpointManager
from pistoseg_tpu.core.config import Config as JaxConfig
from pistoseg_tpu.core.manifest import check_upstream
from pistoseg_tpu.data.labels import parse_label as jax_parse_label
from pistoseg_tpu.models.rfm import ReviseNet as JaxReviseNet
from pistoseg_tpu.ops.augment import normalize as jax_normalize
from pistoseg_tpu.ops.background import extract_background as jax_extract_background
from pistoseg_tpu.ops.palette import decode_palette_png
from pistoseg_tpu.ops.resize import resize as jax_resize
from pistoseg_tpu.ops.resize import resize_palette_pil as jax_resize_palette_pil
from pistoseg_tpu.stages.stage4b_infer_revise import infer_stage4b as jax_infer_stage4b
from pistoseg_tpu_torch.core.checkpoint import load_rfm, save_rfm
from pistoseg_tpu_torch.core.config import Config
from pistoseg_tpu_torch.data.labels import parse_label
from pistoseg_tpu_torch.data.loader import BatchLoader
from pistoseg_tpu_torch.models.weights import state_dict_from_flax
from pistoseg_tpu_torch.ops.augment import imagenet_normalize, normalize
from pistoseg_tpu_torch.ops.background import extract_background
from pistoseg_tpu_torch.ops.cuda.rfm_attention import rfm_attention
from pistoseg_tpu_torch.ops.resize import resize, resize_palette_pil
from pistoseg_tpu_torch.stages.common import parse_cli, resolve_device
from pistoseg_tpu_torch.stages.stage4b_infer_revise import infer_stage4b

from util_synthetic import make_stage4_artifacts, make_training_patches

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("method", ["linear_align_corners", "linear"])
@pytest.mark.parametrize("in_hw,out_hw", [((8, 8), (64, 64)), ((37, 23), (32, 32)),
                                          ((32, 32), (17, 40))])
def test_resize_matches_jax(method, in_hw, out_hw):
    rng = np.random.RandomState(0)
    x = rng.randn(2, *in_hw, 5).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), out_hw, method=method))
    got_nhwc = resize(torch.from_numpy(x), out_hw, method=method).numpy()
    np.testing.assert_allclose(got_nhwc, ref, atol=1e-5, rtol=1e-5)
    # NCHW maps through the (..., H, W) route give the same numbers
    got_nchw = resize(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw,
                      method=method, channel_last=False)
    np.testing.assert_allclose(got_nchw.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("out_hw", [(256, 256), (203, 297), (31, 17)])
def test_resize_palette_pil_matches_jax(out_hw):
    mask = np.random.RandomState(1).randint(0, 4, (32, 32)).astype(np.uint8)
    np.testing.assert_array_equal(resize_palette_pil(mask, out_hw),
                                  jax_resize_palette_pil(mask, out_hw))


def test_normalize_matches_jax():
    x = np.random.RandomState(2).randint(0, 256, (2, 9, 7, 3)).astype(np.float32)
    ref = np.asarray(jax_normalize(jnp.asarray(x)))
    np.testing.assert_allclose(imagenet_normalize(torch.from_numpy(x)).numpy(), ref,
                               atol=1e-5, rtol=1e-5)
    stats = dict(mean=(0.787, 0.511, 0.785), std=(0.167, 0.248, 0.131))
    np.testing.assert_allclose(normalize(torch.from_numpy(x), **stats).numpy(),
                               np.asarray(jax_normalize(jnp.asarray(x), **stats)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,grammar", [
    ("p01-[1, 0, 1].png", "bracket-list"),
    ("/data/x/7_1.0_0_224-[0, 1, 0].png", "bracket-list"),
    ("TCGA-A1-x[1101].png", "digit-string"),
])
def test_parse_label_matches_jax(name, grammar):
    assert parse_label(name, grammar) == jax_parse_label(name, grammar)


def test_extract_background_matches_jax():
    rng = np.random.RandomState(3)
    rgb = rng.randint(0, 200, (64, 48, 3)).astype(np.uint8)
    rgb[5:20, 5:30] = 255                      # kept: a large bright region
    rgb[40:44, 40:44] = 250                    # dropped: 16 px < min_size
    got = extract_background(rgb)
    np.testing.assert_array_equal(got, jax_extract_background(rgb))
    assert got[10, 10] == 255 and got[41, 41] == 0


def test_config_to_dict_matches_jax():
    """Every field is copied, so manifests hash the same config."""
    assert Config().to_dict() == JaxConfig().to_dict()
    cfg, extras = parse_cli(["--dataset=bcss", "--revise.infer_size=32",
                             "--device=cpu", "--ckpt_dir=/x"])
    assert cfg.revise.infer_size == 32 and cfg.profile.num_classes == 4
    assert extras == {"device": "cpu", "ckpt_dir": "/x"}


def test_batch_loader_pads_last_batch_and_flags_valid():
    class Items:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return {"x": np.full((2,), i, np.float32), "name": f"n{i}"}

    batches = list(BatchLoader(Items(), 2, num_workers=2).epoch(0))
    assert [b["valid"].tolist() for b in batches] == [[True, True], [True, True],
                                                      [True, False]]
    assert batches[-1]["name"] == ["n4", "n4"]
    np.testing.assert_array_equal(np.concatenate([b["x"][:, 0] for b in batches]),
                                  [0, 1, 2, 3, 4, 4])


def test_checkpoint_roundtrip(tmp_path):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "b.running_var": torch.ones(3)}
    save_rfm(tmp_path, sd, epoch=3, extra={"note": "x"})
    got, meta = load_rfm(tmp_path)
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    assert meta["epoch"] == 3 and meta["note"] == "x"
    with pytest.raises(FileNotFoundError):
        load_rfm(tmp_path / "missing")


_FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "pistoseg_tpu")


def _port_sources():
    return sorted((REPO / "pistoseg_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in _FORBIDDEN, f"{path}: imports {mod}"


def test_cuda_requested_without_card_raises(monkeypatch, tmp_path):
    """No silent CPU fallback: the entry point refuses before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer_stage4b(Config(), str(tmp_path), str(tmp_path), str(tmp_path),
                      str(tmp_path), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


_FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: copies the source to the -o path, fails on FAIL
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  src="$1"; shift
done
if grep -q FAIL "$src"; then echo "error: FAIL in $src"; exit 2; fi
echo "ptxas info: built $src"; cp "$src" "$out"
"""


def test_kernel_build_is_keyed_by_source_and_reports_failures(monkeypatch, tmp_path):
    """The build drives one compiler per source, caches by content hash,
    and raises with the compiler's output (a stand-in nvcc: there is
    none on this host)."""
    from pistoseg_tpu_torch.ops.cuda import build

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")

    assert build.kernel_sources() == ["a", "b"]
    logs = build.build(["a", "b"])
    assert set(logs) == {"a", "b"} and "ptxas info" in logs["a"]
    assert build.library_path("a").read_text() == "// a\n"
    assert build.build(["a", "b"]) == {}                 # cached: nothing rebuilt
    (csrc / "a.cu").write_text("// a, edited\n")
    assert set(build.build(["a", "b"])) == {"a"}         # new hash, new library
    (csrc / "b.cu").write_text("FAIL\n")
    with pytest.raises(RuntimeError, match="error: FAIL"):
        build.build(["b"])
    assert not list((tmp_path / "build").glob("*.tmp"))


# Stage 4b end to end: the port against the JAX package on one checkpoint.
#
# A JAX-initialised ReviseNet is saved as the JAX package's Orbax
# checkpoint ``rfm``, carried across into the port's ``rfm.pt`` with
# ``state_dict_from_flax``, and both stages run on the same synthetic
# WSSS4LUAD patches at a 32² inference size in float32.  The palette PNGs
# must agree on at least 99.9% of pixels: the two forwards differ by
# float32 summation order, so only near-ties of the foreground argmax may
# flip (subnormals are flushed on both sides, see the fixture).  The
# port's manifest must satisfy the JAX package's ``check_upstream``, so
# the JAX stage 5 would accept its output.

def _configure(cfg):
    cfg.mesh.shape = (1,)
    cfg.revise.infer_size = 32
    cfg.revise.precision = "fp32"
    cfg.infer.batch_size = 4          # 6 patches: one full batch, one padded
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("s4b")
    train, pmask, cam = root / "train", root / "pmask", root / "cam"
    make_training_patches(train, "wsss4luad", n_per_class=2, size=64)
    make_stage4_artifacts(train, pmask, cam)

    model = JaxReviseNet(num_classes=4, use_pallas=True)
    x = jnp.zeros((1, 32, 32, 3))
    m = jnp.zeros((1, 4, 4, 4))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x, m, m)
    jax_ckpt = root / "jax_ckpt"
    mgr = CheckpointManager(jax_ckpt, async_writes=False)
    mgr.save("rfm", {"params": variables["params"],
                     "batch_stats": variables["batch_stats"]})
    tree = mgr.restore("rfm")
    state_dict = state_dict_from_flax(tree["params"], tree["batch_stats"])

    # each checkpoint holds the full-width ReviseNet (~0.4 GB): the weights
    # are deleted as soon as their stage has read them; the manifests hash
    # only rfm.meta.json, which stays
    args = (str(train), str(pmask), str(cam))
    jax_res = jax_infer_stage4b(_configure(JaxConfig()), *args, str(jax_ckpt),
                                out_dir=str(root / "jax_refine"), trust_inputs=True)
    shutil.rmtree(jax_ckpt / "rfm")
    port_ckpt = root / "port_ckpt"
    save_rfm(port_ckpt, state_dict, extra={"from": "jax rfm"})
    launches = rfm_attention.launches
    # XLA:CPU flushes subnormals to zero.  Where a refined map is ~0 on
    # every foreground class, the argmax then sees exact-zero ties on the
    # JAX side but ~1e-39 subnormals on the port's, and the tie breaks
    # differently; flushing them here compares like with like.
    assert torch.set_flush_denormal(True)
    try:
        port_res = infer_stage4b(_configure(Config()), *args, str(port_ckpt),
                                 out_dir=str(root / "port_refine"),
                                 trust_inputs=True, device="cpu")
    finally:
        torch.set_flush_denormal(False)
        (port_ckpt / "rfm.pt").unlink()
    return {"root": root, "jax": jax_res, "port": port_res,
            "launches": rfm_attention.launches - launches}


def test_port_stage4b_matches_jax(runs):
    root = runs["root"]
    assert runs["jax"]["patches"] == runs["port"]["patches"] == 6
    agree = total = 0
    for sub in ("pmask", "pcam", "cam"):
        jax_pngs = sorted((root / "jax_refine" / sub).glob("*.png"))
        port_pngs = sorted((root / "port_refine" / sub).glob("*.png"))
        assert [p.name for p in port_pngs] == [p.name for p in jax_pngs]
        assert len(port_pngs) == 6
        for pj, pp in zip(jax_pngs, port_pngs):
            a, b = decode_palette_png(pj), decode_palette_png(pp)
            assert b.shape == a.shape == (64, 64)          # native size
            assert set(np.unique(b)) <= {0, 1, 2, 3}       # fg classes + bg
            agree += int((a == b).sum())
            total += a.size
    assert agree / total >= 0.999, f"pixel agreement {agree / total:.5f}"
    # on the CPU the wrapper takes its plain version: no kernel launches
    assert runs["launches"] == 0


def test_port_manifest_accepted_by_jax(runs):
    out = Path(runs["port"]["out_dir"])
    doc = check_upstream(out / "cam", "stage4b", what="refine/cam")
    jax_doc = check_upstream(Path(runs["jax"]["out_dir"]), "stage4b")
    assert doc["outputs"] == {"patches": 6}
    assert doc["config_hash"] == jax_doc["config_hash"]
    for key in ("train_data", "pmask", "cam", "limit"):
        assert doc["inputs"][key] == jax_doc["inputs"][key]


def test_port_stage4b_rerun_skips(runs):
    root = runs["root"]
    res = infer_stage4b(_configure(Config()), str(root / "train"), str(root / "pmask"),
                        str(root / "cam"), str(root / "port_ckpt"),
                        out_dir=str(root / "port_refine"), trust_inputs=True,
                        device="cpu")
    assert res.get("skipped") is True
