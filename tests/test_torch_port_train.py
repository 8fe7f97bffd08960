"""The port's stage-4 training slice against the JAX package, on the CPU.

Inputs are made from numpy seeds and handed to both packages; everything
runs in float32 with TF32 off (the CPU has none).  Tolerances:

* losses: 1e-5 (the same float32 formulas, reductions in another order);
* the attention backward: atol 1e-4, as the JAX package's own kernel
  tests (``tests/test_pallas_kernels.py``);
* the optimizer: 1e-6 after 5 steps (the same update, rounded per step);
* one train step of the full-width ReviseNet at 64²: loss parts 1e-4
  relative; the heads' gradients 1e-3 relative Frobenius error, the
  trunk convs' 5e-3; the parameters after the update 1e-5.  The trunk's
  bound is wider because a ReLU input within float32 rounding of 0 can
  take the other side in either package: at 8×8 × 4096 channels one such
  flip before bn7's ReLU moves every b7 gradient by ~1.5e-3, and a float64
  run of the port puts the JAX package's own float32 b3 gradient 6.6e-4
  away and the port's 1.4e-3.

Dropout is off on both sides for the step's parity (JAX ``train=False``,
the port all-ones masks): the two packages draw different random bits.
The step's inputs avoid ties, where both packages are right and differ:
at equal values ``top_k`` and ``topk`` pick different pixels, and at 0
the derivative of |x| is +1 in JAX and 0 in PyTorch (the reference's
convention, which the port keeps).  So every class is the maximum of the
pseudo-mask and CAM somewhere (no refined map is exactly 0), and the
affinity projections are scaled down so the refined maps are not
piecewise constant.
The stage itself runs on a tiny synthetic set; its checkpoints hold the
full-width model (~1.3 GB together) and are deleted as soon as read.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from pistoseg_tpu.losses import revise as jax_revise
from pistoseg_tpu.models.rfm import ReviseNet as JaxReviseNet
from pistoseg_tpu.ops.augment import imagenet_normalize as jax_imagenet_normalize
from pistoseg_tpu.ops.pallas.rfm_attention import _rfm_attention_reference, _rfm_bwd
from pistoseg_tpu.stages import stage4_revise as jax_stage4
from pistoseg_tpu.train.optim import RFM_MULTIPLIERS as JAX_RFM_MULTIPLIERS
from pistoseg_tpu.train.optim import poly_sgd_grouped as jax_poly_sgd_grouped
from pistoseg_tpu.train.optim import rfm_group_fn as jax_rfm_group_fn
from pistoseg_tpu_torch.core.checkpoint import load_rfm
from pistoseg_tpu_torch.core.config import Config
from pistoseg_tpu_torch.core.prng import stage_generator
from pistoseg_tpu_torch.data.loader import BatchLoader
from pistoseg_tpu_torch.losses import revise
from pistoseg_tpu_torch.models.resnet38d import spatial_dropout_masks
from pistoseg_tpu_torch.models.rfm import ReviseNet
from pistoseg_tpu_torch.models.weights import state_dict_from_flax
from pistoseg_tpu_torch.ops.cuda.rfm_attention import (
    rfm_attention,
    rfm_attention_backward,
    rfm_attention_backward_reference,
    rfm_attention_reference,
)
from pistoseg_tpu_torch.stages import stage4_revise
from pistoseg_tpu_torch.stages.stage4b_infer_revise import infer_stage4b
from pistoseg_tpu_torch.train.optim import (
    RFM_MULTIPLIERS,
    poly_lr,
    poly_sgd_grouped,
    rfm_group_fn,
)
from pistoseg_tpu_torch.train.state import TrainState

from util_synthetic import make_stage4_artifacts, make_training_patches


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- (a) the loss stack ----------------------------------------------------

def _loss_inputs(c, seed=0, n=2, hw=16):
    rs = np.random.RandomState(seed)
    maps = [rs.randn(n, hw, hw, c).astype(np.float32) for _ in range(4)]
    ups = [rs.rand(n, hw, hw, c).astype(np.float32) for _ in range(2)]
    label = rs.randint(0, 2, (n, c)).astype(np.float32)
    label[:, 0] = 1.0                                   # bg_score
    label[np.arange(n), 1 + rs.randint(0, c - 1, n)] = 1.0  # >= 1 foreground
    return maps, ups, label


_LOSS_CASES = {
    "multilabel_soft_margin_loss": lambda m, u, l, mod: mod.multilabel_soft_margin_loss(
        m[0].mean(axis=(1, 2))[:, 1:], l[:, 1:]),
    "adaptive_min_pooling_loss": lambda m, u, l, mod: mod.adaptive_min_pooling_loss(
        (m[1] * l[:, None, None, :])[..., 1:]),
    "max_norm": lambda m, u, l, mod: mod.max_norm(m[2]),
    "max_onehot": lambda m, u, l, mod: mod.max_onehot(m[3]),
    "ecr_loss": lambda m, u, l, mod: mod.ecr_loss(u[0], u[1], m[2], m[3]),
    "rfm_l1_loss": lambda m, u, l, mod: mod.rfm_l1_loss(m[2], m[3]),
}


@pytest.mark.parametrize("c", [4, 5])
@pytest.mark.parametrize("name", sorted(_LOSS_CASES))
def test_loss_matches_jax(name, c):
    maps, ups, label = _loss_inputs(c)
    fn = _LOSS_CASES[name]
    want = fn([jnp.asarray(m) for m in maps], [jnp.asarray(u) for u in ups],
              jnp.asarray(label), jax_revise)
    got = fn([_t(m) for m in maps], [_t(u) for u in ups], _t(label), revise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [4, 5])
def test_revise_losses_and_grads_match_jax(c):
    """The total, its parts and its gradients in the four model outputs;
    C = 5 checks that the ECR top-k keeps the reference's hard-coded 4."""
    maps, ups, label = _loss_inputs(c, seed=1)

    def jax_total(*m):
        return jax_revise.revise_losses(*m, *(jnp.asarray(u) for u in ups),
                                        jnp.asarray(label))

    (want, want_parts), want_grads = jax.value_and_grad(
        jax_total, argnums=(0, 1, 2, 3), has_aux=True)(*(jnp.asarray(m) for m in maps))
    leaves = [_t(m).requires_grad_() for m in maps]
    got, parts = revise.revise_losses(*leaves, *(_t(u) for u in ups), _t(label))
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for key in ("loss_cls", "loss_rfm", "loss_ecr"):
        np.testing.assert_allclose(parts[key].item(), float(want_parts[key]), rtol=1e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


# --- (b) the attention backward --------------------------------------------

def _attention_inputs(l, c, seed, n=2, d=32):
    rs = np.random.RandomState(seed)
    q, k = (rs.randn(n, l, d).astype(np.float32) for _ in range(2))
    v, g = (rs.randn(n, l, c).astype(np.float32) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("c", [4, 12, 15])
@pytest.mark.parametrize("l", [49, 100, 128])
def test_backward_reference_matches_jax(l, c):
    q, k, v, g = _attention_inputs(l, c, seed=l + c)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    bwd = _rfm_bwd(None, (jq, jk, jv), jg)
    auto = jax.grad(lambda *a: jnp.sum(_rfm_attention_reference(*a) * jg),
                    argnums=(0, 1, 2))(jq, jk, jv)
    got = rfm_attention_backward_reference(*(_t(a) for a in (q, k, v, g)))
    for name, a, b, w in zip(("dq", "dk", "dv"), got, bwd, auto):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4, err_msg=name)


def test_autograd_function_on_cpu_takes_plain_versions():
    """Gradients through ``rfm_attention`` equal autograd through the plain
    forward; on the CPU neither kernel is launched."""
    q, k, v, g = (_t(a) for a in _attention_inputs(100, 12, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = rfm_attention.launches, rfm_attention_backward.launches
    grads = torch.autograd.grad(rfm_attention(*leaves), leaves, g)
    assert (rfm_attention.launches, rfm_attention_backward.launches) == (fwd, bwd)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(rfm_attention_reference(*ref), ref, g)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


# --- (c) the optimizer -----------------------------------------------------

_PARAM_PATHS = {   # flax path → shape: one leaf of every group the stage has
    ("backbone", "conv1a", "kernel"): (3, 3, 3, 8),
    ("backbone", "b2", "conv_branch2a", "kernel"): (3, 3, 8, 8),
    ("backbone", "b3", "conv_branch2a", "kernel"): (3, 3, 8, 4),
    ("backbone", "b3", "bn_branch2a", "bn", "scale"): (8,),
    ("backbone", "b3", "bn_branch2a", "bn", "bias"): (8,),
    ("backbone", "b7", "conv_branch2b1", "kernel"): (3, 3, 4, 4),
    ("fc8", "kernel"): (1, 1, 4, 3),
    ("f9_1", "kernel"): (1, 1, 5, 6),
}


def _nest(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = val
    return tree


def _bridged_name(path, leaf):
    """The port's name of one flax leaf, through ``state_dict_from_flax``."""
    (name,) = state_dict_from_flax(_nest({path: np.asarray(leaf)}), {})
    return name


def test_group_labels_match_jax_on_bridged_names(jax_case):
    flat = jax.tree_util.tree_flatten_with_path(jax_case["variables"]["params"])[0]
    assert len(flat) == len(dict(ReviseNet(4).named_parameters()))
    for path, leaf in flat:
        keys = tuple(str(p.key) for p in path)
        assert rfm_group_fn(_bridged_name(keys, leaf)) == jax_rfm_group_fn("/".join(keys)), keys


def test_poly_sgd_grouped_matches_optax():
    rs = np.random.RandomState(5)
    params = {p: rs.randn(*s).astype(np.float32) for p, s in _PARAM_PATHS.items()}
    grads = [{p: rs.randn(*s).astype(np.float32) for p, s in _PARAM_PATHS.items()}
             for _ in range(5)]
    lr, max_step, wd = 1e-2, 8, 5e-4

    tx = jax_poly_sgd_grouped(lr, max_step, jax_rfm_group_fn, JAX_RFM_MULTIPLIERS,
                              weight_decay=wd)
    jparams = _nest({p: jnp.asarray(v) for p, v in params.items()})
    opt_state = tx.init(jparams)
    for g in grads:
        updates, opt_state = tx.update(_nest({p: jnp.asarray(v) for p, v in g.items()}),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    names = {p: _bridged_name(p, v) for p, v in params.items()}
    tparams = {p: torch.nn.Parameter(torch.from_numpy(
        state_dict_from_flax(_nest({p: v}), {})[names[p]].numpy())) for p, v in params.items()}
    opt = poly_sgd_grouped(((names[p], t) for p, t in tparams.items()), lr, max_step,
                           rfm_group_fn, RFM_MULTIPLIERS, weight_decay=wd)
    state = TrainState(torch.nn.Module(), opt)
    for g in grads:
        for p, t in tparams.items():
            if t.requires_grad:
                t.grad = state_dict_from_flax(_nest({p: g[p]}), {})[names[p]]
        state.apply_gradients()
    assert state.step == 5
    for p, t in tparams.items():
        want = state_dict_from_flax(_nest({p: np.asarray(_get(jparams, p))}), {})[names[p]]
        np.testing.assert_allclose(t.detach().numpy(), want.numpy(), atol=1e-6, err_msg=str(p))
        if rfm_group_fn(names[p]) == "frozen":
            assert not t.requires_grad
            np.testing.assert_array_equal(t.detach().numpy(), state_dict_from_flax(
                _nest({p: params[p]}), {})[names[p]].numpy())


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def test_poly_lr_counts_steps_from_zero():
    assert poly_lr(1e-3, 0, 10, 0.9) == 1e-3
    assert poly_lr(1e-3, 10, 10, 0.9) == 0.0
    assert poly_lr(1e-3, 20, 10, 0.9) == 0.0
    np.testing.assert_allclose(poly_lr(1e-3, 5, 10, 0.9), 1e-3 * 0.5 ** 0.9)


# --- (d) one train step of the whole slice -----------------------------------

N_CH = 4


def _randomize(variables, rs):
    """Seeded BN statistics and affine parameters, so BN does something."""
    def leaf(path, v):
        name = str(path[-1].key)
        if name == "mean":
            return rs.randn(*v.shape).astype(np.float32) * 0.1
        if name == "var":
            return rs.rand(*v.shape).astype(np.float32) + 0.5
        if name == "scale":
            return 1.0 + 0.1 * rs.randn(*v.shape).astype(np.float32)
        if name == "bias" and v.ndim == 1:
            return 0.1 * rs.randn(*v.shape).astype(np.float32)
        return np.asarray(v)
    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def jax_case():
    """A full-width JAX ReviseNet with non-trivial BN, a 64² batch of 2
    (every label with a foreground class), and the JAX package's loss,
    gradients and one grouped-PolySGD update on it."""
    rs = np.random.RandomState(7)
    label = np.array([[1, 0, 1], [0, 1, 0]], np.float32)
    # each class the per-pixel maximum on a band of columns, so that no
    # channel of the normalised maps is zero everywhere
    band = (np.arange(32)[None, :, None] * 3 // 32 == np.arange(3)).astype(np.float32)
    batch = {
        "image": rs.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32),
        "pmask": (2.0 * band + rs.randn(2, 32, 32, 3)).astype(np.float32),
        "cam": (band + 0.5 * rs.rand(2, 32, 32, 3)).astype(np.float32),
        "label": label,
        "valid": np.array([True, True]),
    }
    model = JaxReviseNet(num_classes=N_CH, use_pallas=True)
    m = jnp.zeros((1, 32, 32, N_CH))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), m, m)
    variables = _randomize(jax.tree_util.tree_map(np.asarray, variables), rs)
    # a soft affinity: at full gain the random projections give one-hot
    # columns, the refined maps turn piecewise constant, and their ties
    # send the top-k gradients to different pixels in the two packages
    for head in ("f9_1", "f9_2"):
        variables["params"][head]["kernel"] = variables["params"][head]["kernel"] * 0.05

    def loss_fn(params):
        # the composition of the JAX package's build_loss_fn, with dropout off
        pmask, pcam, lbl = jax_stage4.prepare_batch(batch)
        x = jax_imagenet_normalize(jnp.asarray(batch["image"]))
        outs = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           x, pmask, pcam, train=False)
        pmask_up, pcam_up = jax_stage4.ecr_inputs(pmask, pcam, lbl, (64, 64))
        lbl = lbl * jnp.asarray(batch["valid"]).astype(jnp.float32)[:, None]
        total, parts = jax_revise.revise_losses(*outs, pmask_up, pcam_up, lbl)
        return total, parts

    (loss, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    tx = jax_poly_sgd_grouped(1e-3, 10, jax_rfm_group_fn, JAX_RFM_MULTIPLIERS,
                              weight_decay=5e-4)
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    stepped = optax.apply_updates(variables["params"], updates)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"batch": batch, "variables": variables,
            "parts": {k: float(v) for k, v in parts.items()},
            "grads": state_dict_from_flax(to_np(grads), {}),
            "stepped": state_dict_from_flax(to_np(stepped), to_np(variables["batch_stats"]))}


@pytest.fixture(scope="module")
def port_step(jax_case):
    """The port's build_loss_fn, backward and grouped update on the same
    weights and batch, with all-ones dropout masks."""
    sd = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jax_case["variables"]["params"]),
        jax.tree_util.tree_map(np.asarray, jax_case["variables"]["batch_stats"]))
    model = ReviseNet(N_CH, use_kernel=True)
    model.load_state_dict(sd)
    opt = poly_sgd_grouped(model.named_parameters(), 1e-3, 10, rfm_group_fn,
                           RFM_MULTIPLIERS, weight_decay=5e-4)
    state = TrainState(model, opt)
    gen = torch.Generator().manual_seed(0)
    drawn = spatial_dropout_masks(model.dropout_sites(), 2, gen)
    ones = {k: torch.ones_like(v) for k, v in drawn.items()}
    loss_fn = stage4_revise.build_loss_fn(64, 0.2, torch.device("cpu"))
    mp = pytest.MonkeyPatch()
    mp.setattr(stage4_revise, "spatial_dropout_masks", lambda sites, n, g: ones)
    try:
        total, parts = loss_fn(model, jax_case["batch"], gen)
    finally:
        mp.undo()
    total.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    state.apply_gradients()
    return {"total": total.item(), "parts": {k: v.item() for k, v in parts.items()},
            "grads": grads, "stepped": model.state_dict()}


def test_train_step_loss_parts_match_jax(jax_case, port_step):
    for key in ("loss_cls", "loss_rfm", "loss_ecr"):
        np.testing.assert_allclose(port_step["parts"][key], jax_case["parts"][key],
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(port_step["total"], jax_case["parts"]["loss"], rtol=1e-4)


@pytest.mark.parametrize("name,tol", [
    ("fc8.weight", 1e-3), ("f8_3.weight", 1e-3), ("f8_4.weight", 1e-3),
    ("f9_1.weight", 1e-3), ("f9_2.weight", 1e-3),
    ("b3.conv_branch2a.weight", 5e-3), ("b7.conv_branch2b1.weight", 5e-3),
])
def test_train_step_grads_match_jax(jax_case, port_step, name, tol):
    got, want = port_step["grads"][name], jax_case["grads"][name]
    assert float(want.norm()) > 0
    rel = float((got - want).norm() / want.norm())
    assert rel <= tol, f"{name}: relative Frobenius error {rel:.2e}"


def test_train_step_update_matches_jax(jax_case, port_step):
    """Every parameter after the update; frozen ones (BN, conv1a, b2*)
    got no gradient and did not move."""
    frozen = 0
    for name, want in jax_case["stepped"].items():
        got = port_step["stepped"][name]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, err_msg=name)
        if rfm_group_fn(name) == "frozen" and not name.endswith(("running_mean", "running_var")):
            assert name not in port_step["grads"]
            frozen += 1
    assert frozen > 0 and "b2.conv_branch2a.weight" not in port_step["grads"]


# --- (e) the stage end to end -------------------------------------------------

def _stage_cfg():
    cfg = Config()
    cfg.revise.train_size = 64
    cfg.revise.batch_size = 2
    cfg.revise.epochs = 1
    cfg.revise.precision = "fp32"
    cfg.revise.checkpoint_every_steps = 1
    cfg.revise.infer_size = 32
    cfg.infer.batch_size = 4
    return cfg


@pytest.fixture(scope="module")
def stage_runs(tmp_path_factory):
    """An uninterrupted 2-step run, read back by the port's stage 4b, and
    a run cut after 1 step then resumed; only the final weights are kept."""
    root = tmp_path_factory.mktemp("s4")
    data = [root / "train", root / "pmask", root / "cam"]
    make_training_patches(data[0], "wsss4luad", n_per_class=2, size=64)
    make_stage4_artifacts(*data)
    args = [str(p) for p in data]

    # the uninterrupted run goes through the CLI, as a user starts it
    full = stage4_revise.main([
        "--dataset=wsss4luad", f"--train_data={args[0]}", f"--pmask_dir={args[1]}",
        f"--cam_dir={args[2]}", f"--log_dir={root / 'full'}", "--max_steps_per_epoch=2",
        "--revise.train_size=64", "--revise.batch_size=2", "--revise.epochs=1",
        "--revise.precision=fp32", "--revise.checkpoint_every_steps=1",
        "--trust_inputs=true", "--device=cpu"])
    ckpt = Path(full["checkpoint_dir"])
    refine = infer_stage4b(_stage_cfg(), *args, str(ckpt), out_dir=str(root / "refine"),
                           limit=4, trust_inputs=True, device="cpu")
    full_sd, full_meta = load_rfm(ckpt)
    shutil.rmtree(ckpt)

    orig_epoch = BatchLoader.epoch

    def crashing_epoch(self, ep):
        gen = orig_epoch(self, ep)

        def g():
            yield next(gen)
            raise RuntimeError("simulated crash")

        return g()

    mp = pytest.MonkeyPatch()
    mp.setattr(BatchLoader, "epoch", crashing_epoch)
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            stage4_revise.train_stage4(_stage_cfg(), *args, log_dir=str(root / "cut"),
                                       max_steps_per_epoch=2, trust_inputs=True,
                                       device="cpu")
    finally:
        mp.undo()
    cut_ckpt = root / "cut" / "checkpoints"
    cut_files = sorted(p.name for p in cut_ckpt.iterdir())
    resumed = stage4_revise.train_stage4(_stage_cfg(), *args, log_dir=str(root / "cut"),
                                         max_steps_per_epoch=2, trust_inputs=True,
                                         resume=True, device="cpu")
    resumed_sd, _ = load_rfm(cut_ckpt)
    shutil.rmtree(cut_ckpt)
    return {"root": root, "full": full, "full_sd": full_sd, "full_meta": full_meta,
            "refine": refine, "cut_files": cut_files, "resumed": resumed,
            "resumed_sd": resumed_sd}


def test_stage4_trains_and_stage4b_reads_its_checkpoint(stage_runs):
    (row,) = stage_runs["full"]["logs"]
    assert row["epoch"] == 0 and row["steps"] == 2 and np.isfinite(row["train_loss"])
    for key in ("epoch_seconds", "compile_seconds", "step_ms_p50", "items_per_sec"):
        assert row[key] > 0, key
    assert stage_runs["full_meta"]["stage"] == "stage4"
    assert stage_runs["refine"]["patches"] == 4
    for sub in ("pmask", "pcam", "cam"):
        assert len(list((stage_runs["root"] / "refine" / sub).glob("*.png"))) == 4
    csv = (stage_runs["root"] / "full" / "stage4_metrics.csv").read_text().splitlines()
    assert len(csv) == 2 and "train_loss" in csv[0]


def test_stage4_froze_bn_conv1a_and_b2(stage_runs):
    """Frozen parameters are bit-identical to the seeded initialisation;
    every other parameter moved."""
    init = stage4_revise.init_model(_stage_cfg())
    trained = stage_runs["full_sd"]
    for name, p in init.named_parameters():
        if rfm_group_fn(name) == "frozen":
            assert torch.equal(trained[name], p.detach()), name
        else:
            assert not torch.equal(trained[name], p.detach()), name


def test_stage4_resume_after_cut_is_bit_identical(stage_runs):
    assert stage_runs["cut_files"] == ["train_state.meta.json", "train_state.pt"]
    (row,) = stage_runs["resumed"]["logs"]
    assert row["steps"] == 1
    full, resumed = stage_runs["full_sd"], stage_runs["resumed_sd"]
    assert full.keys() == resumed.keys()
    for name in full:
        assert torch.equal(full[name], resumed[name]), name


def test_dropout_masks_are_keyed_by_seed_epoch_step():
    sites = ReviseNet(N_CH).dropout_sites()
    assert sites == {"b6.0": (512, 0.3), "b6.1": (1024, 0.3), "b7.0": (1024, 0.5),
                     "b7.1": (2048, 0.5), "dropout7": (4096, 0.5)}

    def draw(seed, epoch, step):
        return spatial_dropout_masks(sites, 16, stage_generator(seed, "stage4/train",
                                                                epoch, step))

    a, b = draw(42, 1, 3), draw(42, 1, 3)
    assert all(torch.equal(a[k], b[k]) for k in sites)
    for other in (draw(42, 1, 4), draw(42, 2, 3), draw(43, 1, 3)):
        assert not torch.equal(a["dropout7"], other["dropout7"])
    for k, (channels, rate) in sites.items():
        assert a[k].shape == (16, channels, 1, 1)
        assert set(a[k].unique().tolist()) <= {0.0, np.float32(1.0 / (1.0 - rate)).item()}
        kept = (a[k] > 0).float().mean().item()
        assert abs(kept - (1.0 - rate)) < 0.05, k


def test_masks_drop_channels_in_the_trunk():
    """A mask that drops every channel of b7's last site leaves b7's
    output equal to its shortcut branch."""
    block = ReviseNet(N_CH).b7
    x = torch.randn(1, 2048, 4, 4)
    zeros = torch.zeros(1, 2048, 1, 1)
    out, _ = block(x, None, zeros)
    shortcut = block.conv_branch1(torch.relu(block.bn_branch2a(x)))
    torch.testing.assert_close(out, shortcut)


def test_stage4_runs_on_the_card_unless_told_otherwise(monkeypatch, tmp_path):
    """No silent CPU fallback: without a card the default device raises
    before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stage4_revise.main([f"--train_data={tmp_path}", f"--pmask_dir={tmp_path}",
                            f"--cam_dir={tmp_path}", f"--log_dir={tmp_path / 'log'}"])
    assert not (tmp_path / "log").exists()


def test_stage4_refuses_stage0_warm_start(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        stage4_revise.train_stage4(_stage_cfg(), str(tmp_path), str(tmp_path), str(tmp_path),
                                   log_dir=str(tmp_path / "log"), trust_inputs=True,
                                   pretrained_stage0=str(tmp_path), device="cpu")


def test_remat_recomputes_with_the_same_masks():
    """``remat=True`` (each trunk block under torch.utils.checkpoint) gives
    the loss and gradients of the plain trunk under the same drawn masks."""
    torch.manual_seed(0)
    plain = ReviseNet(N_CH)
    remat = ReviseNet(N_CH, remat=True)
    remat.load_state_dict(plain.state_dict())
    rs = np.random.RandomState(9)
    x = _t(rs.randn(1, 32, 32, 3).astype(np.float32))
    pm, pc = (_t(rs.rand(1, 4, 4, N_CH).astype(np.float32)) for _ in range(2))
    masks = spatial_dropout_masks(plain.dropout_sites(), 1, torch.Generator().manual_seed(1))
    grads = []
    for model in (plain, remat):
        loss = sum(o.square().mean() for o in model(x, pm, pc, masks=masks))
        grads.append(torch.autograd.grad(loss, [model.b7.conv_branch2b1.weight,
                                                model.b3.conv_branch2a.weight]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_apply_pretrained_loads_trunk_keys_only(tmp_path):
    """A reference-named ``.pth`` (``module.`` prefixes, a ``state_dict``
    wrapper, a classifier key) overlays the trunk and leaves the heads."""
    from pistoseg_tpu_torch.stages.common import apply_pretrained

    model = ReviseNet(N_CH)
    rs = np.random.RandomState(11)
    keys = ["conv1a.weight", "b2.bn_branch2a.running_var", "b7.conv_branch1.weight"]
    sd = {f"module.{k}": _t(rs.rand(*model.state_dict()[k].shape).astype(np.float32))
          for k in keys}
    sd["module.fc8.weight"] = torch.ones(20, 4096, 1, 1)        # the classifier's head
    torch.save({"state_dict": sd}, tmp_path / "res38d.pth")
    fc8 = model.fc8.weight.detach().clone()
    assert apply_pretrained(model, str(tmp_path / "res38d.pth")) == 3
    for k in keys:
        assert torch.equal(model.state_dict()[k], sd[f"module.{k}"]), k
    assert torch.equal(model.fc8.weight, fc8)
    torch.save({"b3.conv_branch1.weight": torch.zeros(1, 1, 1, 1)}, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="shape"):
        apply_pretrained(model, str(tmp_path / "bad.pth"))
