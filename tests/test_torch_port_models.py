"""The port's ResNet38d trunk and ReviseNet forward against the JAX package.

One 64² image in float32 on the CPU.  The JAX ReviseNet is initialised,
its BatchNorm statistics and affine parameters are replaced by seeded
non-trivial values, and the same tree is carried into the port with
``state_dict_from_flax``.  Tolerance: atol/rtol 5e-4, the bound of the
JAX package's own full-forward parity test
(``tests/test_torch_forward_parity.py``) — two float32 convolution
stacks 40 layers deep sum in different orders.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pistoseg_tpu.models.rfm import ReviseNet as JaxReviseNet
from pistoseg_tpu.models.rfm import get_norm_cam_d as jax_get_norm_cam_d
from pistoseg_tpu_torch.models.resnet38d import ResNet38d
from pistoseg_tpu_torch.models.rfm import ReviseNet, get_norm_cam_d
from pistoseg_tpu_torch.models.weights import state_dict_from_flax

TOL = dict(atol=5e-4, rtol=5e-4)
N_CH = 4


def _randomize(variables, rs):
    """Seeded BN statistics and affine parameters, so BN does something."""
    def leaf(path, v):
        name = str(path[-1].key)
        if name == "mean":
            return jnp.asarray(rs.randn(*v.shape).astype(np.float32) * 0.1)
        if name == "var":
            return jnp.asarray(rs.rand(*v.shape).astype(np.float32) + 0.5)
        if name == "scale":
            return jnp.asarray(1.0 + 0.1 * rs.randn(*v.shape).astype(np.float32))
        if name == "bias" and v.ndim == 1:
            return jnp.asarray(0.1 * rs.randn(*v.shape).astype(np.float32))
        return v
    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def case():
    rs = np.random.RandomState(4)
    x = rs.rand(1, 64, 64, 3).astype(np.float32)
    pmask = rs.randn(1, 8, 8, N_CH).astype(np.float32)
    pcam = rs.rand(1, 8, 8, N_CH).astype(np.float32)
    model = JaxReviseNet(num_classes=N_CH, use_pallas=True)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pmask), jnp.asarray(pcam))
    variables = _randomize(jax.tree_util.tree_map(np.asarray, variables), rs)

    def apply(v, x, pm, pc):
        outs, inter = model.apply(
            v, x, pm, pc, capture_intermediates=lambda m, _: m.name == "backbone",
            mutable=["intermediates"])
        return outs, inter["intermediates"]["backbone"]["__call__"][0]

    outs, taps = jax.jit(apply)(variables, x, pmask, pcam)
    sd = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    return {"x": x, "pmask": pmask, "pcam": pcam, "sd": sd,
            "outs": [np.asarray(o) for o in outs],
            "taps": {k: np.asarray(v) for k, v in taps.items()}}


def test_state_dict_from_flax_keys(case):
    """Keys are the reference's names; every port parameter and buffer is
    covered and nothing is left over."""
    sd = case["sd"]
    assert sd["conv1a.weight"].shape == (64, 3, 3, 3)          # OIHW
    assert "b2.bn_branch2a.running_mean" in sd and "bn7.weight" in sd
    assert sd["f9_1.weight"].shape == (192, 195, 1, 1)
    model = ReviseNet(N_CH)
    assert set(sd) == set(model.state_dict())


def test_resnet38d_taps_match_jax(case):
    trunk = ResNet38d(b7_dilation=4)
    trunk_keys = set(trunk.state_dict())
    trunk.load_state_dict({k: v for k, v in case["sd"].items() if k in trunk_keys})
    with torch.no_grad():
        x = torch.from_numpy(case["x"]).permute(0, 3, 1, 2)
        got = trunk.eval()(x)
    for key in ("conv3", "conv4", "conv5", "conv6"):
        np.testing.assert_allclose(
            got[key].permute(0, 2, 3, 1).numpy(), case["taps"][key], **TOL,
            err_msg=key)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_revisenet_forward_matches_jax(case, use_kernel):
    """Both attention routes (the kernel wrapper, which takes its plain
    version on the CPU, and the einsum path) against the JAX forward."""
    model = ReviseNet(N_CH, use_kernel=use_kernel)
    model.load_state_dict(case["sd"])
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(case[k]) for k in ("x", "pmask", "pcam")))
    for name, g, r in zip(("cam", "cam_rv", "pmask_rv", "pcam_rv"), got, case["outs"]):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, **TOL, err_msg=name)


def test_get_norm_cam_d_matches_jax():
    """Exact same f32 arithmetic on both sides; ties in the non-max
    suppression are kept by construction (repeated values)."""
    rs = np.random.RandomState(7)
    cam = rs.randn(2, 8, 8, 5).astype(np.float32)
    cam[0, :2, :2, 1:3] = 3.0          # tied foreground maxima
    got = get_norm_cam_d(torch.from_numpy(cam)).numpy()
    ref = np.asarray(jax_get_norm_cam_d(jnp.asarray(cam)))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
