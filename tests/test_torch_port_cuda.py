"""The port's Hopper kernels on the card (marker ``cuda``; skipped without one).

Imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)  The
kernels are held against their plain PyTorch versions, in float32 with TF32
off: both sum the same float32 products in different orders.  The forward
at atol 1e-4; the backward's dq, dk and dv at 1e-4 · max(1, max |plain|),
since its gradients grow with the scores' scale.
"""

import numpy as np
import pytest
import torch

from pistoseg_tpu_torch.ops.cuda.rfm_attention import (
    _launch_forward,
    rfm_attention,
    rfm_attention_backward,
    rfm_attention_backward_reference,
    rfm_attention_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, seed, n, l, d, c, scale=0.3):
    rng = np.random.RandomState(seed)
    q = (rng.randn(n, l, d) * scale).astype(np.float32)
    k = (rng.randn(n, l, d) * scale).astype(np.float32)
    v = rng.rand(n, l, c).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (q, k, v))


@pytest.mark.parametrize("n,l,d,c,scale", [
    (2, 100, 192, 4, 0.3),      # ragged on i and j
    (2, 784, 192, 15, 0.3),     # train size, BCSS 3C
    (3, 1024, 192, 12, 0.3),    # infer size, WSSS4LUAD 3C
    (2, 1024, 192, 12, 1.5),    # peaked scores
    (1, 64, 32, 32, 0.3),       # widest C, narrow D
    (1, 65, 384, 1, 0.3),       # widest D, one channel
])
def test_kernel_matches_plain_version(dev, n, l, d, c, scale):
    q, k, v = _inputs(dev, 5, n, l, d, c, scale)
    before = rfm_attention.launches
    got = rfm_attention(q, k, v)
    torch.cuda.synchronize()
    assert rfm_attention.launches == before + 1
    torch.testing.assert_close(got, rfm_attention_reference(q, k, v), rtol=0, atol=1e-4)


def test_kernel_columns_normalized(dev):
    q, k, _ = _inputs(dev, 6, 2, 1024, 192, 12, 1.0)
    out = rfm_attention(q, k, torch.ones(2, 1024, 12, device=dev))
    torch.testing.assert_close(out, torch.ones_like(out), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,l,d,c", [(1, 64, 30, 4), (1, 64, 388, 4), (1, 64, 32, 33)])
def test_kernel_rejects_unsupported_shapes(dev, n, l, d, c):
    q, k, v = _inputs(dev, 7, n, l, d, c)
    before = rfm_attention.launches
    with pytest.raises(ValueError):
        rfm_attention(q, k, v)
    assert rfm_attention.launches == before


def test_kernel_rejects_mixed_devices(dev):
    q, k, v = _inputs(dev, 8, 1, 16, 8, 4)
    with pytest.raises(ValueError):
        rfm_attention(q, k.cpu(), v)


def _grad(dev, seed, n, l, c):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(n, l, c).astype(np.float32)).to(dev)


def _assert_grads_close(got, want):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * max(1.0, b.abs().max().item()), f"{name}: {err}"


@pytest.mark.parametrize("n,l,d,c,scale", [
    (16, 784, 192, 12, 0.3),    # stage-4 train shape, WSSS4LUAD 3C
    (16, 784, 192, 15, 0.3),    # BCSS 3C
    (2, 100, 192, 4, 0.3),      # ragged on i and j
    (8, 1024, 192, 12, 1.0),    # peaked scores
    (64, 1024, 192, 12, 0.3),   # stage-4b batch
    (1, 70, 64, 32, 0.3),       # widest C, ragged
    (1, 65, 256, 1, 0.3),       # widest D, one channel
])
def test_backward_kernel_matches_plain_version(dev, n, l, d, c, scale):
    q, k, v = _inputs(dev, 9, n, l, d, c, scale)
    g = _grad(dev, 10, n, l, c)
    out, lse = _launch_forward(q, k, v, with_lse=True)
    torch.testing.assert_close(lse, torch.logsumexp(
        torch.einsum("nid,njd->nij", q, k), dim=1), rtol=0, atol=1e-4)
    before = rfm_attention_backward.launches
    got = rfm_attention_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert rfm_attention_backward.launches == before + 1
    _assert_grads_close(got, rfm_attention_backward_reference(q, k, v, g))


def test_autograd_function_launches_both_kernels(dev):
    q, k, v = _inputs(dev, 11, 4, 784, 192, 12)
    g = _grad(dev, 12, 4, 784, 12)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = rfm_attention.launches, rfm_attention_backward.launches
    grads = torch.autograd.grad(rfm_attention(*leaves), leaves, g)
    torch.cuda.synchronize()
    assert (rfm_attention.launches, rfm_attention_backward.launches) == (fwd + 1, bwd + 1)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    _assert_grads_close(grads, torch.autograd.grad(rfm_attention_reference(*ref), ref, g))


def test_backward_is_deterministic(dev):
    q, k, v = _inputs(dev, 13, 2, 784, 192, 12)
    g = _grad(dev, 14, 2, 784, 12)
    out, lse = _launch_forward(q, k, v, with_lse=True)
    first = rfm_attention_backward(q, k, v, out, lse, g)
    second = rfm_attention_backward(q, k, v, out, lse, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,l,d,c", [(1, 64, 30, 4), (1, 64, 260, 4), (1, 64, 32, 33)])
def test_backward_rejects_unsupported_shapes(dev, n, l, d, c):
    q, k, v = _inputs(dev, 15, n, l, d, c)
    g = _grad(dev, 16, n, l, c)
    lse = torch.zeros(n, l, device=dev)
    before = rfm_attention_backward.launches
    with pytest.raises(ValueError):
        rfm_attention_backward(q, k, v, v, lse, g)
    assert rfm_attention_backward.launches == before
