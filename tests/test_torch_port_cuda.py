"""The port's Hopper kernels on the card (marker ``cuda``; skipped without one).

Imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)  The
kernel is held against its plain PyTorch version at atol 1e-4, in float32
with TF32 off: both sum the same float32 products in different orders.
"""

import numpy as np
import pytest
import torch

from pistoseg_tpu_torch.ops.cuda.rfm_attention import (
    rfm_attention,
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
