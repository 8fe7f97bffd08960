"""The port's RFM attention (plain version and wrapper) against the JAX
package's Pallas kernel in interpret mode and its XLA reference.

Tolerance atol 1e-4, as the JAX package's own kernel test
(``tests/test_pallas_kernels.py``): float32 softmax-weighted sums over L
terms taken in a different order.  The Hopper kernel itself is held
against the plain version on the card by ``test_torch_port_cuda.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pistoseg_tpu.ops.pallas.rfm_attention import (
    _rfm_attention_reference,
    rfm_attention as jax_rfm_attention,
)
from pistoseg_tpu_torch.ops.cuda.rfm_attention import (
    rfm_attention,
    rfm_attention_reference,
)


def _inputs(seed, n, l, d, c, scale=1.0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(n, l, d) * scale).astype(np.float32)
    k = (rng.randn(n, l, d) * scale).astype(np.float32)
    v = rng.randn(n, l, c).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("n,l,d,c,block_j", [
    (2, 64, 32, 8, 32),     # the JAX kernel test's shape
    (2, 80, 32, 12, 32),    # ragged: the last j block is partial
])
def test_reference_matches_jax_kernel(n, l, d, c, block_j):
    q, k, v = _inputs(0, n, l, d, c)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(jax_rfm_attention(jq, jk, jv, block_j=block_j, interpret=True))
    xla = np.asarray(_rfm_attention_reference(jq, jk, jv))
    got = rfm_attention_reference(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, pallas, atol=1e-4)
    np.testing.assert_allclose(got, xla, atol=1e-4)


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 40, 16, 6))
    before = rfm_attention.launches
    got = rfm_attention(q, k, v)
    assert rfm_attention.launches == before
    torch.testing.assert_close(got, rfm_attention_reference(q, k, v), rtol=0, atol=0)


def test_columns_normalized():
    """Each output pixel is a convex combination of input pixels: v = 1
    gives 1 (softmax over i sums to one per column j)."""
    q, k, _ = _inputs(2, 1, 16, 8, 4, scale=2.0)
    v = torch.ones(1, 16, 4)
    out = rfm_attention(torch.from_numpy(q), torch.from_numpy(k), v)
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("mutate,err", [
    (lambda q, k, v: (q.double(), k, v), TypeError),
    (lambda q, k, v: (q.transpose(1, 2).contiguous().transpose(1, 2), k, v), ValueError),
    (lambda q, k, v: (q, k[:, :-1].contiguous(), v), ValueError),
    (lambda q, k, v: (q, k, v[:, :-1].contiguous()), ValueError),
    (lambda q, k, v: (q, k, v[0]), ValueError),
])
def test_wrapper_rejects_bad_inputs(mutate, err):
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 8, 8, 4))
    with pytest.raises(err):
        rfm_attention(*mutate(q, k, v))
