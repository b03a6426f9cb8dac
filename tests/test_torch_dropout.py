"""The port's dropout (mcan_vqa_tpu_torch/ops/dropout.py) against the JAX
package's (mcan_vqa_tpu/ops/dropout.py): the same quantised keep threshold
t and exact inverse keep probability at 8, 16 and 32 bits, the rate-0 and
rate >= 1 edges, and a keep rate within a binomial bound. The two
frameworks draw different bits from a seed, so masks are compared by
their statistics, not bit for bit."""

import jax
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.ops import dropout as jdrop
from mcan_vqa_tpu_torch.ops import dropout as tdrop

RATES = (0.1, 0.25, 0.5, 1e-4, 0.9999)


@pytest.mark.parametrize("bits", (8, 16, 32))
@pytest.mark.parametrize("rate", RATES)
def test_inverse_keep_matches_jax(rate, bits):
    _, j_inv = jdrop.random_keep_mask(jax.random.PRNGKey(0), rate, (4,),
                                      bits)
    g = torch.Generator().manual_seed(0)
    _, t_inv = tdrop.random_keep_mask(g, rate, (4,), bits)
    assert t_inv == j_inv == tdrop.inv_keep_prob(rate, bits)
    if bits < 32:
        # the JAX threshold: round((1 - rate) 2^bits) clamped to
        # [1, 2^bits - 1], and inv_keep = 2^bits / t exactly
        q = 1 << bits
        t = max(1, min(q - 1, int(round((1.0 - rate) * q))))
        assert tdrop.keep_threshold(rate, bits) == (t, q / t)


@pytest.mark.parametrize("bits", (8, 16, 32))
def test_keep_rate_within_binomial_bound(bits):
    """Realised keep fraction within 6 standard deviations of the
    quantised keep probability, for the port and for JAX alike."""
    rate, n = 0.1, 1 << 20
    p = 1 - rate if bits == 32 else tdrop.keep_threshold(rate, bits)[0] \
        / (1 << bits)
    sd = (p * (1 - p) / n) ** 0.5
    g = torch.Generator().manual_seed(bits)
    keep, _ = tdrop.random_keep_mask(g, rate, (n,), bits)
    assert keep.dtype == torch.bool and keep.shape == (n,)
    assert abs(float(keep.float().mean()) - p) < 6 * sd
    jkeep, _ = jdrop.random_keep_mask(jax.random.PRNGKey(bits), rate, (n,),
                                      bits)
    assert abs(float(np.asarray(jkeep).mean()) - p) < 6 * sd


def test_dropout_edges_and_scaling():
    x = torch.randn(64, 33, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    assert tdrop.dropout(x, 0.0, g) is x
    assert torch.equal(tdrop.dropout(x, 1.0, g), torch.zeros_like(x))
    assert torch.equal(tdrop.dropout(x, 1.5, g, 8), torch.zeros_like(x))
    for bits in (8, 16, 32):
        y = tdrop.dropout(x, 0.25, g, bits)
        inv = tdrop.inv_keep_prob(0.25, bits)
        kept = y != 0
        assert 0 < int(kept.sum()) < x.numel()
        torch.testing.assert_close(y[kept], x[kept] * inv, rtol=0, atol=0)
    # the JAX edges agree
    xj = np.asarray(x)
    assert np.array_equal(np.asarray(jdrop.dropout(
        xj, 1.0, jax.random.PRNGKey(0))), np.zeros_like(xj))


def test_masks_come_from_the_generator():
    a = tdrop.random_keep_mask(torch.Generator().manual_seed(7), 0.1,
                               (1000,), 16)[0]
    b = tdrop.random_keep_mask(torch.Generator().manual_seed(7), 0.1,
                               (1000,), 16)[0]
    c = tdrop.random_keep_mask(torch.Generator().manual_seed(8), 0.1,
                               (1000,), 16)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        tdrop.random_keep_mask(torch.Generator(), 0.1, (4,), 12)
