"""Dropout with a keep-probability quantised to the bits drawn
(mcan_vqa_tpu/ops/dropout.py).

``random_keep_mask`` draws ``bit_width`` random bits per element from a
``torch.Generator`` on the mask's device:

  * 32 bits: keep with probability 1 - rate (uniform < 1 - rate), kept
    values scaled by 1 / (1 - rate), as ``jax.random.bernoulli`` is used;
  * 8 or 16 bits: keep where the drawn integer r < t, t = round((1 - rate)
    * 2**bits) clamped to [1, 2**bits - 1], kept values scaled by the exact
    2**bits / t, so E[dropout(x)] == x holds exactly.

The JAX and torch generators give different bits from one seed; the tests
compare the quantisation, the edges and the keep rate.

``draw_seeds`` takes the in-kernel dropout's per-block seeds from the same
generator, on the host.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

BIT_WIDTHS = (8, 16, 32)


def keep_threshold(rate: float, bit_width: int) -> Tuple[int, float]:
    """(t, inv_keep) for 8 / 16 bits: keep where r < t, r uniform in
    [0, 2**bits)."""
    q = 1 << bit_width
    t = max(1, min(q - 1, int(round((1.0 - rate) * q))))
    return t, float(q) / t


def inv_keep_prob(rate: float, bit_width: int = 32) -> float:
    """The scale of kept values: 1 / (1 - rate) at 32 bits, the exact
    2**bits / t of the quantised keep probability at 8 / 16 bits."""
    if bit_width == 32:
        return 1.0 / (1.0 - rate)
    return keep_threshold(rate, bit_width)[1]


def random_keep_mask(generator: torch.Generator, rate: float,
                     shape: Sequence[int], bit_width: int = 32
                     ) -> Tuple[torch.Tensor, float]:
    """Bool keep-mask of ``shape`` on the generator's device and the
    inverse keep probability."""
    if bit_width not in BIT_WIDTHS:
        raise ValueError(f"bit_width must be 8, 16, or 32; got {bit_width}")
    dev = generator.device
    if bit_width == 32:
        u = torch.rand(tuple(shape), generator=generator, device=dev)
        return u < (1.0 - rate), inv_keep_prob(rate, 32)
    t, inv_keep = keep_threshold(rate, bit_width)
    r = torch.randint(0, 1 << bit_width, tuple(shape), generator=generator,
                      device=dev, dtype=torch.int32)
    return r < t, inv_keep


def keep_masks(generator: Optional[torch.Generator], rate: float,
               shapes: Mapping[str, Sequence[int]], bit_width: int = 32
               ) -> Tuple[Dict[str, Optional[torch.Tensor]], float]:
    """One bool keep-mask per entry of ``shapes``, drawn from ``generator``
    in the order of its keys with ``bit_width`` bits per element, and the
    inverse keep probability. At rate 0 every mask is None and nothing is
    drawn; rate >= 1 keeps nothing and is refused."""
    if rate <= 0.0:
        return {name: None for name in shapes}, 1.0
    if rate >= 1.0:
        raise ValueError(f"dropout rate {rate} >= 1 keeps nothing")
    masks = {name: random_keep_mask(generator, rate, shape, bit_width)[0]
             for name, shape in shapes.items()}
    return masks, inv_keep_prob(rate, bit_width)


SEED_MAX = (1 << 31) - 1      # seeds lie in [0, SEED_MAX), as JAX's randint


def draw_seeds(generator: torch.Generator, n: int) -> List[int]:
    """n seeds in [0, 2^31 - 1) for the in-kernel dropout of n blocks, as
    host ints: a hash of the generator's state, which then moves on to a
    state seeded from the same hash. Reading the state of a CUDA
    generator is host work (its seed and offset), so the draw launches
    nothing and never waits for the card; the same generator state gives
    the same seeds and the same state after."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes()).digest()
    words = []
    while len(words) < n + 2:
        words += [int.from_bytes(digest[i:i + 4], "little")
                  for i in range(0, len(digest), 4)]
        digest = hashlib.sha256(digest).digest()
    generator.manual_seed(words[0] | (words[1] << 32))
    return [w % SEED_MAX for w in words[2:n + 2]]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            bit_width: int = 32) -> torch.Tensor:
    """Inverted, unbiased dropout of x; the caller gates on training.
    Rate 0 returns x, rate >= 1 zeros (nn.Dropout's edge)."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep, inv_keep = random_keep_mask(generator, rate, x.shape, bit_width)
    return torch.where(keep, x * inv_keep, torch.zeros_like(x))
