"""MCA layers: FFN, SA, SGA, the encoder-decoder backbone and the
image-only SA encoder (mcan_vqa_tpu/models/mca.py; reference
core/model/mca.py:85-207).

Blocks are post-norm, ``norm(x + sublayer(x))``, and the decoder (SGA over
image regions) attends to the FINAL encoder output. Dropout is an identity
at inference; training applies it in train/fused_engine.py.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mcan_vqa_tpu_torch.models.attention import MHAtt
from mcan_vqa_tpu_torch.models.layers import (MLP, StdLayerNorm,
                                              copy_to_model, row_parallel)


class FFN(nn.Module):
    """MLP(D, F, D). Under tensor parallelism (``model_group`` set by
    ``parallel/sharding.py::shard_module_``) the up projection is
    column-parallel behind f and the down projection row-parallel, summed
    by g before its bias."""

    model_group = None

    def __init__(self, hidden_size: int, ff_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = MLP(hidden_size, ff_size, hidden_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.model_group
        if group is None:
            return self.mlp(x)
        h = self.mlp.fc(copy_to_model(x, group))
        return row_parallel(h, self.mlp.linear.weight.t(),
                            self.mlp.linear.bias, group)


class SA(nn.Module):
    """Self-attention block (reference core/model/mca.py:105-127)."""

    def __init__(self, hidden_size: int, num_heads: int, ff_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mhatt = MHAtt(hidden_size, num_heads, generator)
        self.ffn = FFN(hidden_size, ff_size, generator)
        self.norm1 = StdLayerNorm(hidden_size)
        self.norm2 = StdLayerNorm(hidden_size)

    def forward(self, x, x_mask):
        x = self.norm1(x + self.mhatt(x, x, x, x_mask))
        return self.norm2(x + self.ffn(x))


class SGA(nn.Module):
    """Self-guided attention block (reference core/model/mca.py:134-164).
    x: image regions (queries); y: encoded question (keys/values)."""

    def __init__(self, hidden_size: int, num_heads: int, ff_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mhatt1 = MHAtt(hidden_size, num_heads, generator)
        self.mhatt2 = MHAtt(hidden_size, num_heads, generator)
        self.ffn = FFN(hidden_size, ff_size, generator)
        self.norm1 = StdLayerNorm(hidden_size)
        self.norm2 = StdLayerNorm(hidden_size)
        self.norm3 = StdLayerNorm(hidden_size)

    def forward(self, x, y, x_mask, y_mask):
        x = self.norm1(x + self.mhatt1(x, x, x, x_mask))
        x = self.norm2(x + self.mhatt2(y, y, x, y_mask))
        return self.norm3(x + self.ffn(x))


class MCAEncoderDecoder(nn.Module):
    """MCA_ED: L x SA over the question, then L x SGA over the image
    regions guided by the final question encoding."""

    def __init__(self, num_layers: int, hidden_size: int, num_heads: int,
                 ff_size: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc_list = nn.ModuleList(
            SA(hidden_size, num_heads, ff_size, generator)
            for _ in range(num_layers))
        self.dec_list = nn.ModuleList(
            SGA(hidden_size, num_heads, ff_size, generator)
            for _ in range(num_layers))

    def forward(self, x, y, x_mask, y_mask):
        for enc in self.enc_list:
            x = enc(x, x_mask)
        for dec in self.dec_list:
            y = dec(y, x, y_mask, x_mask)
        return x, y


class MCAEncoder(nn.Module):
    """L x SA over one stream, the image-only classifier's backbone
    (mcan_vqa_tpu/models/mca.py:151-170; reference core/model/mca.py:
    189-207). The blocks sit in ``enc_list``, so the keys read
    ``backbone.enc_list.{i}.*``, the names the JAX export gives an
    ``enc_i`` tree."""

    def __init__(self, num_layers: int, hidden_size: int, num_heads: int,
                 ff_size: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc_list = nn.ModuleList(
            SA(hidden_size, num_heads, ff_size, generator)
            for _ in range(num_layers))

    def forward(self, y, y_mask):
        for enc in self.enc_list:
            y = enc(y, y_mask)
        return y
