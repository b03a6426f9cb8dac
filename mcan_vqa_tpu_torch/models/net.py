"""AttFlat pooling, the MCAN VQA network and the image-only classifier
(mcan_vqa_tpu/models/net.py; reference Net2, core/model/net.py:295-381,
and ClassifierNet, :140-196).

The module tree produces the reference ``Net2`` state_dict keys in Net2's
registration order, so a reference pickle and the JAX export
(train/checkpoint.py) load with ``load_state_dict(strict=True)``.
``MCANet.forward`` and ``ClassifierNet.forward`` are the port's "plain"
engines: op by op, an f32 residual stream, the numerics of the JAX
``model.apply``. They return logits; the caller applies the sigmoid.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.models.attention import NEG_INF
from mcan_vqa_tpu_torch.models.layers import (MLP, Dense, StdLayerNorm,
                                              make_mask, operand)
from mcan_vqa_tpu_torch.models.lstm import LSTMEncoder
from mcan_vqa_tpu_torch.models.mca import MCAEncoder, MCAEncoderDecoder


def attflat_pool(att_logits: torch.Tensor, x: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """The AttFlat pooling between its two projections: PAD rows set to
    -1e9, softmax over L in f32, glimpse-weighted sum of bf16 operands in
    f32. att_logits [B, L, G], x [B, L, D], mask [B, 1, 1, L] -> [B, G*D]."""
    att = att_logits.masked_fill(mask[:, 0, 0, :, None], NEG_INF)
    att = torch.softmax(att.float(), dim=1)
    pooled = operand(att).transpose(1, 2) @ operand(x)
    return pooled.reshape(x.shape[0], -1)


class AttFlat(nn.Module):
    """[B, L, D] -> [B, flat_out] (reference core/model/net.py:20-55)."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = MLP(cfg.hidden_size, cfg.flat_mlp_size, cfg.flat_glimpses,
                       generator)
        self.linear_merge = Dense(cfg.hidden_size * cfg.flat_glimpses,
                                  cfg.flat_out_size, generator)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        return self.linear_merge(attflat_pool(self.mlp(x), x, x_mask))


class MCANet(nn.Module):
    """forward(img_feat [B, R, img_feat_size] f32, ques_ix [B, T] int)
    -> logits [B, answer_size]."""

    def __init__(self, cfg: Config, token_size: int, answer_size: int,
                 pretrained_emb: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.embedding = nn.Embedding(token_size, cfg.word_embed_size)
        with torch.no_grad():
            if pretrained_emb is not None:
                emb = torch.as_tensor(np.asarray(pretrained_emb, np.float32))
                if emb.shape != self.embedding.weight.shape:
                    raise ValueError(
                        f"pretrained_emb shape {tuple(emb.shape)} != "
                        f"(token_size={token_size}, word_embed_size="
                        f"{cfg.word_embed_size})")
                self.embedding.weight.copy_(emb)
            else:
                self.embedding.weight.normal_(generator=g)
        self.lstm = LSTMEncoder(cfg.word_embed_size, cfg.hidden_size, g)
        self.img_feat_linear = Dense(cfg.img_feat_size, cfg.hidden_size, g)
        self.backbone = MCAEncoderDecoder(cfg.layer, cfg.hidden_size,
                                          cfg.multi_head, cfg.ff_size, g)
        self.attflat_img = AttFlat(cfg, g)
        self.attflat_lang = AttFlat(cfg, g)
        self.proj_norm = StdLayerNorm(cfg.flat_out_size)
        self.proj = Dense(cfg.flat_out_size, answer_size, g)

    def forward(self, img_feat: torch.Tensor,
                ques_ix: torch.Tensor) -> torch.Tensor:
        q_mask = make_mask(ques_ix.unsqueeze(-1))
        v_mask = make_mask(img_feat)
        q = self.lstm(self.embedding(ques_ix))
        v = self.img_feat_linear(img_feat)
        q, v = self.backbone(q, v, q_mask, v_mask)
        fused = self.proj_norm(self.attflat_lang(q, q_mask)
                               + self.attflat_img(v, v_mask))
        return self.proj(fused)


class ClassifierNet(nn.Module):
    """The image-only multi-label classifier (mcan_vqa_tpu/models/net.py:
    140-171; reference core/model/net.py:140-196): forward(img_feat
    [B, R, img_feat_size] f32) -> logits [B, answer_size]. The modules
    register in the JAX module's creation order: img_feat_linear,
    backbone (an ``MCAEncoder``), attflat_img, proj_norm, proj."""

    def __init__(self, cfg: Config, answer_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.img_feat_linear = Dense(cfg.img_feat_size, cfg.hidden_size, g)
        self.backbone = MCAEncoder(cfg.layer, cfg.hidden_size,
                                   cfg.multi_head, cfg.ff_size, g)
        self.attflat_img = AttFlat(cfg, g)
        self.proj_norm = StdLayerNorm(cfg.flat_out_size)
        self.proj = Dense(cfg.flat_out_size, answer_size, g)

    def forward(self, img_feat: torch.Tensor) -> torch.Tensor:
        v_mask = make_mask(img_feat)
        v = self.backbone(self.img_feat_linear(img_feat), v_mask)
        return self.proj(self.proj_norm(self.attflat_img(v, v_mask)))
