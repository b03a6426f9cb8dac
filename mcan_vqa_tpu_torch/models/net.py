"""AttFlat pooling, the MCAN VQA network and the image-only classifier
(mcan_vqa_tpu/models/net.py; reference Net2, core/model/net.py:295-381,
and ClassifierNet, :140-196).

The module tree produces the reference ``Net2`` state_dict keys in Net2's
registration order, so a reference pickle and the JAX export
(train/checkpoint.py) load with ``load_state_dict(strict=True)``.
``MCANet.forward`` and ``ClassifierNet.forward`` are the port's "plain"
engines: op by op, an f32 residual stream, the numerics of the JAX
``model.apply``. They return logits; the caller applies the sigmoid.
``forward_outputs`` returns the JAX modules' whole output dictionary
(logits, streams, masks, AttFlat weights, the fused vector) on the same
code path.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.models.attention import NEG_INF
from mcan_vqa_tpu_torch.models.layers import (MLP, Dense, StdLayerNorm,
                                              make_mask, operand)
from mcan_vqa_tpu_torch.models.lstm import LSTMEncoder
from mcan_vqa_tpu_torch.models.mca import MCAEncoder, MCAEncoderDecoder


def attflat_weights(att_logits: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """AttFlat's glimpse weights: PAD rows set to -1e9, softmax over L in
    f32. att_logits [B, L, G], mask [B, 1, 1, L] -> [B, L, G]."""
    att = att_logits.masked_fill(mask[:, 0, 0, :, None], NEG_INF)
    return torch.softmax(att.float(), dim=1)


def weighted_pool(att: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The glimpse-weighted sum of bf16 operands in f32: att [B, L, G],
    x [B, L, D] -> [B, G*D]."""
    pooled = operand(att).transpose(1, 2) @ operand(x)
    return pooled.reshape(x.shape[0], -1)


def attflat_pool(att_logits: torch.Tensor, x: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """The AttFlat pooling between its two projections: the glimpse
    weights (``attflat_weights``), then ``weighted_pool``. att_logits
    [B, L, G], x [B, L, D], mask [B, 1, 1, L] -> [B, G*D]."""
    return weighted_pool(attflat_weights(att_logits, mask), x)


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
        return self.pool_with_weights(x, x_mask)[0]

    def pool_with_weights(self, x: torch.Tensor, x_mask: torch.Tensor):
        """-> (the pooled [B, flat_out], the glimpse weights [B, L, G] f32),
        JAX's AttFlat output pair (mcan_vqa_tpu/models/net.py:29-54)."""
        att = attflat_weights(self.mlp(x), x_mask)
        return self.linear_merge(weighted_pool(att, x)), att


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
        return self.forward_outputs(img_feat, ques_ix)["logits"]

    def forward_outputs(self, img_feat: torch.Tensor, ques_ix: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
        """The JAX ``MCANet``'s output dictionary (mcan_vqa_tpu/models/
        net.py:132-137), which the visualization reads: "logits" [B, A];
        the backbone's streams "v" [B, R, D] and "q" [B, T, D]; their PAD
        masks "v_mask" / "q_mask" bool [B, 1, 1, L]; AttFlat's glimpse
        weights "v_w" [B, R, G] / "q_w" [B, T, G] (f32); "fused" [B,
        flat_out], the normed sum the head reads. ``forward`` returns this
        method's "logits"."""
        q_mask = make_mask(ques_ix.unsqueeze(-1))
        v_mask = make_mask(img_feat)
        q = self.lstm(self.embedding(ques_ix))
        v = self.img_feat_linear(img_feat)
        q, v = self.backbone(q, v, q_mask, v_mask)
        lang, q_w = self.attflat_lang.pool_with_weights(q, q_mask)
        img, v_w = self.attflat_img.pool_with_weights(v, v_mask)
        fused = self.proj_norm(lang + img)
        return {"logits": self.proj(fused), "v": v, "v_mask": v_mask,
                "v_w": v_w, "q": q, "q_mask": q_mask, "q_w": q_w,
                "fused": fused}


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
        return self.forward_outputs(img_feat)["logits"]

    def forward_outputs(self, img_feat: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
        """The JAX ``ClassifierNet``'s output dictionary (net.py:177-178):
        "logits", "v", "v_mask", "v_w" and "fused", as
        ``MCANet.forward_outputs`` gives them."""
        v_mask = make_mask(img_feat)
        v = self.backbone(self.img_feat_linear(img_feat), v_mask)
        img, v_w = self.attflat_img.pool_with_weights(v, v_mask)
        fused = self.proj_norm(img)
        return {"logits": self.proj(fused), "v": v, "v_mask": v_mask,
                "v_w": v_w, "fused": fused}
