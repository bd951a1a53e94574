"""Plain ViT (ViTDet) trunk, the EfficientTAM image encoder (reference
sam2/modeling/backbones/vitdet.py:24-299), NHWC.

Counterpart of the JAX package's ``models/vitdet.py``: a patch-16 embed, the
absolute position embedding of the pretrain grid (cls token dropped) resized
bicubically to the token map, windowed blocks interleaved with global blocks,
and the last global block's map as the one output. A ViT block is the Hiera
block at ``dim_out == dim`` without q-pooling (``hiera.MultiScaleBlock``):
norm1 through the LayerNorm kernel, ``MultiScaleAttention`` (the
window-attention kernel at ws 14 on the map zero-padded to whole windows with
bias-filled pad tokens, the plain attention in the global blocks), the
residual, and the MLP tail through the LN -> MLP -> residual kernel. The
parameter names are the JAX tree's (``patch_embed``, ``pos_embed``,
``blocks_{i}/{norm1,attn/{qkv,proj},norm2,mlp}``). The JAX package's
space-to-depth patch embed exists only for the TPU; here it is one stride-16
convolution.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from us_video_medsam2_tpu_torch.core.config import ViTDetConfig
from us_video_medsam2_tpu_torch.models.hiera import MultiScaleBlock
from us_video_medsam2_tpu_torch.models.layers import NHWCConv
from us_video_medsam2_tpu_torch.ops.resize import resize2d


class ViTDet(nn.Module):
    """Trunk producing one feature map: the last global block's output."""

    def __init__(self, cfg: ViTDetConfig):
        super().__init__()
        self.cfg = cfg
        c, ps = cfg.embed_dim, cfg.patch_size
        self.patch_embed = NHWCConv(3, c, ps, ps, 0)
        self.grid = cfg.pretrain_img_size // ps
        n_pos = self.grid * self.grid + (1 if cfg.pretrain_use_cls_token else 0)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, c))
        for i in range(cfg.depth):
            ws = cfg.window_size if i in cfg.window_block_indexes else 0
            self.add_module(f"blocks_{i}", MultiScaleBlock(c, c, cfg.num_heads, ws, None, cfg.mlp_ratio))
        self.last_global = max(i for i in range(cfg.depth) if i not in cfg.window_block_indexes)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> list[torch.Tensor]:
        cfg = self.cfg
        x = self.patch_embed(x)
        pe = self.pos_embed[:, 1:] if cfg.pretrain_use_cls_token else self.pos_embed
        pe = resize2d(pe.float().reshape(1, self.grid, self.grid, cfg.embed_dim), x.shape[1:3], mode="cubic")
        x = (x + pe.to(x.dtype)).contiguous()
        outputs = []
        for i in range(cfg.depth):
            x = getattr(self, f"blocks_{i}")(x, deterministic)
            if i == self.last_global:
                outputs.append(x)
        return outputs
