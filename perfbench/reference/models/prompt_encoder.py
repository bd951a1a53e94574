# Frozen copy of us_video_medsam2_tpu_torch/models/prompt_encoder.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""SAM prompt encoder (reference sam/prompt_encoder.py:17-182), NHWC.

Counterpart of the JAX package's ``models/prompt_encoder.py``: points arrive
as padded [B, P, 2] coords with [B, P] labels (-1 = padding); boxes are the
two-point (label 2/3) encoding. Rows of ``point_embed`` are
[not_a_point, negative, positive, box corner 1, box corner 2].
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from perfbench.reference.models.layers import Conv2d, LayerNorm, gelu_exact


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim=256, image_embedding_size=32, input_image_size=512,
                 mask_in_chans=16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.pe_gaussian = nn.Parameter(torch.randn(2, embed_dim // 2))
        self.point_embed = nn.Parameter(torch.randn(5, embed_dim))
        self.no_mask_embed = nn.Parameter(torch.randn(embed_dim))
        ch = mask_in_chans
        self.mask_down_conv1 = Conv2d(1, ch // 4, 2, stride=2)
        self.mask_down_ln1 = LayerNorm(ch // 4, eps=1e-6)
        self.mask_down_conv2 = Conv2d(ch // 4, ch, 2, stride=2)
        self.mask_down_ln2 = LayerNorm(ch, eps=1e-6)
        self.mask_down_conv3 = Conv2d(ch, embed_dim, 1)

    def _pe_encoding(self, coords: torch.Tensor, dtype) -> torch.Tensor:
        c = (2.0 * coords - 1.0).float() @ self.pe_gaussian.float()
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1).to(dtype)

    def dense_pe(self, dtype) -> torch.Tensor:
        """[H, W, embed_dim] positional grid for the mask decoder."""
        s = self.image_embedding_size
        dev = self.pe_gaussian.device
        y = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
        x = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
        grid = torch.stack([x[None, :].expand(s, s), y[:, None].expand(s, s)], dim=-1)
        return self._pe_encoding(grid, dtype)

    def embed_points(self, coords, labels, dtype):
        pts = (coords.float() + 0.5) / self.input_image_size
        pe = self._pe_encoding(pts, dtype)
        pe = torch.where((labels == -1)[..., None], torch.zeros_like(pe), pe)
        return pe + self.point_embed.to(dtype)[torch.clamp(labels + 1, 0, 4).long()]

    def embed_masks(self, masks, dtype):
        x = gelu_exact(self.mask_down_ln1(self.mask_down_conv1(masks.to(dtype))))
        x = gelu_exact(self.mask_down_ln2(self.mask_down_conv2(x)))
        return self.mask_down_conv3(x)

    def forward(self, point_coords, point_labels, masks=None, dtype=torch.float32):
        # the reference appends one padding point when no box is given; the
        # token count matters to attention
        b = point_coords.shape[0]
        point_coords = torch.cat([point_coords, point_coords.new_zeros(b, 1, 2)], dim=1)
        point_labels = torch.cat([point_labels, -point_labels.new_ones(b, 1)], dim=1)
        sparse = self.embed_points(point_coords, point_labels, dtype)
        if masks is not None:
            dense = self.embed_masks(masks, dtype)
        else:
            s = self.image_embedding_size
            dense = self.no_mask_embed.to(dtype)[None, None, None, :].expand(b, s, s, self.embed_dim)
        return sparse, dense
