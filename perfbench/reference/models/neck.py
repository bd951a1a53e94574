# Frozen copy of us_video_medsam2_tpu_torch/models/neck.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""FPN neck, the plain-ViT trunks' one-level neck, and the image-encoder wrapper
(reference backbones/image_encoder.py:16-200), NHWC."""

from __future__ import annotations

import torch
import torch.nn as nn

from perfbench.reference.config import FpnNeckConfig
from perfbench.reference.models.layers import LayerNorm, NHWCConv
from perfbench.reference.ops.posenc import sine_pos_embed_2d
from perfbench.reference.ops.resize import resize2d, upsample_nearest_2x


class FpnNeck(nn.Module):
    """1x1 laterals, top-down sum on the selected levels only. ``convs_j``
    takes ``backbone_channel_list[j]`` channels (lowest resolution first)."""

    def __init__(self, cfg: FpnNeckConfig):
        super().__init__()
        self.cfg = cfg
        for j, cin in enumerate(cfg.backbone_channel_list):
            self.add_module(f"convs_{j}", NHWCConv(cin, cfg.d_model, 1))

    def forward(self, xs: list[torch.Tensor]):
        cfg = self.cfg
        n = len(cfg.backbone_channel_list) - 1
        out: list = [None] * len(xs)
        pos: list = [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            lateral = getattr(self, f"convs_{n - i}")(xs[i])
            if i in cfg.fpn_top_down_levels and prev is not None:
                if cfg.fpn_interp_model == "nearest":
                    top_down = upsample_nearest_2x(prev.float())
                else:
                    top_down = resize2d(prev.float(), (prev.shape[1] * 2, prev.shape[2] * 2))
                prev = lateral + top_down.to(lateral.dtype)
                if cfg.fuse_type == "avg":
                    prev = prev / 2
            else:
                prev = lateral
            out[i] = prev
            pos[i] = sine_pos_embed_2d(
                prev.shape[1], prev.shape[2], cfg.d_model, cfg.pos_temperature, prev.device
            ).to(prev.dtype)
        return out, pos


class ViTDetNeck(nn.Module):
    """One-level neck of the plain-ViT trunks (reference image_encoder.py:139-200):
    1x1 conv, 3x3 conv, each followed by a LayerNorm (eps 1e-6) and bias-free
    when ``neck_norm`` is set (the EfficientMedSAM configs' 'LN')."""

    def __init__(self, cfg: FpnNeckConfig):
        super().__init__()
        self.cfg = cfg
        d, norm = cfg.d_model, cfg.neck_norm is not None
        self.convs_0_conv_1x1 = NHWCConv(cfg.backbone_channel_list[0], d, 1, bias=not norm)
        self.convs_0_conv_3x3 = NHWCConv(d, d, 3, padding=1, bias=not norm)
        if norm:
            self.convs_0_norm_0 = LayerNorm(d, eps=1e-6)
            self.convs_0_norm_1 = LayerNorm(d, eps=1e-6)

    def forward(self, xs: list[torch.Tensor]):
        cfg = self.cfg
        norm = cfg.neck_norm is not None
        x = self.convs_0_conv_1x1(xs[0])
        if norm:
            x = self.convs_0_norm_0(x)
        x = self.convs_0_conv_3x3(x)
        if norm:
            x = self.convs_0_norm_1(x)
        pos = sine_pos_embed_2d(x.shape[1], x.shape[2], cfg.d_model, cfg.pos_temperature, x.device).to(x.dtype)
        return [x], [pos]


class ImageEncoder(nn.Module):
    """trunk -> neck -> (features, positions); ``scalp`` drops the lowest-res levels."""

    def __init__(self, trunk: nn.Module, neck: nn.Module, scalp: int = 0):
        super().__init__()
        self.trunk = trunk
        self.neck = neck
        self.scalp = scalp

    def forward(self, sample: torch.Tensor, deterministic: bool = True) -> dict:
        features, pos = self.neck(self.trunk(sample, deterministic))
        if self.scalp > 0:
            features, pos = features[: -self.scalp], pos[: -self.scalp]
        return {"vision_features": features[-1], "vision_pos_enc": pos, "backbone_fpn": features}
