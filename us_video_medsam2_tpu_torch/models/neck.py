"""FPN neck and image-encoder wrapper (reference backbones/image_encoder.py:16-137), NHWC."""

from __future__ import annotations

import torch
import torch.nn as nn

from us_video_medsam2_tpu_torch.core.config import FpnNeckConfig
from us_video_medsam2_tpu_torch.models.layers import NHWCConv
from us_video_medsam2_tpu_torch.ops.posenc import sine_pos_embed_2d
from us_video_medsam2_tpu_torch.ops.resize import resize2d, upsample_nearest_2x


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
