# Frozen copy of us_video_medsam2_tpu_torch/models/hiera.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""Hiera trunk (reference sam2/modeling/backbones/hieradet.py:169-317), NHWC.

Counterpart of the JAX package's ``models/hiera.py``. Per block: norm1 through
the LayerNorm kernel, the qkv projection as one Linear over the map, windowed
attention through the window-attention kernel (global blocks use the plain
attention, as the JAX package does), the output projection, and the
LN -> MLP -> residual tail through its kernel (with the plain MLP and drop
path instead when drop path is on in training, as the JAX package gates its
kernel). The port's opt-in fused qkv window kernel is not copied: no cell
runs it. The JAX package's 128-lane head-dim padding exists only for the TPU and is not
carried over.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from perfbench.reference.config import HieraConfig
from perfbench.reference.plain import layer_norm
from perfbench.reference.plain import ln_mlp_residual
from perfbench.reference.plain import window_attention
from perfbench.reference.models.layers import MLP, LayerNorm, Linear, NHWCConv
from perfbench.reference.ops.attention import attention_plain
from perfbench.reference.ops.resize import resize2d


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool over [B, H, W, C]."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class MultiScaleAttention(nn.Module):
    """Windowed MHSA with optional q max-pooling (reference hieradet.py:39-81)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, q_pool: bool):
        super().__init__()
        self.dim_out, self.num_heads, self.q_pool = dim_out, num_heads, q_pool
        self.qkv = Linear(dim, 3 * dim_out)
        self.proj = Linear(dim_out, dim_out)

    def forward(self, x: torch.Tensor, window_size: int) -> torch.Tensor:
        b, h, w, _ = x.shape
        nh = self.num_heads
        hd = self.dim_out // nh
        ws = window_size
        pad_h, pad_w = ((ws - h % ws) % ws, (ws - w % ws) % ws) if ws else (0, 0)
        ho, wo = (h // 2, w // 2) if self.q_pool else (h, w)
        qkv = self.qkv(x)
        if window_size == 0:
            qkv = qkv.reshape(b, h * w, 3, nh, hd)
            q = qkv[:, :, 0]
            if self.q_pool:
                q = max_pool_2x(q.reshape(b, h, w, nh * hd))
                h, w = q.shape[1:3]
                q = q.reshape(b, h * w, nh, hd)
            k, v = qkv[:, :, 1], qkv[:, :, 2]
            o = attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
            out = o.transpose(1, 2).reshape(b, h, w, nh * hd)
        else:
            if pad_h or pad_w:
                # the reference zero-pads the tokens before the projection, so
                # pad tokens carry the projection bias; they are attended
                full = self.qkv.bias.to(qkv.dtype).expand(b, h + pad_h, w + pad_w, -1).clone()
                full[:, :h, :w] = qkv
                qkv = full
            # h: the last strip's pad query rows are cut and come back zero, as
            # the JAX package calls its kernel; they are sliced off here
            o = window_attention(qkv.contiguous(), ws, nh, self.q_pool, h)
            out = o[:, :ho, :wo]
        return self.proj(out)


def drop_path(x: torch.Tensor, rate: float, deterministic: bool) -> torch.Tensor:
    """Per-sample stochastic depth (reference sam2_utils.py:92-107), torch's RNG."""
    if rate == 0.0 or deterministic:
        return x
    keep = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MultiScaleBlock(nn.Module):
    """Hiera block (reference hieradet.py:84-166)."""

    def __init__(self, dim, dim_out, num_heads, window_size, q_stride, mlp_ratio, drop_path=0.0):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.window_size = window_size
        self.q_stride = q_stride
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, eps=1e-6)
        if dim != dim_out:
            self.proj = Linear(dim, dim_out)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_pool=q_stride is not None)
        self.norm2 = LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2, activation="gelu")

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        shortcut = x
        x = layer_norm(x.contiguous(), self.norm1.weight, self.norm1.bias, 1e-6)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_stride:
                shortcut = max_pool_2x(shortcut)
        x = shortcut + drop_path(self.attn(x, self.window_size), self.drop_path, deterministic)
        if not (deterministic or self.drop_path == 0.0):
            return x + drop_path(self.mlp(self.norm2(x)), self.drop_path, deterministic)
        b, h, w, c = x.shape
        l0, l1 = self.mlp.layers_0, self.mlp.layers_1
        out = ln_mlp_residual(  # weights cast at use: f32 master weights keep their gradient
            x.reshape(b * h * w, c), self.norm2.weight, self.norm2.bias,
            l0.weight.to(x.dtype), l0.bias, l1.weight.to(x.dtype), l1.bias, 1e-6,
        )
        return out.reshape(b, h, w, c)


class Hiera(nn.Module):
    """Trunk producing one feature map per stage, high -> low resolution."""

    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = NHWCConv(3, cfg.embed_dim, cfg.patch_kernel,
                                    cfg.patch_stride, cfg.patch_padding)
        bh, bw = cfg.window_pos_embed_bkg_spatial_size
        win = cfg.window_spec[0]
        self.pos_embed = nn.Parameter(torch.zeros(1, bh, bw, cfg.embed_dim))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, win, win, cfg.embed_dim))

        depth = sum(cfg.stages)
        dpr = [cfg.drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.stage_ends = [sum(cfg.stages[: i + 1]) - 1 for i in range(len(cfg.stages))]
        q_pool_blocks = [e + 1 for e in self.stage_ends[:-1]][: cfg.q_pool]
        dim, num_heads, cur_stage = cfg.embed_dim, cfg.num_heads, 1
        self.depth = depth
        for i in range(depth):
            dim_out = dim
            # the window size is read before the stage advances: a q-pool
            # block keeps the previous stage's window
            window_size = cfg.window_spec[cur_stage - 1]
            if cfg.global_att_blocks and i in cfg.global_att_blocks:
                window_size = 0
            if i - 1 in self.stage_ends:
                dim_out = int(dim * cfg.dim_mul)
                num_heads = int(num_heads * cfg.head_mul)
                cur_stage += 1
            self.add_module(f"blocks_{i}", MultiScaleBlock(
                dim, dim_out, num_heads, window_size,
                cfg.q_stride if i in q_pool_blocks else None, cfg.mlp_ratio, dpr[i],
            ))
            dim = dim_out

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> list[torch.Tensor]:
        x = self.patch_embed(x)
        h, w = x.shape[1:3]
        win = self.cfg.window_spec[0]
        pe = resize2d(self.pos_embed.float(), (h, w), mode="cubic")
        pe = pe + self.pos_embed_window.float().repeat(1, h // win, w // win, 1)
        x = (x + pe.to(x.dtype)).contiguous()
        outputs = []
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x, deterministic)
            if i in self.stage_ends:
                outputs.append(x)
        return outputs
