# Frozen copy of us_video_medsam2_tpu_torch/models/memory.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""Memory attention and memory encoder (reference memory_attention.py:17-169,
memory_encoder.py:17-181), batch-first, NHWC.

Counterpart of the JAX package's ``models/memory.py``. Memory keys are the
fixed-shape concatenation [spatial memory-slot tokens | object-pointer
tokens]; invalid slots are excluded by a boolean key mask. Pointer tokens are
not rotated by RoPE. With ``efficient_pool_size`` > 1 the cross-attention
pools the spatial memory keys and values into landmarks (EfficientTAM,
``transformer.landmark_attention``). CXBlock runs its plain composition (the
port's opt-in whole-block kernel is not copied: no cell runs it). With
``deterministic`` False the layers apply their residual
dropouts (``dropout``, ``dropout1``-``dropout3``, ``torch.native_dropout`` on the
device's default generator).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from perfbench.reference.config import MemoryAttentionConfig, MemoryEncoderConfig
from perfbench.reference.models.layers import ACTIVATIONS, Conv2d, LayerNorm, Linear, gelu_exact
from perfbench.reference.models.transformer import RoPEAttention
from perfbench.reference.ops.posenc import compute_axial_rope, rope_key_tables, sine_pos_embed_2d


class MemoryAttentionLayer(nn.Module):
    def __init__(self, cfg: MemoryAttentionConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.self_attn = RoPEAttention(d, cfg.num_heads, dropout=cfg.dropout)
        self.cross_attn_image = RoPEAttention(d, cfg.num_heads, kv_in_dim=cfg.kv_in_dim,
                                              dropout=cfg.dropout)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm2 = LayerNorm(d, eps=1e-5)
        self.norm3 = LayerNorm(d, eps=1e-5)
        self.linear1 = Linear(d, cfg.dim_feedforward)
        self.linear2 = Linear(cfg.dim_feedforward, d)
        self.act = ACTIVATIONS[cfg.activation]

    def forward(self, tgt, memory, pos, query_pos, rope_q, rope_k, key_mask=None,
                deterministic=True, gen=None, n_rope=None):
        cfg = self.cfg

        def drop(x):  # residual dropouts, and the one inside the FFN
            # the draw out of place (F.dropout's on the CPU is in place), so a
            # selective checkpoint can save it (``training/train_model.py``)
            if deterministic or cfg.dropout == 0.0:
                return x
            return torch.native_dropout(x, cfg.dropout, True)[0]

        tgt2 = self.norm1(tgt)
        q = tgt2 + query_pos if cfg.pos_enc_at_attn else tgt2
        tgt = tgt + drop(self.self_attn(q, q, tgt2, rope_q, rope_q, None, deterministic, gen))
        tgt2 = self.norm2(tgt)
        tgt = tgt + drop(self.cross_attn_image(
            tgt2 + query_pos if cfg.pos_enc_at_cross_attn_queries else tgt2,
            memory + pos if cfg.pos_enc_at_cross_attn_keys else memory,
            memory, rope_q, rope_k, key_mask, deterministic, gen, n_rope,
            cfg.efficient_pool_size, cfg.rope_feat_sizes, cfg.efficient_pool_variant,
        ))
        tgt2 = self.linear2(drop(self.act(self.linear1(self.norm3(tgt)))))
        return tgt + drop(tgt2)


class MemoryAttention(nn.Module):
    """Stack of MemoryAttentionLayers + final norm (memory_attention.py:102-169)."""

    def __init__(self, cfg: MemoryAttentionConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", MemoryAttentionLayer(cfg))
        self.norm = LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, curr, memory, curr_pos, memory_pos, num_obj_ptr_tokens=0, key_mask=None,
                deterministic=True, gen=None):
        cfg = self.cfg
        cos, sin = compute_axial_rope(cfg.d_model // cfg.num_heads, cfg.rope_feat_sizes[0],
                                      cfg.rope_feat_sizes[1], cfg.rope_theta, curr.device)
        lk = memory.shape[1]
        n_rope = lk - num_obj_ptr_tokens
        rope_k = rope_key_tables(cos, sin, n_rope, lk)
        out = curr + 0.1 * curr_pos if cfg.pos_enc_at_input else curr
        for i in range(cfg.num_layers):
            out = getattr(self, f"layers_{i}")(out, memory, memory_pos, curr_pos, (cos, sin),
                                               rope_k, key_mask, deterministic, gen, n_rope)
        return self.norm(out)


class MaskDownSampler(nn.Module):
    """Stride-16 conv pyramid over the mask (memory_encoder.py:17-58)."""

    def __init__(self, cfg: MemoryEncoderConfig):
        super().__init__()
        s = cfg.mask_downsampler_stride
        self.num_layers = int(math.log2(cfg.mask_downsampler_total_stride) // math.log2(s))
        cin = 1
        for i in range(self.num_layers):
            cout = cin * s * s
            self.add_module(f"encoder_{i}", Conv2d(cin, cout, cfg.mask_downsampler_kernel, s,
                                                   cfg.mask_downsampler_padding))
            self.add_module(f"encoder_ln_{i}", LayerNorm(cout, eps=1e-6))
            cin = cout
        self.encoder_out = Conv2d(cin, cfg.mask_downsampler_embed_dim, 1)

    def forward(self, x):
        for i in range(self.num_layers):
            x = gelu_exact(getattr(self, f"encoder_ln_{i}")(getattr(self, f"encoder_{i}")(x)))
        return self.encoder_out(x)


class CXBlock(nn.Module):
    """ConvNeXt block, NHWC (memory_encoder.py:62-117): depthwise conv, LN,
    pwconv1, exact GELU, pwconv2, layer scale, residual."""

    def __init__(self, dim, kernel_size=7, padding=3, layer_scale_init=1e-6):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, kernel_size, padding=padding, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x):
        y = self.pwconv2(gelu_exact(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + self.gamma.to(x.dtype) * y


class MemoryEncoder(nn.Module):
    """Fuse pixel features with the downsampled mask into a memory (memory_encoder.py:138-181)."""

    def __init__(self, cfg: MemoryEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.mask_downsampler = MaskDownSampler(cfg)
        self.pix_feat_proj = Conv2d(cfg.in_dim, cfg.in_dim, 1)
        for i in range(cfg.fuser_layers):
            self.add_module(f"fuser_{i}", CXBlock(cfg.in_dim, cfg.fuser_kernel, cfg.fuser_padding,
                                                  cfg.fuser_layer_scale_init))
        if cfg.out_dim != cfg.in_dim:
            self.out_proj = Conv2d(cfg.in_dim, cfg.out_dim, 1)

    def forward(self, pix_feat, masks):
        cfg = self.cfg
        x = self.pix_feat_proj(pix_feat) + self.mask_downsampler(masks)
        for i in range(cfg.fuser_layers):
            x = getattr(self, f"fuser_{i}")(x)
        if cfg.out_dim != cfg.in_dim:
            x = self.out_proj(x)
        pos = sine_pos_embed_2d(x.shape[1], x.shape[2], cfg.pos_channels, cfg.pos_temperature,
                                x.device).to(x.dtype)
        return x, pos
