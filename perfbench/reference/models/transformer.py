# Frozen copy of us_video_medsam2_tpu_torch/models/transformer.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""Attention modules and the SAM two-way transformer (reference sam/transformer.py:44-360).

Counterpart of the JAX package's ``models/transformer.py``, batch-first
[B, N, C]. ``Attention`` (mask decoder) uses the plain attention, as the JAX
package does at these token counts; ``RoPEAttention`` (memory attention)
goes through ``ops.attention.sdpa``, the flash kernel's plain composition
(the training step's dropout attention is not copied: no cell trains). With
landmark pooling on (EfficientTAM's efficient cross-attention) the memory
cross-attention runs ``landmark_attention`` in plain PyTorch, as the JAX
package computes it outside any kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from perfbench.reference.plain import NEG_INF
from perfbench.reference.models.layers import MLP, LayerNorm, Linear
from perfbench.reference.ops.attention import attention_plain, sdpa
from perfbench.reference.ops.posenc import apply_rope_halfsplit


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, nh, c // nh).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class Attention(nn.Module):
    """Multi-head attention with optional internal downsampling (transformer.py:215-287)."""

    def __init__(self, embedding_dim, num_heads, downsample_rate=1, kv_in_dim=None):
        super().__init__()
        internal = embedding_dim // downsample_rate
        kv = kv_in_dim or embedding_dim
        self.num_heads = num_heads
        self.q_proj = Linear(embedding_dim, internal)
        self.k_proj = Linear(kv, internal)
        self.v_proj = Linear(kv, internal)
        self.out_proj = Linear(internal, embedding_dim)

    def forward(self, q, k, v):
        nh = self.num_heads
        out = attention_plain(_heads(self.q_proj(q), nh), _heads(self.k_proj(k), nh),
                              _heads(self.v_proj(v), nh))
        return self.out_proj(_merge(out))


class RoPEAttention(Attention):
    """Attention with axial RoPE on q and k (transformer.py:289-360). The key
    tables arrive already extended over repeated memory slots and over the
    unrotated object-pointer keys (``ops.posenc.rope_key_tables``). With ``landmark_pool``
    > 1 and more rotated keys (``n_rope``, memory slots of ``spatial_hw``
    tokens) than queries, the attention is ``landmark_attention``."""

    def __init__(self, embedding_dim, num_heads, downsample_rate=1, kv_in_dim=None, dropout=0.0):
        super().__init__(embedding_dim, num_heads, downsample_rate, kv_in_dim)
        self.dropout = dropout

    def forward(self, q, k, v, rope_q, rope_k, key_mask=None, deterministic=True,
                gen: torch.Generator | None = None, n_rope: int | None = None,
                landmark_pool: int = 0, spatial_hw=None, landmark_variant: int = 1):
        nh = self.num_heads
        q = apply_rope_halfsplit(_heads(self.q_proj(q), nh), *rope_q)
        k = apply_rope_halfsplit(_heads(self.k_proj(k), nh), *rope_k)
        v = _heads(self.v_proj(v), nh)
        n_rope = k.shape[2] if n_rope is None else n_rope
        if landmark_pool > 1 and n_rope > q.shape[2]:
            out = landmark_attention(q, k, v, n_rope, landmark_pool, spatial_hw, key_mask, landmark_variant)
        else:
            out = sdpa(q, k, v, key_mask)
        return self.out_proj(_merge(out))


def landmark_attention(q, k, v, n_rope: int, pool: int, spatial_hw, key_mask=None, variant: int = 1):
    """EfficientTAM's landmark-pooled attention over [B, H, L, D]
    (efficient_track_anything/modeling/sam/transformer.py:317-532): the first
    ``n_rope`` keys and values, memory slots of ``spatial_hw`` tokens, are
    average-pooled ``pool`` x ``pool`` per slot; the pointer keys after them
    stay. The pooled keys' area is compensated by 2·log(pool), as a logit bias
    (variant 1, EfficientRoPEAttention1) or added to the pooled key values
    (variant 2). A slot's validity is uniform over its tokens, so the mask
    pools by taking one token of each pool. f32 logits and softmax,
    probabilities rounded to the value dtype, f32 accumulation."""
    b, nh, _, d = q.shape
    hh, ww = spatial_hw
    n_slots = n_rope // (hh * ww)

    def pool_tokens(x):
        xs = x[:, :, :n_rope].reshape(b, nh, n_slots, hh // pool, pool, ww // pool, pool, d)
        return xs.mean(dim=(4, 6)).reshape(b, nh, -1, d)

    k_land, v_land = pool_tokens(k), pool_tokens(v)
    comp = 2.0 * math.log(pool)
    if variant == 2:
        k_land = k_land + comp
    k_full = torch.cat([k_land, k[:, :, n_rope:]], 2)
    v_full = torch.cat([v_land, v[:, :, n_rope:]], 2)
    s = torch.matmul(q.float(), k_full.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    n_land = k_land.shape[2]
    if variant == 1:
        s[..., :n_land] += comp
    if key_mask is not None:
        m_sp = key_mask[:, :n_rope].reshape(b, n_slots, hh * ww)[:, :, :: pool * pool]
        m = torch.cat([m_sp.reshape(b, -1), key_mask[:, n_rope:]], 1)
        s = torch.where(m[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, -1)
    return torch.matmul(p.to(v.dtype).float(), v_full.float()).to(q.dtype)


class TwoWayAttentionBlock(nn.Module):
    """Sparse self-attn, sparse->dense cross, MLP, dense->sparse cross (transformer.py:137-212)."""

    def __init__(self, dim, num_heads, mlp_dim, downsample_rate, skip_first_layer_pe):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(dim, num_heads)
        self.cross_attn_token_to_image = Attention(dim, num_heads, downsample_rate)
        self.cross_attn_image_to_token = Attention(dim, num_heads, downsample_rate)
        self.mlp = MLP(dim, mlp_dim, dim, 2, activation="relu")
        for i in range(1, 5):
            self.add_module(f"norm{i}", LayerNorm(dim, eps=1e-5))

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """Depth-2 token <-> image decoder transformer (transformer.py:44-134)."""

    def __init__(self, depth=2, embedding_dim=256, num_heads=8, mlp_dim=2048, downsample_rate=2):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layers_{i}", TwoWayAttentionBlock(
                embedding_dim, num_heads, mlp_dim, downsample_rate, skip_first_layer_pe=(i == 0)
            ))
        self.final_attn_token_to_image = Attention(embedding_dim, num_heads, downsample_rate)
        self.norm_final_attn = LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        queries, keys = point_embedding, image_embedding
        for i in range(self.depth):
            queries, keys = getattr(self, f"layers_{i}")(queries, keys, point_embedding, image_pe)
        q, k = queries + point_embedding, keys + image_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
