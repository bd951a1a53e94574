# Frozen copy of us_video_medsam2_tpu_torch/ops/posenc.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""Positional encodings: 2-D sine grid, 1-D sine, and axial RoPE (half-split form).

Counterpart of the JAX package's ``ops/posenc.py`` (reference
sam2/modeling/position_encoding.py:79-221, sam2_utils.py:64-74). Tables are
built once per shape in numpy and kept on each device that asks for them.

RoPE runs in the half-split channel layout: q/k projection weights carry the
importer's permutation that maps torch's interleaved pairs (2j, 2j+1) to
(j, d/2+j), so rotation works on two contiguous halves. ``from_jax_params``
copies those permuted weights unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# device copies of the numpy tables, so a per-frame call costs no host copy
_device_tables: dict = {}


def _on_device(key, make, device):
    dev = torch.device(device)
    k = (key, str(dev))
    t = _device_tables.get(k)
    if t is None:
        # a normal tensor even when first asked for under torch.inference_mode()
        # (the predictor): autograd may save it later, in a training step
        with torch.inference_mode(False):
            t = _device_tables[k] = make(dev)
    return t


@functools.lru_cache(maxsize=64)
def _sine_pos_embed_2d_np(
    h: int, w: int, channels: int, temperature: float, normalize: bool, scale: float
) -> np.ndarray:
    half = channels // 2
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    if normalize:
        eps = 1e-6
        y = y / (y[-1:, :] + eps) * scale
        x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(half, dtype=np.float32)
    dim_t = temperature ** (2.0 * (dim_t // 2) / half)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], axis=-1)
    pos_x = pos_x.reshape(h, w, half)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], axis=-1)
    pos_y = pos_y.reshape(h, w, half)
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)


def sine_pos_embed_2d(
    h: int, w: int, channels: int, temperature: float = 10000.0,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """[H, W, channels] f32 sine position grid (channels-last)."""
    return _on_device(
        ("sine2d", h, w, channels, float(temperature)),
        lambda dev: torch.from_numpy(
            _sine_pos_embed_2d_np(h, w, channels, float(temperature), True, 2.0 * np.pi)
        ).to(dev),
        device,
    )


def sine_pe_1d(pos: torch.Tensor, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """1-D sine embedding of (possibly fractional) positions: [...] -> [..., dim]."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2.0 * torch.div(dim_t, 2, rounding_mode="floor") / pe_dim)
    emb = pos.float()[..., None] / dim_t
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


@functools.lru_cache(maxsize=64)
def _axial_rope_np(dim: int, end_x: int, end_y: int, theta: float):
    nf = dim // 4
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4, dtype=np.float32)[:nf] / dim))
    t = np.arange(end_x * end_y, dtype=np.float32)
    t_x = t % end_x
    t_y = np.floor(t / end_x)
    ang = np.concatenate([np.outer(t_x, freqs), np.outer(t_y, freqs)], axis=-1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def compute_axial_rope(
    dim: int, end_x: int, end_y: int, theta: float = 10000.0,
    device: str | torch.device = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) f32 tables [end_x*end_y, dim//2] for axial RoPE."""
    def make(dev):
        cos, sin = _axial_rope_np(dim, end_x, end_y, float(theta))
        return torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev)

    return _on_device(("rope", dim, end_x, end_y, float(theta)), make, device)


def rope_halfsplit_perm(dim: int, n_heads: int) -> np.ndarray:
    """Permutation of a projection's output channels turning torch's
    interleaved RoPE pairs (2j, 2j+1) into the half-split pairs (j, d/2+j) of
    each head: new[:, i] = old[:, perm[i]]. q.k is unchanged when q and k are
    permuted together (JAX ``ops/posenc.py::rope_halfsplit_perm``)."""
    dh = dim // n_heads
    perm = np.empty(dim, np.int64)
    for h in range(n_heads):
        base = h * dh
        for j in range(dh // 2):
            perm[base + j] = base + 2 * j
            perm[base + dh // 2 + j] = base + 2 * j + 1
    return perm


def rope_key_tables(
    cos: torch.Tensor, sin: torch.Tensor, n_rope: int, lk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Key tables for ``lk`` keys: the [L0, d/2] tables repeated over the first
    ``n_rope`` keys (memory slots, rope k-repeat) and the identity rotation
    (cos 1, sin 0) over the remaining object-pointer keys."""
    l0 = cos.shape[0]
    reps = n_rope // l0
    assert reps * l0 == n_rope, f"rope repeat {n_rope} is not a multiple of {l0}"
    cos_k, sin_k = cos.repeat(reps, 1), sin.repeat(reps, 1)
    if n_rope < lk:
        d2 = cos.shape[1]
        cos_k = torch.cat([cos_k, cos.new_ones(lk - n_rope, d2)])
        sin_k = torch.cat([sin_k, sin.new_zeros(lk - n_rope, d2)])
    return cos_k, sin_k


def apply_rope_halfsplit(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (x[..., j], x[..., d/2+j]) pairs; x [..., L, d], cos/sin [L, d/2].
    Computes in x's dtype, as the JAX version does."""
    d2 = x.shape[-1] // 2
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    x0, x1 = x[..., :d2], x[..., d2:]
    return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
