"""Temporal fusion: the fork's inter-frame feature mixers.

Counterpart of the JAX package's ``models/temporal_fusion.py`` (reference
sam2/modeling/sam2_base.py:25-758, TemporalContextExchange.py:5-56): TCE,
GFTE, ATSF and GP, each applied to one FPN level over the frame axis when
the training forward passes ``num_frames`` > 1 (sam2_base.py:1249-1262).
Plain PyTorch, as the JAX modules are plain XLA: the products are Linear
layers, the temporal convolutions shifted multiply-adds, the BatchNorm
statistics f32 reductions.

- Features are NHWC [B·T, H, W, C], viewed as [B, T, H, W, C] with
  ``reshape(bt // num_frames, num_frames, ...)``, as in JAX.
- ``BatchNorm3d`` normalises by the biased batch statistics in training and
  by its ``mean`` / ``var`` buffers in eval, and never updates the buffers
  (JAX ``temporal_fusion.py:29-33``): it is not ``nn.BatchNorm3d``.
- Dtypes follow the JAX modules' promotion: a Linear runs in the input's
  dtype (the model's compute dtype, as ``nn.Dense(dtype=...)``), a product
  with an f32 parameter vector promotes to f32, scalar residual weights are
  cast to the input's dtype; BatchNorm statistics and GFTE's softmax are f32.
- Random draws in training come from the step's ``torch.Generator`` on the
  model's device, each in one named function (``gfte_attention_keep``,
  ``gp_gumbel``), so that a captured step draws them anew at each replay.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from us_video_medsam2_tpu_torch.core.config import TemporalFusionConfig
from us_video_medsam2_tpu_torch.kernels.flash_dropout import draw_seed, keep_mask
from us_video_medsam2_tpu_torch.models.layers import Linear, gelu_exact


def gfte_attention_keep(b: int, heads: int, t: int, rate: float, gen: torch.Generator | None,
                        device) -> torch.Tensor:
    """GFTE's attention-dropout keep mask [b, heads, t, t]: the port's dropout
    hash (``kernels/flash_dropout.py::keep_mask``) under an int32 seed drawn
    on the device from ``gen``, as the memory attention draws its seed."""
    return keep_mask(b * heads, t, t, draw_seed(gen, device), rate, device).reshape(b, heads, t, t)


def gp_gumbel(b: int, t: int, gen: torch.Generator | None, device) -> torch.Tensor:
    """GP's Gumbel noise [b, t] f32, drawn from ``gen`` on its device (the
    training step's, the model's) and moved to ``device``
    (``jax.random.gumbel``: -log(-log(u)), u in [tiny, 1))."""
    dev = torch.device(device) if gen is None else gen.device
    u = torch.rand((b, t), generator=gen, dtype=torch.float32, device=dev).clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def _param(*shape, value=None) -> nn.Parameter:
    """A parameter of ``shape``: filled with ``value`` (the JAX constant
    initialisers), else N(0, 1/fan_in) with flax's fan_in (size / last dim)."""
    if value is not None:
        return nn.Parameter(torch.full(shape, float(value)))
    fan_in = max(1, int(np.prod(shape)) // shape[-1])
    return nn.Parameter(torch.randn(shape) * fan_in**-0.5)


class BatchNorm3d(nn.Module):
    """torch.nn.BatchNorm3d's normalisation over [..., C] with parameters
    ``weight`` / ``bias`` and buffers ``mean`` / ``var`` (zeros / ones until a
    checkpoint brings running statistics). Training (``use_running_stats``
    False) normalises by the biased batch statistics over every non-channel
    axis; the buffers are read in eval and never written. f32 statistics,
    output in the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, use_running_stats: bool = True) -> torch.Tensor:
        xf = x.float()
        if use_running_stats:
            mean, var = self.mean, self.var
        else:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = xf.var(axes, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


def _depthwise_tconv(xt: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise temporal convolution over [B, T, H, W, C] (torch Conv3d with
    kernel (k, 1, 1), groups C, zero padding k // 2); ``w`` [k, C]: k shifted
    multiply-adds."""
    k, t = w.shape[0], xt.shape[1]
    p = k // 2
    pad = F.pad(xt, (0, 0, 0, 0, 0, 0, p, p))
    out = sum(pad[:, i:i + t] * w[i] for i in range(k))
    return out if bias is None else out + bias


def _se_gate(pooled: torch.Tensor, fc1: Linear, fc2: Linear, dtype, act=F.relu) -> torch.Tensor:
    """AdaptiveAvgPool3d(1) -> 1x1 conv -> act -> 1x1 conv -> sigmoid (the
    reference's channel-attention blocks), the products in ``dtype``."""
    return torch.sigmoid(fc2(act(fc1(pooled.to(dtype)))))


def _frames(x: torch.Tensor, num_frames: int) -> torch.Tensor:
    bt, h, w, c = x.shape
    return x.reshape(bt // num_frames, num_frames, h, w, c)


class TemporalContextExchange(nn.Module):
    """safeTemporalContextExchange (sam2_base.py:697-758): depthwise temporal
    conv (no bias) -> bn1 -> SE channel attention over (T, H, W) -> pointwise
    1x1 (no bias) -> bn2 -> learned ``alpha`` residual."""

    def __init__(self, channels: int, alpha_init: float = 0.1):
        super().__init__()
        c = self.channels = channels
        hidden = max(c // 16, 8)
        self.depthwise = _param(3, c)
        self.bn1 = BatchNorm3d(c)
        self.attn_fc1 = Linear(c, hidden)
        self.attn_fc2 = Linear(hidden, c)
        self.pointwise = Linear(c, c, bias=False)
        self.bn2 = BatchNorm3d(c)
        self.alpha = _param(value=alpha_init)

    def forward(self, x, num_frames: int, deterministic: bool = True, gen=None):
        if x.shape[-1] != self.channels or num_frames <= 1:
            return x  # the reference returns its input on a mismatch (:740-742)
        dt = x.dtype
        xt = _frames(x, num_frames)
        out = self.bn1(_depthwise_tconv(xt, self.depthwise), deterministic)
        out = out * _se_gate(out.mean((1, 2, 3)), self.attn_fc1, self.attn_fc2, dt)[:, None, None, None, :]
        out = self.bn2(self.pointwise(out.to(dt)), deterministic)
        return x + self.alpha.to(dt) * out.reshape(x.shape).to(dt)


@functools.lru_cache(maxsize=16)
def _gfte_eigenbasis(t: int) -> np.ndarray:
    """Eigenbasis [T, T] (columns ascending) of the reference GFTE's
    normalised weighted-path Laplacian (A = 0.4 I + 0.3 path, L_sym =
    D^-1/2 (D - A) D^-1/2; sam2_base.py:434-446), a constant for each T."""
    a = np.eye(t, dtype=np.float64) * 0.4
    for i in range(t - 1):
        a[i, i + 1] = a[i + 1, i] = 0.3
    d = a.sum(axis=1)
    d_inv_sqrt = np.diag(1.0 / np.sqrt(d + 1e-6))
    _, evecs = np.linalg.eigh(d_inv_sqrt @ (np.diag(d) - a) @ d_inv_sqrt)
    return evecs.astype(np.float32)


class GFTE(nn.Module):
    """Reference GFTE (sam2_base.py:372-527), the variant of the shipped
    configs. Branches: (1) graph-Fourier filtering with a per-channel gain,
    which commutes with the orthonormal basis, so ``xt * filt`` (the
    reference's (1, C, 1) filter interpolated over frequencies is constant);
    (2) 8-head attention over per-frame descriptors, f32 softmax, dropout
    ``dropout`` in training; (3) softmax-weighted depthwise temporal convs k
    3, 5, 7. Their sum -> norm1 -> SE gate -> refinement MLP -> norm2 ->
    fixed 0.1 residual (:527)."""

    def __init__(self, channels: int, num_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        c = self.channels = channels
        self.num_heads, self.dropout = num_heads, dropout
        self.spectral_filters = _param(c, value=0.5)
        self.tattn_in_proj = Linear(c, 3 * c)
        self.tattn_out_proj = Linear(c, c)
        self.alpha = _param(value=0.1)
        self.beta = _param(value=0.1)
        self.gamma = _param(value=0.1)
        for k in (3, 5, 7):
            setattr(self, f"msdw_{k}", _param(k, c))
            setattr(self, f"msdw_{k}_bias", _param(c, value=0.0))
        self.norm1 = BatchNorm3d(c)
        hidden = max(c // 16, 8)
        self.gate_fc1 = Linear(c, hidden)
        self.gate_fc2 = Linear(hidden, c)
        self.refine_fc1 = Linear(c, 2 * c)
        self.refine_fc2 = Linear(2 * c, c)
        self.norm2 = BatchNorm3d(c)

    def forward(self, x, num_frames: int, deterministic: bool = True, gen=None):
        if x.shape[-1] != self.channels or num_frames <= 1:
            return x
        dt = x.dtype
        xt = _frames(x, num_frames)
        b, t, _, _, c = xt.shape
        nh = self.num_heads
        hd = c // nh

        spectral = xt * self.spectral_filters  # (1): U diag(filt) U^T x == x * filt

        # (2) attention over the frames' global descriptors
        q, k, v = self.tattn_in_proj(xt.mean((2, 3))).chunk(3, dim=-1)
        q, k, v = (y.reshape(b, t, nh, hd).transpose(1, 2) for y in (q, k, v))
        logits = torch.matmul(q, k.transpose(-1, -2)) * hd**-0.5
        probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        if self.dropout > 0.0 and not deterministic:
            keep = gfte_attention_keep(b, nh, t, self.dropout, gen, x.device)
            probs = torch.where(keep, probs / (1.0 - self.dropout), torch.zeros_like(probs))
        tsig = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, c)
        attn_feat = self.tattn_out_proj(tsig)[:, :, None, None, :]

        # (3) multi-scale depthwise temporal convs, softmax-weighted
        mix = torch.softmax(torch.stack([self.alpha, self.beta, self.gamma]), dim=0)
        ms = sum(mix[i] * _depthwise_tconv(xt, getattr(self, f"msdw_{k}"), getattr(self, f"msdw_{k}_bias"))
                 for i, k in enumerate((3, 5, 7)))

        agg = self.norm1(spectral + attn_feat + ms, deterministic)
        gated = agg * _se_gate(agg.mean((1, 2, 3)), self.gate_fc1, self.gate_fc2, dt)[:, None, None, None, :]
        ref = self.refine_fc2(gelu_exact(self.refine_fc1(gated.to(dt))))
        ref = self.norm2(ref, deterministic)
        return x + 0.1 * ref.reshape(x.shape).to(dt)  # the reference's fixed 0.1 (:527)


class AdaptiveTemporalSemanticFusion(nn.Module):
    """Reference AdaptiveTemporalSemanticFusion (sam2_base.py:233-361): a
    local depthwise-conv branch and a global temporal-context branch mixed by
    a softmax gate, cross-temporal SE attention, a per-channel scale,
    projection + BN, learned ``residual_weight``."""

    def __init__(self, channels: int, reduction_ratio: int = 16):
        super().__init__()
        c = self.channels = channels
        self.local_dw = _param(3, c)
        self.local_bn = BatchNorm3d(c)
        self.global_proj = Linear(c, c, bias=False)
        self.global_bn = BatchNorm3d(c)
        self.fgate_fc1 = Linear(c, max(c // 8, 8))
        self.fgate_fc2 = Linear(max(c // 8, 8), 2)
        self.ctattn_fc1 = Linear(c, c // reduction_ratio)
        self.ctattn_fc2 = Linear(c // reduction_ratio, c)
        self.scale_selector = _param(c, value=1.0)
        self.out_proj = Linear(c, c, bias=False)
        self.out_bn = BatchNorm3d(c)
        self.residual_weight = _param(value=0.1)

    def forward(self, x, num_frames: int, deterministic: bool = True, gen=None):
        if x.shape[-1] != self.channels or num_frames <= 1:
            return x
        dt = x.dtype
        xt = _frames(x, num_frames)
        local = gelu_exact(self.local_bn(_depthwise_tconv(xt, self.local_dw), deterministic))
        gctx = self.global_bn(self.global_proj(xt.mean((2, 3), keepdim=True)), deterministic)
        global_feat = xt * torch.sigmoid(gctx)
        fw = torch.softmax(self.fgate_fc2(gelu_exact(self.fgate_fc1(xt.mean((1, 2, 3))))), dim=-1)
        fused = fw[:, 0, None, None, None, None] * local + fw[:, 1, None, None, None, None] * global_feat
        ta = self.ctattn_fc2(gelu_exact(self.ctattn_fc1(fused.mean(1, keepdim=True).to(dt))))
        scaled = fused * torch.sigmoid(ta) * self.scale_selector
        out = self.out_bn(self.out_proj(scaled.to(dt)), deterministic)
        return x + self.residual_weight.to(dt) * out.reshape(x.shape).to(dt)


class SpatioTemporalGPAttention(nn.Module):
    """SpatioTemporalGaussianProcessAttention (sam2_base.py:25-211) after
    the reference's intended math, as the JAX module (``docs/PARITY.md`` #12):
    RBF-mixture temporal attention, Gumbel-softmax importance sampling in
    training, covariance-weighted fusion, depthwise diffusion + BN + GELU,
    uncertainty-aware fusion, temporal pooling, projection + BN,
    tanh(``temperature``) residual."""

    def __init__(self, channels: int, num_components: int = 4, num_basis: int = 8):
        super().__init__()
        c = self.channels = channels
        self.num_components, self.num_basis = num_components, num_basis
        self.temperature = _param(value=1.0)
        self.temporal_kernels = nn.Parameter(torch.randn(num_components, c) * 0.02)
        self.kernel_weights = _param(num_components, value=1.0)
        self.length_scales = _param(num_components, value=1.0)
        self.temporal_basis = nn.Parameter(torch.randn(num_basis, c) * 0.02)
        self.cov_fc1 = Linear(c, c // 8)
        self.cov_fc2 = Linear(c // 8, 2 * c)
        self.diffusion_dw = _param(3, c)
        self.diffusion_bn = BatchNorm3d(c)
        self.unc_fc1 = Linear(c, c // 4)
        self.unc_fc2 = Linear(c // 4, 2)
        self.tpool_kernel = _param(3, c, c)
        self.tpool_bias = _param(c, value=0.0)
        self.output_proj = Linear(c, c, bias=False)
        self.bn = BatchNorm3d(c)

    def forward(self, x, num_frames: int, deterministic: bool = True, gen=None):
        if x.shape[-1] != self.channels or num_frames <= 1:
            return x
        dt = x.dtype
        xt = _frames(x, num_frames)
        b, t, c = xt.shape[0], xt.shape[1], xt.shape[-1]

        # RBF-mixture temporal kernel attention (f32: the JAX einsum promotes)
        tg = torch.arange(t, dtype=torch.float32, device=x.device)
        time_grid = tg[:, None] - tg[None, :]
        weights = torch.softmax(self.kernel_weights, dim=0)
        xf = xt.float()
        attended = 0
        for i in range(self.num_components):
            length = torch.exp(self.length_scales[i])
            rbf = torch.exp(-(time_grid**2) / (2.0 * length**2))
            attended = attended + weights[i] * torch.einsum("st,bthwc->bshwc", rbf, xf) * self.temporal_kernels[i]

        # stochastic temporal importance sampling
        imp_sig = self.temporal_basis.mean(dim=1)
        src = torch.linspace(0.0, self.num_basis - 1.0, t, device=x.device)
        lo = torch.floor(src).long().clamp(0, self.num_basis - 1)
        hi = (lo + 1).clamp(0, self.num_basis - 1)
        frac = src - lo
        importance = torch.softmax(imp_sig[lo] * (1 - frac) + imp_sig[hi] * frac, dim=0)
        if not deterministic:
            g = gp_gumbel(b, t, gen, x.device)
            mask = torch.softmax((torch.log(importance + 1e-8) + g) / self.temperature, dim=-1)
        else:
            mask = importance.expand(b, t)
        stoch = xt * mask[:, :, None, None, None]

        # spatio-temporal covariance weighting (the mean half unused, :166)
        cv = self.cov_fc2(gelu_exact(self.cov_fc1(xt.mean((1, 2, 3)))))
        cov_w = torch.sigmoid(cv[:, c:])[:, None, None, None, :]
        fused = attended * cov_w + stoch * (1.0 - cov_w)

        # temporal diffusion
        diffused = gelu_exact(self.diffusion_bn(_depthwise_tconv(fused, self.diffusion_dw), deterministic))

        # uncertainty-aware Bayesian fusion (softplus guards 1/(var + 1e-6), :180)
        u = self.unc_fc2(gelu_exact(self.unc_fc1(diffused.to(dt))))
        mean, variance = u[..., 0:1], u[..., 1:2]
        precision = 1.0 / (F.softplus(variance) + 1e-6)
        fused2 = (mean * precision + diffused) / (precision + 1.0)

        # temporal pooling: the (3, 1, 1) full conv commutes with the (H, W) pool
        padm = F.pad(fused2.mean((2, 3)), (0, 0, 1, 1))
        pooled_t = sum(torch.matmul(padm[:, i:i + t], self.tpool_kernel[i]) for i in range(3)) + self.tpool_bias
        out = fused2 + pooled_t[:, :, None, None, :]

        out = self.bn(self.output_proj(out.to(dt)), deterministic)
        return x + torch.tanh(self.temperature).to(dt) * out.reshape(x.shape).to(dt)


VARIANTS = {
    "tce": TemporalContextExchange,
    "gfte": GFTE,
    "atsf": AdaptiveTemporalSemanticFusion,
    "gp": SpatioTemporalGPAttention,
}


def build_temporal_fusion(cfg: TemporalFusionConfig) -> list | None:
    """One module per FPN level (reference sam2_base.py:854-857), or None."""
    if cfg.variant == "none":
        return None
    cls = VARIANTS[cfg.variant]
    return [cls(channels=cfg.channels) for _ in range(cfg.num_levels)]
