"""Weights: the JAX parameter tree -> the port's state_dict, and seeded random weights.

``from_jax_params`` is the bridge the tests use to run both packages on the
same weights (counterpart of the JAX package's ``core/import_torch.py``, in
the other direction). The port's module tree mirrors the JAX parameter tree
name for name, so the mapping is by rule:

- ``kernel`` -> ``weight``: Dense [in, out] -> Linear [out, in]; Conv HWIO ->
  OIHW (depthwise [kh, kw, 1, C] -> [C, 1, kh, kw]); the mask decoder's
  ConvTranspose2x [in, 2, 2, out] -> [in, out, 2, 2];
- LayerNorm ``scale`` -> ``weight``;
- everything else (biases, NHWC position embeddings, tokens, tables) as is;
- the ``batch_stats`` collection (the temporal fusion's BatchNorm3d running
  statistics) -> the buffers ``<module>.mean`` / ``<module>.var``.

The RoPE attentions' q/k projections keep the half-split channel permutation
the JAX importer applied; the port's RoPE runs in that layout.
"""

from __future__ import annotations

import numpy as np
import torch

_CONV_TRANSPOSE = ("upscale_dc1", "upscale_dc2")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_jax_params(params, cfg=None) -> dict:
    """JAX variables ({'params': ..., 'batch_stats': ...}, or the bare
    parameter tree; leaves array-like) -> state_dict for ``SAM2Model(cfg)``,
    loadable with strict=True."""
    variables = params if "params" in params else {"params": params}
    sd = {".".join(path): torch.from_numpy(np.array(leaf, np.float32))
          for path, leaf in _flatten(variables.get("batch_stats", {}))}
    for path, leaf in _flatten(variables["params"]):
        v = np.asarray(leaf, np.float32)
        name = path[-1]
        mod = ".".join(path[:-1])
        if name == "kernel":
            if path[-2] in _CONV_TRANSPOSE:
                v = v.transpose(0, 3, 1, 2)
            elif v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            elif v.ndim == 2:
                v = v.T
            key = f"{mod}.weight"
        elif name == "scale":
            key = f"{mod}.weight"
        else:
            key = ".".join(path)
        sd[key] = torch.from_numpy(np.array(v, order="C"))  # a copy; keeps 0-d leaves 0-d
    return sd


_UNIT_NORMAL = ("pe_gaussian", "point_embed", "no_mask_embed", "iou_token", "mask_tokens",
                "obj_score_token")
# the temporal fusion's constant-initialised leaves, at their JAX initial values
_FUSION_CONSTANTS = {"alpha": 0.1, "beta": 0.1, "gamma": 0.1, "spectral_filters": 0.5, "scale_selector": 1.0,
                     "residual_weight": 0.1, "temperature": 1.0, "kernel_weights": 1.0, "length_scales": 1.0}
# its other leaves of rank >= 2 drawn N(0, 1/fan_in) as flax's lecun_normal
# (fan_in = size / last dim); temporal_kernels and temporal_basis N(0, 0.02²)
_FUSION_LECUN = ("depthwise", "msdw_3", "msdw_5", "msdw_7", "local_dw", "diffusion_dw", "tpool_kernel")


@torch.no_grad()
def init_random_(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Fill every parameter from a seeded CPU generator: weight matrices
    N(0, 1/fan_in), biases N(0, 0.02²), LayerNorm scales 1, learned tokens and
    Fourier features N(0, 1), other embeddings N(0, 0.02²), layer scales kept;
    the temporal fusion's constants at their JAX initial values (buffers are
    left as they are)."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        fusion = name.startswith("temporal_fusion_")
        if fusion and leaf in _FUSION_CONSTANTS:
            p.fill_(_FUSION_CONSTANTS[leaf])
            continue
        if leaf == "gamma":
            continue
        if fusion and leaf in _FUSION_LECUN:
            val = torch.randn(p.shape, generator=g) * (p.numel() // p.shape[-1]) ** -0.5
        elif leaf == "weight" and p.dim() >= 2:
            fan_in = p[0].numel()  # Linear [out, in], conv [out, in/g, kh, kw]
            if name.rsplit(".", 2)[-2] in _CONV_TRANSPOSE:  # [in, out, 2, 2]
                fan_in = p.shape[0]
            val = torch.randn(p.shape, generator=g) * fan_in**-0.5
        elif leaf == "weight":
            val = torch.ones(p.shape)
        elif leaf in _UNIT_NORMAL:
            val = torch.randn(p.shape, generator=g)
        else:
            val = torch.randn(p.shape, generator=g) * 0.02
        p.copy_(val.to(p.dtype))
    return model
