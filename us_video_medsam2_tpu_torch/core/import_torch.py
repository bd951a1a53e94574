"""Reference checkpoint (SAM2 / MedSAM2 names) -> the port's state_dict, without JAX.

Counterpart of the JAX package's ``core/import_torch.py``
(``convert_reference_state_dict``, ``convert_fusion_module``,
``load_torch_checkpoint``), in numpy only. The mapping builds the JAX
variables' flat paths (``params/...`` and ``batch_stats/...``), as the JAX
importer does, and ``core/weights.py::from_jax_params`` turns them into the
port's names, so the result equals ``from_jax_params`` of the JAX importer's
variables bit for bit. Covered: the Hiera and ViTDet trunks, both necks, the
memory attention (its RoPE q/k projections permuted into the half-split
layout, ``docs/PARITY.md`` #13), the memory encoder, the prompt encoder, the
mask decoder, and the fork's temporal fusion (``temporal_fusion.{i}.`` ->
``temporal_fusion_{i}``; TCE, GFTE and ATSF, whose BatchNorm3d running
statistics become the ``mean`` / ``var`` buffers; a GP checkpoint raises, as
in JAX, since the reference GP cannot run).

Unlike the JAX importer, the port is strict as the reference loader is
(build_sam.py:197-207): a checkpoint key that no parameter or buffer takes
raises, and so does one that the checkpoint lacks or gives another shape.
Two kinds of fusion keys are read and dropped on purpose: BatchNorm's
``num_batches_tracked`` (a count of updates that nothing reads) and TCE's
``temporal_conv.weight`` (the reference module holds it; its forward never
calls it).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from us_video_medsam2_tpu_torch.core.weights import from_jax_params
from us_video_medsam2_tpu_torch.ops.posenc import rope_halfsplit_perm


def _lin(w):  # torch Linear weight -> Dense kernel
    return np.ascontiguousarray(w.T)


def _conv(w):  # torch Conv2d weight -> HWIO kernel
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _convT(w):  # torch ConvTranspose2d(k=2, s=2) -> [in, 2, 2, out]
    return np.ascontiguousarray(np.transpose(w, (0, 2, 3, 1)))


class _Keys(dict):
    """The checkpoint, recording each key read."""

    def __init__(self, sd):
        super().__init__(sd)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _attention(out, t, j, sd, rope_heads: int = 0):
    """q/k/v/out projections; with ``rope_heads`` the q and k output channels
    go from torch's interleaved RoPE pairs to the half-split layout."""
    perm = rope_halfsplit_perm(sd[f"{t}.q_proj.weight"].shape[0], rope_heads) if rope_heads else None
    for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
        kern, bias = _lin(sd[f"{t}.{p}.weight"]), sd[f"{t}.{p}.bias"]
        if perm is not None and p in ("q_proj", "k_proj"):
            kern, bias = kern[:, perm], bias[perm]
        out[f"{j}/{p}/kernel"], out[f"{j}/{p}/bias"] = kern, bias


def _mlp(out, t, j, sd, n_layers):
    for i in range(n_layers):
        out[f"{j}/layers_{i}/kernel"] = _lin(sd[f"{t}.layers.{i}.weight"])
        out[f"{j}/layers_{i}/bias"] = sd[f"{t}.layers.{i}.bias"]


def _norm(out, t, j, sd):
    out[f"{j}/scale"], out[f"{j}/bias"] = sd[f"{t}.weight"], sd[f"{t}.bias"]


def _linear(out, t, j, sd):
    out[f"{j}/kernel"], out[f"{j}/bias"] = _lin(sd[f"{t}.weight"]), sd[f"{t}.bias"]


def _conv2d(out, t, j, sd):
    out[f"{j}/kernel"], out[f"{j}/bias"] = _conv(sd[f"{t}.weight"]), sd[f"{t}.bias"]


def _dw3d(w):  # depthwise Conv3d (k, 1, 1) weight [C, 1, k, 1, 1] -> [k, C]
    return np.ascontiguousarray(np.transpose(w[:, 0, :, 0, 0], (1, 0)))


def _conv3d_1x1(w):  # Conv3d 1x1x1 weight [out, in, 1, 1, 1] -> Dense kernel [in, out]
    return np.ascontiguousarray(w[:, :, 0, 0, 0].T)


def _fusion(out, stats, sd, variant: str, i: int):
    """Module ``temporal_fusion.{i}`` of a reference checkpoint (JAX
    ``convert_fusion_module``: safeTCE sam2_base.py:697-758, GFTE :372-527,
    ATSF :233-361) -> ``temporal_fusion_{i}``; BatchNorm3d running
    statistics into ``stats``."""
    t, j = f"temporal_fusion.{i}", f"temporal_fusion_{i}"

    def drop(key):  # counted as read, and not carried
        sd.read.add(key)

    def bn(tn, jn):
        _norm(out, f"{t}.{tn}", f"{j}/{jn}", sd)
        stats[f"{j}/{jn}/mean"] = sd[f"{t}.{tn}.running_mean"]
        stats[f"{j}/{jn}/var"] = sd[f"{t}.{tn}.running_var"]
        drop(f"{t}.{tn}.num_batches_tracked")

    def dense(tn, jn, bias=True):
        out[f"{j}/{jn}/kernel"] = _conv3d_1x1(sd[f"{t}.{tn}.weight"])
        if bias:
            out[f"{j}/{jn}/bias"] = sd[f"{t}.{tn}.bias"]

    if variant == "tce":
        out[f"{j}/depthwise"] = _dw3d(sd[f"{t}.depthwise_conv.weight"])
        drop(f"{t}.temporal_conv.weight")
        dense("pointwise", "pointwise", bias=False)
        bn("bn1", "bn1")
        bn("bn2", "bn2")
        dense("attention.1", "attn_fc1")
        dense("attention.3", "attn_fc2")
        out[f"{j}/alpha"] = sd[f"{t}.alpha"]
    elif variant == "gfte":
        out[f"{j}/tattn_in_proj/kernel"] = _lin(sd[f"{t}.temporal_attention.in_proj_weight"])
        out[f"{j}/tattn_in_proj/bias"] = sd[f"{t}.temporal_attention.in_proj_bias"]
        _linear(out, f"{t}.temporal_attention.out_proj", f"{j}/tattn_out_proj", sd)
        out[f"{j}/spectral_filters"] = sd[f"{t}.spectral_filters"].reshape(-1)
        for n, k in enumerate((3, 5, 7)):
            out[f"{j}/msdw_{k}"] = _dw3d(sd[f"{t}.temporal_convs.{n}.weight"])
            out[f"{j}/msdw_{k}_bias"] = sd[f"{t}.temporal_convs.{n}.bias"]
        dense("refinement.0", "refine_fc1")
        dense("refinement.2", "refine_fc2")
        for nm in ("alpha", "beta", "gamma"):
            out[f"{j}/{nm}"] = sd[f"{t}.{nm}"]
        dense("spectral_gate.1", "gate_fc1")
        dense("spectral_gate.3", "gate_fc2")
        bn("norm1", "norm1")
        bn("norm2", "norm2")
    elif variant == "atsf":
        out[f"{j}/local_dw"] = _dw3d(sd[f"{t}.local_temp.0.weight"])
        bn("local_temp.1", "local_bn")
        dense("global_temp.1", "global_proj", bias=False)
        bn("global_temp.2", "global_bn")
        dense("cross_temp_attn.0", "ctattn_fc1")
        dense("cross_temp_attn.2", "ctattn_fc2")
        out[f"{j}/scale_selector"] = sd[f"{t}.scale_selector"].reshape(-1)
        dense("fusion_gate.1", "fgate_fc1")
        dense("fusion_gate.3", "fgate_fc2")
        dense("output_proj.0", "out_proj", bias=False)
        bn("output_proj.1", "out_bn")
        out[f"{j}/residual_weight"] = sd[f"{t}.residual_weight"]
    else:
        raise ValueError(f"no torch mapping for fusion variant {variant!r}")


def _ids(sd, pattern):
    return sorted({int(m.group(1)) for k in sd if (m := re.match(pattern, k))})


def _trunk(out, sd):
    tr = "image_encoder.trunk"
    hiera = f"{tr}.pos_embed_window" in sd
    if hiera:
        out["image_encoder/trunk/pos_embed"] = np.transpose(sd[f"{tr}.pos_embed"], (0, 2, 3, 1))
        out["image_encoder/trunk/pos_embed_window"] = np.transpose(sd[f"{tr}.pos_embed_window"], (0, 2, 3, 1))
    elif f"{tr}.pos_embed" in sd:  # plain ViT (EfficientTAM): [1, N(+cls), C] as is
        out["image_encoder/trunk/pos_embed"] = sd[f"{tr}.pos_embed"]
    else:
        return
    if hiera or f"{tr}.patch_embed.proj.weight" in sd:
        _conv2d(out, f"{tr}.patch_embed.proj", "image_encoder/trunk/patch_embed", sd)
    for i in _ids(sd, r"image_encoder\.trunk\.blocks\.(\d+)\."):
        t, j = f"{tr}.blocks.{i}", f"image_encoder/trunk/blocks_{i}"
        _norm(out, f"{t}.norm1", f"{j}/norm1", sd)
        _norm(out, f"{t}.norm2", f"{j}/norm2", sd)
        for suffix in ("qkv", "proj"):
            _linear(out, f"{t}.attn.{suffix}", f"{j}/attn/{suffix}", sd)
        _mlp(out, f"{t}.mlp", f"{j}/mlp", sd, 2)
        if hiera and f"{t}.proj.weight" in sd:
            _linear(out, f"{t}.proj", f"{j}/proj", sd)


def _neck(out, sd):
    for j in _ids(sd, r"image_encoder\.neck\.convs\.(\d+)\.conv\.weight"):
        _conv2d(out, f"image_encoder.neck.convs.{j}.conv", f"image_encoder/neck/convs_{j}", sd)
    base = "image_encoder.neck.convs.0"
    if f"{base}.conv_1x1.weight" in sd:  # ViTDetNeck
        for conv in ("conv_1x1", "conv_3x3"):
            out[f"image_encoder/neck/convs_0_{conv}/kernel"] = _conv(sd[f"{base}.{conv}.weight"])
            if f"{base}.{conv}.bias" in sd:
                out[f"image_encoder/neck/convs_0_{conv}/bias"] = sd[f"{base}.{conv}.bias"]
        if f"{base}.norm_0.weight" in sd:
            _norm(out, f"{base}.norm_0", "image_encoder/neck/convs_0_norm_0", sd)
            _norm(out, f"{base}.norm_1", "image_encoder/neck/convs_0_norm_1", sd)


def _memory(out, sd, cfg):
    for i in _ids(sd, r"memory_attention\.layers\.(\d+)\."):
        t, j = f"memory_attention.layers.{i}", f"memory_attention/layers_{i}"
        heads = cfg.memory_attention.num_heads
        _attention(out, f"{t}.self_attn", f"{j}/self_attn", sd, rope_heads=heads)
        _attention(out, f"{t}.cross_attn_image", f"{j}/cross_attn_image", sd, rope_heads=heads)
        for n in ("norm1", "norm2", "norm3"):
            _norm(out, f"{t}.{n}", f"{j}/{n}", sd)
        for n in ("linear1", "linear2"):
            _linear(out, f"{t}.{n}", f"{j}/{n}", sd)
    _norm(out, "memory_attention.norm", "memory_attention/norm", sd)

    md = "memory_encoder/mask_downsampler"
    ids = _ids(sd, r"memory_encoder\.mask_downsampler\.encoder\.(\d+)\.weight")
    n_conv = 0
    for idx in ids:
        t = f"memory_encoder.mask_downsampler.encoder.{idx}"
        w = sd[f"{t}.weight"]
        if w.ndim == 4:
            j = f"{md}/encoder_out/conv" if idx == ids[-1] else f"{md}/encoder_{n_conv}/conv"
            out[f"{j}/kernel"], out[f"{j}/bias"] = _conv(w), sd[f"{t}.bias"]
        else:  # LayerNorm2d
            out[f"{md}/encoder_ln_{n_conv}/scale"], out[f"{md}/encoder_ln_{n_conv}/bias"] = w, sd[f"{t}.bias"]
            n_conv += 1
    _conv2d(out, "memory_encoder.pix_feat_proj", "memory_encoder/pix_feat_proj/conv", sd)
    for i in _ids(sd, r"memory_encoder\.fuser\.layers\.(\d+)\."):
        t, j = f"memory_encoder.fuser.layers.{i}", f"memory_encoder/fuser_{i}"
        _conv2d(out, f"{t}.dwconv", f"{j}/dwconv/conv", sd)
        _norm(out, f"{t}.norm", f"{j}/norm", sd)
        _linear(out, f"{t}.pwconv1", f"{j}/pwconv1", sd)
        _linear(out, f"{t}.pwconv2", f"{j}/pwconv2", sd)
        out[f"{j}/gamma"] = sd[f"{t}.gamma"]
    if "memory_encoder.out_proj.weight" in sd:
        _conv2d(out, "memory_encoder.out_proj", "memory_encoder/out_proj/conv", sd)


def _prompt_encoder(out, sd):
    pe = "sam_prompt_encoder"
    out[f"{pe}/pe_gaussian"] = sd[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"]
    out[f"{pe}/point_embed"] = np.concatenate(
        [sd[f"{pe}.not_a_point_embed.weight"]] + [sd[f"{pe}.point_embeddings.{i}.weight"] for i in range(4)], axis=0)
    out[f"{pe}/no_mask_embed"] = sd[f"{pe}.no_mask_embed.weight"].reshape(-1)
    md = f"{pe}.mask_downscaling"
    _conv2d(out, f"{md}.0", f"{pe}/mask_down_conv1/conv", sd)
    _norm(out, f"{md}.1", f"{pe}/mask_down_ln1", sd)
    _conv2d(out, f"{md}.3", f"{pe}/mask_down_conv2/conv", sd)
    _norm(out, f"{md}.4", f"{pe}/mask_down_ln2", sd)
    _conv2d(out, f"{md}.6", f"{pe}/mask_down_conv3/conv", sd)


def _mask_decoder(out, sd):
    dec = j = "sam_mask_decoder"
    out[f"{j}/iou_token"] = sd[f"{dec}.iou_token.weight"]
    out[f"{j}/mask_tokens"] = sd[f"{dec}.mask_tokens.weight"]
    if f"{dec}.obj_score_token.weight" in sd:
        out[f"{j}/obj_score_token"] = sd[f"{dec}.obj_score_token.weight"]
    for i in range(2):
        t, jj = f"{dec}.transformer.layers.{i}", f"{j}/transformer/layers_{i}"
        for attn in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
            _attention(out, f"{t}.{attn}", f"{jj}/{attn}", sd)
        for n in ("norm1", "norm2", "norm3", "norm4"):
            _norm(out, f"{t}.{n}", f"{jj}/{n}", sd)
        _mlp(out, f"{t}.mlp", f"{jj}/mlp", sd, 2)
    _attention(out, f"{dec}.transformer.final_attn_token_to_image", f"{j}/transformer/final_attn_token_to_image", sd)
    _norm(out, f"{dec}.transformer.norm_final_attn", f"{j}/transformer/norm_final_attn", sd)
    for k, idx in (("upscale_dc1", 0), ("upscale_dc2", 3)):
        out[f"{j}/{k}/kernel"] = _convT(sd[f"{dec}.output_upscaling.{idx}.weight"])
        out[f"{j}/{k}/bias"] = sd[f"{dec}.output_upscaling.{idx}.bias"]
    _norm(out, f"{dec}.output_upscaling.1", f"{j}/upscale_ln", sd)
    for i in range(sd[f"{dec}.mask_tokens.weight"].shape[0]):
        _mlp(out, f"{dec}.output_hypernetworks_mlps.{i}", f"{j}/hyper_mlps_{i}", sd, 3)
    _mlp(out, f"{dec}.iou_prediction_head", f"{j}/iou_head", sd, 3)
    if f"{dec}.pred_obj_score_head.layers.0.weight" in sd:
        _mlp(out, f"{dec}.pred_obj_score_head", f"{j}/obj_score_head", sd, 3)
    elif f"{dec}.pred_obj_score_head.weight" in sd:
        _linear(out, f"{dec}.pred_obj_score_head", f"{j}/obj_score_head", sd)
    if f"{dec}.conv_s0.weight" in sd:  # the decoder's high-res projections sit at the model's top level
        _conv2d(out, f"{dec}.conv_s0", "conv_s0/conv", sd)
        _conv2d(out, f"{dec}.conv_s1", "conv_s1/conv", sd)


def reference_to_flat(sd: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """Reference names -> the JAX variables' '/'-joined paths (the JAX
    importer's map: ``params/...``, and ``batch_stats/...`` for the temporal
    fusion's running statistics), raising on a key that none of them takes."""
    sd = _Keys(sd)
    out: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    _trunk(out, sd)
    _neck(out, sd)
    out["maskmem_tpos_enc"] = sd["maskmem_tpos_enc"].reshape(cfg.num_maskmem, -1)
    out["no_mem_embed"] = sd["no_mem_embed"].reshape(-1)
    out["no_mem_pos_enc"] = sd["no_mem_pos_enc"].reshape(-1)
    for k in ("no_obj_ptr", "no_obj_embed_spatial"):
        if k in sd:
            out[k] = sd[k].reshape(-1)
    if "mask_downsample.weight" in sd:
        _conv2d(out, "mask_downsample", "mask_downsample/conv", sd)
    _memory(out, sd, cfg)
    _prompt_encoder(out, sd)
    _mask_decoder(out, sd)
    if "obj_ptr_proj.layers.0.weight" in sd:
        _mlp(out, "obj_ptr_proj", "obj_ptr_proj", sd, 3)
    elif "obj_ptr_proj.weight" in sd:
        _linear(out, "obj_ptr_proj", "obj_ptr_proj", sd)
    if "obj_ptr_tpos_proj.weight" in sd:
        _linear(out, "obj_ptr_tpos_proj", "obj_ptr_tpos_proj", sd)
    i = 0
    while any(k.startswith(f"temporal_fusion.{i}.") for k in sd):
        _fusion(out, stats, sd, cfg.temporal_fusion.variant, i)
        i += 1
    left = sorted(set(sd) - sd.read)
    if left:
        raise KeyError(f"{len(left)} checkpoint keys taken by no parameter: {left[:5]}")
    return {**{f"params/{k}": v for k, v in out.items()}, **{f"batch_stats/{k}": v for k, v in stats.items()}}


def check_state_dict(sd: Dict[str, torch.Tensor], cfg) -> None:
    """Raise unless ``sd`` has exactly the keys and shapes of ``SAM2Model(cfg)``
    (built on the meta device: no memory, no weights)."""
    from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model

    with torch.device("meta"):
        ref = {k: tuple(v.shape) for k, v in SAM2Model(cfg).state_dict().items()}
    missing, extra = sorted(set(ref) - set(sd)), sorted(set(sd) - set(ref))
    shapes = sorted(k for k in set(ref) & set(sd) if tuple(sd[k].shape) != ref[k])
    if missing or extra or shapes:
        raise RuntimeError(f"checkpoint mismatch: missing {missing[:5]}, extra {extra[:5]}, "
                           f"shapes differ {[(k, tuple(sd[k].shape), ref[k]) for k in shapes[:5]]}")


def convert_reference_state_dict(sd: Dict[str, np.ndarray], cfg) -> Dict[str, torch.Tensor]:
    """A reference SAM2Base state_dict (numpy values) -> the port's state_dict
    for ``SAM2Model(cfg).load_state_dict(strict=True)``."""
    flat = reference_to_flat(sd, cfg)
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    out = from_jax_params(tree, cfg)
    check_state_dict(out, cfg)
    return out


def load_torch_checkpoint(path: str, cfg) -> Dict[str, torch.Tensor]:
    """A .pt / .pth checkpoint (weights at the top level or under "model", as
    the fork's training checkpoints keep them) -> the port's state_dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    return convert_reference_state_dict({k: v.float().numpy() for k, v in sd.items()}, cfg)
