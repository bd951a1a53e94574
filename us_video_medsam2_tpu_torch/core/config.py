"""Model configuration: frozen dataclasses and named presets.

A copy of the JAX package's ``core/config.py`` limited to what the port's
paths use, with its YAML reader (``load_yaml_config``: a ``model:`` mapping,
OmegaConf-style ``${...}`` references resolved; PyYAML is imported only when
a YAML file is read). Defaults reproduce ``sam2.1_hiera_t512`` (reference
sam2/configs/sam2.1_hiera_t512.yaml); the EfficientTAM presets swap the
Hiera trunk and FPN neck for the plain ViT (ViTDet) trunk and its one-level
neck (reference sam2/configs/efficientmedsam_s_512_FLARE_RECIST.yaml). A
YAML key the port's dataclasses lack raises, as in the JAX reader.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def _tuplify(x):
    return tuple(x) if isinstance(x, (list, tuple)) else x


@dataclass(frozen=True)
class HieraConfig:
    """Hierarchical windowed ViT trunk (reference backbones/hieradet.py:169-317)."""

    embed_dim: int = 96
    num_heads: int = 1
    stages: Tuple[int, ...] = (1, 2, 7, 2)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    q_pool: int = 3
    q_stride: Tuple[int, int] = (2, 2)
    window_spec: Tuple[int, ...] = (8, 4, 14, 7)
    global_att_blocks: Tuple[int, ...] = (5, 7, 9)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.0
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3


@dataclass(frozen=True)
class ViTDetConfig:
    """Plain ViT trunk used by the EfficientTAM family (reference backbones/vitdet.py)."""

    img_size: int = 512
    patch_size: int = 16
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    window_size: int = 14
    window_block_indexes: Tuple[int, ...] = (0, 1, 3, 4, 6, 7, 9, 10)
    use_rel_pos: bool = False
    pretrain_img_size: int = 224
    pretrain_use_cls_token: bool = True


@dataclass(frozen=True)
class FpnNeckConfig:
    """FPN neck (reference backbones/image_encoder.py:47-137)."""

    d_model: int = 256
    backbone_channel_list: Tuple[int, ...] = (768, 384, 192, 96)
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    fpn_interp_model: str = "nearest"
    fuse_type: str = "sum"
    pos_temperature: float = 10000.0
    neck_norm: str | None = None  # 'LN' for the EfficientMedSAM ViTDetNeck


@dataclass(frozen=True)
class MemoryAttentionConfig:
    """4-layer RoPE self/cross transformer (reference memory_attention.py:17-169)."""

    d_model: int = 256
    num_layers: int = 4
    num_heads: int = 1
    dim_feedforward: int = 2048
    dropout: float = 0.1
    pos_enc_at_input: bool = True
    pos_enc_at_attn: bool = False
    pos_enc_at_cross_attn_keys: bool = True
    pos_enc_at_cross_attn_queries: bool = False
    activation: str = "relu"
    rope_theta: float = 10000.0
    rope_feat_sizes: Tuple[int, int] = (32, 32)
    kv_in_dim: int = 64
    # EfficientTAM landmark pooling of the spatial memory K/V (0 = off;
    # efficient_track_anything/modeling/sam/transformer.py:378-415); variant 1
    # adds the area compensation as a logit bias, variant 2 to the pooled keys
    efficient_pool_size: int = 0
    efficient_pool_variant: int = 1


@dataclass(frozen=True)
class MemoryEncoderConfig:
    """Mask downsampler + ConvNeXt fuser (reference memory_encoder.py:17-181)."""

    out_dim: int = 64
    in_dim: int = 256
    mask_downsampler_embed_dim: int = 256
    mask_downsampler_kernel: int = 3
    mask_downsampler_stride: int = 2
    mask_downsampler_padding: int = 1
    mask_downsampler_total_stride: int = 16
    fuser_layers: int = 2
    fuser_kernel: int = 7
    fuser_padding: int = 3
    fuser_layer_scale_init: float = 1e-6
    pos_channels: int = 64
    pos_temperature: float = 10000.0


@dataclass(frozen=True)
class TemporalFusionConfig:
    """The fork's inter-frame feature mixers (reference sam2_base.py:25-758).

    variant: 'none' | 'tce' (TemporalContextExchange) | 'gfte' | 'atsf' | 'gp'.
    Applied to the top ``num_levels`` FPN levels over the frame axis when
    ``forward_image`` is given num_frames > 1, which only the training forward
    does (reference sam2_base.py:1249-1262, gated by `temporalVideo`).
    """

    variant: str = "none"
    channels: int = 256
    num_levels: int = 3
    alpha: float = 0.1  # residual mixing weight


@dataclass(frozen=True)
class SAM2Config:
    """Full model config == reference SAM2Base kwargs (sam2_base.py:764-948)."""

    image_size: int = 512
    backbone_stride: int = 16
    # trunk selection: exactly one of hiera / vitdet
    hiera: Optional[HieraConfig] = field(default_factory=HieraConfig)
    vitdet: Optional[ViTDetConfig] = None
    neck: FpnNeckConfig = field(default_factory=FpnNeckConfig)
    neck_scalp: int = 1
    memory_attention: MemoryAttentionConfig = field(default_factory=MemoryAttentionConfig)
    memory_encoder: MemoryEncoderConfig = field(default_factory=MemoryEncoderConfig)
    temporal_fusion: TemporalFusionConfig = field(default_factory=TemporalFusionConfig)

    num_maskmem: int = 7
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    binarize_mask_from_pts_for_mem_enc: bool = False
    use_mask_input_as_output_without_sam: bool = True
    directly_add_no_mem_embed: bool = True
    use_high_res_features_in_sam: bool = True
    multimask_output_in_sam: bool = True
    multimask_min_pt_num: int = 0
    multimask_max_pt_num: int = 1
    multimask_output_for_tracking: bool = True
    use_multimask_token_for_obj_ptr: bool = True
    iou_prediction_use_sigmoid: bool = True
    memory_temporal_stride_for_eval: int = 1
    non_overlap_masks_for_mem_enc: bool = False
    use_obj_ptrs_in_encoder: bool = True
    max_obj_ptrs_in_encoder: int = 16
    add_tpos_enc_to_obj_ptrs: bool = True
    proj_tpos_enc_in_obj_ptrs: bool = True
    use_signed_tpos_enc_to_obj_ptrs: bool = True
    only_obj_ptrs_in_the_past_for_eval: bool = True
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    fixed_no_obj_ptr: bool = True
    soft_no_obj_ptr: bool = False
    use_mlp_for_obj_ptr_proj: bool = True
    no_obj_embed_spatial: bool = True
    dynamic_multimask_via_stability: bool = True
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98
    # static slot count for conditioning-frame memories in the fixed-shape bank
    max_cond_frame_slots: int = 4

    @property
    def hidden_dim(self) -> int:
        return self.neck.d_model

    @property
    def mem_dim(self) -> int:
        return self.memory_encoder.out_dim

    @property
    def feat_size(self) -> int:
        return self.image_size // self.backbone_stride

    @property
    def tokens_per_obj_ptr(self) -> int:
        return max(1, self.hidden_dim // self.mem_dim)


def sam21_hiera_tiny_512() -> SAM2Config:
    return SAM2Config()


def efficienttam_s_512() -> SAM2Config:
    """EfficientMedSAM-S (reference configs/efficientmedsam_s_512_FLARE_RECIST.yaml:79-137):
    ViT-S trunk (embed 384, 6 heads of 64), the LN neck, plain RoPE memory attention."""
    return SAM2Config(
        hiera=None,
        vitdet=ViTDetConfig(),
        neck=FpnNeckConfig(backbone_channel_list=(384,), fpn_top_down_levels=(), neck_norm="LN"),
        neck_scalp=0,
        use_high_res_features_in_sam=False,
        add_tpos_enc_to_obj_ptrs=False,
        proj_tpos_enc_in_obj_ptrs=False,
        use_signed_tpos_enc_to_obj_ptrs=False,
        no_obj_embed_spatial=False,
    )


def efficienttam_ti_512() -> SAM2Config:
    """EfficientMedSAM / EfficientTAM-Ti: the -S preset at embed 192, 3 heads
    (reference efficientmedsam_ti_512_FLARE_RECIST.yaml:79-105,
    efficient_track_anything/configs/efficienttam_ti_512x512.yaml:11-30)."""
    cfg = efficienttam_s_512()
    return dataclasses.replace(
        cfg,
        vitdet=dataclasses.replace(cfg.vitdet, embed_dim=192, num_heads=3),
        neck=dataclasses.replace(cfg.neck, backbone_channel_list=(192,)),
    )


def tiny64_test() -> SAM2Config:
    """Structurally complete micro config for CPU smoke runs."""
    return SAM2Config(
        image_size=64,
        hiera=HieraConfig(
            embed_dim=8,
            stages=(1, 1, 1, 1),
            q_pool=3,
            global_att_blocks=(),
            window_spec=(4, 2, 2, 2),
            window_pos_embed_bkg_spatial_size=(2, 2),
        ),
        neck=FpnNeckConfig(d_model=32, backbone_channel_list=(64, 32, 16, 8)),
        memory_attention=MemoryAttentionConfig(
            d_model=32, num_layers=1, dim_feedforward=64, rope_feat_sizes=(4, 4),
            kv_in_dim=8,
        ),
        memory_encoder=MemoryEncoderConfig(
            out_dim=8, in_dim=32, mask_downsampler_embed_dim=32, pos_channels=8
        ),
    )


PRESETS = {
    "sam2.1_hiera_t512": sam21_hiera_tiny_512,
    "efficientmedsam_s_512": efficienttam_s_512,
    "efficientmedsam_ti_512": efficienttam_ti_512,
    "efficienttam_ti_512": efficienttam_ti_512,
    "tiny64_test": tiny64_test,
}


_CONFIG_TYPES = {
    "hiera": HieraConfig,
    "vitdet": ViTDetConfig,
    "neck": FpnNeckConfig,
    "memory_attention": MemoryAttentionConfig,
    "memory_encoder": MemoryEncoderConfig,
    "temporal_fusion": TemporalFusionConfig,
}


def _from_dict(cls, data: Any):
    if data is None or not dataclasses.is_dataclass(cls):
        return data
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in data.items():
        if key not in names:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        sub = _CONFIG_TYPES.get(key)
        kwargs[key] = _from_dict(sub, val) if sub is not None and isinstance(val, dict) else _tuplify(val)
    return cls(**kwargs)


def sam2_config_from_dict(data: dict) -> SAM2Config:
    return _from_dict(SAM2Config, data)


def _is_num(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _num(s: str):
    f = float(s)
    return int(f) if f.is_integer() else f


def _resolve_refs(node, root):
    """OmegaConf-style interpolation: ${times:a,b}, ${divide:a,b},
    ${minus:a,b}, ${add:a,...} and ${path.to.key} (reference
    training/utils/train_utils.py:52-63 resolvers)."""

    def lookup(path: str):
        cur = root
        for part in path.split("."):
            cur = cur[part]
        return cur

    def arg(a: str):
        a = a.strip()
        if a.startswith("${"):
            return _resolve_refs(a, root)
        return _num(a) if _is_num(a) else lookup(a)

    def resolve_str(s: str):
        m = re.fullmatch(r"\$\{([a-z_]+):([^}]+)\}", s)
        if m:
            fn, args = m.group(1), [arg(a) for a in m.group(2).split(",")]
            if fn == "times":
                out = 1
                for a in args:
                    out *= a
                return out
            if fn == "divide":
                return args[0] / args[1]
            if fn == "minus":
                return args[0] - args[1]
            if fn == "add":
                return sum(args)
            raise ValueError(f"unknown resolver {fn}")
        m = re.fullmatch(r"\$\{([^}:]+)\}", s)
        if m:
            return lookup(m.group(1))
        return s

    if isinstance(node, dict):
        return {k: _resolve_refs(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_refs(v, root) for v in node]
    if isinstance(node, str) and "${" in node:
        return resolve_str(node)
    return node


def load_yaml_dict(path: str) -> dict:
    import yaml  # only here: nothing on the card's path reads YAML

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return _resolve_refs(data, data)


def load_yaml_config(path: str) -> SAM2Config:
    data = load_yaml_dict(path)
    return sam2_config_from_dict(data.get("model", data))


def snapshot_config(cfg, path: str) -> None:
    """The resolved dataclass ``cfg`` as JSON at ``path`` (reference
    training/train.py:142-153); values JSON cannot hold as strings."""
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


def resolve_config(config: str | SAM2Config) -> SAM2Config:
    """A config, a preset's name, or the path of a YAML file."""
    if isinstance(config, SAM2Config):
        return config
    if config in PRESETS:
        return PRESETS[config]()
    if os.path.exists(config):
        return load_yaml_config(config)
    raise ValueError(f"unknown config {config!r}; presets: {sorted(PRESETS)}")
