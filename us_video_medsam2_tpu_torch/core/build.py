"""Model builder (the reference's build_sam.py facade, build_sam.py:63-207).

Resolves a config (a preset's name or a YAML file, ``core/config.py::
resolve_config``), applies the predictor's postprocessing overrides (dynamic
multimask stability, binarized click memories), and loads the weights: a
state_dict in the port's names, a checkpoint file (``load_params``: a
reference-name ``.pt`` / ``.pth`` such as a MedSAM2 release, a native
``.npz`` of the JAX package's trainer with its ``batch_stats``, or a
reference-name ``.npz``), or, with neither, weights made from a seed. No
path needs JAX.

The predictor builders are importable from here as in JAX
(``build_sam2_video_predictor``, its ``_npz`` alias and
``build_efficienttam_video_predictor``, defined beside the predictor in
``inference/video_predictor.py``, which imports this module: they are
looked up when first asked for), and ``build_sam2_image_predictor``. Each
runs on ``device="cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from us_video_medsam2_tpu_torch.core.config import SAM2Config, resolve_config
from us_video_medsam2_tpu_torch.core.device import resolve_device
from us_video_medsam2_tpu_torch.core.weights import from_jax_params, init_random_
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model


def load_params(cfg: SAM2Config, ckpt_path: str, strict: bool = True) -> dict:
    """The port's state_dict from a checkpoint file (JAX ``build.py::load_params``):
    ``.pt`` / ``.pth`` through the reference-name importer; an ``.npz`` whose
    keys start with ``params/`` through the native reader; any other
    ``.npz`` as reference names (the test fixtures' form); any other path as
    a native checkpoint. With ``strict`` the keys and shapes must be the
    model's."""
    from us_video_medsam2_tpu_torch.core import checkpoint, import_torch

    if ckpt_path.endswith((".pt", ".pth")):
        sd = import_torch.load_torch_checkpoint(ckpt_path, cfg)
    elif ckpt_path.endswith(".npz"):
        with np.load(ckpt_path) as f:
            native = any(k.startswith("params/") for k in f.files)
            data = None if native else dict(f)
        if native:
            sd = from_jax_params(checkpoint.restore_params(ckpt_path), cfg)
        else:
            sd = import_torch.convert_reference_state_dict(data, cfg)
    else:
        sd = from_jax_params(checkpoint.restore_params(ckpt_path), cfg)
    if strict:
        import_torch.check_state_dict(sd, cfg)
    return sd


def build_sam2(config: str | SAM2Config = "sam2.1_hiera_t512", state_dict=None, seed: int = 0,
               ckpt_path: str | None = None, **overrides) -> SAM2Model:
    """f32 SAM2Model on the CPU for ``config`` (a preset's name, a YAML path
    or a SAM2Config); weights from ``state_dict`` (strict), else from the
    checkpoint at ``ckpt_path``, else made from ``seed``."""
    overrides.setdefault("dynamic_multimask_via_stability", True)
    overrides.setdefault("binarize_mask_from_pts_for_mem_enc", True)
    cfg = dataclasses.replace(resolve_config(config), **overrides)
    model = SAM2Model(cfg)
    if state_dict is None and ckpt_path is not None:
        state_dict = load_params(cfg, ckpt_path)
    if state_dict is None:
        logging.warning("no checkpoint given: weights made from seed %d", seed)
        init_random_(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.eval()


_VIDEO_BUILDERS = ("build_sam2_video_predictor", "build_sam2_video_predictor_npz",
                   "build_efficienttam_video_predictor")


def __getattr__(name):
    if name in _VIDEO_BUILDERS:
        from us_video_medsam2_tpu_torch.inference import video_predictor

        return getattr(video_predictor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def build_sam2_image_predictor(config: str | SAM2Config = "sam2.1_hiera_t512", state_dict=None,
                               device="cuda", dtype=torch.bfloat16, seed: int = 0,
                               ckpt_path: str | None = None, apply_postprocessing: bool = True,
                               **overrides):
    """The image predictor (JAX ``core/build.py:128-141``): the model built as
    ``build_sam2`` builds it, moved to ``device`` in compute ``dtype``; with
    ``apply_postprocessing`` holes and sprinkles up to 8 px are removed from
    its masks, and without it the config keeps its own multimask and
    click-memory settings."""
    from us_video_medsam2_tpu_torch.inference.image_predictor import SAM2ImagePredictor

    dev = resolve_device(device)
    if not apply_postprocessing:
        cfg = resolve_config(config)
        overrides.setdefault("dynamic_multimask_via_stability", cfg.dynamic_multimask_via_stability)
        overrides.setdefault("binarize_mask_from_pts_for_mem_enc", cfg.binarize_mask_from_pts_for_mem_enc)
    model = build_sam2(config, state_dict, seed=seed, ckpt_path=ckpt_path, **overrides)
    area = 8 if apply_postprocessing else 0
    return SAM2ImagePredictor(model.to(dev).set_compute_dtype(dtype), max_hole_area=area,
                              max_sprinkle_area=area, device=dev)
