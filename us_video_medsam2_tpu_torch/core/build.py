"""Model builder (the reference's build_sam.py facade, build_sam.py:63-207).

Resolves a named preset, applies the predictor's postprocessing overrides
(dynamic multimask stability, binarized click memories), and loads a
state_dict or fills the weights from a seed.
"""

from __future__ import annotations

import dataclasses

from us_video_medsam2_tpu_torch.core.config import SAM2Config, resolve_config
from us_video_medsam2_tpu_torch.core.weights import init_random_
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model


def build_sam2(config: str | SAM2Config = "sam2.1_hiera_t512", state_dict=None, seed: int = 0,
               **overrides) -> SAM2Model:
    """f32 SAM2Model on the CPU; weights from ``state_dict`` (strict) or ``seed``."""
    overrides.setdefault("dynamic_multimask_via_stability", True)
    overrides.setdefault("binarize_mask_from_pts_for_mem_enc", True)
    cfg = dataclasses.replace(resolve_config(config), **overrides)
    model = SAM2Model(cfg)
    if state_dict is None:
        init_random_(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.eval()
