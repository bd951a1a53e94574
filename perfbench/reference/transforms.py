# Frozen copy of us_video_medsam2_tpu_torch/inference/transforms.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""Image / coordinate transforms for inference (reference sam2/utils/transforms.py).

Counterpart of the JAX package's ``inference/transforms.py``: resize to the
model's square + ImageNet normalization, coordinate and box transforms, and
mask postprocessing (hole filling + sprinkle removal + resize to the
original resolution), all on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.ops.connected_components import (
    fill_holes_in_mask_scores,
    remove_small_sprinkles,
)
from perfbench.reference.ops.posenc import _on_device
from perfbench.reference.ops.resize import resize2d

IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_images(images: torch.Tensor, image_size: int) -> torch.Tensor:
    """uint8/float [T, H, W, 3] -> normalized f32 [T, S, S, 3]. Elementwise
    at model resolution, so a frame gives the same bits alone or in a batch;
    the mean and std live on the device (a captured frame body normalizes
    its raw uint8 frame with no host copy)."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    if x.shape[-3] != image_size or x.shape[-2] != image_size:
        x = resize2d(x, (image_size, image_size))
    mean = _on_device("img_mean", lambda d: torch.tensor(IMG_MEAN, device=d), x.device)
    std = _on_device("img_std", lambda d: torch.tensor(IMG_STD, device=d), x.device)
    return (x - mean) / std


def prep_frames(images: torch.Tensor, image_size: int) -> torch.Tensor:
    """A chunk of video frames -> normalized f32 at model resolution: uint8
    frames, or frames at another size, through ``preprocess_images``; float
    frames at model resolution (already normalized) as f32. JAX's
    ``_prep_chunk_impl`` without the fold, a TPU relayout."""
    if images.dtype == torch.uint8 or images.shape[-3] != image_size or images.shape[-2] != image_size:
        return preprocess_images(images, image_size)
    return images.float()


def transform_coords(coords, orig_hw: tuple[int, int], image_size: int) -> np.ndarray:
    """Scale (x, y) pixel coords from the original resolution to the model's."""
    h, w = orig_hw
    out = np.asarray(coords, np.float32).copy()
    out[..., 0] *= image_size / w
    out[..., 1] *= image_size / h
    return out


def transform_boxes(boxes, orig_hw: tuple[int, int], image_size: int) -> np.ndarray:
    """[..., 4] XYXY boxes -> [..., 2, 2] corner points at model resolution."""
    boxes = np.asarray(boxes, np.float32)
    return transform_coords(boxes.reshape(*boxes.shape[:-1], 2, 2), orig_hw, image_size)


def postprocess_masks(mask_logits: torch.Tensor, orig_hw: tuple[int, int], max_hole_area: float = 0.0,
                      max_sprinkle_area: float = 0.0) -> torch.Tensor:
    """Hole fill + sprinkle removal on [..., h, w] low-res logits, then a
    linear resize to ``orig_hw``, in f32 (reference SAM2Transforms.postprocess_masks)."""
    x = mask_logits
    if max_hole_area > 0:
        x = fill_holes_in_mask_scores(x, int(max_hole_area))
    if max_sprinkle_area > 0:
        x = remove_small_sprinkles(x, int(max_sprinkle_area))
    lead = x.shape[:-2]
    xh = resize2d(x.reshape(-1, *x.shape[-2:])[..., None].float(), tuple(orig_hw))[..., 0]
    return xh.reshape(*lead, *orig_hw)
