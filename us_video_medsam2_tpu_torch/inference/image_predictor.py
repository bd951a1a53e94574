"""Single-image SAM predictor (reference sam2/sam2_image_predictor.py:20-468).

Counterpart of the JAX package's ``inference/image_predictor.py``:
``set_image`` (or ``set_image_batch``) runs the image encoder once and keeps
its features, the top level with the no-memory embedding added (an image has
no memory: ``SAM2Model.no_mem_features``); ``predict`` runs the prompt
encoder and the mask decoder only. One prompt set is broadcast against one
image, one prompt is tiled over a batch of images; ``predict_batch_points``
serves the automatic mask generator. JAX's two ``jax.jit`` caches are eager
calls here: the encoder runs once per image and needs no graph.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from us_video_medsam2_tpu_torch.core.device import resolve_device
from us_video_medsam2_tpu_torch.inference.graphs import encode_frames
from us_video_medsam2_tpu_torch.inference.transforms import (
    postprocess_masks,
    preprocess_images,
    transform_boxes,
    transform_coords,
)
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model


class SAM2ImagePredictor:
    def __init__(self, model: SAM2Model, mask_threshold: float = 0.0, max_hole_area: float = 0.0,
                 max_sprinkle_area: float = 0.0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.mask_threshold = mask_threshold
        self.max_hole_area = max_hole_area
        self.max_sprinkle_area = max_sprinkle_area
        self._features: Optional[Dict[str, torch.Tensor]] = None
        self._orig_hw: Optional[Tuple[int, int]] = None

    def _encode(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B, S, S, 3] normalized -> the decoder's features, no memory."""
        feats = encode_frames(self.model, images)
        feats["top"] = self.model.no_mem_features(feats["top"])
        return feats

    def _predict(self, coords: torch.Tensor, labels: torch.Tensor, mask_input: Optional[torch.Tensor],
                 multimask: bool) -> dict:
        """The heads on the kept features: coords [B, P, 2] at model
        resolution, labels [B, P], mask_input [B, 4fs, 4fs, 1] logits or
        None. Features of one image are broadcast to B prompt sets
        (reference mask_decoder.py:199-204)."""
        feats = self._features
        b = coords.shape[0]
        if feats["top"].shape[0] == 1 and b > 1:
            feats = {k: v.expand(b, *v.shape[1:]) for k, v in feats.items()}
        high_res = [feats["s0"], feats["s1"]] if self.cfg.use_high_res_features_in_sam else None
        return self.model.sam_heads(feats["top"], coords, labels, mask_input, high_res, multimask)

    def _images(self, images: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        return preprocess_images(x, self.cfg.image_size)

    @torch.inference_mode()
    def set_image(self, image: np.ndarray) -> None:
        """image: [H, W, 3] uint8 (RGB) or float in [0, 1]."""
        self._orig_hw = (image.shape[0], image.shape[1])
        self._features = self._encode(self._images(image[None]))

    @torch.inference_mode()
    def set_image_batch(self, images: List[np.ndarray]) -> None:
        if any(i.shape != images[0].shape for i in images):
            raise ValueError("set_image_batch takes images of one shape")
        self._orig_hw = (images[0].shape[0], images[0].shape[1])
        self._features = self._encode(self._images(np.stack(images)))

    def _require_image(self) -> None:
        if self._features is None:
            raise RuntimeError("call set_image first")

    @torch.inference_mode()
    def predict_batch_points(self, point_coords: np.ndarray, point_labels: np.ndarray,
                             multimask_output: bool = True):
        """Batched point prompts ([N, P, 2] at the original resolution, [N, P])
        against the current image (the AMG path). Returns (mask_logits [N, M,
        H, W] at the original resolution, ious [N, M], low_res_logits [N, M,
        h, w]) as numpy."""
        self._require_image()
        coords = transform_coords(np.asarray(point_coords, np.float32), self._orig_hw, self.cfg.image_size)
        out = self._predict(torch.from_numpy(coords).to(self.device),
                            torch.as_tensor(np.asarray(point_labels), dtype=torch.int32, device=self.device),
                            None, multimask_output)
        low = out["low_res_multimasks"]
        masks = postprocess_masks(low, self._orig_hw, self.max_hole_area, self.max_sprinkle_area)
        return masks.cpu().numpy(), out["ious"].float().cpu().numpy(), low.cpu().numpy()

    @torch.inference_mode()
    def predict(self, point_coords: Optional[np.ndarray] = None, point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None, mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = True, return_logits: bool = False, normalize_coords: bool = True):
        """Returns (masks [M, H, W], ious [M], low_res_logits [M, 4fs, 4fs]) of
        the first image as numpy; masks are bool unless ``return_logits``."""
        self._require_image()
        size = self.cfg.image_size
        pts, lbl = [], []
        if box is not None:
            b = np.asarray(box, np.float32).reshape(1, 4)
            bp = transform_boxes(b, self._orig_hw, size) if normalize_coords else b.reshape(1, 2, 2)
            pts.append(bp.reshape(1, 2, 2))
            lbl.append(np.array([[2, 3]], np.int32))
        if point_coords is not None:
            p = np.asarray(point_coords, np.float32).reshape(1, -1, 2)
            if normalize_coords:
                p = transform_coords(p, self._orig_hw, size)
            pts.append(p)
            lbl.append(np.asarray(point_labels, np.int32).reshape(1, -1))
        if not pts:
            raise ValueError("provide a prompt")
        coords = torch.from_numpy(np.concatenate(pts, axis=1)).to(self.device)
        labels = torch.from_numpy(np.concatenate(lbl, axis=1)).to(self.device)
        # one prompt tiled over a batch of images (set_image_batch)
        b_feat = self._features["top"].shape[0]
        if b_feat > 1 and coords.shape[0] == 1:
            coords, labels = coords.expand(b_feat, -1, -1), labels.expand(b_feat, -1)
        mi = None
        if mask_input is not None:
            low = 4 * self.cfg.feat_size
            mi = torch.tensor(np.asarray(mask_input), dtype=torch.float32, device=self.device)
            mi = mi.reshape(1, low, low, 1).expand(b_feat, -1, -1, -1)
        out = self._predict(coords, labels, mi, multimask_output)
        low = out["low_res_multimasks"][0]
        masks = postprocess_masks(low, self._orig_hw, self.max_hole_area, self.max_sprinkle_area)
        if not return_logits:
            masks = masks > self.mask_threshold
        return masks.cpu().numpy(), out["ious"][0].float().cpu().numpy(), low.cpu().numpy()
