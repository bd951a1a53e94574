"""Automatic ("everything") mask generator.

Counterpart of the JAX package's ``inference/automatic_mask_generator.py``
(reference efficient_track_anything/automatic_mask_generator.py:38-457):
grid-prompted batched prediction, IoU/stability filtering, per-crop +
cross-crop box NMS, optional small-region postprocessing, RLE/binary output.
Point batches run through the image predictor's heads at the fixed batch
size ``points_per_batch``, the last padded as in JAX: each point's masks are
computed on their own row, so the pad changes none of them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from us_video_medsam2_tpu_torch.inference.amg import (
    MaskData,
    area_from_rle,
    batch_iterator,
    batched_mask_to_box,
    box_nms,
    box_xyxy_to_xywh,
    build_all_layer_point_grids,
    calculate_stability_score,
    coco_encode_rle,
    generate_crop_boxes,
    is_box_near_crop_edge,
    mask_to_rle,
    remove_small_regions,
    rle_to_mask,
    uncrop_boxes_xyxy,
    uncrop_masks,
    uncrop_points,
)


class SAM2AutomaticMaskGenerator:
    def __init__(
        self,
        predictor,  # SAM2ImagePredictor
        points_per_side: Optional[int] = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.8,
        stability_score_thresh: float = 0.95,
        stability_score_offset: float = 1.0,
        mask_threshold: float = 0.0,
        box_nms_thresh: float = 0.7,
        crop_n_layers: int = 0,
        crop_nms_thresh: float = 0.7,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
        point_grids: Optional[List[np.ndarray]] = None,
        min_mask_region_area: int = 0,
        output_mode: str = "binary_mask",
        multimask_output: bool = True,
    ):
        if (points_per_side is None) == (point_grids is None):
            raise ValueError("give exactly one of points_per_side and point_grids")
        if point_grids is None:
            point_grids = build_all_layer_point_grids(
                points_per_side, crop_n_layers, crop_n_points_downscale_factor
            )
        self.predictor = predictor
        self.point_grids = point_grids
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.mask_threshold = mask_threshold
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        self.multimask_output = multimask_output

    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        data = self._generate_masks(image)
        if self.min_mask_region_area > 0:
            data = self.postprocess_small_regions(
                data, self.min_mask_region_area, max(self.box_nms_thresh, self.crop_nms_thresh)
            )
        out = []
        for i in range(len(data["rles"])):
            rle = data["rles"][i]
            if self.output_mode == "binary_mask":
                seg = rle_to_mask(rle)
            elif self.output_mode == "coco_rle":
                seg = coco_encode_rle(rle)
            else:
                seg = rle
            out.append(
                {
                    "segmentation": seg,
                    "area": area_from_rle(rle),
                    "bbox": box_xyxy_to_xywh(data["boxes"][i]).tolist(),
                    "predicted_iou": float(data["iou_preds"][i]),
                    "point_coords": [data["points"][i].tolist()],
                    "stability_score": float(data["stability_score"][i]),
                    "crop_box": box_xyxy_to_xywh(np.array(data["crop_boxes"][i])).tolist(),
                }
            )
        return out

    def _generate_masks(self, image: np.ndarray) -> MaskData:
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio
        )
        data = MaskData()
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            data.cat(self._process_crop(image, crop_box, layer_idx, orig_size))
        if len(crop_boxes) > 1 and len(data["boxes"]):
            scores = 1.0 / np.array([b[2] for b in data["crop_boxes"]], np.float32)
            keep = box_nms(data["boxes"], scores, self.crop_nms_thresh)
            data.filter(keep)
        return data

    def _process_crop(self, image, crop_box, layer_idx, orig_size) -> MaskData:
        x0, y0, x1, y1 = crop_box
        cropped = image[y0:y1, x0:x1]
        crop_size = cropped.shape[:2]
        self.predictor.set_image(cropped)

        pts_scale = np.array(crop_size)[None, ::-1]  # (w, h)
        pts = self.point_grids[layer_idx] * pts_scale

        data = MaskData()
        for (batch_pts,) in batch_iterator(self.points_per_batch, pts):
            data.cat(self._process_batch(batch_pts, crop_size, crop_box, orig_size))
        if len(data["boxes"]):
            keep = box_nms(data["boxes"], data["iou_preds"], self.box_nms_thresh)
            data.filter(keep)
        data["boxes"] = uncrop_boxes_xyxy(data["boxes"], crop_box)
        data["points"] = uncrop_points(data["points"], crop_box)
        data["crop_boxes"] = [crop_box for _ in data["rles"]]
        return data

    def _process_batch(self, points, im_size, crop_box, orig_size) -> MaskData:
        # pad to the fixed batch size so every batch hits one compiled program
        n = len(points)
        padded = np.zeros((self.points_per_batch, 1, 2), np.float32)
        padded[:n, 0] = points
        logits, ious, _ = self.predictor.predict_batch_points(
            padded,
            np.ones((self.points_per_batch, 1), np.int32),
            multimask_output=self.multimask_output,
        )
        m = logits.shape[1]
        masks = logits[:n].reshape(n * m, *logits.shape[2:])
        ious = np.asarray(ious[:n]).reshape(n * m)
        pts_rep = np.repeat(points, m, axis=0)

        data = MaskData(masks=masks, iou_preds=ious, points=pts_rep)
        if self.pred_iou_thresh > 0:
            data.filter(data["iou_preds"] > self.pred_iou_thresh)
        data["stability_score"] = calculate_stability_score(
            data["masks"], self.mask_threshold, self.stability_score_offset
        )
        if self.stability_score_thresh > 0:
            data.filter(data["stability_score"] >= self.stability_score_thresh)
        data["masks"] = data["masks"] > self.mask_threshold
        data["boxes"] = batched_mask_to_box(data["masks"])
        keep = ~is_box_near_crop_edge(data["boxes"], crop_box, [0, 0, orig_size[1], orig_size[0]])
        if not keep.all():
            data.filter(keep)
        data["masks"] = uncrop_masks(data["masks"], crop_box, orig_size[0], orig_size[1])
        data["rles"] = [mask_to_rle(m) for m in data["masks"]]
        del data["masks"]
        return data

    def refine_with_m2m(self, points, low_res_masks):
        """Mask->mask refinement: re-run the decoder feeding each mask's own
        low-res logits as the mask prompt (reference
        automatic_mask_generator.py:440-457).

        points: [N, 2] original-resolution coords; low_res_masks: [N, h, w] logits.
        Returns (refined low-res logits [N, 1, h, w], ious [N, 1]) as numpy.
        """
        import torch

        from us_video_medsam2_tpu_torch.inference.transforms import transform_coords

        pred = self.predictor
        pred._require_image()
        n = len(points)
        coords = transform_coords(
            np.asarray(points, np.float32).reshape(n, 1, 2),
            pred._orig_hw,
            pred.cfg.image_size,
        )
        dev = pred.device
        with torch.inference_mode():
            out = pred._predict(
                torch.from_numpy(coords).to(dev),
                torch.ones((n, 1), dtype=torch.int32, device=dev),
                torch.as_tensor(np.asarray(low_res_masks)[..., None], dtype=torch.float32, device=dev),
                multimask=False,
            )
        return out["low_res_multimasks"].cpu().numpy(), out["ious"].float().cpu().numpy()

    @staticmethod
    def postprocess_small_regions(data: MaskData, min_area: int, nms_thresh: float):
        """(reference automatic_mask_generator.py:390-438)"""
        if len(data["rles"]) == 0:
            return data
        new_masks, scores = [], []
        for rle in data["rles"]:
            mask = rle_to_mask(rle)
            mask, changed = remove_small_regions(mask, min_area, "holes")
            unchanged = not changed
            mask, changed = remove_small_regions(mask, min_area, "islands")
            unchanged = unchanged and not changed
            new_masks.append(mask)
            scores.append(float(unchanged))
        masks = np.stack(new_masks)
        boxes = batched_mask_to_box(masks)
        keep = box_nms(boxes, np.array(scores), nms_thresh)
        for i in keep:
            if scores[i] == 0.0:
                data["rles"][i] = mask_to_rle(masks[i])
                data["boxes"][i] = boxes[i]
        data.filter(keep)
        return data
