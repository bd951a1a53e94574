"""Automatic mask generation utilities ("everything" mode).

A numpy copy of the JAX package's ``inference/amg.py`` (reference
efficient_track_anything/utils/amg.py:24-348): MaskData container, point
grids, crop boxes, uncompressed RLE (COCO layout, in numpy — pycocotools only
for the optional compressed form), stability scores, box NMS, and small-region
removal, which labels with ``scipy.ndimage.label`` under a 3x3 structure of
ones (8-connectivity, components in raster order as cv2 numbers them).
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Generator, ItemsView, List, Tuple

import numpy as np


class MaskData:
    """Dict of parallel arrays/lists with filter/cat (reference amg.py:24-78)."""

    def __init__(self, **kwargs):
        self._stats: Dict[str, Any] = dict(kwargs)

    def __setitem__(self, k, v):
        self._stats[k] = v

    def __getitem__(self, k):
        return self._stats[k]

    def __delitem__(self, k):
        del self._stats[k]

    def items(self) -> ItemsView:
        return self._stats.items()

    def filter(self, keep: np.ndarray):
        for k, v in self._stats.items():
            if v is None:
                continue
            if isinstance(v, np.ndarray):
                self._stats[k] = v[keep]
            elif isinstance(v, list):
                idx = np.flatnonzero(keep) if keep.dtype == bool else keep
                self._stats[k] = [v[i] for i in idx]

    def cat(self, other: "MaskData"):
        for k, v in other.items():
            if k not in self._stats or self._stats[k] is None:
                self._stats[k] = deepcopy(v)
            elif isinstance(v, np.ndarray):
                self._stats[k] = np.concatenate([self._stats[k], v], axis=0)
            elif isinstance(v, list):
                self._stats[k] = self._stats[k] + deepcopy(v)


def batch_iterator(batch_size: int, *args) -> Generator[List[Any], None, None]:
    n = len(args[0])
    for b in range(0, n, batch_size):
        yield [a[b : b + batch_size] for a in args]


def build_point_grid(n_per_side: int) -> np.ndarray:
    """[n^2, 2] normalized (x, y) grid (reference amg.py:181-188)."""
    offset = 1 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    gx, gy = np.meshgrid(pts, pts)
    return np.stack([gx.ravel(), gy.ravel()], axis=-1)


def build_all_layer_point_grids(n_per_side: int, n_layers: int, scale_per_layer: int):
    return [
        build_point_grid(int(n_per_side / (scale_per_layer**i)))
        for i in range(n_layers + 1)
    ]


def generate_crop_boxes(
    im_size: Tuple[int, int], n_layers: int, overlap_ratio: float
) -> Tuple[List[List[int]], List[int]]:
    """(reference amg.py:202-238)"""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len, n_crops, overlap):
        return int(np.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * min(im_h, im_w) * (2 / n_crops_per_side))
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_crops_per_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_crops_per_side)]
        for x0 in x0s:
            for y0 in y0s:
                crop_boxes.append([x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)])
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: np.ndarray, crop_box: List[int]) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return boxes + np.array([[x0, y0, x0, y0]])


def uncrop_points(points: np.ndarray, crop_box: List[int]) -> np.ndarray:
    return points + np.array([[crop_box[0], crop_box[1]]])


def uncrop_masks(masks: np.ndarray, crop_box: List[int], orig_h: int, orig_w: int):
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    out = np.zeros((masks.shape[0], orig_h, orig_w), masks.dtype)
    out[:, y0:y1, x0:x1] = masks
    return out


def is_box_near_crop_edge(boxes, crop_box, orig_box, atol: float = 20.0):
    """(reference amg.py:80-91)"""
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray(orig_box, np.float32)
    b = uncrop_boxes_xyxy(boxes, crop_box).astype(np.float32)
    near_crop = np.isclose(b, crop[None], atol=atol, rtol=0)
    near_image = np.isclose(b, orig[None], atol=atol, rtol=0)
    near_crop = near_crop & ~near_image
    return near_crop.any(axis=1)


def box_xyxy_to_xywh(box: np.ndarray) -> np.ndarray:
    out = np.array(box, np.float32).copy()
    out[..., 2] = out[..., 2] - out[..., 0]
    out[..., 3] = out[..., 3] - out[..., 1]
    return out


# ----------------------------------------------------------------------- RLE
def mask_to_rle(mask: np.ndarray) -> Dict[str, Any]:
    """Uncompressed COCO RLE, column-major (reference amg.py:109-138)."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.ravel()  # fortran order (column-major)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    idx = 0
    val = False
    for count in rle["counts"]:
        flat[idx : idx + count] = val
        idx += count
        val = not val
    return flat.reshape(w, h).T


def area_from_rle(rle: Dict[str, Any]) -> int:
    return sum(rle["counts"][1::2])


def coco_encode_rle(rle: Dict[str, Any]) -> Dict[str, Any]:
    """Compress to the COCO bytes format if pycocotools is available."""
    try:
        from pycocotools import mask as mask_utils  # type: ignore

        h, w = rle["size"]
        out = mask_utils.frPyObjects(rle, h, w)
        out["counts"] = out["counts"].decode("utf-8")
        return out
    except ImportError:
        return rle


# ------------------------------------------------------------------ filtering
def calculate_stability_score(masks: np.ndarray, mask_threshold: float, offset: float):
    """(reference amg.py:158-178); [N, H, W] logits -> [N], N may be 0
    (every mask of a batch filtered out before)."""
    hi = (masks > (mask_threshold + offset)).sum(axis=(-2, -1))
    lo = (masks > (mask_threshold - offset)).sum(axis=(-2, -1))
    return hi.astype(np.float32) / np.maximum(lo, 1)


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] bool -> [N, 4] xyxy (reference amg.py:305-348)."""
    n, h, w = masks.shape
    out = np.zeros((n, 4), np.float32)
    for i in range(n):
        ys, xs = np.where(masks[i])
        if len(ys) == 0:
            continue
        out[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return out


def box_nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS -> kept indices (torchvision.ops.nms equivalent)."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(area_i + area_r - inter, 1e-6)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int64)


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str):
    """Remove small disconnected regions or holes (reference amg.py:269-293).
    Components are 8-connected and numbered in raster order, as
    ``cv2.connectedComponentsWithStats(..., 8)`` numbers them, so the
    "islands" fallback (every component small: keep the largest, the first
    of equal ones) keeps the same one."""
    from scipy import ndimage

    if mode not in ("holes", "islands"):
        raise ValueError(f"mode {mode!r}: 'holes' or 'islands'")
    correct_holes = mode == "holes"
    working = correct_holes ^ np.asarray(mask, bool)
    regions, n = ndimage.label(working, structure=np.ones((3, 3), int))
    n_labels = n + 1
    sizes = np.bincount(regions.ravel(), minlength=n_labels)[1:]
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = [0] + small
    if not correct_holes:
        fill = [i for i in range(n_labels) if i not in fill] or [
            int(np.argmax(sizes)) + 1
        ]
    mask = np.isin(regions, fill)
    return mask, True
