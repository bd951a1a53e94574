"""Video/volume frame loading (reference sam2/utils/misc.py:104-311).

Counterpart of the JAX package's ``utils/video_io.py``, in numpy:

- load_video_frames: JPEG directory or video file -> [T, S, S, 3] normalized
  float32 (cv2 instead of decord for video files; no other decoder is used,
  so a video file needs cv2, a frame directory needs PIL)
- AsyncVideoFrameLoader: background-thread prefetch of frames so the first
  prediction starts before the whole video is decoded
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from us_video_medsam2_tpu_torch.inference.transforms import IMG_MEAN, IMG_STD


def _load_img_as_array(path: str, image_size: int) -> Tuple[np.ndarray, int, int]:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    img = img.resize((image_size, image_size))
    return np.asarray(img, np.float32) / 255.0, h, w


def _list_frame_files(dirpath: str) -> List[str]:
    files = [
        p
        for p in os.listdir(dirpath)
        if os.path.splitext(p)[-1].lower() in (".jpg", ".jpeg", ".png")
    ]
    # reference expects '<frame_index>.jpg' names (misc.py:204-210)
    try:
        files.sort(key=lambda p: int(os.path.splitext(p)[0]))
    except ValueError:
        files.sort()
    return [os.path.join(dirpath, p) for p in files]


def load_video_frames(
    video_path: str,
    image_size: int = 512,
    normalize: bool = True,
) -> Tuple[np.ndarray, int, int]:
    """-> (frames [T, S, S, 3] float32, video_height, video_width)."""
    if os.path.isdir(video_path):
        paths = _list_frame_files(video_path)
        if not paths:
            raise FileNotFoundError(f"no frames found in {video_path}")
        frames = []
        vh = vw = None
        for p in paths:
            arr, vh, vw = _load_img_as_array(p, image_size)
            frames.append(arr)
        out = np.stack(frames)
    else:
        import cv2

        cap = cv2.VideoCapture(video_path)
        frames = []
        vh = vw = None
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            vh, vw = frame.shape[:2]
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            rgb = cv2.resize(rgb, (image_size, image_size))
            frames.append(rgb.astype(np.float32) / 255.0)
        cap.release()
        if not frames:
            raise ValueError(f"no frames decoded from {video_path}")
        out = np.stack(frames)
    if normalize:
        out = (out - IMG_MEAN) / IMG_STD
    return out, vh, vw


class AsyncVideoFrameLoader:
    """Background-thread frame loader (reference misc.py:104-170)."""

    def __init__(self, frame_paths: List[str], image_size: int, normalize: bool = True):
        self.frame_paths = frame_paths
        self.image_size = image_size
        self.normalize = normalize
        self.frames: List[Optional[np.ndarray]] = [None] * len(frame_paths)
        self.exception: Optional[Exception] = None
        self.video_height = self.video_width = None
        self._lock = threading.Condition()
        # load the first frame synchronously (warm start, misc.py:128-132)
        self._load(0)
        self.thread = threading.Thread(target=self._load_all, daemon=True)
        self.thread.start()

    def _load(self, idx: int):
        arr, h, w = _load_img_as_array(self.frame_paths[idx], self.image_size)
        if self.normalize:
            arr = (arr - IMG_MEAN) / IMG_STD
        self.video_height, self.video_width = h, w
        with self._lock:
            self.frames[idx] = arr
            self._lock.notify_all()

    def _load_all(self):
        try:
            for i in range(len(self.frame_paths)):
                if self.frames[i] is None:
                    self._load(i)
        except Exception as e:  # noqa: BLE001 -- handed to the reader, which raises it
            self.exception = e
            with self._lock:
                self._lock.notify_all()

    def __getitem__(self, idx: int) -> np.ndarray:
        with self._lock:
            while self.frames[idx] is None:
                if self.exception is not None:
                    raise self.exception
                self._lock.wait(timeout=5.0)
        return self.frames[idx]

    def __len__(self):
        return len(self.frames)


def concat_points(old, new_points, new_labels):
    """(reference misc.py:341-349)"""
    if old is None:
        return {"point_coords": new_points, "point_labels": new_labels}
    return {
        "point_coords": np.concatenate([old["point_coords"], new_points], axis=1),
        "point_labels": np.concatenate([old["point_labels"], new_labels], axis=1),
    }
