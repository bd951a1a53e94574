"""Video/volume frame loading (reference sam2/utils/misc.py:104-311).

Counterpart of the JAX package's ``utils/video_io.py``, in numpy:

- load_video_frames: JPEG directory or video file -> [T, S, S, 3] normalized
  float32. A frame directory goes through PIL. An AVI whose video stream is
  raw 32-bit ``'RGBA'`` (what ``cv2.VideoWriter(path, cv2.CAP_FFMPEG,
  cv2.VideoWriter_fourcc(*"RGBA"), ...)`` writes) is read here, in numpy,
  and resized by ``resize_linear_u8``, OpenCV's fixed-point INTER_LINEAR
  rule: the same frames as cv2 gives, on a machine without cv2. Every other
  video file (mp4, a compressed AVI, ...) goes through ``cv2.VideoCapture``
  as in JAX (cv2 instead of decord), and needs cv2. What the file is picks
  the route, not what is installed.
- write_png_gray: an 8-bit greyscale PNG through zlib (the mask export)
- AsyncVideoFrameLoader: background-thread prefetch of frames so the first
  prediction starts before the whole video is decoded
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
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


NEEDS_CV2 = ("only a frame directory (PIL) and an AVI of raw 32-bit 'RGBA' frames are read without cv2; "
             "every other video file (mp4, a compressed AVI, ...) needs cv2 (opencv-python)")


def _riff_chunks(buf: bytes, start: int, end: int):
    """(fourcc, list type or None, payload start, payload end) of the RIFF
    chunks in ``buf[start:end]``; a LIST's payload starts after its type."""
    off = start
    while off + 8 <= end:
        cid = buf[off: off + 4]
        size = struct.unpack_from("<I", buf, off + 4)[0]
        body = off + 8
        if cid in (b"RIFF", b"LIST"):
            yield cid, buf[body: body + 4], body + 4, min(body + size, end)
        else:
            yield cid, None, body, min(body + size, end)
        off = body + size + (size & 1)  # chunks are word-aligned


def _rgba_stream(buf: bytes) -> Optional[Tuple[int, int, int]]:
    """(stream index, width, height) of the first video stream of an AVI in
    ``buf`` whose frames are raw 32-bit 'RGBA', else None."""
    if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"AVI ":
        return None
    for cid, typ, a, b in _riff_chunks(buf, 12, len(buf)):
        if typ != b"hdrl":
            continue
        stream = -1
        for cid2, typ2, a2, b2 in _riff_chunks(buf, a, b):
            if typ2 != b"strl":
                continue
            stream += 1
            strh = strf = None
            for cid3, _, a3, b3 in _riff_chunks(buf, a2, b2):
                if cid3 == b"strh":
                    strh = buf[a3:b3]
                elif cid3 == b"strf":
                    strf = buf[a3:b3]
            if strh is None or strf is None or strh[:4] != b"vids" or len(strf) < 20:
                continue
            # BITMAPINFOHEADER: size, width, height, planes, bit count, compression
            _, w, h, _, bits = struct.unpack_from("<IiiHH", strf, 0)
            if strf[16:20] == b"RGBA" and bits == 32 and w > 0 and h != 0:
                return stream, w, abs(h)
        return None
    return None


def is_rgba_avi(path: str) -> bool:
    """Whether ``path`` is an AVI whose video is raw 32-bit 'RGBA' frames."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)  # the header list comes first and is a few KB
    return _rgba_stream(head) is not None


def read_rgba_avi(path: str) -> np.ndarray:
    """Frames [T, H, W, 3] uint8 RGB of an AVI of raw 32-bit 'RGBA' frames.

    The layout is what cv2 (FFmpeg's AVI muxer) writes and reads for the
    'RGBA' fourcc: each ``##db`` / ``##dc`` chunk of the ``movi`` list holds
    one frame of H rows of W pixels, top row first, 4 bytes a pixel in the
    order R, G, B, A (alpha dropped), with no row padding (a row of 32-bit
    pixels is word-aligned). The frames are taken in ``idx1``'s order where
    the file has an index, else in ``movi``'s. Held against
    ``cv2.VideoCapture`` on files cv2 wrote (tests/test_torch_video_io.py)."""
    with open(path, "rb") as f:
        buf = f.read()
    found = _rgba_stream(buf)
    if found is None:
        raise ValueError(f"{path} is not an AVI of raw 'RGBA' frames")
    stream, w, h = found
    tags = (b"%02ddb" % stream, b"%02ddc" % stream)
    nbytes = w * h * 4
    movi = idx1 = None
    for cid, typ, a, b in _riff_chunks(buf, 12, len(buf)):
        if typ == b"movi":
            movi = (a, b)
        elif cid == b"idx1":
            idx1 = (a, b)
    if movi is None:
        raise ValueError(f"{path}: no movi list")
    offsets = []
    if idx1 is not None:
        entries = np.frombuffer(buf, "<u4", count=(idx1[1] - idx1[0]) // 16 * 4, offset=idx1[0]).reshape(-1, 4)
        base = movi[0] - 4  # idx1 offsets count from the movi list's type field
        if len(entries) and buf[base + int(entries[0, 2]): base + int(entries[0, 2]) + 4] != struct.pack(
                "<I", int(entries[0, 0])):
            base = 0  # an index of absolute offsets
        for tag, _, off, size in entries:
            if struct.pack("<I", tag) in tags and size:
                offsets.append((base + int(off) + 8, int(size)))
    else:
        offsets = [(x, y - x) for cid, _, x, y in _riff_chunks(buf, *movi) if cid in tags and y > x]
    for i, (off, size) in enumerate(offsets):
        if size < nbytes or off + nbytes > len(buf):
            raise ValueError(f"{path}: frame {i} holds {min(size, len(buf) - off)} bytes, {nbytes} expected")
    frames = np.empty((len(offsets), h, w, 3), np.uint8)
    for i, (off, _) in enumerate(offsets):
        frames[i] = np.frombuffer(buf, np.uint8, count=nbytes, offset=off).reshape(h, w, 4)[..., :3]
    return frames


def _linear_taps(src: int, dst: int, clamp_weight: bool):
    """OpenCV's INTER_LINEAR taps along one axis (``resize.cpp``): source
    position (d + 0.5) * src / dst - 0.5 in float32, its floor and the two
    weights rounded to 11 fractional bits. Along x a position left of the
    first or right of the last pixel takes that pixel with weight 1
    (``clamp_weight``); along y the weights stay and both rows clip."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if clamp_weight:
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0
        s = np.clip(s, 0, src - 1)
    w1 = np.rint(f * 2048).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * 2048).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` (INTER_LINEAR) of uint8 [H, W, C]
    bit for bit, in numpy: OpenCV's fixed-point rule, a horizontal pass in
    11-bit weights into int32, then the vertical pass as its SIMD path
    computes it, ((b0 * (r0 >> 4)) >> 16 + (b1 * (r1 >> 4)) >> 16 + 2) >> 2.
    Held against cv2 at down- and up-scales (tests/test_torch_video_io.py)."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(w, width, True)
    y0, y1, b0, b1 = _linear_taps(h, height, False)
    src = img.astype(np.int32)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    rows >>= 4
    out = ((rows[y0] * b0[:, None, None]) >> 16) + ((rows[y1] * b1[:, None, None]) >> 16)
    out += 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8)


def write_png_gray(canvas: np.ndarray) -> bytes:
    """An 8-bit greyscale PNG of uint8 [H, W] (filter 0 on every row, zlib
    level 6): the mask export's ``cv2.imencode(".png", canvas)``."""
    a = np.ascontiguousarray(canvas, np.uint8)
    if a.ndim != 2:
        raise ValueError(f"a greyscale canvas is [H, W], not {a.shape}")
    h, w = a.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), a], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


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
    elif is_rgba_avi(video_path):
        raw = read_rgba_avi(video_path)
        if not len(raw):
            raise ValueError(f"no frames decoded from {video_path}")
        vh, vw = raw.shape[1:3]
        out = np.stack([resize_linear_u8(f, image_size, image_size) for f in raw]).astype(np.float32) / 255.0
    else:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(f"cannot decode {video_path}: {NEEDS_CV2}") from e

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
