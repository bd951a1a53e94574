"""Interactive video-annotation web app (Gradio).

Counterpart of the JAX package's ``apps/app.py`` (reference app.py:111-449
without the per-session child-process command loop): upload a video, click
(positive/negative points) or draw a box on a frame, track through the
video, export the masks (a zip of id-coded PNGs) and an overlay mp4. One
predictor serves every session. Gradio is an optional dependency: without
it the module is the programmatic ``AnnotationSession`` API (used by the
tests and by ``apps/http_api.py``).

Sessions share their predictor, and on the card each tracked frame replays
a CUDA graph whose input and output buffers belong to the predictor
(``inference/graphs.py``): two sessions tracking at once in two threads
would write into the same buffers. So every session call that reaches the
device (``init_state`` when the session opens, ``click``, ``stroke_box``,
``track``) holds the predictor's ``lock``, on the predictor's device (a new
thread's current CUDA device is ``cuda:0``). Reading masks out for an
export touches no device.

Where JAX decodes the video twice (normalised, then raw for the overlays),
a session decodes it once and normalises that array: the same values.
Uploads decode as ``utils/video_io.py`` says: a frame directory, or an AVI
of raw 'RGBA' frames, without cv2; any other video file through cv2. The
export is split in two: ``export_masks`` (``masks.zip``, PNGs through
``write_png_gray``, no cv2) and ``export_overlay`` (``tracked.mp4``, mp4v
at 10 frames/s through cv2, which raises an ``ImportError`` naming cv2
without it); ``export`` writes both, as JAX's does.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
import zipfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from us_video_medsam2_tpu_torch.inference.transforms import IMG_MEAN, IMG_STD
from us_video_medsam2_tpu_torch.utils.video_io import load_video_frames, resize_linear_u8, write_png_gray

COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0), (255, 0, 255),
    (0, 255, 255), (255, 128, 0), (128, 0, 255),
]
MAX_OBJECTS = 8  # a session's object slots, as JAX's session allocates them


@contextlib.contextmanager
def on_device(predictor):
    """The predictor's ``lock`` held, with its CUDA device current (on the CPU, the lock only)."""
    dev = next(predictor.model.parameters()).device  # "cuda" with its index
    with predictor.lock, (torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()):
        yield


class AnnotationSession:
    """Predictor-backed annotation state for one video (reference app.py:342-423)."""

    def __init__(self, predictor, video):
        """``video``: a path, or what ``decode(predictor, path)`` gave for it."""
        self.predictor = predictor
        # frames in [0, 1], kept for the overlays, and their normalised copy for the model
        self.raw, vh, vw = self.decode(predictor, video) if isinstance(video, str) else video
        self.vh, self.vw = vh, vw
        with on_device(predictor):
            self.state = predictor.init_state((self.raw - IMG_MEAN) / IMG_STD, vh, vw, max_objects=MAX_OBJECTS)
        self.clicks = {}  # obj_id -> (points, labels)
        self.masks_by_frame = {}

    @staticmethod
    def decode(predictor, video_path: str):
        """(frames [T, S, S, 3] in [0, 1], video height, width); touches no device."""
        return load_video_frames(video_path, predictor.cfg.image_size, normalize=False)

    def click(self, frame_idx: int, obj_id: int, x: float, y: float, positive: bool):
        pts, lbls = self.clicks.get(obj_id, ([], []))
        pts = pts + [[x, y]]
        lbls = lbls + [1 if positive else 0]
        self.clicks[obj_id] = (pts, lbls)
        with on_device(self.predictor):
            _, obj_ids, masks = self.predictor.add_new_points_or_box(
                self.state, frame_idx, obj_id,
                points=np.array(pts, np.float32), labels=np.array(lbls, np.int32),
            )
        return obj_ids, masks > 0

    def stroke_box(self, frame_idx: int, obj_id: int, box_xyxy):
        with on_device(self.predictor):
            _, obj_ids, masks = self.predictor.add_new_points_or_box(
                self.state, frame_idx, obj_id, box=np.asarray(box_xyxy, np.float32)
            )
        return obj_ids, masks > 0

    def track(self, start_frame_idx: Optional[int] = None):
        self.masks_by_frame = {}
        with on_device(self.predictor):
            for fi, obj_ids, logits in self.predictor.propagate_in_video(
                self.state, start_frame_idx=start_frame_idx
            ):
                self.masks_by_frame[fi] = (obj_ids, np.asarray(logits[:, 0]) > 0)
        return self.masks_by_frame

    def overlay_frame(self, frame_idx: int) -> np.ndarray:
        img = (self.raw[frame_idx] * 255).astype(np.uint8)
        img = resize_linear_u8(img, self.vh, self.vw)  # JAX's cv2.resize(img, (vw, vh))
        if frame_idx in self.masks_by_frame:
            obj_ids, masks = self.masks_by_frame[frame_idx]
            for oi, oid in enumerate(obj_ids):
                color = np.array(COLORS[oid % len(COLORS)], np.uint8)
                m = masks[oi]
                img[m] = (0.5 * color + 0.5 * img[m]).astype(np.uint8)
        return img

    def export_masks(self, out_dir: str) -> str:
        """``masks.zip``: one id-coded PNG ``{fi:05d}.png`` for each frame with masks."""
        os.makedirs(out_dir, exist_ok=True)
        zip_path = os.path.join(out_dir, "masks.zip")
        with zipfile.ZipFile(zip_path, "w") as zf:
            for fi in range(len(self.raw)):
                if fi in self.masks_by_frame:
                    obj_ids, masks = self.masks_by_frame[fi]
                    canvas = np.zeros((self.vh, self.vw), np.uint8)
                    for oi, oid in enumerate(obj_ids):
                        canvas[masks[oi]] = oid
                    zf.writestr(f"{fi:05d}.png", write_png_gray(canvas))
        return zip_path

    def export_overlay(self, out_dir: str) -> str:
        """``tracked.mp4``: every frame's overlay, mp4v at 10 frames/s, through cv2."""
        try:
            import cv2
        except ImportError as e:
            raise ImportError("the overlay mp4 is written through cv2 (opencv-python), which is not "
                              "installed; masks.zip needs no cv2") from e
        os.makedirs(out_dir, exist_ok=True)
        mp4_path = os.path.join(out_dir, "tracked.mp4")
        writer = cv2.VideoWriter(mp4_path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (self.vw, self.vh))
        try:
            for fi in range(len(self.raw)):
                writer.write(cv2.cvtColor(self.overlay_frame(fi), cv2.COLOR_RGB2BGR))
        finally:
            writer.release()
        return mp4_path

    def export(self, out_dir: str) -> Tuple[str, str]:
        """Write overlay mp4 + mask zip (reference tracking_objects, app.py:267-330)."""
        zip_path = self.export_masks(out_dir)
        return self.export_overlay(out_dir), zip_path


class SessionManager:
    """Per-session state registry with an idle reaper.

    The reference app isolates each browser session in a child process and
    kills it after an idle timeout (app.py:408-450); here sessions are
    lightweight predictor states sharing one predictor per config, so the
    reaper just drops idle states (device buffers are freed with them)."""

    def __init__(self, max_idle_s: float = 600.0, reap_every_s: float = 60.0):
        self.max_idle_s = max_idle_s
        self._lock = threading.Lock()
        self._sessions: dict = {}
        self._last_used: dict = {}
        self._reap_every_s = reap_every_s
        self._reaper: Optional[threading.Thread] = None

    def start_reaper(self):
        if self._reaper is None:
            self._reaper = threading.Thread(target=self._reap_loop, daemon=True)
            self._reaper.start()

    def _reap_loop(self):
        while True:
            time.sleep(self._reap_every_s)
            self.reap()

    def reap(self, now: Optional[float] = None) -> List[str]:
        """Drop sessions idle longer than max_idle_s; returns reaped keys."""
        now = time.monotonic() if now is None else now
        with self._lock:
            dead = [k for k, t in self._last_used.items() if now - t > self.max_idle_s]
            for k in dead:
                self._sessions.pop(k, None)
                self._last_used.pop(k, None)
        return dead

    def put(self, key: str, sess):
        with self._lock:
            self._sessions[key] = sess
            self._last_used[key] = time.monotonic()

    def get(self, key: str):
        """Raises KeyError when the session was reaped (max_idle_s) or closed;
        UI callbacks must translate that into a user-facing error."""
        with self._lock:
            sess = self._sessions[key]
            self._last_used[key] = time.monotonic()
            return sess

    def close(self, key: str):
        with self._lock:
            self._sessions.pop(key, None)
            self._last_used.pop(key, None)

    def __len__(self):
        with self._lock:
            return len(self._sessions)


class PredictorRegistry:
    """Lazily built, cached predictors per (config, checkpoint) — backs the
    app's model/checkpoint dropdowns (reference app.py model selection),
    each built on ``device``."""

    def __init__(self, choices: Optional[dict] = None, device: str = "cuda"):
        # name -> (cfg, checkpoint_path or None)
        self.choices = choices or {"sam2.1_hiera_t512 (random init)": ("sam2.1_hiera_t512", None)}
        self.device = device
        self._cache: dict = {}
        self._lock = threading.Lock()

    def names(self) -> List[str]:
        return list(self.choices)

    def get(self, name: str):
        from us_video_medsam2_tpu_torch.core.build import build_sam2_video_predictor

        cfg, ckpt = self.choices[name]
        with self._lock:
            if name not in self._cache:
                self._cache[name] = build_sam2_video_predictor(cfg, ckpt_path=ckpt, device=self.device)
            return self._cache[name]


def build_demo(
    checkpoint: Optional[str] = None,
    cfg: str = "sam2.1_hiera_t512",
    model_choices: Optional[dict] = None,
    max_idle_s: float = 600.0,
    device: str = "cuda",
):
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed in this environment; use AnnotationSession "
            "programmatically or install gradio for the web UI"
        ) from e

    if model_choices is None:
        model_choices = {f"{cfg}": (cfg, checkpoint)}
    registry = PredictorRegistry(model_choices, device)
    sessions = SessionManager(max_idle_s=max_idle_s)
    sessions.start_reaper()

    def load_video(video, model_name, request: "gr.Request"):
        sess = AnnotationSession(registry.get(model_name), video)
        sessions.put(request.session_hash, sess)
        return sess.overlay_frame(0), gr.update(maximum=len(sess.raw) - 1, value=0)

    def _get_session(request: "gr.Request"):
        try:
            return sessions.get(request.session_hash)
        except KeyError:
            # the idle reaper (or unload) dropped the session; surface a
            # user-facing message instead of a generic server error
            raise gr.Error("session expired — reload the video") from None

    def on_click(frame_idx, obj_id, positive, evt: "gr.SelectData", request: "gr.Request"):
        sess = _get_session(request)
        x, y = evt.index
        obj_ids, masks = sess.click(int(frame_idx), int(obj_id), float(x), float(y), bool(positive))
        sess.masks_by_frame[int(frame_idx)] = (obj_ids, masks[:, 0])
        return sess.overlay_frame(int(frame_idx))

    def on_track(request: "gr.Request"):
        sess = _get_session(request)
        sess.track()
        out_dir = tempfile.mkdtemp(prefix="uvms2_")
        mp4, zf = sess.export(out_dir)
        return mp4, zf

    def on_unload(request: "gr.Request"):
        sessions.close(request.session_hash)

    with gr.Blocks(title="US-Video-MedSAM2 (PyTorch/CUDA)") as demo:
        gr.Markdown("## Promptable medical video segmentation — PyTorch/CUDA")
        model_dd = gr.Dropdown(registry.names(), value=registry.names()[0], label="model / checkpoint")
        with gr.Row():
            video_in = gr.Video(label="input video")
            frame_view = gr.Image(label="frame")
        frame_slider = gr.Slider(0, 1, step=1, label="frame")
        obj_id = gr.Number(value=1, label="object id")
        positive = gr.Checkbox(value=True, label="positive click")
        track_btn = gr.Button("Track")
        video_out = gr.Video(label="tracked")
        masks_out = gr.File(label="masks.zip")
        video_in.change(load_video, [video_in, model_dd], [frame_view, frame_slider])
        frame_view.select(on_click, [frame_slider, obj_id, positive], [frame_view])
        track_btn.click(on_track, [], [video_out, masks_out])
        demo.unload(on_unload)
    return demo


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()
    build_demo(args.checkpoint, args.cfg, device=args.device).launch(server_port=args.port)
