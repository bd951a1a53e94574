"""Dependency-free HTTP serving surface for the interactive annotation flow.

Counterpart of the JAX package's ``apps/http_api.py``. The reference exposes
upload -> click -> track -> export only through a Gradio app (reference
app.py:111-449). This module serves the SAME session layer (``apps/app.py``
AnnotationSession / SessionManager) over a stdlib ThreadingHTTPServer with a
JSON-over-HTTP protocol, so headless clients (curl, notebooks, the tests)
drive the full annotation flow through real HTTP round trips with no extra
dependency.

Protocol (all request/response bodies JSON unless noted):
  GET    /healthz                      -> {"ok": true, "sessions": N}
  POST   /sessions                     body = raw video bytes (an AVI of raw
                                       'RGBA' frames decodes without cv2; mp4
                                       and other containers need cv2)
                                       -> {"session_id", "num_frames", "height", "width"}
  POST   /sessions/<id>/click          {"frame_idx","obj_id","x","y","positive"}
                                       -> {"obj_ids": [...], "areas": [px, ...]}
  POST   /sessions/<id>/box            {"frame_idx","obj_id","box": [x0,y0,x1,y1]}
                                       -> {"obj_ids": [...], "areas": [px, ...]}
  POST   /sessions/<id>/track          -> {"frames": {"<fi>": {"obj_ids", "areas"}}}
  GET    /sessions/<id>/export/masks.zip   -> application/zip (per-frame id-coded PNGs; no cv2)
  GET    /sessions/<id>/export/tracked.mp4 -> video/mp4 (overlay render; 501 without cv2)
  DELETE /sessions/<id>                -> {"closed": true}

Errors: 404 unknown route/expired session (the SessionManager reaper drops
idle sessions exactly like the reference's child-process kill, app.py:408-450),
400 malformed request or an upload that does not decode, 500 a decoded
upload whose session could not be opened on the device, 501 an mp4 export
where cv2 is not installed.

Locks: one per session, as in JAX, so that a session's requests run one at
a time; inside it, every call that reaches the device holds the predictor's
lock on the predictor's device (``apps/app.py::on_device``), because the
sessions' tracking windows replay CUDA graphs whose buffers the predictor
owns. An export reads the session's masks under the session's lock only.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from us_video_medsam2_tpu_torch.apps.app import AnnotationSession, SessionManager


def _mask_areas(obj_ids, masks):
    """Summaries small enough for JSON: per-object foreground pixel counts."""
    return [int(m.sum()) for m in masks[: len(obj_ids)]]


class _AnnotationHTTPHandler(BaseHTTPRequestHandler):
    server_version = "uvms2-http/1.0"
    # set by create_server on the subclass:
    predictor = None
    sessions: SessionManager = None
    locks: dict = None
    locks_lock: threading.Lock = None
    tmp_root: str = None

    # ------------------------------------------------------------- plumbing
    def log_message(self, fmt, *args):  # quiet by default; tests read stdout
        pass

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _bytes(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _session(self, sid: str):
        try:
            return self.sessions.get(sid)
        except KeyError:
            return None

    def _lock(self, sid: str) -> threading.Lock:
        # one in-flight request per session (the reference serializes a
        # session through its child process's command loop, app.py:342-423)
        with self.locks_lock:
            return self.locks.setdefault(sid, threading.Lock())

    # ------------------------------------------------------------- routes
    def do_GET(self):  # noqa: N802 (http.server API)
        parts = [p for p in self.path.split("/") if p]
        if parts == ["healthz"]:
            return self._json(200, {"ok": True, "sessions": len(self.sessions)})
        if len(parts) == 4 and parts[0] == "sessions" and parts[2] == "export":
            sess = self._session(parts[1])
            if sess is None:
                return self._json(404, {"error": "unknown or expired session"})
            artifact = parts[3]
            if artifact not in ("masks.zip", "tracked.mp4"):
                return self._json(404, {"error": f"no artifact {artifact}"})
            out_dir = os.path.join(self.tmp_root, parts[1])
            with self._lock(parts[1]):
                if artifact == "masks.zip":
                    path, ctype = sess.export_masks(out_dir), "application/zip"
                else:
                    try:
                        path, ctype = sess.export_overlay(out_dir), "video/mp4"
                    except ImportError as e:
                        return self._json(501, {"error": str(e)})
            with open(path, "rb") as f:
                return self._bytes(200, f.read(), ctype)
        return self._json(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        parts = [p for p in self.path.split("/") if p]
        if parts == ["sessions"]:
            return self._create_session()
        if len(parts) == 3 and parts[0] == "sessions":
            sid, action = parts[1], parts[2]
            sess = self._session(sid)
            if sess is None:
                return self._json(404, {"error": "unknown or expired session"})
            try:
                req = json.loads(self._read_body() or b"{}")
            except json.JSONDecodeError:
                return self._json(400, {"error": "body is not JSON"})
            try:
                if action == "click":
                    with self._lock(sid):
                        obj_ids, masks = sess.click(
                            int(req["frame_idx"]),
                            int(req["obj_id"]),
                            float(req["x"]),
                            float(req["y"]),
                            bool(req.get("positive", True)),
                        )
                        # mirror the Gradio on_click callback: the prompted
                        # frame's overlay state updates immediately
                        sess.masks_by_frame[int(req["frame_idx"])] = (obj_ids, masks[:, 0])
                    return self._json(200, {"obj_ids": obj_ids, "areas": _mask_areas(obj_ids, masks[:, 0])})
                if action == "box":
                    with self._lock(sid):
                        obj_ids, masks = sess.stroke_box(int(req["frame_idx"]), int(req["obj_id"]), req["box"])
                        sess.masks_by_frame[int(req["frame_idx"])] = (obj_ids, masks[:, 0])
                    return self._json(200, {"obj_ids": obj_ids, "areas": _mask_areas(obj_ids, masks[:, 0])})
                if action == "track":
                    with self._lock(sid):
                        tracked = sess.track(start_frame_idx=req.get("start_frame_idx"))
                    frames = {
                        str(fi): {"obj_ids": obj_ids, "areas": _mask_areas(obj_ids, masks)}
                        for fi, (obj_ids, masks) in tracked.items()
                    }
                    return self._json(200, {"frames": frames})
            except (KeyError, TypeError, ValueError) as e:
                return self._json(400, {"error": f"bad request: {e}"})
        return self._json(404, {"error": f"no route {self.path}"})

    def do_DELETE(self):  # noqa: N802
        parts = [p for p in self.path.split("/") if p]
        if len(parts) == 2 and parts[0] == "sessions":
            self.sessions.close(parts[1])
            with self.locks_lock:
                self.locks.pop(parts[1], None)
            return self._json(200, {"closed": True})
        return self._json(404, {"error": f"no route {self.path}"})

    def _create_session(self):
        body = self._read_body()
        if not body:
            return self._json(400, {"error": "empty upload"})
        sid = uuid.uuid4().hex
        suffix = ".mp4"
        name = self.headers.get("X-Filename", "")
        if "." in name:
            suffix = "." + name.rsplit(".", 1)[1]
        video_path = os.path.join(self.tmp_root, f"upload_{sid}{suffix}")
        with open(video_path, "wb") as f:
            f.write(body)
        try:
            video = AnnotationSession.decode(self.predictor, video_path)
        except (ValueError, ImportError, OSError) as e:  # an undecodable upload, or cv2 missing for its container
            return self._json(400, {"error": f"could not decode video: {e}"})
        try:
            sess = AnnotationSession(self.predictor, video)
        except Exception as e:  # noqa: BLE001 — a fault of the server (device memory, a kernel), not of the upload
            return self._json(500, {"error": f"could not open the session: {e}"})
        self.sessions.put(sid, sess)
        return self._json(
            200,
            {"session_id": sid, "num_frames": len(sess.raw), "height": sess.vh, "width": sess.vw},
        )


def create_server(
    predictor,
    host: str = "127.0.0.1",
    port: int = 0,
    max_idle_s: float = 600.0,
    tmp_root: Optional[str] = None,
) -> ThreadingHTTPServer:
    """Build (but do not start) the annotation HTTP server.

    Returns a ThreadingHTTPServer bound to (host, port) — port 0 picks a free
    one, read it back from `server.server_address`. Run with
    `server.serve_forever()` (a daemon thread in tests / embedding apps).
    """
    sessions = SessionManager(max_idle_s=max_idle_s)
    sessions.start_reaper()
    handler = type(
        "AnnotationHTTPHandler",
        (_AnnotationHTTPHandler,),
        {
            "predictor": predictor,
            "sessions": sessions,
            "locks": {},
            "locks_lock": threading.Lock(),
            "tmp_root": tmp_root or tempfile.mkdtemp(prefix="uvms2_http_"),
        },
    )
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7861)
    ap.add_argument("--max-idle-s", type=float, default=600.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    from us_video_medsam2_tpu_torch.core.build import build_sam2_video_predictor

    predictor = build_sam2_video_predictor(args.cfg, ckpt_path=args.checkpoint, device=args.device)
    server = create_server(predictor, args.host, args.port, max_idle_s=args.max_idle_s)
    print(f"serving on http://{server.server_address[0]}:{server.server_address[1]}")
    server.serve_forever()


if __name__ == "__main__":
    main()
