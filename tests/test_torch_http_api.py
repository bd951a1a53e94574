"""PyTorch port: the annotation HTTP server (apps/http_api.py) against the
JAX package's, on the CPU at the MINI config (the same fixture weights
through both importers, ``fill_hole_area`` 0 as JAX's app tests), through
real HTTP round trips.

1. Every route on both servers with the same upload (JAX's mp4 fixture and
   an AVI of raw 'RGBA' frames): the same JSON bodies, ``obj_ids`` equal and
   each ``areas`` entry within 0.1% (``assert_masks_close``'s mask IoU >
   0.999 bounds an area's change by 0.1% of its union); ``masks.zip``'s
   names and PNGs; ``tracked.mp4``; DELETE, and 404 after.
2. The errors: 404 for an unknown route, session or artifact; 400 for an
   empty upload, an upload that does not decode, a body that is not JSON and
   a request without its fields.
3. Without cv2 (monkeypatched away): an AVI upload and ``masks.zip`` still
   work, ``tracked.mp4`` answers 501 with an error naming cv2, and an mp4
   upload answers 400 "could not decode video", as JAX's server does on a
   machine without cv2.
4. A device fault while a decoded upload's session opens (``init_state``
   monkeypatched to raise as a CUDA error would) answers 500, not 400: the
   upload was good. JAX's server has no such case.
"""

from __future__ import annotations

import io
import json
import sys
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest

from tests.test_app_and_io import video_file  # noqa: F401 (a fixture)
from tests.test_torch_app import BOX, avi_file, predictors  # noqa: F401 (fixtures)
from tests.torch_port_helpers import iou
from us_video_medsam2_tpu.apps.http_api import create_server as jax_create_server
from us_video_medsam2_tpu_torch.apps.http_api import create_server

cv2 = pytest.importorskip("cv2")


class Client:
    def __init__(self, server):
        host, port = server.server_address
        self.base = f"http://{host}:{port}"

    def call(self, method, path, body=None, headers=None):
        """(status, content type, body bytes); an HTTP error's status and body too."""
        req = urllib.request.Request(self.base + path, data=body, method=method, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status, resp.headers.get_content_type(), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get_content_type(), e.read()

    def json(self, method, path, payload=None, **kw):
        body = json.dumps(payload).encode() if payload is not None else kw.pop("body", None)
        code, ctype, out = self.call(method, path, body, **kw)
        assert ctype == "application/json", (path, code, ctype)
        return code, json.loads(out)


@pytest.fixture(scope="module")
def servers(predictors, tmp_path_factory):
    jpred, tpred = predictors
    made = [jax_create_server(jpred, port=0, tmp_root=str(tmp_path_factory.mktemp("jax_http"))),
            create_server(tpred, port=0, tmp_root=str(tmp_path_factory.mktemp("port_http")))]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in made]
    for t in threads:
        t.start()
    yield [Client(s) for s in made]
    for s in made:
        s.shutdown()
        s.server_close()


def _upload(client, path, name):
    with open(path, "rb") as f:
        return client.json("POST", "/sessions", body=f.read(), headers={"X-Filename": name})


def _same_masks_body(got, want, what):
    assert got["obj_ids"] == want["obj_ids"], (what, got, want)
    assert len(got["areas"]) == len(want["areas"]) == len(want["obj_ids"])
    for a, b in zip(got["areas"], want["areas"]):
        assert abs(a - b) <= 1e-3 * max(a, b), (what, got["areas"], want["areas"])


@pytest.fixture(scope="module", params=["mp4", "avi"])
def flow(request, servers, video_file, avi_file):  # noqa: F811
    """The same flow on both servers: upload, two clicks and a box, track."""
    path = video_file if request.param == "mp4" else avi_file
    out = []
    for c in servers:
        rec = {"client": c}
        code, rec["meta"] = _upload(c, path, f"test.{request.param}")
        assert code == 200, rec["meta"]
        sid = rec["meta"]["session_id"]
        rec["click"] = c.json("POST", f"/sessions/{sid}/click",
                              {"frame_idx": 0, "obj_id": 1, "x": 32.0, "y": 42.0, "positive": True})
        rec["box"] = c.json("POST", f"/sessions/{sid}/box", {"frame_idx": 0, "obj_id": 2, "box": BOX})
        rec["neg"] = c.json("POST", f"/sessions/{sid}/click",
                            {"frame_idx": 0, "obj_id": 1, "x": 80.0, "y": 70.0, "positive": False})
        rec["track"] = c.json("POST", f"/sessions/{sid}/track", body=b"{}")
        out.append(rec)
    return request.param, out


def test_every_route_answers_as_jax(flow):
    name, (want, got) = flow
    for rec in (want, got):
        assert rec["client"].json("GET", "/healthz")[1]["ok"] is True
    meta_w, meta_g = dict(want["meta"]), dict(got["meta"])
    assert meta_g.pop("session_id") != meta_w.pop("session_id")
    assert meta_g == meta_w == {"num_frames": 5, "height": 80, "width": 96}
    for what in ("click", "box", "neg"):
        assert got[what][0] == want[what][0] == 200
        _same_masks_body(got[what][1], want[what][1], f"{name} {what}")
    assert got["track"][0] == want["track"][0] == 200
    frames_w, frames_g = want["track"][1]["frames"], got["track"][1]["frames"]
    assert sorted(frames_g) == sorted(frames_w) == [str(f) for f in range(5)]
    for f in frames_w:
        _same_masks_body(frames_g[f], frames_w[f], f"{name} frame {f}")


def _zip(client, sid):
    code, ctype, body = client.call("GET", f"/sessions/{sid}/export/masks.zip")
    assert code == 200 and ctype == "application/zip"
    with zipfile.ZipFile(io.BytesIO(body)) as z:
        return {n: cv2.imdecode(np.frombuffer(z.read(n), np.uint8), cv2.IMREAD_UNCHANGED) for n in z.namelist()}


def test_exports_and_close_answer_as_jax(flow):
    name, (want, got) = flow
    sids = [r["meta"]["session_id"] for r in (want, got)]
    zw, zg = _zip(want["client"], sids[0]), _zip(got["client"], sids[1])
    assert sorted(zg) == sorted(zw) == [f"{f:05d}.png" for f in range(5)]
    for n in zw:
        for oid in (1, 2):
            assert iou(zg[n] == oid, zw[n] == oid) > 0.999, (name, n, oid)
    code, ctype, body = got["client"].call("GET", f"/sessions/{sids[1]}/export/tracked.mp4")
    assert code == 200 and ctype == "video/mp4" and len(body) > 0
    for rec, sid in zip((want, got), sids):
        c = rec["client"]
        assert c.json("DELETE", f"/sessions/{sid}") == (200, {"closed": True})
        assert c.json("POST", f"/sessions/{sid}/track", body=b"{}")[0] == 404
        assert c.json("GET", f"/sessions/{sid}/export/masks.zip")[0] == 404


def test_errors_answer_as_jax(servers, avi_file):  # noqa: F811
    for c in servers:
        assert c.json("GET", "/nowhere")[0] == 404
        assert c.json("POST", "/sessions/nope/click", {"frame_idx": 0})[0] == 404
        assert c.json("DELETE", "/nowhere/at/all")[0] == 404
        assert c.json("POST", "/sessions", body=b"")[0] == 400
        code, body = c.json("POST", "/sessions", body=b"not a video", headers={"X-Filename": "x.avi"})
        assert code == 400 and "could not decode video" in body["error"]
    # on the port's server: an open session's malformed requests
    c = servers[1]
    code, meta = _upload(c, avi_file, "test.avi")
    sid = meta["session_id"]
    assert c.json("POST", f"/sessions/{sid}/click", body=b"{not json")[0] == 400
    code, body = c.json("POST", f"/sessions/{sid}/click", {"frame_idx": 0, "obj_id": 1})
    assert code == 400 and "bad request" in body["error"]
    assert c.json("GET", f"/sessions/{sid}/export/other.bin")[0] == 404
    assert c.json("POST", f"/sessions/{sid}/unknown", {})[0] == 404
    assert c.json("GET", "/healthz")[1]["sessions"] >= 1
    assert c.json("DELETE", f"/sessions/{sid}")[0] == 200


def test_without_cv2(servers, avi_file, video_file, monkeypatch):  # noqa: F811
    c = servers[1]
    monkeypatch.setitem(sys.modules, "cv2", None)
    code, body = _upload(c, video_file, "test.mp4")
    assert code == 400 and "could not decode video" in body["error"] and "needs cv2" in body["error"]
    code, meta = _upload(c, avi_file, "test.avi")
    assert code == 200, meta
    sid = meta["session_id"]
    assert c.json("POST", f"/sessions/{sid}/click", {"frame_idx": 0, "obj_id": 1, "x": 32.0, "y": 42.0})[0] == 200
    assert c.json("POST", f"/sessions/{sid}/track", body=b"{}")[0] == 200
    code, ctype, zbody = c.call("GET", f"/sessions/{sid}/export/masks.zip")
    assert code == 200 and ctype == "application/zip"
    with zipfile.ZipFile(io.BytesIO(zbody)) as z:
        assert len(z.namelist()) == 5
    code, body = c.json("GET", f"/sessions/{sid}/export/tracked.mp4")
    assert code == 501 and "cv2" in body["error"]
    assert c.json("DELETE", f"/sessions/{sid}")[0] == 200


def test_device_fault_on_open_answers_500(servers, predictors, avi_file, monkeypatch):  # noqa: F811
    c, (_, tpred) = servers[1], predictors
    sessions = c.json("GET", "/healthz")[1]["sessions"]

    def fault(*args, **kw):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(tpred, "init_state", fault)
    code, body = _upload(c, avi_file, "test.avi")
    assert code == 500 and "could not open the session" in body["error"] and "out of memory" in body["error"]
    assert c.json("GET", "/healthz")[1]["sessions"] == sessions
