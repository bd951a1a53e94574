"""PyTorch port: the annotation app (apps/app.py) against the JAX package's,
on the CPU at the MINI config (the same fixture weights through both
importers, ``fill_hole_area`` 0 as JAX's app tests).

1. ``AnnotationSession`` on JAX's own mp4 fixture (tests/test_app_and_io.py)
   and on an AVI of raw 'RGBA' frames, port against JAX: the frames, the
   click and box masks, every tracked frame's masks (per object, IoU >
   0.999: ``assert_masks_close``'s mask tolerance; a session keeps
   thresholded masks, not logits), ``masks.zip``'s names and its decoded
   PNGs, and every overlay within 1 grey level.
2. The export split: ``export_masks`` needs no cv2, ``export_overlay``
   raises an ImportError naming cv2 without it; ``export`` writes both.
3. The predictor's lock: held around every session call that reaches the
   device, and two sessions tracking in two threads give their sequential
   results.
4. ``SessionManager``'s reaper, ``PredictorRegistry``'s cache and device,
   ``build_demo``'s ImportError without gradio, and its full flow through
   JAX's gradio shim (tests/test_app_and_io.py::_make_gradio_shim).
"""

from __future__ import annotations

import os
import sys
import threading
import time
import zipfile

import numpy as np
import pytest

import chip_smoke
from tests.test_app_and_io import _make_gradio_shim, video_file  # noqa: F401 (a fixture)
from tests.torch_port_helpers import iou, mini_jax_predictor, mini_port_predictor
from us_video_medsam2_tpu.apps import app as japp
from us_video_medsam2_tpu_torch.apps import app as tapp

cv2 = pytest.importorskip("cv2")

BOX = [50.0, 10.0, 90.0, 40.0]


@pytest.fixture(scope="module")
def avi_file(tmp_path_factory):
    """JAX's fixture video as an AVI of raw 'RGBA' frames (no compression),
    written by chip_smoke.py's numpy writer."""
    rng = np.random.default_rng(0)
    frames = []
    for t in range(5):
        frame = (rng.random((80, 96, 3)) * 255).astype(np.uint8)
        frame[30 + t: 55 + t, 20 + t: 45 + t] = 255
        frames.append(frame)
    path = str(tmp_path_factory.mktemp("avi") / "test.avi")
    chip_smoke.write_rgba_avi(path, np.stack(frames))
    return path


@pytest.fixture(scope="module")
def predictors():
    return mini_jax_predictor(fill_hole_area=0), mini_port_predictor(fill_hole_area=0)


def _assert_masks_match(got, want, what):
    assert got[0] == want[0], (what, got[0], want[0])
    a, b = np.asarray(got[1]), np.asarray(want[1])
    assert a.shape == b.shape and a.dtype == b.dtype == bool, (what, a.shape, b.shape)
    for o in range(len(got[0])):
        assert iou(a[o], b[o]) > 0.999, (what, o)


def _zip_pngs(path):
    with zipfile.ZipFile(path) as z:
        return {n: cv2.imdecode(np.frombuffer(z.read(n), np.uint8), cv2.IMREAD_UNCHANGED) for n in z.namelist()}


@pytest.fixture(scope="module", params=["mp4", "avi"])
def sessions(request, predictors, video_file, avi_file, tmp_path_factory):  # noqa: F811
    """A JAX and a port session on the same video, each clicked, boxed and tracked."""
    path = video_file if request.param == "mp4" else avi_file
    jpred, tpred = predictors
    js, ts = japp.AnnotationSession(jpred, path), tapp.AnnotationSession(tpred, path)
    calls = {"click": [], "box": [], "neg": []}
    for s in (js, ts):
        calls["click"].append(s.click(0, 1, 32.0, 42.0, True))
        calls["box"].append(s.stroke_box(0, 2, BOX))
        calls["neg"].append(s.click(0, 1, 80.0, 70.0, False))
    tracked = [js.track(), ts.track()]
    out = tmp_path_factory.mktemp(f"export_{request.param}")
    return request.param, js, ts, calls, tracked, out


def test_session_frames_and_prompts_match_jax(sessions):
    name, js, ts, calls, _, _ = sessions
    assert (ts.vh, ts.vw) == (js.vh, js.vw) == (80, 96)
    assert ts.raw.shape == js.raw.shape and ts.raw.dtype == js.raw.dtype
    np.testing.assert_array_equal(ts.raw, js.raw)
    for what, (want, got) in calls.items():
        assert got[1].shape == (tapp.MAX_OBJECTS, 1, 80, 96) == (8, 1, 80, 96)  # JAX's 8 object slots
        _assert_masks_match((got[0], got[1][:, 0]), (want[0], want[1][:, 0]), f"{name} {what}")


def test_tracked_masks_match_jax(sessions):
    name, _, _, _, (want, got), _ = sessions
    assert list(got) == list(want) == [0, 1, 2, 3, 4]
    for f in want:
        _assert_masks_match(got[f], want[f], f"{name} frame {f}")
    assert any(got[f][1][:2].any() for f in got), "the masks are empty"


def test_masks_zip_and_overlays_match_jax(sessions):
    name, js, ts, _, _, out = sessions
    mp4, zip_path = js.export(str(out / "jax"))
    got_zip = ts.export_masks(str(out / "port"))
    want, got = _zip_pngs(zip_path), _zip_pngs(got_zip)
    assert sorted(got) == sorted(want) == [f"{f:05d}.png" for f in range(5)]
    for n in want:
        assert got[n].shape == want[n].shape == (80, 96) and got[n].dtype == np.uint8
        for oid in (1, 2):
            assert iou(got[n] == oid, want[n] == oid) > 0.999, (name, n, oid)
    for f in range(5):
        a, b = ts.overlay_frame(f).astype(int), js.overlay_frame(f).astype(int)
        assert a.shape == b.shape == (80, 96, 3)
        assert np.abs(a - b).max() <= 1, (name, f)


def test_export_writes_both_and_masks_need_no_cv2(sessions, monkeypatch):
    _, _, ts, _, _, out = sessions
    mp4, zip_path = ts.export(str(out / "both"))
    cap = cv2.VideoCapture(mp4)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 5 and zipfile.is_zipfile(zip_path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert _names(ts.export_masks(str(out / "no_cv2"))) == _names(zip_path)
    with pytest.raises(ImportError, match="cv2"):
        ts.export_overlay(str(out / "no_cv2"))


def _names(path):
    with zipfile.ZipFile(path) as z:
        return sorted(z.namelist())


class RecordingLock:
    """A lock that counts its holders at once and the acquisitions."""

    def __init__(self):
        self._lock = threading.Lock()
        self.holders = self.most = self.acquired = 0

    def __enter__(self):
        self._lock.acquire()
        self.holders += 1
        self.most = max(self.most, self.holders)
        self.acquired += 1
        return self

    def __exit__(self, *exc):
        self.holders -= 1
        self._lock.release()
        return False


def test_session_calls_hold_the_predictor_lock(avi_file, monkeypatch):
    pred = mini_port_predictor(fill_hole_area=0)
    lock = RecordingLock()
    monkeypatch.setattr(pred, "lock", lock)
    init_state, propagate = pred.init_state, pred.propagate_in_video

    def must_hold(fn):
        def held(*a, **k):
            assert lock.holders == 1, f"{fn.__name__} called without the predictor's lock"
            return fn(*a, **k)
        return held

    monkeypatch.setattr(pred, "init_state", must_hold(init_state))
    monkeypatch.setattr(pred, "add_new_points_or_box", must_hold(pred.add_new_points_or_box))
    monkeypatch.setattr(pred, "propagate_in_video", must_hold(propagate))
    s = tapp.AnnotationSession(pred, avi_file)
    s.click(0, 1, 32.0, 42.0, True)
    s.stroke_box(0, 2, BOX)
    s.track()
    assert lock.acquired == 4 and lock.holders == 0
    s.overlay_frame(1)  # host work: no lock
    assert lock.acquired == 4


def test_two_sessions_tracking_in_two_threads_give_their_sequential_results(avi_file, video_file):  # noqa: F811
    pred = mini_port_predictor(fill_hole_area=0)
    lock = RecordingLock()
    pred.lock = lock
    sessions = [tapp.AnnotationSession(pred, p) for p in (avi_file, video_file)]
    for s, x in zip(sessions, (32.0, 40.0)):
        s.click(0, 1, x, 42.0, True)
    alone = [{f: (o, m.copy()) for f, (o, m) in s.track().items()} for s in sessions]
    start = threading.Barrier(2)
    errors = []

    def run(s):
        try:
            start.wait(timeout=60)
            s.track()
        except Exception as e:  # noqa: BLE001 — handed to the test thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(s,)) for s in sessions]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert lock.most == 1
    for s, want in zip(sessions, alone):
        assert list(s.masks_by_frame) == list(want)
        for f, (o, m) in want.items():
            assert s.masks_by_frame[f][0] == o
            np.testing.assert_array_equal(s.masks_by_frame[f][1], m)


def test_session_manager_reaper():
    mgr = tapp.SessionManager(max_idle_s=0.2)
    mgr.put("a", object())
    mgr.put("b", object())
    assert len(mgr) == 2
    mgr.get("a")
    assert mgr.reap(now=time.monotonic()) == []
    time.sleep(0.3)
    assert sorted(mgr.reap()) == ["a", "b"] and len(mgr) == 0
    with pytest.raises(KeyError):
        mgr.get("a")
    mgr.put("c", object())
    mgr.close("c")
    mgr.close("c")
    assert len(mgr) == 0
    fast = tapp.SessionManager(max_idle_s=0.05, reap_every_s=0.05)
    fast.put("d", object())
    fast.start_reaper()
    deadline = time.monotonic() + 5
    while len(fast) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert len(fast) == 0, "the reaper thread dropped nothing"


def test_predictor_registry_caches_and_builds_on_its_device(monkeypatch):
    from us_video_medsam2_tpu_torch.core import build as build_mod

    calls = []

    def fake_build(cfg, ckpt_path=None, device="cuda"):
        calls.append((cfg, ckpt_path, device))
        return object()

    monkeypatch.setattr(build_mod, "build_sam2_video_predictor", fake_build)
    reg = tapp.PredictorRegistry(
        {"tiny": ("sam2.1_hiera_t512", None), "eff": ("efficientmedsam_s_512", "x.pt")}, device="cpu")
    assert reg.names() == ["tiny", "eff"]
    assert reg.get("tiny") is reg.get("tiny") and calls == [("sam2.1_hiera_t512", None, "cpu")]
    reg.get("eff")
    assert calls[-1] == ("efficientmedsam_s_512", "x.pt", "cpu")
    assert tapp.PredictorRegistry().device == "cuda"


def test_build_demo_needs_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio is not installed"):
        tapp.build_demo()


def test_gradio_build_demo_full_flow(video_file, monkeypatch):  # noqa: F811
    """build_demo's real callbacks through JAX's gradio shim: load a video,
    click an object, track, export mp4 + zip, then expire the session."""
    from us_video_medsam2_tpu_torch.core import build as build_mod

    pred = mini_port_predictor(fill_hole_area=0)
    shim = _make_gradio_shim()
    monkeypatch.setitem(sys.modules, "gradio", shim)
    monkeypatch.setattr(build_mod, "build_sam2_video_predictor", lambda cfg, ckpt_path=None, device="cuda": pred)
    demo = tapp.build_demo(model_choices={"mini": ("mini", None)}, max_idle_s=1e9, device="cpu")

    def find(cls_name, label):
        return next(c for c in shim._components if type(c).__name__ == cls_name and c.label == label)

    req = shim.Request()
    req.session_hash = "sess-1"
    load_fn, _, _ = find("Video", "input video").handlers["change"]
    frame0, slider_update = load_fn(video_file, "mini", req)
    assert frame0.shape == (80, 96, 3) and frame0.dtype == np.uint8
    assert slider_update["maximum"] == 4 and slider_update["value"] == 0
    evt = shim.SelectData()
    evt.index = (32, 42)
    click_fn, _, _ = find("Image", "frame").handlers["select"]
    overlay = click_fn(0, 1, True, evt, req)
    assert overlay.shape == (80, 96, 3) and (overlay != frame0).any(), "click must paint an object overlay"
    track_fn, _, _ = find("Button", "Track").handlers["click"]
    mp4, zf = track_fn(req)
    assert os.path.getsize(mp4) > 0
    pngs = _zip_pngs(zf)
    assert len(pngs) == 5 and (pngs["00000.png"] == 1).sum() > 0
    demo.unload_fn(req)
    with pytest.raises(shim.Error):
        click_fn(0, 1, True, evt, req)

