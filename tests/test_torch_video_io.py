"""PyTorch port: utils/video_io.py against the JAX package's, exactly.

A frame directory (PNG and JPEG, through PIL), an mp4 written with cv2 and
read back through it, ``AsyncVideoFrameLoader`` and ``concat_points``; the
upload decoder of an AVI of raw 'RGBA' frames (against cv2 and JAX's
``load_video_frames``), OpenCV's INTER_LINEAR rule (against cv2.resize)
and the greyscale PNG writer (against cv2.imdecode), each exactly.
"""

import sys

import numpy as np
import pytest

import chip_smoke
from us_video_medsam2_tpu.utils import video_io as jio
from us_video_medsam2_tpu_torch.utils import video_io as tio

PIL = pytest.importorskip("PIL.Image")


def _frames(n=4, h=30, w=40):
    rng = np.random.default_rng(0)
    return (rng.random((n, h, w, 3)) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    for i, f in enumerate(_frames()):
        PIL.fromarray(f).save(d / f"{i}.{'png' if i % 2 else 'jpg'}")
    (d / "notes.txt").write_text("not a frame")
    return str(d)


@pytest.mark.parametrize("normalize", [True, False])
def test_frame_directory_matches_jax(frame_dir, normalize):
    got, gh, gw = tio.load_video_frames(frame_dir, 32, normalize)
    want, wh, ww = jio.load_video_frames(frame_dir, 32, normalize)
    assert got.shape == (4, 32, 32, 3) and got.dtype == want.dtype == np.float32
    assert (gh, gw) == (wh, ww) == (30, 40)
    np.testing.assert_array_equal(got, want)


def test_frame_names_sort_as_jax(tmp_path):
    for name in ("b.png", "a.png", "c.jpeg", "10.png"):
        PIL.fromarray(_frames(1)[0]).save(tmp_path / name)
    assert tio._list_frame_files(str(tmp_path)) == jio._list_frame_files(str(tmp_path))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tio.load_video_frames(str(empty), 32)


def test_mp4_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (40, 30))
    if not wr.isOpened():
        pytest.skip("cv2 has no mp4v writer here")
    for f in _frames(5):
        wr.write(f)
    wr.release()
    got, gh, gw = tio.load_video_frames(path, 24)
    want, wh, ww = jio.load_video_frames(path, 24)
    assert got.shape == (5, 24, 24, 3) and (gh, gw) == (wh, ww) == (30, 40)
    np.testing.assert_array_equal(got, want)


def test_async_loader_matches_jax(frame_dir):
    paths = tio._list_frame_files(frame_dir)
    got = tio.AsyncVideoFrameLoader(paths, 32)
    want = jio.AsyncVideoFrameLoader(paths, 32)
    assert len(got) == len(want) == 4
    for i in range(4):
        np.testing.assert_array_equal(got[i], want[i])
    got.thread.join(timeout=10)
    assert not got.thread.is_alive() and got.exception is None
    assert (got.video_height, got.video_width) == (want.video_height, want.video_width) == (30, 40)


def test_async_loader_raises_the_loader_thread_error(tmp_path):
    good = tmp_path / "0.png"
    PIL.fromarray(_frames(1)[0]).save(good)
    bad = tmp_path / "1.png"
    bad.write_bytes(b"not a png")
    loader = tio.AsyncVideoFrameLoader([str(good), str(bad)], 16)
    loader.thread.join(timeout=10)
    with pytest.raises(Exception):
        loader[1]


def test_concat_points_matches_jax():
    p1, l1 = np.ones((1, 2, 2), np.float32), np.ones((1, 2), np.int32)
    p2, l2 = np.zeros((1, 1, 2), np.float32), np.zeros((1, 1), np.int32)
    first = tio.concat_points(None, p1, l1)
    assert first is not None and first["point_coords"] is p1
    got = tio.concat_points(first, p2, l2)
    want = jio.concat_points(jio.concat_points(None, p1, l1), p2, l2)
    for k in ("point_coords", "point_labels"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["point_coords"].shape == (1, 3, 2)


# ------------------------------------------------------------------ uploads
# An AVI of raw 32-bit 'RGBA' frames is read by the port itself (the card's
# machine has no cv2): the reader is held bit for bit against
# cv2.VideoCapture on files cv2 wrote (even sizes: cv2's writer cuts an odd
# size, 37x51 comes back 36x50), the resize bit for bit against
# cv2.resize, and load_video_frames against the JAX package's (exactly;
# the rule allows 1 grey level). Odd sizes are the port's own round trip:
# chip_smoke.py's numpy writer and the reader, which cv2 also reads back.

def _cv2_rgba_avi(path, frames_rgb):
    cv2 = pytest.importorskip("cv2")
    t, h, w = frames_rgb.shape[:3]
    wr = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"RGBA"), 10, (w, h))
    if not wr.isOpened():
        pytest.skip("cv2 has no FFmpeg 'RGBA' AVI writer here")
    for f in frames_rgb:
        wr.write(np.ascontiguousarray(f[..., ::-1]))
    wr.release()
    return str(path)


def _cv2_read(path):
    cv2 = pytest.importorskip("cv2")
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f[..., ::-1])
    cap.release()
    return np.stack(out)


@pytest.mark.parametrize("hw", [(80, 96), (48, 64), (120, 160)])
def test_rgba_avi_reader_matches_cv2(tmp_path, hw):
    frames = (np.random.default_rng(hw[0]).random((3, *hw, 3)) * 255).astype(np.uint8)
    path = _cv2_rgba_avi(tmp_path / "clip.avi", frames)
    want = _cv2_read(path)
    assert tio.is_rgba_avi(path)
    got = tio.read_rgba_avi(path)
    assert got.shape == want.shape == frames.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, frames)  # the file is lossless


@pytest.mark.parametrize("hw", [(80, 96), (37, 51), (1, 1)])
def test_numpy_writer_round_trip(tmp_path, hw):
    frames = (np.random.default_rng(1).random((4, *hw, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "own.avi")
    chip_smoke.write_rgba_avi(path, frames)
    np.testing.assert_array_equal(tio.read_rgba_avi(path), frames)
    np.testing.assert_array_equal(_cv2_read(path), frames)  # cv2 reads the writer's file alike


def test_reader_with_an_index_of_absolute_offsets(tmp_path):
    """idx1 offsets may count from the file's start instead of the movi list."""
    import struct

    frames = (np.random.default_rng(2).random((3, 20, 30, 3)) * 255).astype(np.uint8)
    path = tmp_path / "own.avi"
    chip_smoke.write_rgba_avi(str(path), frames)
    data = bytearray(path.read_bytes())
    movi = data.index(b"movi")
    idx = data.rindex(b"idx1") + 8
    for i in range(3):
        off = idx + 16 * i + 8
        data[off: off + 4] = struct.pack("<I", struct.unpack_from("<I", data, off)[0] + movi)
    path.write_bytes(bytes(data))
    np.testing.assert_array_equal(tio.read_rgba_avi(str(path)), frames)


def test_reader_refuses_a_truncated_file(tmp_path):
    frames = (np.random.default_rng(2).random((3, 20, 30, 3)) * 255).astype(np.uint8)
    path = tmp_path / "own.avi"
    chip_smoke.write_rgba_avi(str(path), frames)
    data = path.read_bytes()
    path.write_bytes(data[: data.index(b"00dc") + 8 + 100])  # the first frame cut short, no index
    assert tio.is_rgba_avi(str(path))
    with pytest.raises(ValueError, match="bytes"):
        tio.read_rgba_avi(str(path))


def test_reader_without_index(tmp_path):
    """A file whose idx1 is cut off reads in movi's order."""
    frames = (np.random.default_rng(2).random((3, 20, 30, 3)) * 255).astype(np.uint8)
    path = tmp_path / "own.avi"
    chip_smoke.write_rgba_avi(str(path), frames)
    data = path.read_bytes()
    cut = data[: data.rindex(b"idx1")]
    cut = cut[:4] + len(cut[8:]).to_bytes(4, "little") + cut[8:]
    path.write_bytes(cut)
    np.testing.assert_array_equal(tio.read_rgba_avi(str(path)), frames)


@pytest.mark.parametrize("src,dst", [((80, 96), (64, 64)), ((480, 640), (512, 512)), ((600, 800), (512, 512)),
                                     ((36, 50), (64, 64)), ((1024, 1024), (512, 512)), ((7, 9), (32, 32)),
                                     ((64, 64), (80, 96)), ((512, 512), (37, 51)), ((5, 3), (5, 3))])
def test_resize_linear_u8_matches_cv2(src, dst):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    for img in (rng.integers(0, 256, (*src, 3), np.uint8), np.full((*src, 3), 255, np.uint8),
                np.repeat(rng.integers(0, 256, (*src, 1), np.uint8), 3, axis=-1)):
        want = cv2.resize(img, (dst[1], dst[0]))
        np.testing.assert_array_equal(tio.resize_linear_u8(img, *dst), want)


@pytest.mark.parametrize("normalize", [True, False])
def test_rgba_avi_matches_jax(tmp_path, normalize):
    frames = (np.random.default_rng(3).random((4, 48, 64, 3)) * 255).astype(np.uint8)
    path = _cv2_rgba_avi(tmp_path / "clip.avi", frames)
    got, gh, gw = tio.load_video_frames(path, 40, normalize)
    want, wh, ww = jio.load_video_frames(path, 40, normalize)
    assert got.shape == want.shape == (4, 40, 40, 3) and (gh, gw) == (wh, ww) == (48, 64)
    scale = 1.0 / 255.0 / (float(tio.IMG_STD.min()) if normalize else 1.0)
    assert np.abs(got - want).max() <= scale + 1e-6  # within 1 grey level
    np.testing.assert_array_equal(got, want)  # and in fact exactly, the resize being cv2's rule


def test_rgba_avi_reads_without_cv2(tmp_path, monkeypatch):
    frames = (np.random.default_rng(4).random((2, 30, 40, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "own.avi")
    chip_smoke.write_rgba_avi(path, frames)
    with_cv2, _, _ = tio.load_video_frames(path, 24)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got, h, w = tio.load_video_frames(path, 24)
    assert (h, w) == (30, 40)
    np.testing.assert_array_equal(got, with_cv2)


def test_other_containers_need_cv2(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (40, 30))
    for f in _frames(2):
        wr.write(f)
    wr.release()
    assert not tio.is_rgba_avi(path)
    ffv1 = str(tmp_path / "clip.avi")
    wr = cv2.VideoWriter(ffv1, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"FFV1"), 10, (40, 30))
    for f in _frames(2):
        wr.write(f)
    wr.release()
    assert not tio.is_rgba_avi(ffv1)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for p in (path, ffv1):
        with pytest.raises(ImportError, match="'RGBA'.*needs cv2"):
            tio.load_video_frames(p, 24)


def test_write_png_gray_decodes_exactly():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    for canvas in (rng.integers(0, 9, (37, 51), np.uint8), np.zeros((1, 1), np.uint8),
                   rng.integers(0, 256, (480, 640), np.uint8)):
        png = tio.write_png_gray(canvas)
        got = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint8 and got.shape == canvas.shape
        np.testing.assert_array_equal(got, canvas)
        np.testing.assert_array_equal(chip_smoke.read_png_gray(png), canvas)
    with pytest.raises(ValueError):
        tio.write_png_gray(np.zeros((2, 2, 3), np.uint8))
