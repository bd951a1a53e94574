"""PyTorch port: utils/video_io.py against the JAX package's, exactly.

A frame directory (PNG and JPEG, through PIL), an mp4 written with cv2 and
read back through it, ``AsyncVideoFrameLoader`` and ``concat_points``.
"""

import numpy as np
import pytest

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
