"""PyTorch port, the native NPZ reader (``training/native_npz.py`` and its
copy of the C++ source, ``us_video_medsam2_tpu_torch/native/npz_reader.cpp``).

The library builds here (a C++ compiler and ``zlib.h`` are present) and
reads every array of an ``.npz`` byte for byte as numpy does, compressed or
stored, across dtypes; the switch ``UVMS2_NATIVE_NPZ`` unset leaves numpy as
the reader; set, a reader that cannot be built, or an array of a dtype it
cannot read, raises instead of giving way to numpy. The JAX package's reader
(``us_video_medsam2_tpu/training/native_npz.py``) reads the same files into
the same arrays.
"""

from __future__ import annotations

import numpy as np
import pytest

from us_video_medsam2_tpu_torch.training import data as P
from us_video_medsam2_tpu_torch.training import native_npz


@pytest.fixture
def native(monkeypatch, tmp_path):
    """The switch set and the library built into a fresh directory."""
    monkeypatch.setenv("UVMS2_NATIVE_NPZ", "1")
    monkeypatch.setattr(native_npz, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_npz, "_lib", None)
    yield native_npz
    monkeypatch.setattr(native_npz, "_lib", None)


def arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "imgs": (rng.random((5, 33, 47)) * 255).astype(np.uint8),
        "gts": (rng.random((5, 33, 47)) * 3).astype(np.int16),
        "mask": rng.random((7, 9)) > 0.5,
        "f32": rng.standard_normal((3, 4, 5)).astype(np.float32),
        "f64": rng.standard_normal(11),
        "i64": rng.integers(-2**40, 2**40, (2, 3)),
        "u16": rng.integers(0, 2**16, (4,)).astype(np.uint16),
        "f16": rng.standard_normal((6,)).astype(np.float16),
        "scalar": np.asarray(3.5, np.float32),
    }


def assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("compressed", [True, False])
def test_native_reader_equals_numpy(native, tmp_path, compressed):
    path = str(tmp_path / "a.npz")
    (np.savez_compressed if compressed else np.savez)(path, **arrays())
    assert native.native_available() and native.library_path().exists()
    with np.load(path) as ref:
        want = {k: ref[k] for k in ref.files}
    assert_same(native.load_npz(path), want)
    assert_same(native.load_npz(path, ["imgs", "mask"]), {k: want[k] for k in ("imgs", "mask")})
    loader = native.PrefetchingNPZLoader(num_workers=2, ahead=2)
    loader.schedule(path)
    assert_same(loader.get(path), want)
    assert_same(loader.get(path), want)  # an unscheduled read


def test_jax_reader_reads_the_same(native, tmp_path, monkeypatch):
    from us_video_medsam2_tpu.training import native_npz as jax_native

    path = str(tmp_path / "b.npz")
    np.savez_compressed(path, imgs=arrays()["imgs"], gts=arrays()["gts"])
    assert_same(native.load_npz(path), jax_native.load_npz(path))


def test_switch_unset_reads_with_numpy(monkeypatch, tmp_path):
    monkeypatch.delenv("UVMS2_NATIVE_NPZ", raising=False)
    monkeypatch.setattr(native_npz, "_lib", None)
    assert native_npz.get_lib() is None and not native_npz.native_available()
    path = str(tmp_path / "c.npz")
    np.savez(path, x=np.arange(4), y=np.ones((2, 2), complex))  # numpy reads any dtype
    out = native_npz.load_npz(path)
    assert out["y"].dtype == complex
    monkeypatch.setenv("UVMS2_NATIVE_NPZ", "0")
    assert native_npz.get_lib() is None


def test_set_and_unbuildable_raises(native, monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_npz, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="does not build"):
        native_npz.load_npz(str(tmp_path / "any.npz"))
    monkeypatch.setattr(native_npz.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="compiler"):
        native_npz.get_lib()


def test_set_and_unreadable_dtype_raises(native, tmp_path):
    path = str(tmp_path / "d.npz")
    np.savez(path, z=np.ones(3, np.complex64))
    with pytest.raises(IOError, match="does not read"):
        native.load_npz(path)


def test_npz_dataset_reads_through_the_switch(native, tmp_path):
    root = tmp_path / "vids"
    root.mkdir()
    for v in range(2):
        a = arrays(v)
        np.savez_compressed(root / f"v{v}.npz", imgs=a["imgs"], gts=a["gts"])
    calls = []
    real = native.get_lib

    def counted():
        lib = real()
        calls.append(lib is not None)
        return lib

    native.get_lib = counted
    try:
        ds = P.NPZRawDataset(str(root), prefetch_workers=1, prefetch_ahead=1)
        video, seg = ds.get_video(0)
        video1, _ = ds.get_video(1)
    finally:
        native.get_lib = real
    assert calls and all(calls)
    want = arrays(0)
    np.testing.assert_array_equal(video.frames[2].data[..., 0], want["imgs"][2].astype(np.float32) / 255.0)
    np.testing.assert_array_equal(seg.masks, want["gts"])
    np.testing.assert_array_equal(video1.frames[0].data[..., 1], arrays(1)["imgs"][0].astype(np.float32) / 255.0)
