"""PyTorch port: the three example twins (examples/torch_*.py) on the CPU at
``tiny64_test``, each against its JAX example.

- ``torch_quickstart``: its synthetic video and ground truth equal the JAX
  quickstart's ``make_synthetic_video`` exactly; ``main`` prints the Dice
  line over every frame.
- ``torch_walkthrough_ct_lesion`` and ``torch_walkthrough_inference_video``:
  run beside the JAX walkthroughs (each package with its own random weights,
  so the predicted masks are not compared): the same synthetic data, prompt
  and outputs: ``seg_info.csv``'s case, key slice, box and ground-truth
  voxels equal and ``overlay.png`` written; the same frame count, mask
  prompt size, PNG names and ``key_frames.png``; with PIL and matplotlib
  hidden, the twins still run and say what they skipped.
- every twin takes ``--device``, the card by default (no fallback).
"""

from __future__ import annotations

import builtins
import csv
import importlib.util
import os
import runpy
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


def load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_example(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"), run_name="__main__")


def seg_info(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["case", "key_slice", "box", "pred_voxels", "gt_voxels", "dice"] and len(rows) == 2
    return dict(zip(rows[0], rows[1]))


def hide(monkeypatch, *names):
    real = builtins.__import__

    def fake(name, *a, **k):
        if name.split(".")[0] in names:
            raise ImportError(f"{name} hidden")
        return real(name, *a, **k)

    for n in list(sys.modules):
        if n.split(".")[0] in names:
            monkeypatch.delitem(sys.modules, n)
    monkeypatch.setattr(builtins, "__import__", fake)


def test_quickstart(capsys):
    twin = load("torch_quickstart")
    jax_quickstart = load("quickstart")  # its module level imports numpy only
    for t, size in ((3, 64), (2, 512)):
        got, want = twin.make_synthetic_video(t, size), jax_quickstart.make_synthetic_video(t, size)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert twin.main(["--cfg", "tiny64_test", "--frames", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "propagated 4 frames; mean Dice vs synthetic GT:" in out and "random weights" in out


def test_walkthrough_ct_lesion(tmp_path, capsys, monkeypatch):
    twin = load("torch_walkthrough_ct_lesion")
    assert twin.main(["--cfg", "tiny64_test", "--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    run_jax_example("walkthrough_ct_lesion", ["--cfg", "tiny64_test", "--out", str(tmp_path / "jax")], monkeypatch)
    jout = capsys.readouterr().out
    got, want = seg_info(tmp_path / "port" / "seg_info.csv"), seg_info(tmp_path / "jax" / "seg_info.csv")
    for k in ("case", "key_slice", "box", "gt_voxels"):
        assert got[k] == want[k], k
    assert got["case"] == "synthetic" and got["key_slice"] == "6" and 0 <= float(got["dice"]) <= 1
    for line in ("volume: (12, 512, 512)", f"key slice 6, box"):
        assert line in out and line in jout
    assert (tmp_path / "port" / "overlay.png").stat().st_size > 0 and (tmp_path / "jax" / "overlay.png").exists()
    # an NPZ case of the user's, matplotlib absent
    imgs, gts = twin.synthetic_case(t=5)
    np.savez(tmp_path / "case.npz", imgs=imgs, gts=gts * 3)
    hide(monkeypatch, "matplotlib")
    assert twin.main(["--cfg", "tiny64_test", "--npz", str(tmp_path / "case.npz"), "--out", str(tmp_path / "npz"),
                      "--device", "cpu"]) == 0
    assert "matplotlib unavailable; skipping visualization" in capsys.readouterr().out
    info = seg_info(tmp_path / "npz" / "seg_info.csv")
    assert info["case"] == "case.npz" and int(info["gt_voxels"]) == int((gts > 0).sum())
    assert not (tmp_path / "npz" / "overlay.png").exists()


def test_walkthrough_inference_video(tmp_path, capsys, monkeypatch):
    twin = load("torch_walkthrough_inference_video")
    argv = ["--cfg", "tiny64_test", "--frames", "4"]
    assert twin.main([*argv, "--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    run_jax_example("walkthrough_inference_video", [*argv, "--out", str(tmp_path / "jax")], monkeypatch)
    jout = capsys.readouterr().out.splitlines()
    for prefix in ("video:", "prompted frame 0 with a mask of", "propagated", "masks written to"):
        got = [x for x in out if x.startswith(prefix)]
        want = [x for x in jout if x.startswith(prefix)]
        assert len(got) == len(want) == 1, prefix
        if prefix != "masks written to":
            assert got == want
    assert any(x.startswith("mean IoU vs synthetic GT over 4 frames:") for x in out)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == [f"{i:05d}.png" for i in range(4)] + ["key_frames.png"]
    from PIL import Image

    png = np.asarray(Image.open(tmp_path / "port" / "00000.png"))
    assert png.shape == (512, 512) and set(np.unique(png)) <= {0, 1}
    # a frame folder with a mask prompt of the user's, PIL's export and matplotlib present
    frames, gt = twin.synthetic_cine(3, size=256)
    (tmp_path / "frames").mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / "frames" / f"f{i}.png")
    Image.fromarray(gt[0].astype(np.uint8) * 255).save(tmp_path / "mask0.png")
    assert twin.main(["--cfg", "tiny64_test", "--video_dir", str(tmp_path / "frames"), "--mask_prompt",
                      str(tmp_path / "mask0.png"), "--out", str(tmp_path / "dir"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "video: (3, 256, 256, 3)" in out and f"a mask of {int(gt[0].sum())} px" in out and "mean IoU" not in out
    assert gt[0].sum() > 0
    # the frame's file name, extension included, then ".png", as the JAX walkthrough names them
    assert sorted(os.listdir(tmp_path / "dir")) == ["f0.png.png", "f1.png.png", "f2.png.png", "key_frames.png"]
    # PIL and matplotlib absent: the synthetic run still propagates
    hide(monkeypatch, "PIL", "matplotlib")
    assert twin.main([*argv, "--out", str(tmp_path / "bare"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PIL unavailable; skipping PNG export" in out and "matplotlib unavailable" in out
    assert os.listdir(tmp_path / "bare") == []


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_walkthrough_ct_lesion",
                                  "torch_walkthrough_inference_video"])
def test_card_is_the_default(name, tmp_path):
    twin = load(name)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        twin.main(["--cfg", "tiny64_test", "--out", str(tmp_path)] if name != "torch_quickstart"
                  else ["--cfg", "tiny64_test"])
