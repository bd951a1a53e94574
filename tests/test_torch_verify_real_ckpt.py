"""PyTorch port: tools/torch_verify_real_ckpt.py on the CPU against the JAX
package's tools/verify_real_ckpt.py, after
tests/test_e2e_pipeline.py::test_verify_real_ckpt_harness.

A seeded ``tiny64_test`` checkpoint in the native ``.npz`` layout (written by
the port, read by both packages) and synthetic NPZ cases (classes 1 and 2):
- both tools' JSON summaries on the same cases, each package's predictor in
  f32: the same keys, cases and classes, every mean within 1e-3 (as
  tests/test_torch_apps.py holds ``evaluate_video``), and the same FAIL exit
  code under ``--expect_dice 0.999``;
- the twin at its own default dtype (bf16): exit 0 with no gate, PASS (0)
  under ``--expect_dice 0``, FAIL (1) under 0.999, the CSV's ALL rows; the
  same weights as a reference-name ``.pt`` under "model" give the same
  summary;
- an Orbax directory and a missing checkpoint refused; the card as the
  default device (no fallback to the CPU).
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """tests/test_e2e_pipeline.py's NPZ videos, with frame 0 unannotated."""
    root = tmp_path_factory.mktemp("verify_cases")
    rng = np.random.default_rng(0)
    for vi in range(3):
        t, h, w = 5, 96, 80
        imgs = (rng.random((t, h, w)) * 255).astype(np.uint8)
        gts = np.zeros((t, h, w), np.uint8)
        for ti in range(t):
            y, x = 30 + ti, 25 + ti
            gts[ti, y: y + 25, x: x + 20] = 1
            gts[ti, 5:20, 50:70] = 2
            imgs[ti][gts[ti] == 1] = 220
        gts[0] = 0
        np.savez_compressed(root / f"video_{vi}.npz", imgs=imgs, gts=gts)
    return str(root)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(native .npz, reference-name .pt) of seeded tiny64_test weights, the
    object-score head's output bias at +10 so that every object is tracked."""
    import chip_smoke
    from us_video_medsam2_tpu_torch.core import checkpoint
    from us_video_medsam2_tpu_torch.core.build import build_sam2
    from us_video_medsam2_tpu_torch.core.weights import to_jax_params

    root = tmp_path_factory.mktemp("verify_ckpt")
    model = build_sam2("tiny64_test", seed=3)
    with torch.no_grad():
        model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
    npz = str(root / "checkpoint.npz")
    checkpoint.save_checkpoint(npz, {"params": to_jax_params(model.state_dict(), model.cfg)})
    pt = str(root / "reference.pt")
    torch.save({"model": chip_smoke.to_reference_state_dict(model.state_dict(), model.cfg)}, pt)
    return npz, pt


def run(tool, argv, capsys):
    rc = tool.main(argv)
    out = capsys.readouterr().out
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert len(lines) == 1, out
    return rc, lines[0], out


def hold_summaries(got, want, ckpt_path):
    assert got["checkpoint"] == want["checkpoint"] == ckpt_path
    assert (got["cfg"], got["cases"]) == (want["cfg"], want["cases"])
    assert sorted(got["global_means"]) == sorted(want["global_means"]) == ["1", "2"]
    for c, m in want["global_means"].items():
        assert sorted(got["global_means"][c]) == sorted(m) == ["acc", "dice", "iou"]
        for k, v in m.items():
            np.testing.assert_allclose(got["global_means"][c][k], v, atol=1e-3, err_msg=f"class {c} {k}")


def test_summary_and_exit_codes_match_jax(cases, ckpt, tmp_path, capsys, monkeypatch):
    import jax.numpy as jnp

    from us_video_medsam2_tpu.core import build as jbuild
    from us_video_medsam2_tpu_torch.core import build as tbuild

    monkeypatch.setattr(jbuild, "build_sam2_video_predictor_npz",
                        functools.partial(jbuild.build_sam2_video_predictor_npz, dtype=jnp.float32))
    monkeypatch.setattr(tbuild, "build_sam2_video_predictor_npz",
                        functools.partial(tbuild.build_sam2_video_predictor_npz, dtype=torch.float32),
                        raising=False)
    npz, _ = ckpt
    args = [npz, "--data_dir", cases, "--cfg", "tiny64_test", "--cases", "2", "--expect_dice", "0.999"]
    rc_j, want, out_j = run(load("verify_real_ckpt"), args + ["--out_dir", str(tmp_path / "jax")], capsys)
    rc_t, got, out_t = run(load("torch_verify_real_ckpt"),
                           args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"], capsys)
    assert rc_j == rc_t == 1 and "FAIL: class-1 Dice" in out_j and "FAIL: class-1 Dice" in out_t
    assert got["csv"] == str(tmp_path / "port" / "evaluation_summary.csv")
    hold_summaries(got, want, npz)
    assert 0.2 < got["global_means"]["1"]["dice"] < 0.999
    rows = [open(s["csv"]).read().splitlines() for s in (want, got)]
    assert [r.split(",")[:2] for r in rows[0]] == [r.split(",")[:2] for r in rows[1]]


def test_gate_exit_codes_and_checkpoint_forms(cases, ckpt, tmp_path, capsys):
    tool = load("torch_verify_real_ckpt")
    npz, pt = ckpt
    common = ["--data_dir", cases, "--cfg", "tiny64_test", "--device", "cpu"]
    rc, free, out = run(tool, [npz, *common, "--out_dir", str(tmp_path / "a")], capsys)
    assert rc == 0 and "PASS" not in out and "FAIL" not in out and free["cases"] == 3
    rows = open(free["csv"]).read().splitlines()
    assert rows[0].startswith("video,class") and [r.split(",")[:2] for r in rows if r.startswith("ALL,")] == [
        ["ALL", "1"], ["ALL", "2"]]
    rc, passed, out = run(tool, [npz, *common, "--out_dir", str(tmp_path / "b"), "--expect_dice", "0"], capsys)
    assert rc == 0 and "PASS: class-1 Dice" in out
    assert passed["global_means"] == free["global_means"]
    rc, _, out = run(tool, [npz, *common, "--out_dir", str(tmp_path / "c"), "--cases", "1", "--expect_dice",
                            "0.999"], capsys)
    assert rc == 1 and "FAIL: class-1 Dice" in out
    rc, from_pt, _ = run(tool, [pt, *common, "--out_dir", str(tmp_path / "d")], capsys)
    assert rc == 0 and from_pt["global_means"] == free["global_means"]


def test_refusals(cases, ckpt, tmp_path):
    tool = load("torch_verify_real_ckpt")
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    with pytest.raises(NotImplementedError, match="Orbax"):
        tool.main([str(orbax), "--data_dir", cases, "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        tool.main([str(tmp_path / "missing.pt"), "--data_dir", cases, "--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(SystemExit):
        tool.main([ckpt[0], "--data_dir", str(tmp_path / "no_cases"), "--device", "cpu"])
    from us_video_medsam2_tpu_torch.core.build import load_params
    from us_video_medsam2_tpu_torch.core.config import resolve_config

    with pytest.raises(NotImplementedError, match="Orbax"):
        load_params(resolve_config("tiny64_test"), str(orbax))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main([ckpt[0], "--data_dir", cases, "--cfg", "tiny64_test", "--out_dir", str(tmp_path / "o")])
