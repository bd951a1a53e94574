"""PyTorch port: chip_smoke.py's phase 10 (the training entry point) on the
CPU at ``tiny64_test`` and a small corpus, as
tests/test_torch_smoke_entry_points.py runs phase 9: ``apps/train.py``'s
``main`` for two epochs, resumed to a third (the step, the best, the
parameters and moments restored bit for bit, epoch 2's batches equal to a
fresh loader's), ``checkpoint.npz`` served against the trainer's final
weights bit for bit, a GFTE epoch with its buffers kept, one epoch in a
one-rank gloo group, and the native NPZ reader against numpy. The card's own
gates (launch counts, peak memory) are the card's and are not run here."""

import os

import numpy as np

import chip_smoke

SMALL = dict(FRAMES=4)


def test_phase_10_on_cpu(tmp_path, monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(chip_smoke, k, v)
    monkeypatch.delenv("UVMS2_NATIVE_NPZ", raising=False)
    chip_smoke.run_training_entry("cpu", str(tmp_path), name="tiny64_test", device="cpu", hw=(60, 80), frames=6)
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".pt"]  # the checkpoint is removed after its use
    for run in ("run", "run_gfte", "run_rank"):
        assert (tmp_path / run / "checkpoint.npz").exists()
    assert "UVMS2_NATIVE_NPZ" not in os.environ and "RANK" not in os.environ


def test_train_corpus(tmp_path):
    ent = chip_smoke.write_train_corpus(str(tmp_path), (60, 80), 6)
    assert len(ent) == chip_smoke.TE_VIDEOS
    assert sum(e < 2.5 for e in ent.values()) == chip_smoke.TE_VIDEOS - 1
    v = np.load(tmp_path / "video_2.npz")
    assert v["imgs"].shape == (6, 60, 80) and v["imgs"].dtype == np.uint8
    assert set(np.unique(v["gts"][0])) == {0, 1, 2, 3}
