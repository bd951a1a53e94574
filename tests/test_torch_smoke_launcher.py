"""PyTorch port: chip_smoke.py's phase 14 (f) on the CPU at ``tiny64_test``
(the other parts: tests/test_torch_smoke_surfaces.py): the training
launcher under a real torchrun (one process, ``--device cpu``) on a seeded
corpus, with the step hook in the trainer's process, and its checkpoint
served."""

import json

import pytest
import torch

import chip_smoke
from tests.test_torch_smoke_surfaces import seeded_weights, small  # noqa: F401 (small: a fixture)


@pytest.mark.parametrize("part", ["f"])
def test_phase_14_on_cpu(part, tmp_path, small):  # noqa: F811 (the fixture)
    _, host_sd = seeded_weights()
    corpus = str(tmp_path / "corpus")
    chip_smoke.write_train_corpus(corpus, (60, 80), 6)
    chip_smoke.run_surfaces("cpu", str(tmp_path / "surfaces"), {"host_sd": host_sd}, corpus, name="tiny64_test",
                            device="cpu", parts=part)
    surfaces = tmp_path / "surfaces"
    steps = json.loads((surfaces / "launcher" / "steps.json").read_text())
    assert steps and all(set(s["launches"].values()) == {0} for s in steps)  # the host's plain versions
    assert (surfaces / "launcher" / "run" / "checkpoint.npz").exists()
    assert not list(surfaces.rglob("*.pt"))  # each checkpoint removed after its use
    assert not torch.distributed.is_initialized()
