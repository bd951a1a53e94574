"""PyTorch port: chip_smoke.py's host reference runs (the card's fixed-plan
training steps' host steps, phases 7 and 11, and phase 8 (d)'s host run of
the editing sequence) in their child process (``HostRuns``) at
``tiny64_test``: each result the in-process run's bit for bit at the
child's thread count (the same seeded weights), the step's FLOPs counted
where asked; a child that fails is reported with its log."""

import numpy as np
import pytest
import torch

import chip_smoke

RUNS = (("step", "tiny64_test", None, True), ("step", "tiny64_test", ("gfte", 32, 3), False),
        ("editing", "tiny64_test", None, False))


@pytest.fixture
def host_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(chip_smoke.HOST_THREADS)
    yield
    torch.set_num_threads(n)


def test_child_host_runs_equal_the_in_process_runs(tmp_path, host_threads):
    runs = chip_smoke.HostRuns(str(tmp_path), RUNS)
    try:
        for kind, name, fusion, flops in RUNS:
            got, _ = runs.result(kind, name, fusion)
            if kind == "editing":
                host_sd, cfg = chip_smoke.seeded_predictor_weights(name)
                want = chip_smoke.host_editing_run(host_sd, cfg.image_size, name)
                assert got["ran"] == want["ran"] and list(got["frames"]) == list(want["frames"])
                assert all(g[0] == w[0] and np.array_equal(g[1], w[1])
                           for g, w in zip(got["frames"].values(), want["frames"].values()))
                continue
            want = chip_smoke.host_fixed_step(chip_smoke.seeded_train_model(fusion, name).state_dict(), fusion,
                                              name, flops)
            assert got["core_loss"] == want["core_loss"]
            assert got["grads"].keys() == want["grads"].keys()
            assert all(torch.equal(got["grads"][k], want["grads"][k]) for k in want["grads"])
            assert (got["flops"] is not None) == flops and got["flops"] == want["flops"]
            assert any(n.startswith("temporal_fusion") for n in got["grads"]) == (fusion is not None)
    finally:
        runs.stop()
    assert runs.proc.returncode == 0


def test_a_failed_child_raises_with_its_log(tmp_path):
    runs = chip_smoke.HostRuns(str(tmp_path), (("step", "no_such_preset", None, False),))
    with pytest.raises(AssertionError, match="no_such_preset"):
        runs.result("step", "no_such_preset")
