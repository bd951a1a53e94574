"""The frozen reference held against the port at tiny64_test on the CPU.

Both run in float32 from one state dict: the port's plain versions stand in
for its kernels on the CPU, so the two compute one function and agree to
float32 rounding. The reference's own departures (float32 bank, valid keys
only) change nothing beyond that.
"""

import numpy as np
import pytest
import torch

from perfbench import common
from perfbench.frozen.video import make_videos
from perfbench.reference import propagate as ref
from perfbench.tests.conftest import tiny_model

def gap(p, r, reduce=max):
    """The largest (or with ``reduce``, another) frame's rms gap relative to its rms logit."""
    n = common.frame_norms(p, r).reshape(-1, 2)
    return float(reduce(n[:, 0] / n[:, 1]))


TOL = 1e-4  # float32 rounding along 5 tracked frames of the tiny model


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    cfg = {"model": tiny_model(), "dtype": "float32", "fill_hole_area": 8}
    sd = common.state_dict(cfg, 123, "cpu")
    videos, clicks = make_videos([11, 12], 5, 64, "cpu")
    pred = common.program(cfg, sd, "cpu")
    pred.bank_dtype = torch.float32
    return cfg, sd, videos, clicks, pred


def test_serving_matches_the_port(setup):
    from us_video_medsam2_tpu_torch.inference.serve import batched_propagate

    cfg, sd, videos, clicks, pred = setup
    got = batched_propagate(pred, videos, clicks[:, None], np.ones((2, 1), np.int32))
    model = ref.build_model(cfg["model"], sd, "cpu")
    want = ref.propagate(model, videos, torch.as_tensor(clicks[:, None]), torch.ones(2, 1, dtype=torch.int32),
                         fill_hole_area=8, fill_first=True)
    assert gap(got, want) < TOL


def test_interactive_matches_the_port(setup):
    cfg, sd, videos, clicks, pred = setup
    state = pred.init_state(videos[1], 64, 64, t_bucket=16)
    pred.add_new_points_or_box(state, 0, 1, points=clicks[1][None], labels=np.array([1], np.int32))
    got = torch.as_tensor(np.stack([m[0, 0] for _, _, m in pred.propagate_in_video(state)]))
    model = ref.build_model(cfg["model"], sd, "cpu")
    want = ref.propagate(model, videos[1:2], torch.as_tensor(clicks[1][None, None]),
                         torch.ones(1, 1, dtype=torch.int32), fill_hole_area=8, fill_first=False, video_hw=(64, 64))
    assert gap(got, want[0]) < TOL


def test_the_reference_sees_the_prompt(setup):
    """Another click gives other masks: the comparison is not of constants."""
    cfg, sd, videos, clicks, _ = setup
    model = ref.build_model(cfg["model"], sd, "cpu")
    kw = dict(labels=torch.ones(1, 1, dtype=torch.int32), fill_hole_area=8, fill_first=True)
    a = ref.propagate(model, videos[:1], torch.as_tensor(clicks[:1, None]), **kw)
    b = ref.propagate(model, videos[:1], torch.as_tensor(clicks[:1, None]) * 0 + 5.0, **kw)
    assert gap(a, b, min) > 1e-3
