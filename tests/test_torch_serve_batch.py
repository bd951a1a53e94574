"""PyTorch port: batched multi-video serving (inference/serve.py) on the CPU
at the MINI config (fixture weights).

1. Against the JAX ``batched_propagate`` at N 2, T 3, with ``fill_hole_area``
   0 and 8: low-res logits at ``assert_masks_close``'s tolerances (rtol and
   atol 1e-3, every mask at IoU > 0.999).
2. Each video against the port's interactive predictor (the JAX test's
   check, tests/test_serve_batch.py:40-71): the batched low-res logits
   upsampled to the video against the interactive masks over 9 frames,
   IoU > 0.99 and within 1e-5, hole filling off and on (on, the prompted frame is filled
   as in JAX's serving; the predictor yields it unfilled).
3. The predictor's own frame body unchanged: a one-frame buffer's features
   expanded to the object rows, bit for bit against the body written out
   by hand, and a buffer of a frame a row giving each row its own.
"""

import numpy as np
import pytest
import torch

from tests.test_parity import MINI
from tests.torch_port_helpers import assert_masks_close, iou, mini_jax_predictor, mini_port_predictor
from us_video_medsam2_tpu.inference.serve import batched_propagate as jax_batched_propagate
from us_video_medsam2_tpu_torch.inference import graphs
from us_video_medsam2_tpu_torch.inference.serve import batched_propagate, serve_graph_key, serve_graphs
from us_video_medsam2_tpu_torch.ops.connected_components import fill_holes_in_mask_scores
from us_video_medsam2_tpu_torch.ops.resize import resize2d

SIZE = MINI.image_size
POINTS = np.array([[[120.0, 100.0]], [[116.0, 105.0]]], np.float32)
LABELS = np.ones((2, 1), np.int32)


def _videos(n, t, size=SIZE):
    rng = np.random.default_rng(0)
    vids = rng.standard_normal((n, t, size, size, 3)).astype(np.float32)
    for i in range(n):
        yy, xx = np.mgrid[0:size, 0:size]
        blob = ((yy - 100 - 5 * i) ** 2 + (xx - 120 + 4 * i) ** 2) < 40**2
        vids[i, :, blob] += 3.0
    return vids


@pytest.mark.parametrize("fill_hole_area", [0, 8])
def test_batched_matches_jax(fill_hole_area):
    vids = _videos(2, 3)
    got = batched_propagate(mini_port_predictor(fill_hole_area=fill_hole_area), vids, POINTS, LABELS)
    want = np.asarray(jax_batched_propagate(mini_jax_predictor(fill_hole_area=fill_hole_area), vids, POINTS,
                                            LABELS))
    assert got.shape == want.shape == (2, 3, 4 * MINI.feat_size, 4 * MINI.feat_size)
    assert got.dtype == torch.float32
    # per video, the frames as [T, 1, h, w] (one object row each)
    for i in range(2):
        assert_masks_close({f: got[i, f][None].numpy() for f in range(3)},
                           {f: want[i, f][None] for f in range(3)}, f"video {i}")
    if fill_hole_area:
        assert (got.numpy() == np.float32(0.1)).any()  # a hole was filled


@pytest.mark.parametrize("fill_hole_area", [0, 8])
def test_batched_matches_interactive(fill_hole_area):
    """Per video as the interactive predictor, but for the prompted frame's
    holes: serving fills them over all N·T frames, as JAX's does, where the
    predictor yields a prompted frame's output as prompted."""
    pred = mini_port_predictor(fill_hole_area=fill_hole_area)
    t = 9  # past num_maskmem (7): the memory selection drops frames
    vids = _videos(2, t)
    lows = batched_propagate(pred, vids, POINTS, LABELS)
    pred.fill_hole_area = 0
    unfilled = batched_propagate(pred, vids[:, :1], POINTS, LABELS)[:, 0]
    pred.fill_hole_area = fill_hole_area
    np.testing.assert_array_equal(lows[:, 0].numpy(), fill_holes_in_mask_scores(unfilled, fill_hole_area).numpy())
    for i in range(2):
        state = pred.init_state(vids[i], SIZE, SIZE, 1)
        pred.add_new_points_or_box(state, 0, 1, points=POINTS[i], labels=LABELS[i], normalize_coords=False)
        got = {f: m[0, 0] for f, _, m in pred.propagate_in_video(state)}
        assert sorted(got) == list(range(t))
        for f in range(t):
            low = unfilled[i] if f == 0 else lows[i, f]
            up = resize2d(low[None, ..., None], (SIZE, SIZE))[0, ..., 0].numpy()
            assert iou(up, got[f]) > 0.99, (i, f)
            np.testing.assert_allclose(up, got[f], rtol=1e-5, atol=1e-6 * np.abs(got[f]).max())


def test_uint8_videos_and_the_graph_key():
    """uint8 frames at another size are normalized and resized as the
    interactive predictor's init_state does it; the key of a batched body."""
    pred = mini_port_predictor(fill_hole_area=0)
    rng = np.random.default_rng(1)
    raw = (rng.random((2, 2, 100, 90, 3)) * 255).astype(np.uint8)
    lows = batched_propagate(pred, raw, POINTS, LABELS)
    from us_video_medsam2_tpu_torch.inference.transforms import prep_frames

    frames = prep_frames(torch.from_numpy(raw.reshape(4, 100, 90, 3)), SIZE).reshape(2, 2, SIZE, SIZE, 3)
    np.testing.assert_array_equal(lows.numpy(), batched_propagate(pred, frames, POINTS, LABELS).numpy())
    assert serve_graph_key(pred, 2, 2) == (2, 2, False, False, torch.float32, torch.bfloat16)
    assert serve_graphs(pred).captures == 0 and not pred.use_graphs  # the CPU runs the body eagerly


def _frame_bufs(pred, objects, per_row):
    bank = pred._new_bank(objects, 3)
    return graphs.make_buffers(pred.model, bank, False, new_bank=False, per_row_frames=per_row)


def test_predictor_body_unchanged():
    pred = mini_port_predictor(fill_hole_area=0)
    model = pred.model
    vids = _videos(2, 2)
    bufs = _frame_bufs(pred, 2, per_row=False)
    assert bufs.frame.shape == (1, SIZE, SIZE, 3)
    bufs.frame.copy_(torch.from_numpy(vids[0, 1:2]))
    bufs.t.fill_(1)
    bufs.num_frames.fill_(2)
    with torch.inference_mode():
        graphs.frame_body(model, bufs, bufs.num_frames, False, 1)
        # the body as the predictor ran it before batched serving: one
        # frame's features expanded to the object rows
        ref = _frame_bufs(pred, 2, per_row=False)
        feats = graphs.encode_frames(model, torch.from_numpy(vids[0, 1:2]))
        feats = {k: v.expand(2, -1, -1, -1) for k, v in feats.items()}
        out, _ = model.track_step(ref.t.fill_(1), feats, ref.bank, ref.num_frames.fill_(2), multimask_output=True,
                                  max_cond_slots=1)
    np.testing.assert_array_equal(bufs.lows[1].numpy(), out["low_res_masks"][:, 0].float().numpy())
    np.testing.assert_array_equal(bufs.bank.maskmem.float().numpy(), ref.bank.maskmem.float().numpy())
    # a frame a row: each row keeps its own features
    rows = _frame_bufs(pred, 2, per_row=True)
    assert rows.frame.shape == (2, SIZE, SIZE, 3)
    rows.frame.copy_(torch.from_numpy(vids[:, 1]))
    rows.t.fill_(1)
    rows.num_frames.fill_(2)
    with torch.inference_mode():
        graphs.frame_body(model, rows, rows.num_frames, False, 1)
    np.testing.assert_allclose(rows.lows[1, 0].numpy(), bufs.lows[1, 0].numpy(), rtol=1e-4, atol=1e-5)
    assert np.abs(rows.lows[1, 1].numpy() - rows.lows[1, 0].numpy()).max() > 1e-4
