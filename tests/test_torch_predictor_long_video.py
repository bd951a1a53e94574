"""PyTorch port: the predictor's long-video options against the JAX predictor on the CPU.

Counterparts of tests/test_video_predictor.py's long-video tests, at MINI with
the fixture weights through both importers and the fixture's 5-frame video:
each port session is held against the JAX predictor's session with JAX's own
tolerances (logits rtol / atol 1e-3, mask IoU > 0.999), and against the port's
own exact session where the JAX test holds JAX against itself.

1. ``chunk_size`` streaming against the whole window (bit for bit in the port);
   ``max_frame_num_to_track`` bounding the yields and the bank, whole window
   and streamed.
2. ``t_bucket="auto"`` (16 slots for 5 frames) against the exact session.
3. ``offload_video_to_host``: a float32 host store, and a uint8 video at
   model resolution kept as its raw bytes, against the device-resident
   session.
4. Program sharing: lengths 5 and 9 with offload (bucket 16) make one graph
   key, length 20 a second (bucket 32), through ``FrameGraphs`` with a capture
   stub whose replay runs the body; the replayed frames equal the eager ones.
5. ``select_memories`` with the video's length as a 0-d tensor against the
   JAX function with a traced length under ``jax.jit``, on banks with more
   slots than frames.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import require_fixture
from tests.test_parity import MINI
from tests.torch_port_helpers import (
    assert_masks_close,
    iou,
    mini_jax_predictor,
    mini_port_predictor,
    nchw_to_nhwc,
    port_config,
    t,
)
from us_video_medsam2_tpu.models import memory_bank as jbank
from us_video_medsam2_tpu_torch.inference import graphs
from us_video_medsam2_tpu_torch.inference.video_predictor import round_bucket
from us_video_medsam2_tpu_torch.models import memory_bank as tbank

SEL_FIELDS = ("mem_idx", "mem_valid", "mem_tpos", "ptr_idx", "ptr_valid", "ptr_pos")


@pytest.fixture(scope="module")
def fx():
    return np.load(require_fixture("predictor_video.npz"))


@pytest.fixture(scope="module")
def images(fx):
    return nchw_to_nhwc(fx["images"])  # [5, 256, 256, 3]


def _prompt_two(pred, state, fx):
    pred.add_new_mask(state, 1, 1, fx["mask_prompt"])
    _, _, pm = pred.add_new_points_or_box(state, 1, 2, points=np.array([[30.0, 150.0]]), labels=np.array([1]))
    return np.asarray(pm)


def _session(pred, fx, images, chunk=None, **init_kw):
    """Two objects prompted on frame 1, forward then reverse: (state, prompt
    masks, {t: fwd masks}, {t: rev masks})."""
    state = pred.init_state(images, 200, 180, max_objects=2, **init_kw)
    pm = _prompt_two(pred, state, fx)
    fwd = {f: np.asarray(m) for f, _, m in pred.propagate_in_video(state, chunk_size=chunk)}
    rev = {f: np.asarray(m) for f, _, m in pred.propagate_in_video(state, reverse=True, chunk_size=chunk)}
    return state, pm, fwd, rev


@pytest.fixture(scope="module")
def jax_pred():
    return mini_jax_predictor(fill_hole_area=0)


@pytest.fixture(scope="module")
def jax_ref(jax_pred, fx, images):
    return _session(jax_pred, fx, images)


@pytest.fixture(scope="module")
def port_ref(fx, images):
    return _session(mini_port_predictor(fill_hole_area=0), fx, images)


def _equal(a: dict, b: dict):
    assert list(a) == list(b)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=str(f))


def test_exact_session_matches_jax(jax_ref, port_ref):
    _, pm_j, fwd_j, rev_j = jax_ref
    state, pm, fwd, rev = port_ref
    np.testing.assert_allclose(pm, pm_j, rtol=1e-4, atol=1e-4)
    assert list(fwd) == [1, 2, 3, 4] and list(rev) == [1, 0]
    assert_masks_close(fwd, fwd_j, "fwd")
    assert_masks_close(rev, rev_j, "rev")
    assert state.bucket == state.num_frames == state.bank.valid.shape[1] == 5
    assert state.frames_tracked == {0: {"reverse": True}, 2: {"reverse": False}, 3: {"reverse": False},
                                    4: {"reverse": False}}


def test_chunked_streaming_matches_full_scan(fx, images, jax_ref, port_ref):
    """chunk_size=2: the same bits as the whole window in the port, and the
    JAX session's masks."""
    _, _, fwd_j, rev_j = jax_ref
    _, _, fwd, rev = port_ref
    _, _, fwd_c, rev_c = _session(mini_port_predictor(fill_hole_area=0), fx, images, chunk=2)
    _equal(fwd_c, fwd)
    _equal(rev_c, rev)
    assert_masks_close(fwd_c, fwd_j, "fwd")
    assert_masks_close(rev_c, rev_j, "rev")


def test_chunks_are_yielded_before_the_next_chunk_runs(fx, images, monkeypatch):
    """Streaming: each chunk's frames come out before the next chunk's window."""
    pred = mini_port_predictor(fill_hole_area=0)
    state = pred.init_state(images, 200, 180, max_objects=2)
    _prompt_two(pred, state, fx)
    log = []
    run = pred._run_window

    def logged(state, steps, *a, **k):
        log.append(("window", [f for f, r in steps if r]))
        return run(state, steps, *a, **k)

    monkeypatch.setattr(pred, "_run_window", logged)
    for f, _, _ in pred.propagate_in_video(state, chunk_size=2):
        log.append(("yield", f))
    assert log == [("window", [2]), ("yield", 1), ("yield", 2), ("window", [3, 4]), ("yield", 3), ("yield", 4)]


def test_max_frame_num_to_track_bounds_tracking_and_bank(fx, images, jax_pred):
    """Frames past the window neither yielded nor tracked into the bank, in
    the whole window and streamed; the JAX predictor's yields and masks."""
    jstate = jax_pred.init_state(images, 200, 180, max_objects=2)
    jax_pred.add_new_mask(jstate, 1, 1, fx["mask_prompt"])
    want = {f: np.asarray(m) for f, _, m in jax_pred.propagate_in_video(jstate, max_frame_num_to_track=2)}
    pred = mini_port_predictor(fill_hole_area=0)
    for chunk in (None, 2):
        state = pred.init_state(images, 200, 180, max_objects=2)
        pred.add_new_mask(state, 1, 1, fx["mask_prompt"])
        got = {f: m for f, _, m in pred.propagate_in_video(state, max_frame_num_to_track=2, chunk_size=chunk)}
        assert list(got) == [1, 2, 3], chunk
        valid = state.bank.valid[0].numpy()
        assert not valid[4] and valid[1:4].all(), chunk
        np.testing.assert_array_equal(valid, np.asarray(jstate.bank.valid[0]))
        assert_masks_close(got, want, f"chunk {chunk}")


def test_bucketed_session_matches_exact(fx, images, jax_ref, port_ref):
    """t_bucket="auto": 16 slots for 5 frames; the exact session's masks and
    the JAX session's."""
    _, pm_e, fwd_e, rev_e = port_ref
    _, _, fwd_j, rev_j = jax_ref
    s_b, pm_b, fwd_b, rev_b = _session(mini_port_predictor(fill_hole_area=0), fx, images, t_bucket="auto")
    assert s_b.bank.valid.shape[1] == s_b.bucket == 16 and s_b.num_frames == 5
    np.testing.assert_allclose(pm_b, pm_e, rtol=1e-4, atol=1e-4)
    assert_masks_close(fwd_b, fwd_e, "fwd vs exact")
    assert_masks_close(rev_b, rev_e, "rev vs exact")
    assert_masks_close(fwd_b, fwd_j, "fwd vs JAX")
    assert_masks_close(rev_b, rev_j, "rev vs JAX")


@pytest.mark.parametrize("t_bucket, want", [(None, 37), ("auto", 64), (40, 40), (1000, 1000)])
def test_bucket_rule(t_bucket, want):
    """"auto" rounds up to a power of two, at least 16 (JAX ``_round_bucket``);
    an int pins the bucket; a bucket below the length raises."""
    pred = mini_port_predictor()
    video = np.zeros((37, 256, 256, 3), np.float32)
    state = pred.init_state(video, 8, 8, t_bucket=t_bucket)
    assert state.bucket == state.bank.valid.shape[1] == want and state.num_frames == 37
    assert [round_bucket(n) for n in (1, 16, 17, 37, 64, 65, 1000)] == [16, 16, 32, 64, 64, 128, 1024]
    with pytest.raises(ValueError, match="t_bucket"):
        pred.init_state(video, 8, 8, t_bucket=20)


def test_offloaded_session_matches_device(fx, images, jax_ref, port_ref):
    """A float32 host store fed a chunk at a time: the device-resident
    session's masks and the JAX session's."""
    _, pm_d, fwd_d, rev_d = port_ref
    _, _, fwd_j, rev_j = jax_ref
    pred = mini_port_predictor(fill_hole_area=0)
    state = pred.init_state(images, 200, 180, max_objects=2, offload_video_to_host=True, io_chunk=4,
                            host_dtype=np.float32)
    assert state.images is None and state.images_host.shape == images.shape
    assert state.images_host.dtype == np.float32 and state.bank.valid.shape[1] == 16  # offload implies "auto"
    pm = _prompt_two(pred, state, fx)
    np.testing.assert_allclose(pm, pm_d, rtol=1e-4, atol=1e-4)
    fwd = {f: m for f, _, m in pred.propagate_in_video(state, chunk_size=2)}
    rev = {f: m for f, _, m in pred.propagate_in_video(state, reverse=True, chunk_size=2)}
    assert_masks_close(fwd, fwd_d, "fwd vs resident")
    assert_masks_close(rev, rev_d, "rev vs resident")
    assert_masks_close(fwd, fwd_j, "fwd vs JAX")
    assert_masks_close(rev, rev_j, "rev vs JAX")


def test_offloaded_float16_store_is_the_video_rounded(images):
    pred = mini_port_predictor()
    state = pred.init_state(images, 200, 180, offload_video_to_host=True, io_chunk=2)
    assert state.images_host.dtype == np.float16
    np.testing.assert_array_equal(state.images_host, images.astype(np.float16))


@pytest.fixture(scope="module")
def bright_square_video():
    rng = np.random.default_rng(7)
    video = rng.integers(0, 255, (5, 256, 256, 3), np.uint8)
    video[:, 60:140, 80:160] = 240  # a bright square to track
    return video


def test_offloaded_uint8_store_matches_device(bright_square_video, jax_pred):
    """A uint8 video at model resolution offloads as its raw bytes, normalized
    on the device a frame at a time: the device-resident session's masks (the
    same bits: both normalize elementwise) and the JAX session's."""
    video = bright_square_video

    def session(pred, chunk, **kw):
        state = pred.init_state(video, 200, 180, max_objects=1, **kw)
        pred.add_new_points_or_box(state, 0, 1, points=np.array([[120.0, 100.0]]), labels=np.array([1]))
        return state, {f: np.asarray(m) for f, _, m in pred.propagate_in_video(state, chunk_size=chunk)}

    _, want = session(jax_pred, None)
    pred = mini_port_predictor(fill_hole_area=0)
    _, dev = session(pred, 2)
    s_off, off = session(pred, 2, offload_video_to_host=True)
    assert s_off.images_host.dtype == np.uint8 and s_off.images_host.shape == video.shape  # raw store
    assert list(off) == [0, 1, 2, 3, 4]
    _equal(off, dev)
    assert_masks_close(off, want, "offloaded vs JAX")
    assert_masks_close(dev, want, "resident vs JAX")
    assert iou(off[4][0], off[0][0]) > 0.1  # the square is tracked, not lost


class _Replay:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def _stub_captures(monkeypatch):
    """A capture that keeps the body; a replay runs it eagerly."""
    def capture(self, body):
        self.graph = _Replay(body)

    monkeypatch.setattr(graphs.FrameGraph, "warm_up_and_capture", capture)


def test_long_video_program_sharing(fx, images, monkeypatch):
    """Lengths 5 and 9 offloaded (bucket 16) share one graph key, length 20
    (bucket 32) adds a second; every frame is yielded in order, with the bits
    of the eager body."""
    _stub_captures(monkeypatch)
    gpred = mini_port_predictor(fill_hole_area=0)
    gpred.use_graphs = True
    epred = mini_port_predictor(fill_hole_area=0)

    def run(pred, nf):
        video = np.concatenate([images] * ((nf + 4) // 5))[:nf]
        state = pred.init_state(video, 200, 180, max_objects=1, offload_video_to_host=True, io_chunk=4)
        pred.add_new_mask(state, 0, 1, fx["mask_prompt"])
        out = {f: m for f, _, m in pred.propagate_in_video(state, chunk_size=4)}
        assert list(out) == list(range(nf)), (nf, list(out))
        return state, out

    captures, keys = [], []
    for nf in (5, 9, 20):
        state, got = run(gpred, nf)
        captures.append(gpred.graphs.captures)
        keys.append(next(reversed(gpred.graphs.entries)))
        _, want = run(epred, nf)
        _equal(got, want)
        assert state.bucket == (16 if nf < 20 else 32)
    assert captures == [1, 1, 2]
    assert keys[0] == keys[1] != keys[2] and keys[0][0] == 16 and keys[2][0] == 32
    assert keys[0][5] == torch.float16  # the host store's dtype is the frame buffer's


@pytest.mark.parametrize("nf, slots", [(5, 16), (9, 16), (20, 32), (16, 16)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_select_memories_tensor_num_frames_matches_traced_jax(reverse, stride, nf, slots):
    """The length as a 0-d tensor against JAX's traced length under jax.jit,
    at every frame of the video, on a bank with ``slots`` slots."""
    rng = np.random.default_rng(100 * nf + 10 * stride + reverse)
    valid = np.zeros((2, slots), bool)
    valid[:, :nf] = rng.random((2, nf)) > 0.3
    is_cond = valid & (rng.random((2, slots)) > 0.7)
    tb = tbank.init_memory_bank(2, slots, 4, 8, 16)
    tb.valid[:] = t(valid)
    tb.is_cond[:] = t(is_cond)
    jb = jbank.init_memory_bank(2, slots, 4, 8, 16).replace(valid=jnp.asarray(valid), is_cond=jnp.asarray(is_cond))
    jcfg = dataclasses.replace(MINI, memory_temporal_stride_for_eval=stride)
    pcfg = port_config(jcfg)
    jsel = jax.jit(lambda f, n: jbank.select_memories(jb, f, jcfg, n, reverse))
    n_t = torch.tensor(nf)
    for frame in range(nf):
        got = tbank.select_memories(tb, torch.tensor(frame), pcfg, n_t, reverse)
        want = jsel(jnp.int32(frame), jnp.int32(nf))
        k = min(MINI.max_cond_frame_slots, slots)
        assert got.ptr_idx.shape[1] == want.ptr_idx.shape[1] == k + MINI.max_obj_ptrs_in_encoder - 1
        for f in SEL_FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f"{f} at t {frame}")
        assert got.t_diff_max.dtype == torch.float32
        np.testing.assert_array_equal(got.t_diff_max.numpy(), np.asarray(want.t_diff_max))


@pytest.mark.parametrize("nf", [5, 16, 20])
def test_select_memories_int_and_tensor_num_frames_agree_on_the_valid_slots(nf):
    """The int length (pointer slots min(nf, 16)) and the tensor length (16
    slots, those past the video masked) select the same valid pointers with
    the same positions and normalizer."""
    rng = np.random.default_rng(nf)
    bank = tbank.init_memory_bank(1, nf, 4, 8, 16)
    bank.valid[:] = torch.from_numpy(rng.random((1, nf)) > 0.2)
    bank.is_cond[:] = bank.valid & torch.from_numpy(rng.random((1, nf)) > 0.8)
    cfg = port_config(MINI)
    for frame in range(nf):
        a = tbank.select_memories(bank, frame, cfg, nf)
        b = tbank.select_memories(bank, frame, cfg, torch.tensor(nf))
        p = a.ptr_idx.shape[1]
        assert torch.equal(a.ptr_valid, b.ptr_valid[:, :p]) and not b.ptr_valid[:, p:].any()
        assert torch.equal(a.ptr_idx, b.ptr_idx[:, :p]) and torch.equal(a.ptr_pos, b.ptr_pos[:, :p])
        assert float(b.t_diff_max) == a.t_diff_max
        for f in ("mem_idx", "mem_valid", "mem_tpos"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
