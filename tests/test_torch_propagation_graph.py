"""PyTorch port: the predictor's one-program propagation on the CPU.

The JAX predictor runs its tracking window as one ``lax.scan`` with a traced
frame index; the port runs ``inference/graphs.py::frame_body`` once a frame
with the index as a 0-d tensor (a CUDA graph replay on the card, the same
body eagerly here).

1. ``select_memories`` with ``frame_idx`` a 0-d long tensor against the JAX
   function under ``jax.jit`` with a traced int32 index: every t of the bank,
   forward and reverse, strides 1-3, two conditioning-slot counts, on a bank
   with seeded valid and conditioning rows. Indices and masks exactly equal,
   and the int index gives the same bits as the tensor.
2. The predictor with ``precompute_features_batch`` 0 and 3, forward and
   reverse, two objects, hole filling on, against the JAX predictor with the
   same setting (the tolerance of test_torch_predictor.py's JAX test).
3. One hole-filling pass over [F, O, h, w] against the per-frame pass, bit
   for bit; the windowed count row by row against the whole-window unfold;
   the predictor's emission in chunks of 2 frames against one chunk.
4. The card's buffer flow (a bank of the graph's own, the state's bank copied
   in before the window and out after) against the state's bank used in place.
5. The launch counters of a captured body: captured counts taken back off at
   capture and added at every replay, with a fake graph; the kernels'
   registry. The graphs kept: at most MAX_GRAPHS, the last used, and all
   dropped when a weight changes (in place, a new tensor, a cast).
6. The ViTDet pos-embed table kept when no gradient is wanted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import require_fixture
from tests.test_parity import MINI
from tests.torch_port_helpers import mini_port_model, mini_weights, nchw_to_nhwc, port_config, t
from us_video_medsam2_tpu.inference.video_predictor import SAM2VideoPredictor as JaxPredictor
from us_video_medsam2_tpu.models import memory_bank as jbank
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu_torch.core.build import build_sam2
from us_video_medsam2_tpu_torch.core.config import ViTDetConfig
import torch.nn.functional as F

from us_video_medsam2_tpu_torch.inference import graphs
from us_video_medsam2_tpu_torch.inference import video_predictor as tvp
from us_video_medsam2_tpu_torch.inference.video_predictor import SAM2VideoPredictor
from us_video_medsam2_tpu_torch.kernels import _lib, flash_attention, layer_norm, window_attention
from us_video_medsam2_tpu_torch.models import memory_bank as tbank
from us_video_medsam2_tpu_torch.models.vitdet import ViTDet
from us_video_medsam2_tpu_torch.ops.connected_components import fill_holes_in_mask_scores, small_component_mask
from us_video_medsam2_tpu_torch.ops.resize import resize2d

SEL_FIELDS = ("mem_idx", "mem_valid", "mem_tpos", "ptr_idx", "ptr_valid", "ptr_pos")


# ------------------------------------------------------------ select_memories
@pytest.mark.parametrize("mcs", [None, 2])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("reverse", [False, True])
def test_select_memories_tensor_index_matches_traced_jax(reverse, stride, mcs):
    rng = np.random.default_rng(10 * stride + reverse)
    s = 20
    valid = rng.random((2, s)) > 0.3
    is_cond = valid & (rng.random((2, s)) > 0.7)
    tb = tbank.init_memory_bank(2, s, 4, 8, 16)
    tb.valid[:] = t(valid)
    tb.is_cond[:] = t(is_cond)
    jb = jbank.init_memory_bank(2, s, 4, 8, 16).replace(valid=jnp.asarray(valid), is_cond=jnp.asarray(is_cond))
    jcfg = dataclasses.replace(MINI, memory_temporal_stride_for_eval=stride)
    pcfg = port_config(jcfg)
    jsel = jax.jit(lambda f: jbank.select_memories(jb, f, jcfg, s, reverse, max_cond_slots=mcs))
    for frame in range(s):
        got = tbank.select_memories(tb, torch.tensor(frame), pcfg, s, reverse, mcs)
        want = jsel(jnp.int32(frame))
        by_int = tbank.select_memories(tb, frame, pcfg, s, reverse, mcs)
        for f in SEL_FIELDS:
            g = getattr(got, f)
            np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)), err_msg=f"{f} at t {frame}")
            assert torch.equal(g, getattr(by_int, f)) and g.dtype == getattr(by_int, f).dtype, (f, frame)
        assert got.t_diff_max == want.t_diff_max == by_int.t_diff_max


def test_write_memory_tensor_index_matches_int_index():
    rng = np.random.default_rng(3)
    banks = [tbank.init_memory_bank(2, 6, 4, 8, 16, dtype=torch.bfloat16, ptr_dtype=torch.float32)
             for _ in range(2)]
    for i, frame in enumerate((4, 0, 5, 4)):
        mem = t(rng.standard_normal((2, 4, 8)).astype(np.float32))
        ptr = t(rng.standard_normal((2, 16)).astype(np.float32))
        tbank.write_memory(banks[0], frame, mem, ptr, i % 2 == 0)
        tbank.write_memory(banks[1], torch.tensor(frame), mem, ptr, i % 2 == 0)
    for a, b in zip(graphs.bank_tensors(banks[0]), graphs.bank_tensors(banks[1])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert banks[0].valid[:, [0, 4, 5]].all() and not banks[0].valid[:, [1, 2, 3]].any()
    assert not banks[0].is_cond[:, [0, 4]].any() and banks[0].is_cond[:, 5].all()


# ------------------------------------------------------------------ predictor
def _iou(a, b):
    a, b = a > 0, b > 0
    union = (a | b).sum()
    return 1.0 if union == 0 else (a & b).sum() / union


@pytest.fixture(scope="module")
def fx():
    return np.load(require_fixture("predictor_video.npz"))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("precompute", [0, 3])
def test_predictor_matches_jax_predictor(fx, precompute, reverse):
    """Five frames, a mask prompt and a click for two objects on the first
    frame (the last in reverse), hole filling on; the video resolution is the
    low-res mask size, so the yielded logits are the filled low-res logits.
    With precompute 3 the five frames are encoded in batches of 3 and 2."""
    images = nchw_to_nhwc(fx["images"])
    nf = images.shape[0]
    low = 4 * MINI.feat_size
    prompt_t = nf - 1 if reverse else 0
    params, _ = mini_weights()
    jpred = JaxPredictor(JaxSAM2Model(MINI), params, fill_hole_area=8, precompute_features_batch=precompute)
    tpred = SAM2VideoPredictor(mini_port_model(), fill_hole_area=8, device="cpu",
                               precompute_features_batch=precompute)
    results = []
    for pred, imgs, mask in ((jpred, jnp.asarray(images), jnp.asarray(fx["mask_prompt"])),
                             (tpred, images, fx["mask_prompt"])):
        state = pred.init_state(imgs, low, low, max_objects=2)
        pred.add_new_mask(state, prompt_t, 1, mask)
        pred.add_new_points_or_box(state, prompt_t, 2, points=np.array([[8.0, 40.0]]), labels=np.array([1]))
        results.append([(f, np.asarray(m)) for f, _, m in pred.propagate_in_video(state, reverse=reverse)])
    jframes, tframes = results
    order = list(range(nf))[::-1] if reverse else list(range(nf))
    assert [f for f, _ in tframes] == [f for f, _ in jframes] == order
    for (f, got), (_, want) in zip(tframes, jframes):
        assert got.shape == want.shape == (2, 1, low, low)
        scale = np.abs(want).max()
        assert want.std() > 0.05 * scale, f
        for o in range(2):
            assert _iou(got[o], want[o]) > 0.99, (f, o)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * scale, err_msg=str(f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_feature_buffers_have_the_encoders_shapes_and_dtype(dtype):
    model = build_sam2("tiny64_test", seed=0).set_compute_dtype(dtype)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        feats = graphs.encode_frames(model, images)
        bank = tbank.init_memory_bank(1, 2, model.cfg.feat_size ** 2, model.cfg.mem_dim, model.cfg.hidden_dim)
        bufs = graphs.make_buffers(model, bank, precompute=True, new_bank=True)
    assert set(feats) == set(bufs.feats) == set(graphs.feature_shapes(model.cfg))
    for k, v in feats.items():
        assert v.dtype == bufs.feats[k].dtype == dtype and v.shape == bufs.feats[k].shape, k


# -------------------------------------------------------------- hole filling
@pytest.mark.parametrize("max_area", [1, 8])
def test_one_hole_filling_pass_equals_the_per_frame_pass(max_area):
    rng = np.random.default_rng(max_area)
    # blobs of foreground with background specks of 1-12 pixels inside them
    x = rng.standard_normal((5, 2, 48, 40)).astype(np.float32) + 2.0
    x[rng.random(x.shape) < 0.08] = -1.0
    x[:, :, 10:14, 10:13] = -3.0
    lows = torch.from_numpy(x)
    once = fill_holes_in_mask_scores(lows, max_area)
    per_frame = torch.stack([fill_holes_in_mask_scores(lows[f], max_area) for f in range(lows.shape[0])])
    assert torch.equal(once, per_frame)
    assert (once != lows).any()


def _small_components_whole_window(fg, max_area):
    """small_component_mask with its count over the whole [B, (2A+1)^2, H, W]
    window at once, by one unfold."""
    b, h, w = fg.shape
    a = max_area
    inf = float(2 ** 30)

    def pool_max(x):
        return F.max_pool2d(x[:, None], 3, stride=1, padding=1)[:, 0]

    idx = torch.arange(h * w, dtype=torch.float32).reshape(1, h, w).expand(b, h, w)
    labels = torch.where(fg, idx, torch.full_like(idx, inf))

    def neighbor_min(lab):
        return torch.where(fg, -pool_max(-torch.where(fg, lab, torch.full_like(lab, inf))), inf)

    for _ in range(a):
        labels = torch.minimum(labels, neighbor_min(labels))
    nmin = neighbor_min(labels)
    nmax = pool_max(torch.where(fg, labels, torch.full_like(labels, -1.0)))
    mixed = fg & ((nmin < labels) | ((nmax > labels) & (nmax < inf)))
    flood = mixed.float()
    for _ in range(a):
        flood = torch.maximum(pool_max(flood) * fg.float(), flood)
    padded = F.pad(torch.where(fg, labels, torch.full_like(labels, -2.0))[:, None], (a, a, a, a), value=-2.0)
    win = F.unfold(padded, 2 * a + 1).reshape(b, (2 * a + 1) ** 2, h, w)
    return fg & (flood == 0) & ((win == labels[:, None]).sum(1) <= max_area)


@pytest.mark.parametrize("max_area", [1, 3, 8])
def test_windowed_count_row_by_row_equals_the_whole_window(max_area):
    """The count runs one window row at a time (2A+1 bytes a pixel at once,
    not (2A+1)^2 floats); the mask is the whole window's, bit for bit, with
    isolated components of every area from 1 to 14 pixels planted."""
    rng = np.random.default_rng(40 + max_area)
    fg = torch.from_numpy(rng.random((6, 48, 36)) < 0.35)
    fg[:, 30:] = False
    for k in range(1, 15):  # a k-pixel bar, isolated
        fg[k % 6, 31 + 2 * (k // 6) * 3, 1: 1 + k] = True
    got = small_component_mask(fg, max_area)
    assert torch.equal(got, _small_components_whole_window(fg, max_area))
    assert got[:, 30:].any() and (fg & ~got).any()


def test_chunked_emission_equals_one_chunk(fx, monkeypatch):
    """Hole filling, resize and host copy EMIT_CHUNK frames at a time: chunks
    of 2 frames (the window split 2 + 2) give the bits of one chunk."""
    images = nchw_to_nhwc(fx["images"])
    pred = SAM2VideoPredictor(mini_port_model(), fill_hole_area=8, device="cpu")
    runs = []
    for chunk in (16, 2):
        monkeypatch.setattr(tvp, "EMIT_CHUNK", chunk)
        state = pred.init_state(images, 48, 40, max_objects=2)
        pred.add_new_mask(state, 0, 1, fx["mask_prompt"])
        pred.add_new_points_or_box(state, 0, 2, points=np.array([[8.0, 40.0]]), labels=np.array([1]))
        runs.append([(f, m) for f, _, m in pred.propagate_in_video(state)])
    assert [f for f, _ in runs[0]] == [f for f, _ in runs[1]] == list(range(images.shape[0]))
    for (_, a), (_, b) in zip(*runs):
        assert a.shape == (2, 1, 48, 40) and np.array_equal(a, b)


# ------------------------------------------------- the card's buffer flow
def test_bank_copied_in_and_out_equals_the_state_bank_in_place(fx):
    """The card runs the body over a bank of the graph's own, with the
    state's bank copied in before the window and out after; on the CPU the
    body uses the state's bank itself. Both give the same bits."""
    images = nchw_to_nhwc(fx["images"])
    pred = SAM2VideoPredictor(mini_port_model(), fill_hole_area=0, device="cpu")
    runs = []
    for own_bank in (False, True):
        with torch.inference_mode():
            state = pred.init_state(images, 64, 64, max_objects=2)
            pred.add_new_mask(state, 1, 1, fx["mask_prompt"])
            pred.add_new_points_or_box(state, 1, 2, points=np.array([[8.0, 40.0]]), labels=np.array([1]))
            pred.propagate_in_video_preflight(state)
            bufs = graphs.make_buffers(pred.model, state.bank, precompute=False, new_bank=own_bank)
            if own_bank:
                assert not bufs.bank.valid.any()
                graphs.copy_bank(bufs.bank, state.bank)
                assert bufs.bank.valid[:, 1].all()
            for frame in (2, 3, 4):
                bufs.t.fill_(frame)
                bufs.frame.copy_(state.images[frame: frame + 1])
                graphs.frame_body(pred.model, bufs, state.num_frames, False, 1)
            if own_bank:
                assert not state.bank.valid[:, 2:].any()
                graphs.copy_bank(state.bank, bufs.bank)
        runs.append((bufs.lows.clone(), [x.clone() for x in graphs.bank_tensors(state.bank)]))
    (lows_a, bank_a), (lows_b, bank_b) = runs
    assert torch.equal(lows_a[2:], lows_b[2:])
    assert all(torch.equal(a, b) for a, b in zip(bank_a, bank_b))
    assert bank_a[2][:, 1:].all() and not bank_a[2][:, 0].any()


# ---------------------------------------------------- launch counters at replay
class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeCapture:
    """Runs the body as a capture records it: the Python-side counters tick."""

    def __init__(self, graph):
        self.graph = graph

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _fake_body():
    window_attention.window_attention.launches += 9
    layer_norm.layer_norm.launches += 12
    flash_attention.flash_attention.launches += 8


@pytest.mark.parametrize("replays", [1, 15])
def test_replays_add_the_captured_launch_counts(replays):
    before = graphs.read_counts()
    g = graphs.FrameGraph(bufs=None)
    g.capture(_fake_body, new_graph=_FakeGraph, graph_context=_FakeCapture)
    assert graphs.read_counts() == before  # capture runs nothing on the device
    assert g.counts == {window_attention.window_attention: 9, layer_norm.layer_norm: 12,
                        flash_attention.flash_attention: 8}
    for _ in range(replays):
        g.replay()
    assert g.graph.replays == replays
    after = graphs.read_counts()
    want = {w: n + replays * g.counts.get(w, 0) for w, n in before.items()}
    assert after == want


def test_a_failed_capture_raises_and_leaves_the_counters():
    before = graphs.read_counts()

    def body():
        _fake_body()
        raise RuntimeError("operation not permitted when stream is capturing")

    g = graphs.FrameGraph(bufs=None)
    with pytest.raises(RuntimeError, match="capturing"):
        g.capture(body, new_graph=_FakeGraph, graph_context=_FakeCapture)
    assert g.graph is None and graphs.read_counts() == before


def _fake_captures(monkeypatch):
    monkeypatch.setattr(graphs.FrameGraph, "warm_up_and_capture",
                        lambda self, body: self.capture(body, new_graph=_FakeGraph, graph_context=_FakeCapture))


def test_one_capture_per_key(monkeypatch):
    _fake_captures(monkeypatch)
    made = []
    g = graphs.FrameGraphs()
    for key in ("a", "a", "b", "a", "b"):
        g.get(key, lambda: made.append(1) or object(), lambda bufs: None)
    assert g.captures == 2 and len(made) == 2 and sorted(g.entries) == ["a", "b"]


def test_graphs_kept_are_the_last_used(monkeypatch):
    """At most MAX_GRAPHS graphs: a new key drops the least recently used."""
    _fake_captures(monkeypatch)
    assert graphs.MAX_GRAPHS == 2
    g = graphs.FrameGraphs()
    kept = []
    for key in ("a", "b", "a", "c", "a", "b"):
        g.get(key, object, lambda bufs: None)
        kept.append("".join(g.entries))
    # "c" drops "b" (a was used after it); "b" again drops "c"
    assert kept == ["a", "ab", "ba", "ac", "ca", "ab"]
    assert g.captures == 4


def _weights():
    return [torch.arange(6, dtype=torch.float32).reshape(2, 3), torch.ones(4, dtype=torch.bfloat16)]


def _change(kind, w):
    if kind == "in_place":
        w[0].mul_(2.0)
    elif kind == "new_tensor":  # load_state_dict(assign=True), or .data = ...
        w[0].data = w[0].data.clone()
    elif kind == "cast_round_trip":  # set_compute_dtype(f32) then back: the same values in new memory
        w[1].data = w[1].data.float()
        w[1].data = w[1].data.to(torch.bfloat16)


@pytest.mark.parametrize("kind", ["unchanged", "in_place", "new_tensor", "cast_round_trip"])
def test_graphs_dropped_when_a_weight_changes(monkeypatch, kind):
    """A graph reads the weights by address: any weight in other memory or
    at another version drops every graph, and the next window captures
    anew. The graph holds the tensors it read, so their memory cannot pass
    to another tensor (a round trip cannot land at the old address)."""
    _fake_captures(monkeypatch)
    w = [torch.nn.Parameter(x, requires_grad=False) for x in _weights()]
    g = graphs.FrameGraphs()
    first = g.get("a", object, lambda bufs: None, w)
    g.get("b", object, lambda bufs: None, w)
    old_ptr = w[1].data_ptr()
    _change(kind, w)
    again = g.get("a", object, lambda bufs: None, w)
    if kind == "unchanged":
        assert again is first and g.captures == 2 and list(g.entries) == ["b", "a"]
    else:
        assert again is not first and g.captures == 3 and list(g.entries) == ["a"]
        assert again.reads(w) and not first.reads(w)
    if kind == "cast_round_trip":
        assert w[1].data_ptr() != old_ptr


def test_graph_of_inference_tensors_checks_their_memory(monkeypatch):
    """Inference tensors keep no version: a graph of them checks their memory."""
    _fake_captures(monkeypatch)
    with torch.inference_mode():
        w = _weights()
        g = graphs.FrameGraphs()
        first = g.get("a", object, lambda bufs: None, w)
        assert g.get("a", object, lambda bufs: None, w) is first
        w[0] = w[0].clone()
        assert g.get("a", object, lambda bufs: None, w) is not first and g.captures == 2


def test_counted_registry_holds_every_wrapper_imported():
    """One registry of the kernels' launch counters (kernels/_lib.py), which
    the graphs' accounting reads: every wrapper that counts launches."""
    from us_video_medsam2_tpu_torch.kernels import cxblock, flash_dropout, qkv_window_attention
    from us_video_medsam2_tpu_torch.kernels.rejected import window_attention_v1

    want = {flash_attention.flash_attention, layer_norm.layer_norm, window_attention.window_attention,
            cxblock.cxblock, flash_dropout.flash_dropout_fwd, flash_dropout.flash_dropout_bwd,
            qkv_window_attention.qkv_window_attention, window_attention_v1.window_attention_v1}
    assert want <= set(_lib.COUNTED.values())
    assert all(_lib.COUNTED[w.__name__] is w for w in want)
    assert set(graphs.read_counts()) == set(_lib.COUNTED.values())


# ------------------------------------------------------- ViTDet pos-embed table
def _vit():
    torch.manual_seed(0)
    vit = ViTDet(ViTDetConfig(img_size=128, patch_size=16, embed_dim=32, depth=2, num_heads=2, window_size=4,
                              window_block_indexes=(0,), pretrain_img_size=64))
    torch.nn.init.normal_(vit.pos_embed)
    return vit


def test_pos_embed_table_is_kept_and_equals_the_resize():
    vit = _vit()
    grid = vit.grid
    want = resize2d(vit.pos_embed[:, 1:].detach().float().reshape(1, grid, grid, 32), (8, 8), mode="cubic")
    with torch.no_grad():
        first = vit.pos_embed_table((8, 8), torch.float32)
        again = vit.pos_embed_table((8, 8), torch.float32)
        half = vit.pos_embed_table((8, 8), torch.bfloat16)
    assert torch.equal(first, want) and again is first
    assert torch.equal(half, want.to(torch.bfloat16)) and half.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 128, 128, 3)).astype(np.float32))
    with torch.no_grad():
        kept = vit(x)[0]
    fresh = vit(x)[0]  # a gradient is wanted: the resize is computed in the call
    assert torch.equal(kept, fresh.detach())


def test_pos_embed_table_is_made_anew_after_an_in_place_update():
    vit = _vit()
    with torch.no_grad():
        before = vit.pos_embed_table((8, 8), torch.float32)
        vit.pos_embed.mul_(2.0)
        after = vit.pos_embed_table((8, 8), torch.float32)
    assert after is not before
    assert torch.allclose(after, 2.0 * before, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["new_tensor", "cast_round_trip"])
def test_pos_embed_table_is_made_anew_for_a_new_tensor(kind):
    """``.data =`` (load_state_dict(assign=True)) or a cast there and back:
    the parameter's tensor is another, at version 0 again."""
    vit = _vit()
    with torch.no_grad():
        before = vit.pos_embed_table((8, 8), torch.float32)
        if kind == "new_tensor":
            vit.pos_embed.data = 2.0 * vit.pos_embed.data
        else:
            vit.pos_embed.data = vit.pos_embed.data.double()
            vit.pos_embed.data = 2.0 * vit.pos_embed.data.float()
        after = vit.pos_embed_table((8, 8), torch.float32)
        half = vit.pos_embed_table((4, 4), torch.bfloat16)
    assert after is not before
    assert torch.allclose(after, 2.0 * before, rtol=1e-6, atol=1e-6)
    assert set(vit._pe_tables) == {((8, 8), torch.float32), ((4, 4), torch.bfloat16)}
    assert half.shape == (1, 4, 4, 32)


def test_pos_embed_table_is_bypassed_when_a_gradient_is_wanted():
    vit = _vit()
    with torch.no_grad():
        kept = vit.pos_embed_table((8, 8), torch.float32)
    table = vit.pos_embed_table((8, 8), torch.float32)
    assert table is not kept and table.grad_fn is not None
    table.sum().backward()
    assert vit.pos_embed.grad is not None and vit.pos_embed.grad[:, 1:].abs().sum() > 0


def test_pos_embed_table_made_under_inference_mode_can_be_saved_for_backward():
    vit = _vit()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 128, 128, 3)).astype(np.float32))
    with torch.inference_mode():
        vit(x)  # the table is first made here, as in the predictor
    vit.pos_embed.requires_grad_(False)  # a frozen pos-embed in a later training step: the kept table
    table = vit.pos_embed_table((8, 8), torch.float32)
    assert not table.is_inference()
    w = torch.ones_like(table, requires_grad=True)
    (table * w).sum().backward()  # mul saves the table for backward
    assert torch.equal(w.grad, table)


def test_pos_embed_table_of_an_inference_tensor_is_made_on_each_call():
    with torch.inference_mode():
        vit = _vit()  # parameters made under inference mode keep no version to key on
        assert vit.pos_embed.is_inference()
        first = vit.pos_embed_table((8, 8), torch.float32)
        vit.pos_embed.mul_(2.0)
        second = vit.pos_embed_table((8, 8), torch.float32)
    assert vit._pe_tables == {}
    assert torch.allclose(second, 2.0 * first, rtol=1e-6, atol=1e-6)
