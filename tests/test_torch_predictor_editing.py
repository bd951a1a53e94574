"""PyTorch port: the predictor's editing API against the JAX predictor on the CPU.

Counterparts of tests/test_video_predictor.py's editing tests, at MINI with
the fixture weights through both importers and the fixture's 5-frame video.
The same sequence of calls runs through both predictors; their states (object
ids, prompted frames, the bank's valid and conditioning masks) must agree
exactly and their masks within JAX's own tolerances (logits rtol / atol 1e-3,
mask IoU > 0.999).

1. ``remove_object`` before propagation (the port's session then equals a
   fresh one bit for bit), after propagation, and its edge cases (an unknown
   id, the last object).
2. ``clear_all_prompts_in_frame``: the downgrade of a conditioning frame and
   the full tracking reset.
3. ``clear_non_cond_mem_around_input``: the preflight's scrub and the scrub
   when propagation passes a conditioning frame.
4. Re-prompting a tracked frame with ``prev_low_res_mask``; ``reset_state``.
5. ``non_overlap_masks`` in the prompt return and in propagation.
6. The three bank edits against the JAX predictor's ``_clear_window``,
   ``_downgrade_frame`` and ``_permute_rows``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import require_fixture
from tests.torch_port_helpers import assert_masks_close, mini_jax_predictor, mini_port_predictor, nchw_to_nhwc, t
from us_video_medsam2_tpu_torch.inference import graphs
from us_video_medsam2_tpu_torch.inference import video_predictor as vp
from us_video_medsam2_tpu_torch.models import memory_bank as tbank
from us_video_medsam2_tpu.models import memory_bank as jbank


@pytest.fixture(scope="module")
def fx():
    return np.load(require_fixture("predictor_video.npz"))


@pytest.fixture(scope="module")
def images(fx):
    return nchw_to_nhwc(fx["images"])


@pytest.fixture(scope="module")
def preds():
    """(JAX, port) predictors, hole filling off as in the JAX tests."""
    return mini_jax_predictor(fill_hole_area=0), mini_port_predictor(fill_hole_area=0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bank_masks(state):
    return _np(state.bank.valid), _np(state.bank.is_cond)


def _assert_same_state(js, ps):
    assert ps.obj_ids == js.obj_ids
    assert ps.prompt_frames == js.prompt_frames
    assert sorted(ps.cond_low_res) == sorted(js.cond_low_res)
    assert sorted(ps.frames_tracked) == sorted(js.frames_tracked)
    assert sorted(ps.pending) == sorted(js.pending)
    for a, b in zip(_bank_masks(ps), _bank_masks(js)):
        np.testing.assert_array_equal(a, b)


def _prompt_two(pred, state, fx):
    pred.add_new_mask(state, 1, 1, fx["mask_prompt"])
    pred.add_new_points_or_box(state, 1, 2, points=np.array([[30.0, 150.0]]), labels=np.array([1]))


def _fwd(pred, state, **kw):
    return {f: np.asarray(m) for f, _, m in pred.propagate_in_video(state, **kw)}


def test_remove_object_before_propagation_matches_fresh_session(preds, fx, images):
    """Removed before propagation: the port's session gives the bits of one
    where the object was never prompted; both predictors agree."""
    results = []
    for pred in preds:
        state = pred.init_state(images, 200, 180, max_objects=2)
        _prompt_two(pred, state, fx)
        obj_ids, updated = pred.remove_object(state, 2)
        assert obj_ids == [1] and [f for f, _ in updated] == [1]
        assert updated[0][1].shape == (2, 1, 200, 180)
        got = _fwd(pred, state)
        fresh = pred.init_state(images, 200, 180, max_objects=2)
        pred.add_new_mask(fresh, 1, 1, fx["mask_prompt"])
        want = _fwd(pred, fresh)
        results.append((state, np.asarray(updated[0][1]), got, want))
    (js, jupd, jgot, _), (ps, pupd, pgot, pwant) = results
    assert list(pgot) == list(pwant)
    for f in pwant:
        np.testing.assert_array_equal(pgot[f], pwant[f])
    _assert_same_state(js, ps)
    np.testing.assert_allclose(pupd, jupd, rtol=1e-4, atol=1e-4)
    assert_masks_close(pgot, jgot)


def test_remove_object_after_propagation(preds, fx, images):
    """The removed object's rows and prompts go; the survivor moves to row 0
    with its memories, and re-propagation agrees with the JAX predictor's
    and, on the survivor's row, with a fresh single-object session."""
    results = []
    for pred in preds:
        state = pred.init_state(images, 200, 180, max_objects=2)
        _prompt_two(pred, state, fx)
        _fwd(pred, state)
        obj_ids, updated = pred.remove_object(state, 1)
        assert obj_ids == [2] and [f for f, _ in updated] == [1]
        assert bool(_np(state.bank.valid[0]).any()) and not _np(state.bank.valid[1]).any()
        got = _fwd(pred, state)
        fresh = pred.init_state(images, 200, 180, max_objects=2)
        pred.add_new_points_or_box(fresh, 1, 2, points=np.array([[30.0, 150.0]]), labels=np.array([1]))
        want = _fwd(pred, fresh)
        results.append((state, got, want))
    (js, jgot, _), (ps, pgot, pwant) = results
    _assert_same_state(js, ps)
    assert_masks_close(pgot, jgot)
    assert list(pgot) == list(pwant)
    for f in pwant:
        # the survivor's row; the blanked row differs from a placeholder encode by design
        np.testing.assert_array_equal(pgot[f][0], pwant[f][0])


def test_remove_object_edge_cases(preds, fx, images):
    for pred in preds:
        state = pred.init_state(images, 200, 180, max_objects=2)
        _prompt_two(pred, state, fx)
        obj_ids, updated = pred.remove_object(state, 99)
        assert obj_ids == [1, 2] and updated == []
        with pytest.raises(RuntimeError, match="99"):
            pred.remove_object(state, 99, strict=True)
        pred.remove_object(state, 2)
        obj_ids, _ = pred.remove_object(state, 1)  # the last object: a reset
        assert obj_ids == [] and state.obj_ids == []
        assert not _np(state.bank.valid).any()
        assert state.pending == {} and state.prompt_frames == {} and state.cond_low_res == {}


def test_clear_all_prompts_in_frame(preds, fx, images):
    """The last prompt of a frame cleared: the frame becomes a non-conditioning
    memory; the last conditioning frame cleared: a tracking reset that keeps
    the object ids. Both predictors agree at every step."""
    outs = []
    states = []
    for pred in preds:
        state = pred.init_state(images, 200, 180, max_objects=2)
        pred.add_new_mask(state, 1, 1, fx["mask_prompt"])
        pred.add_new_points_or_box(state, 3, 1, points=np.array([[30.0, 150.0]]), labels=np.array([1]))
        _fwd(pred, state)
        assert bool(_np(state.bank.is_cond[0, 3]))
        out = pred.clear_all_prompts_in_frame(state, 3, 1)
        assert out[0] == 3 and out[1] == [1]
        assert not bool(_np(state.bank.is_cond[0, 3])) and bool(_np(state.bank.valid[0, 3]))
        assert 3 not in state.cond_low_res and 3 not in state.frames_tracked
        again = _fwd(pred, state)  # frame 3 is tracked again from frame 1
        snapshot = [x.copy() for x in _bank_masks(state)]
        pred.clear_all_prompts_in_frame(state, 1, 1)
        assert not _np(state.bank.valid).any()
        assert state.cond_low_res == {} and state.frames_tracked == {} and state.obj_ids == [1]
        outs.append((np.asarray(out[2]), again, snapshot))
        states.append(state)
    (jout, jagain, jsnap), (pout, pagain, psnap) = outs
    np.testing.assert_allclose(pout, jout, rtol=1e-4, atol=1e-4)
    assert_masks_close(pagain, jagain)
    for a, b in zip(psnap, jsnap):
        np.testing.assert_array_equal(a, b)
    _assert_same_state(*states)


def test_clear_non_cond_mem_around_input(fx, images):
    """The preflight scrubs every non-conditioning memory around a newly
    prompted frame, and propagation scrubs again when it passes a
    conditioning frame (MINI: radius 7 covers the 5 frames)."""
    jpred = mini_jax_predictor(fill_hole_area=0, clear_non_cond_mem_around_input=True)
    ppred = mini_port_predictor(fill_hole_area=0, clear_non_cond_mem_around_input=True)
    assert ppred._clear_radius() == jpred._clear_radius() == 7
    steps = []
    for pred in (jpred, ppred):
        state = pred.init_state(images, 200, 180, max_objects=1)
        pred.add_new_mask(state, 1, 1, fx["mask_prompt"])
        first = _fwd(pred, state)
        v1 = _np(state.bank.valid[0]).copy()
        assert v1[1:].all()
        pred.add_new_points_or_box(state, 3, 1, points=np.array([[30.0, 150.0]]), labels=np.array([1]))
        pred.propagate_in_video_preflight(state)
        v2, c2 = _np(state.bank.valid[0]).copy(), _np(state.bank.is_cond[0]).copy()
        assert v2[1] and c2[1] and v2[3] and c2[3] and not (v2[0] or v2[2] or v2[4])
        second = _fwd(pred, state)
        v3 = _np(state.bank.valid[0]).copy()
        assert v3[1] and v3[3] and v3[4] and not v3[2], "passing frame 3 scrubs frame 2"
        steps.append((first, second, v1, v2, v3))
    (jf, js, *jv), (pf, ps, *pv) = steps
    assert_masks_close(pf, jf, "first")
    assert_masks_close(ps, js, "second")
    for a, b in zip(pv, jv):
        np.testing.assert_array_equal(a, b)


def test_clear_is_single_object_unless_the_multi_object_flag(fx, images):
    for multi, want in ((False, False), (True, True)):
        pred = mini_port_predictor(clear_non_cond_mem_around_input=True, clear_non_cond_mem_for_multi_obj=multi)
        state = pred.init_state(images, 200, 180, max_objects=2)
        _prompt_two(pred, state, fx)
        assert pred._clear_enabled(state) is want


def test_reprompt_with_prev_low_res_mask(preds, fx, images):
    """A tracked frame re-prompted with a click and its earlier low-res logits
    as the mask prompt; then propagation from there. Both predictors agree."""
    results = []
    for pred in preds:
        state = pred.init_state(images, 200, 180, max_objects=1)
        pred.add_new_mask(state, 1, 1, fx["mask_prompt"])
        _fwd(pred, state)
        prev = np.asarray(state.cond_low_res[1])[0]  # [4fs, 4fs]
        _, _, with_prev = pred.add_new_points_or_box(state, 3, 1, points=np.array([[30.0, 150.0]]),
                                                     labels=np.array([1]), prev_low_res_mask=prev)
        fresh = pred.init_state(images, 200, 180, max_objects=1)
        pred.add_new_mask(fresh, 1, 1, fx["mask_prompt"])
        _fwd(pred, fresh)
        _, _, without = pred.add_new_points_or_box(fresh, 3, 1, points=np.array([[30.0, 150.0]]),
                                                   labels=np.array([1]))
        after = _fwd(pred, state)
        results.append((np.asarray(with_prev), np.asarray(without), after))
    (jw, jo, ja), (pw, po, pa) = results
    np.testing.assert_allclose(pw, jw, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(po, jo, rtol=1e-3, atol=1e-3)
    # the mask prompt changes the output, and both predictors change it alike
    assert np.abs(pw - jw).max() < 0.1 * np.abs(pw - po).max()
    assert_masks_close(pa, ja)


def test_reset_state(preds, fx, images):
    for pred in preds:
        state = pred.init_state(images, 200, 180, max_objects=2, t_bucket="auto")
        _prompt_two(pred, state, fx)
        _fwd(pred, state)
        pred.reset_state(state)
        assert state.obj_ids == [] and state.pending == {} and state.cond_low_res == {}
        assert state.frames_tracked == {} and state.prompt_frames == {}
        assert _np(state.bank.valid).shape == (2, 16) and not _np(state.bank.valid).any()


def test_non_overlap_masks(fx, images):
    """non_overlap_masks: per pixel only the object of the highest logit keeps
    its logit (the others clamped to -10), in the prompt return and in the
    propagated frames: the port's frames are its unconstrained frames so
    constrained, bit for bit, and the JAX predictor's up to the order of the
    objects at a pixel (the untrained MINI tracks both objects to the same
    logits within ~1e-9, so which of the two keeps its logit is a tie)."""
    results = []
    for pred in (mini_jax_predictor(fill_hole_area=0, non_overlap_masks=True),
                 mini_port_predictor(fill_hole_area=0, non_overlap_masks=True),
                 mini_port_predictor(fill_hole_area=0)):
        state = pred.init_state(images, 200, 180, max_objects=2)
        pred.add_new_mask(state, 1, 1, fx["mask_prompt"])
        _, _, pm = pred.add_new_points_or_box(state, 1, 2, points=np.array([[30.0, 150.0]]),
                                              labels=np.array([1]))
        results.append((np.asarray(pm), _fwd(pred, state, chunk_size=2)))
    (jpm, jf), (ppm, pf), (_, plain) = results
    np.testing.assert_allclose(ppm, jpm, rtol=1e-4, atol=1e-4)
    both = (ppm[0, 0] > 0) & (ppm[1, 0] > 0)
    assert not both.any() and (ppm.max(0) > 0).any()
    assert list(pf) == list(jf) == list(plain)
    for f in pf:
        np.testing.assert_array_equal(pf[f][:, 0], vp._non_overlap(torch.from_numpy(plain[f][:, 0])).numpy())
        np.testing.assert_allclose(np.sort(pf[f], axis=0), np.sort(jf[f], axis=0), rtol=1e-3, atol=1e-3)
        assert ((pf[f] > -10).sum(0) <= 1).all()
    np.testing.assert_allclose(pf[1], jf[1], rtol=1e-3, atol=1e-3)  # the prompted frame: no tie


# ------------------------------------------------------------------ bank edits
def _banks(seed, o=3, s=12):
    rng = np.random.default_rng(seed)
    mem = rng.standard_normal((o, s, 4, 8)).astype(np.float32)
    ptr = rng.standard_normal((o, s, 16)).astype(np.float32)
    valid = rng.random((o, s)) > 0.3
    is_cond = valid & (rng.random((o, s)) > 0.6)
    jb = jbank.MemoryBank(maskmem=jnp.asarray(mem), obj_ptr=jnp.asarray(ptr), valid=jnp.asarray(valid),
                          is_cond=jnp.asarray(is_cond))
    tb = tbank.MemoryBank(t(mem), t(ptr), t(valid), t(is_cond))
    return jb, tb


def _assert_banks_equal(tb, jb):
    for a, b in zip(graphs.bank_tensors(tb), (jb.maskmem, jb.obj_ptr, jb.valid, jb.is_cond)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def jax_edits():
    return mini_jax_predictor()


@pytest.mark.parametrize("frame, radius", [(0, 7), (5, 2), (11, 3), (6, 0)])
@pytest.mark.parametrize("index", ["int", "tensor"])
def test_clear_window_matches_jax(jax_edits, frame, radius, index):
    jb, tb = _banks(frame + 31 * radius)
    want = jax_edits._clear_window(jb, jnp.asarray(frame), radius=radius)
    got = tbank.clear_window(tb, frame if index == "int" else torch.tensor(frame), radius)
    assert got is tb
    _assert_banks_equal(tb, want)


@pytest.mark.parametrize("frame", [0, 4, 11])
@pytest.mark.parametrize("index", ["int", "tensor"])
def test_downgrade_frame_matches_jax(jax_edits, frame, index):
    jb, tb = _banks(frame)
    want = jax_edits._downgrade_frame(jb, jnp.asarray(frame))
    tbank.downgrade_frame(tb, frame if index == "int" else torch.tensor(frame))
    _assert_banks_equal(tb, want)


@pytest.mark.parametrize("perm, keep", [((1, 2, 0), (True, True, False)), ((0, 2, 0), (True, True, False)),
                                        ((2, 0, 1), (True, True, True)), ((1, 0, 0), (True, False, False))])
def test_permute_rows_matches_jax(jax_edits, perm, keep):
    jb, tb = _banks(sum(perm))
    want = jax_edits._permute_rows(jb, jnp.asarray(perm, jnp.int32), jnp.asarray(keep))
    tbank.permute_rows(tb, perm, keep)
    _assert_banks_equal(tb, want)
