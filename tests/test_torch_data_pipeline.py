"""PyTorch port, data pipeline: ``us_video_medsam2_tpu_torch/training/data.py``
against the JAX package's ``training/data.py``, class for class.

The JAX module draws from the global ``random`` and ``np.random``; the port
from the ``Rngs`` it is handed. Each case seeds the JAX globals with s and
the port's generators with ``make_rngs(s)``, runs both, compares the outputs
and then one more draw of each stream, so that a transform that drew once
more or once less than JAX's shows even where its output agrees.

Tolerances, each for its reason:
- flips, colour jitter, grayscale, noise, normalize, the samplers, the
  curricula, COCO RLE, SA-1B and SA-V JSON data: exact (the same numpy
  arithmetic; jitter and noise within 1e-6 for float reassociation);
- resize: images within 1e-5 (bilinear without antialias on both sides;
  measured ~1e-7 at these sizes: cv2 computes the source coordinate in f64,
  PyTorch in f32, which at an upscale of 600 -> 1000 rows alone reaches
  7e-5), masks bit for bit (nearest indexes floor(i · in / out) on both);
- blur: within 1e-5 (the same f32 kernel, another summation order);
- affine against JAX's cv2 warp: on pixels sampled from well inside the
  source, max |d| <= 2e-2 and mean |d| < 2e-3 (the JAX package's own
  limits for its cv2 warp against ``grid_sample``,
  tests/test_data_pipeline.py:440-487: cv2 quantises the source coordinate
  to 1/32 pixel); masks at IoU >= 0.98 per object (measured 1.0: the port
  rounds half up as cv2's fixed point does). The fixture objects are large,
  so no retry diverges;
- whole-stack batches (loader, FLARE stack) are compared bit for bit where
  no affine runs, and with the affine at the affine's own limits.
"""

from __future__ import annotations

import importlib
import json
import os
import random
import sys

import numpy as np
import pytest

from tests.curriculum_corpus import build_aes_corpus, build_corpus
from us_video_medsam2_tpu.training import data as J
from us_video_medsam2_tpu_torch.training import data as P

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "curriculum_quantum.json")


def seed_both(s: int) -> P.Rngs:
    random.seed(s)
    np.random.seed(s % 2**32)
    return P.make_rngs(s)


def assert_streams_aligned(rngs: P.Rngs) -> None:
    assert rngs.py.random() == random.random(), "the port drew from random a different number of times"
    assert rngs.np.rand() == np.random.rand(), "the port drew from np.random a different number of times"


@pytest.fixture(scope="module")
def npz_dir(tmp_path_factory):
    """The JAX pipeline test's corpus (tests/test_data_pipeline.py:24-38) with
    a moving second object: 6 videos of 8 frames, 40x48."""
    root = tmp_path_factory.mktemp("npz")
    rng = np.random.default_rng(0)
    for i in range(6):
        t, h, w = 8, 40, 48
        if i < 3:
            imgs = np.full((t, h, w), 60 + i, np.uint8)
        else:
            imgs = (rng.random((t, h, w)) * 255).astype(np.uint8)
        gts = np.zeros((t, h, w), np.uint8)
        gts[:, 10:25, 12:30] = 1
        for f in range(t):
            gts[f, 26:36, 2 + 2 * f: 14 + 2 * f] = 2
        np.savez_compressed(root / f"v{i}.npz", imgs=imgs, gts=gts)
    return str(root)


def datapoint(mod, t=3, h=64, w=80, seed=0, objects=2):
    """Smooth frames in [0, 1] and large objects, in ``mod``'s VideoDatapoint."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.3 * np.sin(xx / 9.0)[..., None] * np.cos(yy / 7.0)[..., None] * np.ones(3, np.float32)
    imgs = [np.clip(base + 0.05 * rng.standard_normal((h, w, 3)).astype(np.float32) * 0.2 + 0.01 * i, 0, 1)
            .astype(np.float32) for i in range(t)]
    masks = []
    for i in range(t):
        frame = {}
        for o in range(objects):
            m = np.zeros((h, w), bool)
            m[12 + 10 * o + i: 36 + 10 * o + i, 15 + 20 * o: 45 + 20 * o] = True
            frame[o + 1] = m
        masks.append(frame)
    return mod.VideoDatapoint(imgs, masks)


def assert_dp_equal(a, b, atol=0.0):
    assert len(a.images) == len(b.images)
    for x, y in zip(a.images, b.images):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)
    for fa, fb in zip(a.masks, b.masks):
        assert list(fa) == list(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])


# ------------------------------------------------------------------ curricula
def test_quantum_curriculum_matches_fixture_and_jax(tmp_path):
    with open(FIXTURE) as f:
        fix = json.load(f)
    folder = str(tmp_path / "corpus")
    build_corpus(folder)
    ms = {"expand": 20, "full": 50}
    p, j = P.QuantumNPZRawDataset(folder, milestones=ms), J.QuantumNPZRawDataset(folder, milestones=ms)
    assert sorted(p.video_names) == fix["dense"] == sorted(j.video_names)
    for epoch, key in ((19, None), (20, None), (25, "expand"), (60, "full")):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        assert p.stage == j.stage and p.video_names == j.video_names
        if key:
            assert sorted(p.video_names) == fix[key]
    floor = str(tmp_path / "floor.txt")
    with open(floor, "w") as f:
        f.write("\n".join(["vid_a_k4", "vid_l_k10", "vid_d_k16", "vid_e_k20", "vid_f_k28", "vid_j_k28"]))
    p3 = P.QuantumNPZRawDataset(folder, milestones=ms, file_list_txt=floor)
    assert sorted(p3.video_names) == fix["floor_dense"]
    p4 = P.QuantumNPZRawDataset(folder, milestones=ms, refilter_from_all=True)
    j4 = J.QuantumNPZRawDataset(folder, milestones=ms, refilter_from_all=True)
    for epoch in (0, 25, 60):
        p4.set_epoch(epoch)
        j4.set_epoch(epoch)
        assert p4.video_names == j4.video_names
    assert len(p4.video_names) == 10


def test_neurospectral_and_aes_match_fixture_and_jax(tmp_path):
    with open(FIXTURE) as f:
        fix = json.load(f)
    folder = str(tmp_path / "corpus")
    build_corpus(folder)
    ms = {"expand": 20, "full": 50}
    p, j = P.NeuroSpectralNPZRawDataset(folder, milestones=ms), J.NeuroSpectralNPZRawDataset(folder, milestones=ms)
    assert p.video_scores == j.video_scores
    for name, score in fix["neuro_scores"].items():
        assert p.video_scores[name] == pytest.approx(score, rel=1e-9)
    for epoch, key in ((0, "neuro_dense"), (25, "neuro_expand"), (60, "neuro_full")):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        assert list(p.video_names) == fix[key] == list(j.video_names)

    aes = str(tmp_path / "aes")
    build_aes_corpus(aes)
    p, j = P.AESCurriculumNPZRawDataset(aes, milestones=ms), J.AESCurriculumNPZRawDataset(aes, milestones=ms)
    assert p.sample_entropies == j.sample_entropies
    for epoch, key in ((0, "aes_dense"), (25, "aes_expand"), (60, "aes_full")):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        assert list(p.video_names) == fix[key] == list(j.video_names)
    for loss in (0.5, 0.05, 0.05, 0.5):
        p.set_epoch(0, training_loss=loss)
    assert p.adaptive_factor == pytest.approx(fix["aes_adaptive_factor"], rel=1e-12)
    (pv, ps), (jv, js) = p.get_video(0), j.get_video(0)
    for a, b in zip(pv.frames, jv.frames):
        np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(ps.masks, js.masks)


@pytest.mark.parametrize("mask", ["empty", "ring", "blobs"])
def test_mask_complexity_terms_match_jax(mask):
    m = np.zeros((24, 24), bool)
    if mask == "ring":
        m[4:20, 4:20] = True
        m[8:16, 8:16] = False
    elif mask == "blobs":
        m[2:5, 2:5] = m[10:18, 3:9] = m[20, 20] = True
    assert P._perimeter_2d(m) == J._perimeter_2d(m)
    for conn in (1, 2):
        assert P._euler_number_2d(m, conn) == J._euler_number_2d(m, conn)
    assert P.AESCurriculumNPZRawDataset._mask_complexity(m) == J.AESCurriculumNPZRawDataset._mask_complexity(m)


def test_fap_and_signal_curricula_match_jax(npz_dir):
    p, j = P.FAPCurriculumNPZRawDataset(npz_dir), J.FAPCurriculumNPZRawDataset(npz_dir)
    assert p.scores == j.scores
    for epoch in (0, 25, 60):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        assert p.video_names == j.video_names
    p.force_stage("expand")
    j.force_stage("expand")
    assert p.video_names == j.video_names

    p, j = P.SignalCurriculumNPZRawDataset(npz_dir, max_epochs=10), J.SignalCurriculumNPZRawDataset(npz_dir,
                                                                                                     max_epochs=10)
    for epoch in (0, 3, 7):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        assert (p.temporal_stride, p.use_stochastic) == (j.temporal_stride, j.use_stochastic)
        for idx in range(len(p)):
            rngs = seed_both(100 * epoch + idx)
            (pv, ps), (jv, js) = p.get_video(idx, rngs), j.get_video(idx)
            assert [f.frame_idx for f in pv.frames] == [f.frame_idx for f in jv.frames]
            for a, b in zip(pv.frames, jv.frames):
                np.testing.assert_array_equal(a.data, b.data)
            assert_streams_aligned(rngs)


@pytest.fixture
def staged_tree(tmp_path):
    """<root>/<stage>/uterine_niche/*.npz, as the JAX test builds it."""
    rng = np.random.default_rng(1)
    for stage in ("dense", "expand", "full"):
        d = tmp_path / stage / "uterine_niche"
        d.mkdir(parents=True)
        for i in range(3 if stage != "full" else 4):
            imgs = (rng.random((9, 16, 20)) * 255).astype(np.uint8)
            masks = (rng.random((9, 16, 20)) > 0.5).astype(np.uint8)
            np.savez(d / f"s{i}.npz", imgs=imgs, masks=masks)
    return str(tmp_path)


@pytest.mark.parametrize("cls", ["MedSAM2CurriculumDataset", "MedSAM2CurriculumDataset2"])
def test_medsam2_curricula_match_jax(staged_tree, cls):
    ms = {"expand": 2, "full": 4}
    p, j = getattr(P, cls)(staged_tree, milestones=ms, seed=5), getattr(J, cls)(staged_tree, milestones=ms)
    random.seed(5)  # the port's dataset draws from its own Random(seed)
    for epoch in (0, 2, 4):
        p.temporal_stride = j.temporal_stride = 3
        assert p.update_curriculum_stage(epoch) == j.update_curriculum_stage(epoch)
        assert (p.stage, p.samples, len(p)) == (j.stage, j.samples, len(j))
        for idx in range(len(p)):
            a, b = p[idx], j[idx]
            assert a["video_id"] == b["video_id"] and a["num_frames"] == b["num_frames"]
            np.testing.assert_array_equal(a["images"], b["images"])
            np.testing.assert_array_equal(a["masks"], b["masks"])
    assert p.rng.random() == random.random()


# ------------------------------------------------------------------- samplers
@pytest.mark.parametrize("reverse", [0.0, 0.5])
def test_samplers_match_jax(npz_dir, reverse):
    pr, jr = P.NPZRawDataset(npz_dir), J.NPZRawDataset(npz_dir)
    ps, js = P.RandomUniformSampler(3, 1, reverse_time_prob=reverse), J.RandomUniformSampler(3, 1, reverse)
    for idx in range(len(pr)):
        rngs = seed_both(idx)
        (pv, pl), (jv, jl) = pr.get_video(idx), jr.get_video(idx)
        a, b = ps.sample(pv, pl, rngs), js.sample(jv, jl)
        assert [f.frame_idx for f in a.frames] == [f.frame_idx for f in b.frames]
        assert a.object_ids == b.object_ids
        assert_streams_aligned(rngs)
        e1, e2 = P.EvalSampler().sample(pv, pl), J.EvalSampler().sample(jv, jl)
        assert [f.frame_idx for f in e1.frames] == [f.frame_idx for f in e2.frames] and e1.object_ids == e2.object_ids


# ----------------------------------------------------------------- transforms
EXACT = {
    "hflip": (lambda m: m.RandomHorizontalFlip(p=0.5), 0.0),
    "vflip": (lambda m: m.RandomVerticalFlip(p=0.5), 0.0),
    "jitter_consistent": (lambda m: m.ColorJitter(True, 0.2, 0.2, 0.03), 1e-6),
    "jitter_per_frame": (lambda m: m.ColorJitter(False, 0.1, 0.05, 0.05), 1e-6),
    "grayscale": (lambda m: m.RandomGrayscale(p=0.5), 0.0),
    "noise": (lambda m: m.RandomGaussianNoise(p=0.5, sigma=0.02), 1e-6),
    "normalize": (lambda m: m.NormalizeAPI(), 0.0),
}


@pytest.mark.parametrize("name", list(EXACT))
def test_exact_transforms_match_jax(name):
    make, atol = EXACT[name]
    for s in range(6):
        rngs = seed_both(s)
        got = make(P)(datapoint(P, seed=s), rngs)
        want = make(J)(datapoint(J, seed=s))
        assert_dp_equal(got, want, atol)
        assert_streams_aligned(rngs)


@pytest.mark.parametrize("sizes", [512, 32, [24, 40, 56]])
def test_resize_matches_jax_cv2(sizes):
    for s in range(3):
        rngs = seed_both(s)
        got = P.RandomResizeAPI(sizes)(datapoint(P, seed=s, h=60, w=80), rngs)
        want = J.RandomResizeAPI(sizes)(datapoint(J, seed=s, h=60, w=80))
        assert_dp_equal(got, want, atol=1e-5)
        assert_streams_aligned(rngs)


@pytest.mark.parametrize("hw,size", [((600, 800), (512, 512)), ((300, 400), (512, 512)), ((512, 512), (256, 256)),
                                     ((37, 53), (64, 64))])
def test_resize_helpers_match_cv2(hw, size):
    import cv2

    rng = np.random.default_rng(0)
    img = rng.random((*hw, 3)).astype(np.float32)
    mask = rng.random(hw) > 0.7
    np.testing.assert_allclose(P.resize_image(img, size),
                               cv2.resize(img, size[::-1], interpolation=cv2.INTER_LINEAR), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        P.resize_mask(mask, size),
        cv2.resize(mask.astype(np.uint8), size[::-1], interpolation=cv2.INTER_NEAREST).astype(bool))


@pytest.mark.parametrize("ksize,sigma", [(5, (0.5, 1.0)), (5, (0.1, 2.0)), (3, (1.5, 1.5)), (7, (0.8, 3.0))])
def test_blur_matches_jax_cv2(ksize, sigma):
    for s in range(3):
        rngs = seed_both(s)
        got = P.RandomGaussianBlur(p=0.7, kernel_size=ksize, sigma=sigma)(datapoint(P, seed=s), rngs)
        want = J.RandomGaussianBlur(p=0.7, kernel_size=ksize, sigma=sigma)(datapoint(J, seed=s))
        assert_dp_equal(got, want, atol=1e-5)
        assert_streams_aligned(rngs)


def interior(m, h, w, margin=3):
    """Output pixels whose source lies at least ``margin`` pixels inside."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    return (sx > margin - 1) & (sx < w - margin) & (sy > margin - 1) & (sy < h - margin)


def mask_iou(a, b) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


AFFINES = {
    "default_bicubic": dict(degrees=25, shear=20),
    "flare_strong": dict(degrees=25, shear=20, scale=(0.7, 1.4)),
    "flare_weak_translate": dict(degrees=5, shear=5, scale=(0.95, 1.05), translate=(0.05, 0.05), p=0.5),
    "bilinear_per_frame": dict(degrees=15, shear=[-5, 5, -5, 5], image_interpolation="bilinear",
                               consistent_transform=False),
}


@pytest.mark.parametrize("name", list(AFFINES))
def test_affine_matches_jax_cv2_warp(name):
    kw = AFFINES[name]
    h, w = 64, 80
    for s in range(4):
        rngs = seed_both(s)
        got = P.RandomAffine(**kw)(datapoint(P, seed=s, h=h, w=w), rngs)
        want = J.RandomAffine(**kw)(datapoint(J, seed=s, h=h, w=w))
        assert_streams_aligned(rngs)
        for fi, (a, b) in enumerate(zip(got.images, want.images)):
            d = np.abs(a - b)
            assert d.max() <= 0.05, (name, s, fi, d.max())
        for fa, fb in zip(got.masks, want.masks):
            for k in fb:
                assert mask_iou(fa[k], fb[k]) >= 0.98, (name, s, k)


def test_affine_warp_interior_within_the_jax_limits():
    """One warp through both backends with the same matrix: interior pixels
    within the JAX test's limits, the fill blended in at the border, masks
    at IoU >= 0.98 (the same pixels, measured)."""
    import cv2

    h, w = 64, 80
    img = datapoint(P, t=1, h=h, w=w).images[0]
    mask = datapoint(P, t=1, h=h, w=w).masks[0][1]
    fill = (123 / 255, 116 / 255, 103 / 255)
    for angle, translate, scale, shear in ((17.0, (3, -2), 1.15, (8.0, 0.0)), (-25.0, (0, 0), 0.7, (20.0, 5.0)),
                                          (4.0, (6, 6), 1.4, (0.0, -12.0))):
        m = P.affine_inverse_matrix((w * 0.5 - 0.5, h * 0.5 - 0.5), angle, translate, scale, shear)
        np.testing.assert_array_equal(
            m, J.affine_inverse_matrix((w * 0.5 - 0.5, h * 0.5 - 0.5), angle, translate, scale, shear))
        for mode, flag in (("bicubic", cv2.INTER_CUBIC), ("bilinear", cv2.INTER_LINEAR)):
            got = P.warp_affine(img, m, mode, fill)
            want = cv2.warpAffine(img, m, (w, h), flags=flag | cv2.WARP_INVERSE_MAP, borderValue=fill)
            inside = interior(m, h, w)
            assert inside.sum() > h * w // 4
            d = np.abs(got - want)[inside]
            assert d.max() <= 2e-2 and d.mean() < 2e-3, (mode, d.max(), d.mean())
            assert np.abs(got - want).mean() < 2e-2  # the border's fill too
        warped = cv2.warpAffine(mask.astype(np.uint8), m, (w, h), flags=cv2.INTER_NEAREST | cv2.WARP_INVERSE_MAP,
                                borderValue=0).astype(bool)
        assert mask_iou(P.warp_mask_nearest(mask, m), warped) >= 0.98


def test_affine_vanishing_object_retries_then_returns_the_original():
    dp = datapoint(P, t=2)
    tiny = np.zeros((64, 80), bool)
    tiny[0, 0] = True
    dp.masks[0] = {1: tiny}
    dp.masks[1] = {1: tiny.copy()}
    orig = [x.copy() for x in dp.images]
    jdp = datapoint(J, t=2)
    jdp.masks[0] = {1: tiny.copy()}
    jdp.masks[1] = {1: tiny.copy()}
    gave_up = 0
    for s in range(8):
        rngs = seed_both(s)
        out = P.RandomAffine(degrees=40, shear=None, translate=(0.3, 0.3), num_retries=3)(dp, rngs)
        jout = J.RandomAffine(degrees=40, shear=None, translate=(0.3, 0.3), num_retries=3)(jdp)
        assert_streams_aligned(rngs)
        assert_dp_equal(out, jout, atol=0.05)
        gave_up += all(np.array_equal(a, b) for a, b in zip(out.images, orig))
        dp, jdp = datapoint(P, t=2), datapoint(J, t=2)
        dp.masks = [{1: tiny.copy()}, {1: tiny.copy()}]
        jdp.masks = [{1: tiny.copy()}, {1: tiny.copy()}]
    assert gave_up > 0  # some seeds lose the corner pixel in every tentative


def test_affine_rejects_other_interpolations():
    with pytest.raises(NotImplementedError):
        P.RandomAffine(image_interpolation="nearest")


def test_mosaic_matches_jax():
    for s in range(6):
        rngs = seed_both(s)
        got = P.RandomMosaicVideoAPI(prob=0.7, use_random_hflip=bool(s % 2))(datapoint(P, seed=s), rngs)
        want = J.RandomMosaicVideoAPI(prob=0.7, use_random_hflip=bool(s % 2))(datapoint(J, seed=s))
        assert_dp_equal(got, want, atol=1e-5)
        assert_streams_aligned(rngs)


def without_affine(mod, res):
    return mod.ComposeAPI([t for t in mod.flare_train_transforms(res).transforms
                           if not isinstance(t, mod.RandomAffine)])


def test_flare_stack_without_affine_matches_jax():
    for s in range(4):
        rngs = seed_both(s)
        got = without_affine(P, 48)(datapoint(P, seed=s, h=60, w=80), rngs)
        want = without_affine(J, 48)(datapoint(J, seed=s, h=60, w=80))
        assert_dp_equal(got, want, atol=1e-4)  # resize and blur within 1e-5, then / std
        assert_streams_aligned(rngs)


@pytest.mark.parametrize("stack", ["default_train_transforms", "flare_train_transforms"])
def test_whole_stacks_with_affine_match_jax(stack):
    for s in range(3):
        rngs = seed_both(s)
        got = getattr(P, stack)(48)(datapoint(P, seed=s, h=60, w=80), rngs)
        want = getattr(J, stack)(48)(datapoint(J, seed=s, h=60, w=80))
        assert_streams_aligned(rngs)
        for a, b in zip(got.images, want.images):
            d = np.abs(a - b)
            assert d.mean() < 2e-3 / 0.224 and d.max() <= 0.25, (stack, s, d.mean(), d.max())
        for fa, fb in zip(got.masks, want.masks):
            for k in fb:
                assert mask_iou(fa[k], fb[k]) >= 0.98


# ------------------------------------------------------------ dataset, loader
def test_vos_dataset_retries_and_collate_match_jax(npz_dir):
    """A sampler that fails at random sends both datasets to the same
    retried index, drawing it from the same stream."""

    class Flaky:
        def __init__(self, inner):
            self.inner, self.calls = inner, 0

        def sample(self, video, loader, *rest, epoch=None):
            self.calls += 1
            if self.calls % 3 == 1:
                raise RuntimeError("flaky")
            return self.inner.sample(video, loader, *rest, epoch=epoch)

    pd = P.VOSDataset(P.NPZRawDataset(npz_dir), Flaky(P.RandomUniformSampler(3, 2)), without_affine(P, 32),
                      max_num_objects=2)
    jd = J.VOSDataset(J.NPZRawDataset(npz_dir), Flaky(J.RandomUniformSampler(3, 2)), without_affine(J, 32),
                      max_num_objects=2)
    rngs = seed_both(11)
    got = [pd.get_datapoint(i, rngs) for i in (0, 4, 5)]
    want = [jd.get_datapoint(i) for i in (0, 4, 5)]
    assert_streams_aligned(rngs)
    a, b = P.collate_video_batch(got, 2), J.collate_video_batch(want, 2)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4)


def loaders(npz_dir, process_index, process_count, transforms, batch=2, **kw):
    def make(mod, tf):
        ds = mod.VOSDataset(mod.QuantumNPZRawDataset(npz_dir, require_gt_presence=False),
                            mod.RandomUniformSampler(3, 2), tf, max_num_objects=2)
        ds2 = mod.VOSDataset(mod.NPZRawDataset(npz_dir), mod.RandomUniformSampler(2, 1), tf, max_num_objects=2)
        return mod.TrainMixedVideoLoader([ds, ds2], [batch, 1], max_num_objects=2, seed=3,
                                         process_index=process_index, process_count=process_count, **kw)

    return make(P, transforms(P)), make(J, transforms(J))


@pytest.mark.parametrize("processes", [1, 2])
@pytest.mark.parametrize("with_affine", [False, True])
def test_loader_epochs_match_jax(npz_dir, processes, with_affine):
    def tf(mod):
        return mod.default_train_transforms(32) if with_affine else without_affine(mod, 32)

    counts = {0: set(), 1: set()}
    for rank in range(processes):
        pl, jl = loaders(npz_dir, rank, processes, tf)
        assert len(pl) == len(jl)
        for epoch in (0, 1):
            seed = pl.epoch_seed(epoch)
            rngs = seed_both(seed)
            got = list(pl.get_loader(epoch, rngs))
            want = list(jl.get_loader(epoch))
            assert_streams_aligned(rngs)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a["obj_valid"], b["obj_valid"])
                if with_affine:
                    assert np.abs(a["images"] - b["images"]).mean() < 2e-3 / 0.224
                    inter = (a["masks"] & b["masks"]).sum()
                    assert inter >= 0.98 * (a["masks"] | b["masks"]).sum()
                else:
                    np.testing.assert_allclose(a["images"], b["images"], rtol=0, atol=1e-4)
                    np.testing.assert_array_equal(a["masks"], b["masks"])
            # the default generators are the same as the ones handed in
            again = list(pl.get_loader(epoch))
            for a, b in zip(again, got):
                np.testing.assert_array_equal(a["images"], b["images"])
            counts[epoch].add(len(got))
    assert all(len(c) == 1 for c in counts.values())  # every process yields an epoch's number of batches


def test_mixed_epoch_order_and_repeat_factors_match_jax(npz_dir):
    for exhaustion in ("stop", "renormalize"):
        a = list(P.mixed_epoch_order([3, 5, 2], [0.2, 0.5, 0.3], np.random.default_rng(4), exhaustion))
        b = list(J.mixed_epoch_order([3, 5, 2], [0.2, 0.5, 0.3], np.random.default_rng(4), exhaustion))
        assert a == b
    pd = P.VOSDataset(P.NPZRawDataset(npz_dir), P.RandomUniformSampler(2, 1), multiplier=1.5)
    jd = J.VOSDataset(J.NPZRawDataset(npz_dir), J.RandomUniformSampler(2, 1), multiplier=1.5)
    pw, jw = P.RepeatFactorWrapper(pd, 7), J.RepeatFactorWrapper(jd, 7)
    for epoch in range(3):
        pw.set_epoch(epoch)
        jw.set_epoch(epoch)
        assert pw.indices() == jw.indices()


def test_loader_without_curriculum_forces_full_and_chunks_phases(npz_dir):
    pl, jl = loaders(npz_dir, 0, 1, lambda m: m.ComposeAPI([m.RandomResizeAPI(32), m.NormalizeAPI()]),
                     use_curriculum=False, phases_per_epoch=2)
    for epoch in (0, 1):
        got = list(pl.get_loader(epoch, seed_both(epoch)))
        want = list(jl.get_loader(epoch))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a["images"], b["images"], rtol=0, atol=1e-4)  # resize within 1e-5, / std
            np.testing.assert_array_equal(a["masks"], b["masks"])


# -------------------------------------------------------------- data sources
def rle_string(counts) -> str:
    """pycocotools' rleToString: LEB128-like 5-bit chunks, deltas past m = 2."""
    out = []
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if ch & 0x10 else (x != 0)
            out.append(chr((ch | (0x20 if more else 0)) + 48))
    return "".join(out)


def uncompressed(mask: np.ndarray) -> dict:
    """COCO's uncompressed RLE: column-major runs, the first of zeros."""
    flat = mask.T.reshape(-1).astype(np.int8)
    bounds = np.concatenate([[0], np.flatnonzero(np.diff(flat)) + 1, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": list(mask.shape), "counts": counts}


@pytest.mark.parametrize("shape", [(7, 5), (48, 64), (300, 201)])
def test_coco_rle_decoding_matches_jax(shape):
    rng = np.random.default_rng(shape[0])
    for density in (0.0, 0.3, 0.97):
        mask = rng.random(shape) < density
        mask[shape[0] // 3: shape[0] // 2, 1: shape[1] // 2] = True
        rle = uncompressed(mask)
        s = {"size": rle["size"], "counts": rle_string(rle["counts"])}
        for r in (rle, s, {**s, "counts": s["counts"].encode()}):
            got = P.decode_coco_rle(r)
            np.testing.assert_array_equal(got, J.decode_coco_rle(r))
            np.testing.assert_array_equal(got, J._decode_coco_rle_scalar(r))
        np.testing.assert_array_equal(P.decode_coco_rle(rle), mask)


@pytest.fixture
def image_data(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    h, w = 48, 64
    imgs, gts = tmp_path / "imgs", tmp_path / "gts"
    imgs.mkdir()
    gts.mkdir()
    masks = []
    for i in range(3):
        m1 = np.zeros((h, w), bool)
        m1[10 + i:30, 15:40] = True
        m2 = np.zeros((h, w), bool)
        m2[5:12, 50 - i:60] = True
        masks.append((m1, m2))
    for i in range(2):
        PIL.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(imgs / f"sa_{i}.jpg")
        annots = [{"segmentation": {"size": [h, w], "counts": rle_string(uncompressed(m)["counts"])},
                   "area": int(m.sum()), "stability_score": 0.9 + 0.05 * k} for k, m in enumerate(masks[i])]
        (gts / f"sa_{i}.json").write_text(json.dumps({"annotations": annots}))
    vid = imgs / "clip0"
    vid.mkdir()
    for f in range(4):
        PIL.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(vid / f"{f:05d}.jpg")
    frames = [[{"size": [h, w], "counts": rle_string(uncompressed(m)["counts"])} for m in masks[f % 3]]
              for f in range(4)]
    frames[2][1] = None
    (gts / "clip0_manual.json").write_text(json.dumps({"masklet": frames, "fps": 24}))
    return str(imgs), str(gts)


def test_sa1b_and_json_datasets_match_jax(image_data):
    imgs, gts = image_data
    for kw in ({}, {"uncertain_iou": 0.92}, {"mask_area_frac_thresh": 0.1}):
        p, j = P.SA1BRawDataset(imgs, gts, **kw), J.SA1BRawDataset(imgs, gts, **kw)
        assert sorted(p.video_names) == sorted(j.video_names)
        for idx in range(len(p)):
            (pv, pl), (jv, jl) = p.get_video(idx), j.get_video(idx)
            assert (pv.video_name, pv.video_id) == (jv.video_name, jv.video_id)
            np.testing.assert_array_equal(pv.frames[0].data, jv.frames[0].data)
            a, b = pl.load(0), jl.load(0)
            assert list(a) == list(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    p, j = P.JSONRawDataset(imgs, gts, file_list_txt=None), J.JSONRawDataset(imgs, gts, file_list_txt=None)
    p.video_names = j.video_names = ["clip0"]
    (pv, pl), (jv, jl) = p.get_video(0), j.get_video(0)
    assert [f.frame_idx for f in pv.frames] == [f.frame_idx for f in jv.frames]
    for a, b in zip(pv.frames, jv.frames):
        np.testing.assert_array_equal(a.data, b.data)
    for f in range(4):
        a, b = pl.load(f), jl.load(f)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert pl.get_valid_obj_frames_ids() == jl.get_valid_obj_frames_ids()


def test_png_datasets_match_jax(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(2)
    (tmp_path / "img" / "v0").mkdir(parents=True)
    (tmp_path / "gt" / "v0").mkdir(parents=True)
    for f in range(3):
        PIL.fromarray((rng.random((20, 24, 3)) * 255).astype(np.uint8)).save(tmp_path / "img" / "v0" / f"{f:05d}.jpg")
        lab = np.zeros((20, 24), np.uint8)
        lab[2:9, 3:12] = 1
        lab[10:18, 12 + f:20] = 2
        PIL.fromarray(lab).save(tmp_path / "gt" / "v0" / f"{f:05d}.png")
        for o in (0, 1):
            d = tmp_path / "multi" / str(o)
            d.mkdir(parents=True, exist_ok=True)
            PIL.fromarray(((lab == o + 1) * 255).astype(np.uint8)).save(d / f"{f:05d}.png")
    p = P.PNGRawDataset(str(tmp_path / "img"), str(tmp_path / "gt"))
    j = J.PNGRawDataset(str(tmp_path / "img"), str(tmp_path / "gt"))
    (pv, pl), (jv, jl) = p.get_video(0), j.get_video(0)
    for a, b in zip(pv.frames, jv.frames):
        np.testing.assert_array_equal(a.data, b.data)
    pm, jm = P.MultiplePNGSegmentLoader(str(tmp_path / "multi")), J.MultiplePNGSegmentLoader(str(tmp_path / "multi"))
    for f in range(3):
        for a, b in ((pl.load(f), jl.load(f)), (pm.load(f), jm.load(f))):
            assert list(a) == list(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------------ no cv2
def test_the_port_needs_no_cv2(npz_dir, monkeypatch):
    """With cv2 hidden from sys.modules the port's module imports and gives
    the same batches (every transform ran: the affine, the blur and the
    mosaic have no branch that skips them)."""
    def batches():
        pl, _ = loaders(npz_dir, 0, 1, lambda m: m.ComposeAPI(
            list(m.flare_train_transforms(32).transforms) + [m.RandomMosaicVideoAPI(prob=0.5)]))
        return list(pl.get_loader(0))

    with_cv2 = batches()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        importlib.import_module("cv2")
    importlib.reload(P)
    try:
        assert "cv2" not in vars(P)
        without = batches()
    finally:
        monkeypatch.undo()
        importlib.reload(P)
    assert len(with_cv2) == len(without)
    for a, b in zip(with_cv2, without):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # and the affine ran: the first frames moved
    rngs = P.make_rngs(0)
    dp = datapoint(P, seed=0)
    before = dp.images[0].copy()
    assert not np.array_equal(P.RandomAffine()(dp, rngs).images[0], before)
