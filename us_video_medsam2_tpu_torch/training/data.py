"""Video-segmentation data pipeline (host-side, numpy and PyTorch on the CPU).

Counterpart of the JAX package's ``training/data.py``, class for class: the
reference's dataset stack (SURVEY §2.2):
- raw video datasets over NPZ medical videos (`imgs` [T,H,W] uint8 grayscale,
  `gts` [T,H,W] int labels) and PNG-annotated folders
  (reference training/dataset/vos_raw_dataset.py:1040-1115, 196-287)
- curriculum variants: first-frame-entropy stage filtering (QuantumNPZRawDataset,
  vos_raw_dataset.py:746-894 — the one wired into the shipped configs),
  entropy-ordered (AES, 470-636) and temporal-FFT-ordered (NeuroSpectral, 638-744)
- RandomUniformSampler / EvalSampler (vos_sampler.py:31-105)
- video-consistent augmentations (transforms.py: hflip, affine w/ visibility
  retry, square resize, color jitter consistent/per-frame, grayscale, gaussian
  noise/blur for the FLARE config)
- repeat-factor oversampling (dataset/utils.py:42-104), probability-mixed
  multi-dataset loading with per-host sharding, phases_per_epoch chunking and
  the curriculum stage hook (sam2_datasets.py:19-135, 88-118)

Output batches are host numpy arrays, as in the JAX package: images
[T, B, S, S, 3] float32 (ImageNet-normalized), masks [T, B, O, S, S] bool
with padded object slots and an obj_valid [B, O] mask; the trainer copies
them to the card.

Three departures from the JAX module:

- no ``cv2``: the warp is ``F.grid_sample`` on CPU tensors (the image
  bicubic or bilinear with its fill blended through a warped ones-channel,
  as torchvision does; the masks nearest, rounding as cv2 does), the resize
  ``F.interpolate`` (bilinear without antialias, and nearest, which indexes
  as cv2's INTER_NEAREST), the blur a separable kernel made as
  ``cv2.getGaussianKernel`` makes it with reflect-101 padding. Nothing is
  skipped where the JAX transforms return early without ``cv2``;
- explicit random generators: every transform, sampler and retry draws
  from the ``Rngs`` it is handed (a ``random.Random`` and a
  ``np.random.RandomState``), making the calls the JAX module makes on the
  global ``random`` and ``np.random`` in the same order, so a port seeded
  with s yields the JAX module's batches when its globals are seeded with
  s; the loader seeds them from its seed, the epoch and the process index;
- ``NPZRawDataset`` reads through ``training/native_npz.py::load_npz``
  (numpy unless ``UVMS2_NATIVE_NPZ=1``).

PIL is imported only where PNG / JPEG frames are read.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import random
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from us_video_medsam2_tpu_torch.training.native_npz import PrefetchingNPZLoader, load_npz

IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)
MAX_RETRIES = 100


class Rngs(NamedTuple):
    """The two generators a datapoint draws from: ``py`` where the JAX module
    calls the global ``random``, ``np`` where it calls ``np.random``."""

    py: random.Random
    np: np.random.RandomState


def make_rngs(seed: int) -> Rngs:
    """Generators in the states ``random.seed(seed)`` and
    ``np.random.seed(seed % 2**32)`` give the globals."""
    return Rngs(random.Random(seed), np.random.RandomState(seed % 2**32))


# --------------------------------------------------------------------- records
@dataclasses.dataclass
class VOSFrame:
    frame_idx: int
    data: np.ndarray  # [H, W, 3] float32 in [0, 1]


@dataclasses.dataclass
class VOSVideo:
    video_name: str
    video_id: int
    frames: List[VOSFrame]


class NPZSegmentLoader:
    """Per-frame {obj_id: [H, W] bool} from an in-memory label array
    (reference vos_segment_loader.py:304-320)."""

    def __init__(self, masks: np.ndarray):
        self.masks = masks

    def load(self, frame_idx: int) -> Dict[int, np.ndarray]:
        m = self.masks[frame_idx]
        return {int(i): m == i for i in np.unique(m) if i != 0}


class PalettePNGSegmentLoader:
    """Palettised PNG masks <video>/<frame:05d>.png (reference vos_segment_loader.py:103-150)."""

    def __init__(self, video_png_root: str):
        self.root = video_png_root
        self.frame_id_to_png = {
            int(os.path.splitext(p)[0]): os.path.join(video_png_root, p)
            for p in os.listdir(video_png_root)
            if p.endswith(".png")
        }

    def load(self, frame_idx: int) -> Dict[int, np.ndarray]:
        from PIL import Image

        m = np.array(Image.open(self.frame_id_to_png[frame_idx]))
        return {int(i): m == i for i in np.unique(m) if i != 0}


# ----------------------------------------------------------------- raw datasets
class VOSRawDataset:
    def get_video(self, idx: int, rngs: Optional[Rngs] = None) -> Tuple[VOSVideo, object]:
        """The video and its segment loader; ``rngs`` for a dataset that draws."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def set_epoch(self, epoch: int) -> None:  # curriculum hook
        pass


class NPZRawDataset(VOSRawDataset):
    """NPZ folder dataset (reference vos_raw_dataset.py:1040-1115; grayscale ->
    3-channel repeat, optional frame subsampling/truncation)."""

    def __init__(
        self,
        folder: str,
        file_list_txt: Optional[str] = None,
        excluded_videos_list_txt: Optional[str] = None,
        sample_rate: int = 1,
        truncate_video: int = -1,
        require_gt_presence: bool = False,
        prefetch_workers: int = 0,
        prefetch_ahead: int = 4,
    ):
        self.folder = folder
        self.sample_rate = sample_rate
        self.truncate_video = truncate_video
        # opt-in read-ahead on a thread pool (training/native_npz.py: the
        # C++ reader when UVMS2_NATIVE_NPZ=1 releases the GIL while it inflates)
        self._prefetcher = None
        self._prefetch_ahead = prefetch_ahead
        if prefetch_workers > 0:
            self._prefetcher = PrefetchingNPZLoader(
                num_workers=prefetch_workers, ahead=prefetch_ahead
            )

        subset = []
        for root, _, files in os.walk(folder):
            for f in files:
                if f.endswith(".npz"):
                    rel = os.path.relpath(os.path.join(root, f), folder)
                    subset.append(os.path.splitext(rel)[0])
        if file_list_txt is not None:
            with open(file_list_txt) as f:
                keep = {line.strip() for line in f}
            subset = [v for v in subset if v in keep]
        excluded = set()
        if excluded_videos_list_txt is not None:
            with open(excluded_videos_list_txt) as f:
                excluded = {os.path.splitext(line.strip())[0] for line in f}
        self.video_names = sorted(v for v in subset if v not in excluded)
        if require_gt_presence:
            # keep only videos whose first frame has ≥1 labeled object
            # (reference NPZRawDataset GT-presence variant, vos_raw_dataset.py:365-454)
            kept = []
            for v in self.video_names:
                try:
                    gts = load_npz(os.path.join(folder, f"{v}.npz"), ["gts"])["gts"]
                    if (gts != 0).any():
                        kept.append(v)
                except Exception as e:  # noqa: BLE001
                    logging.warning("skipping %s: %s", v, e)
            self.video_names = kept

    def _load_npz(self, video_name: str):
        path = os.path.join(self.folder, f"{video_name}.npz")
        if self._prefetcher is not None:
            data = self._prefetcher.get(path)
        else:
            data = load_npz(path, ["imgs", "gts"])
        frames = data["imgs"].astype(np.float32) / 255.0  # [T, H, W]
        if frames.ndim == 3:
            frames = np.repeat(frames[..., None], 3, axis=-1)
        masks = data["gts"]
        if self.truncate_video > 0:
            frames = frames[: self.truncate_video]
            masks = masks[: self.truncate_video]
        # frames are subsampled but masks stay at full temporal resolution:
        # VOSFrame.frame_idx keeps ORIGINAL indices and NPZSegmentLoader.load()
        # indexes by them, so striding the masks too would pair frame k with
        # mask k*sample_rate (and overrun past T/sample_rate).
        return frames[:: self.sample_rate], masks

    def get_video(self, idx: int, rngs: Optional[Rngs] = None):
        name = self.video_names[idx]
        if self._prefetcher is not None:
            # read-ahead in dataset order (samplers are near-sequential within
            # an epoch shard; unscheduled paths just load synchronously)
            for j in range(idx + 1, min(idx + 1 + self._prefetch_ahead, len(self))):
                self._prefetcher.schedule(
                    os.path.join(self.folder, f"{self.video_names[j]}.npz")
                )
        frames, masks = self._load_npz(name)
        vos_frames = [
            VOSFrame(i * self.sample_rate, data=frames[i]) for i in range(len(frames))
        ]
        return VOSVideo(name, idx, vos_frames), NPZSegmentLoader(masks)

    def __len__(self):
        return len(self.video_names)


def _first_frame_entropy(folder: str, video_name: str) -> float:
    with np.load(os.path.join(folder, f"{video_name}.npz")) as data:
        img0 = data["imgs"][0]
    if img0.ndim == 3:
        img0 = img0.mean(axis=-1)
    hist, _ = np.histogram(img0.ravel(), bins=32)
    prob = hist / (hist.sum() + 1e-8)
    return float(-np.sum(prob * np.log(prob + 1e-10)))


class QuantumNPZRawDataset(NPZRawDataset):
    """Entropy-staged curriculum: dense (<2.5) -> expand (<3.5) -> full, with a
    5-video floor (reference vos_raw_dataset.py:746-894 — wired in
    GFTE_3.yaml:221; parent init always GT-filters, :764-771).

    Faithful quirk (cross-checked against the reference class on a synthetic
    corpus, tests/fixtures/curriculum_quantum.json): the reference filter is
    DESTRUCTIVE — `_apply_curriculum_filter` narrows `self.video_names` in
    place and the full stage returns early, so later stages can only keep
    survivors of the dense filter; the pool never grows back (:833-864). Pass
    `refilter_from_all=True` for the intended monotone curriculum (each stage
    re-filters the complete GT-filtered list); the default replays the
    reference exactly.
    """

    def __init__(
        self,
        folder: str,
        milestones: Optional[Dict[str, int]] = None,
        refilter_from_all: bool = False,
        **kw,
    ):
        kw.setdefault("require_gt_presence", True)
        super().__init__(folder, **kw)
        self.milestones = milestones or {"expand": 20, "full": 50}
        self.all_video_names = list(self.video_names)
        self.refilter_from_all = refilter_from_all
        self.stage = "dense"
        self._apply_filter()

    def set_epoch(self, epoch: int):
        if epoch >= self.milestones.get("full", 50):
            stage = "full"
        elif epoch >= self.milestones.get("expand", 20):
            stage = "expand"
        else:
            stage = "dense"
        if stage != self.stage:
            self.stage = stage
            self._apply_filter()

    def force_stage(self, stage: str):
        self.stage = stage
        self._apply_filter()

    def _apply_filter(self):
        if self.stage == "full":
            if self.refilter_from_all:
                self.video_names = sorted(self.all_video_names)
            return  # reference :833-834 — keeps the current (narrowed) list
        base = self.all_video_names if self.refilter_from_all else self.video_names
        thresh = 2.5 if self.stage == "dense" else 3.5
        filtered = []
        for v in base:
            try:
                if _first_frame_entropy(self.folder, v) < thresh:
                    filtered.append(v)
            except Exception as e:  # noqa: BLE001
                logging.warning("[QuantumNPZRawDataset] skip %s: %s", v, e)
        if len(filtered) < 5:
            filtered = base[: min(10, len(base))]  # reference :861-862
        self.video_names = sorted(filtered)


def _euler_number_2d(mask: np.ndarray, connectivity: int = 2) -> int:
    """2D Euler number via Gray's bit-quad counts — the same quantity
    skimage.measure.euler_number computes (skimage is not in this image, so
    this replicates the published formula: S.B. Gray 1971; 4-conn
    E = (Q1 - Q3 + 2*Qd)/4, 8-conn E = (Q1 - Q3 - 2*Qd)/4)."""
    m = np.pad((np.asarray(mask) != 0).astype(np.int8), 1)
    a = m[:-1, :-1]
    b = m[:-1, 1:]
    c = m[1:, :-1]
    d = m[1:, 1:]
    s = a + b + c + d
    q1 = int(np.sum(s == 1))
    q3 = int(np.sum(s == 3))
    qd = int(np.sum((s == 2) & (a == d)))  # diagonal pairs {a,d} or {b,c}
    if connectivity == 1:
        return (q1 - q3 + 2 * qd) // 4
    return (q1 - q3 - 2 * qd) // 4


def _perimeter_2d(mask: np.ndarray) -> float:
    """Perimeter exactly matching skimage.measure.perimeter(neighbourhood=4),
    the function the reference calls (sam2_datasets.py:1019). skimage's
    published algorithm: erode with the 4-connected cross (border_value=0, so
    the image edge counts as background), take border = mask - eroded, code
    each border pixel as 1 + 2*(# 4-neighbor border px) + 10*(# diagonal
    border px), and weight codes {5,7,15,17,25,27}->1, {21,33}->sqrt(2),
    {13,23}->(1+sqrt(2))/2 (all other codes 0 — e.g. an isolated pixel has
    code 1 and contributes nothing). Hand-computed truth table:
    tests/test_data_pipeline.py::TestMaskComplexityTruthTable."""
    m = np.pad((np.asarray(mask) != 0), 1)
    core = m[1:-1, 1:-1]
    eroded = core & m[:-2, 1:-1] & m[2:, 1:-1] & m[1:-1, :-2] & m[1:-1, 2:]
    b = np.pad(core & ~eroded, 1).astype(np.int32)
    code = (
        b[1:-1, 1:-1]
        + 2 * (b[:-2, 1:-1] + b[2:, 1:-1] + b[1:-1, :-2] + b[1:-1, 2:])
        + 10 * (b[:-2, :-2] + b[:-2, 2:] + b[2:, :-2] + b[2:, 2:])
    ) * b[1:-1, 1:-1]  # even codes (non-border px) all weigh 0 anyway
    weights = np.zeros(50)
    weights[[5, 7, 15, 17, 25, 27]] = 1.0
    weights[[21, 33]] = np.sqrt(2.0)
    weights[[13, 23]] = (1.0 + np.sqrt(2.0)) / 2.0
    return float(weights[code].sum())


class AESCurriculumNPZRawDataset(VOSRawDataset):
    """Adaptive Entropy Sampling curriculum — faithful port of reference
    vos_raw_dataset.py:470-636. Per stage it (re)lists `<folder>/<stage>/`
    (falling back to the flat folder), scores each video as
    (image_entropy + mask_complexity)/2 and keeps those under the stage
    threshold (dense < 0.3·af, expand < 0.6·af, full = all; the adaptive
    factor af moves with training loss, :505-516).

    Faithful quirks: the image entropy histogram uses range=(0, 1) (:583),
    so uint8 [0, 255] corpora score ~0 and the filter passes everything —
    the curriculum only discriminates on [0, 1]-normalized NPZs; frame
    scaling divides by 255 only `if frames.max() > 1.0` (:617). The mask
    complexity term uses numpy ports of skimage's perimeter/euler_number
    (skimage is not installed here; formulas above)."""

    def __init__(
        self,
        folder: str,
        milestones: Optional[Dict[str, int]] = None,
        entropy_threshold: float = 0.7,
        sample_rate: int = 1,
        truncate_video: int = -1,
        **kw,
    ):
        self.folder = folder
        self.milestones = milestones or {"expand": 20, "full": 50}
        self.entropy_threshold = entropy_threshold
        self.sample_rate = sample_rate
        self.truncate_video = truncate_video
        self.stage = "dense"
        self.adaptive_factor = 1.0
        self.video_names: list = []
        self.sample_entropies: Dict[str, float] = {}
        self._load_stage_data("dense")

    def set_epoch(self, epoch: int, training_loss: Optional[float] = None):
        target = "dense"
        if epoch >= self.milestones.get("full", 50):
            target = "full"
        elif epoch >= self.milestones.get("expand", 20):
            target = "expand"
        if training_loss is not None:  # reference :512-516
            if training_loss < 0.1:
                self.adaptive_factor = min(2.0, self.adaptive_factor * 1.05)
            else:
                self.adaptive_factor = max(0.5, self.adaptive_factor * 0.95)
        if target != self.stage:
            self._load_stage_data(target)

    def _stage_dir(self) -> str:
        target = os.path.join(self.folder, self.stage)
        return target if os.path.exists(target) else self.folder

    def _load_stage_data(self, stage: str):
        self.stage = stage
        self.video_names = []
        self.sample_entropies.clear()
        target_path = self._stage_dir()
        if not os.path.exists(target_path):
            return
        for fname in sorted(os.listdir(target_path)):
            if not fname.endswith(".npz"):
                continue
            try:
                data = np.load(os.path.join(target_path, fname), allow_pickle=True)
                imgs = data["imgs"]
                masks = data["gts"] if "gts" in data else data["masks"]
                if len(imgs) == 0:
                    continue
                total = (
                    self._image_entropy(imgs[0]) + self._mask_complexity(masks[0])
                ) / 2.0
                self.sample_entropies[fname] = total
                if self._entropy_filter(total):
                    self.video_names.append(os.path.splitext(fname)[0])
            except Exception as e:  # noqa: BLE001
                logging.warning("[AES-CL] failed loading %s: %s", fname, e)

    def _entropy_filter(self, entropy: float) -> bool:
        if self.stage == "dense":
            return entropy < 0.3 * self.adaptive_factor
        if self.stage == "expand":
            return entropy < 0.6 * self.adaptive_factor
        return True

    @staticmethod
    def _image_entropy(image: np.ndarray) -> float:
        if image.ndim == 3:
            image = np.mean(image, axis=2)
        hist, _ = np.histogram(image.flatten(), bins=32, range=(0, 1))
        prob = hist / (hist.sum() + 1e-10)
        return float(-np.sum(prob * np.log2(prob + 1e-10))) / 5.0

    @staticmethod
    def _mask_complexity(mask: np.ndarray) -> float:
        if np.sum(mask) == 0:
            return 0.0
        area = np.sum(mask)
        complexity = _perimeter_2d(mask) / (area + 1e-10) * 0.1 + abs(
            _euler_number_2d(mask)
        ) * 0.1
        return float(min(complexity, 1.0))

    def __len__(self):
        return len(self.video_names)

    def get_video(self, idx: int, rngs: Optional[Rngs] = None):
        name = self.video_names[idx]
        path = os.path.join(self.folder, self.stage, f"{name}.npz")
        if not os.path.exists(path):
            path = os.path.join(self.folder, f"{name}.npz")
        data = np.load(path, allow_pickle=True)
        frames = data["imgs"]
        masks = data["gts"] if "gts" in data else data["masks"]
        if frames.max() > 1.0:  # reference :617 — conditional scaling
            frames = frames / 255.0
        frames = frames.astype(np.float32)
        if frames.ndim == 3:
            frames = np.repeat(frames[..., None], 3, axis=-1)
        if self.truncate_video > 0:
            frames = frames[: self.truncate_video]
            masks = masks[: self.truncate_video]
        frames = frames[:: self.sample_rate]
        vos_frames = [
            VOSFrame(i * self.sample_rate, data=frames[i]) for i in range(len(frames))
        ]
        return VOSVideo(name, idx, vos_frames), NPZSegmentLoader(masks)


class NeuroSpectralNPZRawDataset(NPZRawDataset):
    """Temporal-FFT difficulty ordering — faithful port of reference
    vos_raw_dataset.py:638-744: per video, the frame-mean intensity signal's
    full FFT magnitude is split at T/4 (DC included in the 'low' band,
    :697-700); score = mean(high)/(mean(low)+1e-6). Videos sort ascending and
    stages keep the easiest 30% / 60% / 100% (min 1, :735-744 — re-sliced
    from the full sorted list each stage, unlike the Quantum filter). Parent
    listing GT-filters like the reference's (:653-658)."""

    def __init__(self, folder: str, milestones: Optional[Dict[str, int]] = None, **kw):
        kw.setdefault("require_gt_presence", True)
        super().__init__(folder, **kw)
        self.milestones = milestones or {"expand": 20, "full": 50}
        self.stage = "dense"
        scores = {}
        for v in self.video_names:
            try:
                imgs = np.load(
                    os.path.join(folder, f"{v}.npz"), allow_pickle=True
                )["imgs"]
                gray = np.mean(imgs, axis=tuple(range(1, imgs.ndim)))
                mag = np.abs(np.fft.fft(gray))
                low = np.mean(mag[: len(mag) // 4])
                high = np.mean(mag[len(mag) // 4 :])
                scores[v] = float(high / (low + 1e-6))
            except Exception as e:  # noqa: BLE001
                logging.warning("[NeuroSpectral] FFT failed: %s | %s", v, e)
                scores[v] = 1.0
        self.video_scores = scores
        self.sorted_videos = sorted(scores.keys(), key=lambda k: scores[k])
        self._apply_stage_filter()

    def set_epoch(self, epoch: int):
        target = "dense"
        if epoch >= self.milestones.get("full", 50):
            target = "full"
        elif epoch >= self.milestones.get("expand", 20):
            target = "expand"
        if target != self.stage:
            self.stage = target
            self._apply_stage_filter()

    def _apply_stage_filter(self):
        n = len(self.sorted_videos)
        if self.stage == "dense":
            keep = int(0.3 * n)
        elif self.stage == "expand":
            keep = int(0.6 * n)
        else:
            keep = n
        self.video_names = self.sorted_videos[: max(1, keep)]


class MedSAM2CurriculumDataset:
    """Progressive stage-directory curriculum over NPZ videos (reference
    vos_raw_dataset.py:70-92 — that class is truncated upstream: it defines
    only the stage loader; the runnable variant is MedSAM2CurriculumDataset2,
    whose machinery both share, :98-194).

    Layout: <folder>/<stage>/uterine_niche/*.npz (fallback <folder>/<stage>);
    stages dense -> expand -> full switch at the epoch `milestones`
    ({"expand": 20, "full": 50} defaults). Per-item semantics:
      - dense: first frame only (static-feature warm-up)
      - expand: every `temporal_stride`-th frame (deterministic here;
        stochastic jittering is the subclass's addition)
      - full: all frames
    Items are dicts with NHWC float images (the torch reference transposes to
    NCHW, :183-185 — NHWC is this framework's layout invariant), float masks,
    video_id, num_frames. Load failures fall through to the next index
    (reference :190-194)."""

    use_stochastic = False

    def __init__(self, folder: str, milestones: Optional[Dict[str, int]] = None, seed: int = 0, **kw):
        self.rng = random.Random(seed)  # the stochastic jitter's draws (JAX: the global random)
        self.base_folder = folder
        self.milestones = dict(milestones or {})
        self.stage = "dense"
        self.temporal_stride = 1
        self.samples: List[str] = []
        self.target_path = folder
        self._load_stage_data("dense")

    def _load_stage_data(self, stage: str):
        self.stage = stage
        self.target_path = os.path.join(self.base_folder, stage, "uterine_niche")
        if not os.path.exists(self.target_path):
            self.target_path = os.path.join(self.base_folder, stage)
        if os.path.exists(self.target_path):
            self.samples = sorted(
                f for f in os.listdir(self.target_path) if f.endswith(".npz")
            )
        else:
            self.samples = []
        logging.info(
            "[MedSAM2Curriculum] stage=%s samples=%d", stage, len(self.samples)
        )

    def update_curriculum_stage(self, epoch: int) -> bool:
        """Epoch-driven stage switch; True when the stage changed (reference
        :131-140)."""
        target = "dense"
        if epoch >= self.milestones.get("full", 50):
            target = "full"
        elif epoch >= self.milestones.get("expand", 20):
            target = "expand"
        if target != self.stage:
            self._load_stage_data(target)
            return True
        return False

    def _sample_indices(self, t: int) -> List[int]:
        if self.stage == "dense":
            return [0]
        if self.stage == "expand" and self.temporal_stride > 1:
            if self.use_stochastic:
                # Stochastic Temporal Jittering (reference :160-171): one frame
                # uniformly from each stride window [i, i+stride), clamped —
                # non-uniform sampling suppresses temporal aliasing
                return [
                    min(i + int(self.rng.randrange(self.temporal_stride)), t - 1)
                    for i in range(0, t, self.temporal_stride)
                ]
            return list(range(0, t, self.temporal_stride))
        return list(range(t))

    def __getitem__(self, idx: int):
        if not self.samples:
            return None
        name = self.samples[idx]
        path = os.path.join(self.target_path, name)
        try:
            data = np.load(path, allow_pickle=True)
            imgs = np.asarray(data["imgs"])  # (T, H, W, 3) or (T, H, W)
            masks = np.asarray(data["masks"] if "masks" in data else data["gts"])
            sel = self._sample_indices(len(imgs))
            imgs = imgs[sel]
            masks = masks[sel]
            if imgs.ndim == 3:
                imgs = np.repeat(imgs[..., None], 3, axis=-1)
            return {
                "video_id": name[: -len(".npz")],
                "images": imgs.astype(np.float32),
                "masks": masks.astype(np.float32),
                "num_frames": len(imgs),
            }
        except Exception as e:  # noqa: BLE001
            logging.error("error loading %s: %s", path, e)
            return self[(idx + 1) % len(self.samples)]

    def __len__(self):
        return len(self.samples)


class MedSAM2CurriculumDataset2(MedSAM2CurriculumDataset):
    """The stochastic-temporal-jittering variant (reference
    vos_raw_dataset.py:98-194): identical staging, but 'expand' picks one
    frame uniformly at random from each stride window instead of the fixed
    window start."""

    use_stochastic = True


class PNGRawDataset(VOSRawDataset):
    """JPEG frames + palettised PNG masks per video folder
    (reference vos_raw_dataset.py:196-287)."""

    def __init__(
        self,
        img_folder: str,
        gt_folder: str,
        file_list_txt: Optional[str] = None,
        sample_rate: int = 1,
        truncate_video: int = -1,
    ):
        self.img_folder = img_folder
        self.gt_folder = gt_folder
        self.sample_rate = sample_rate
        self.truncate_video = truncate_video
        if file_list_txt is not None:
            with open(file_list_txt) as f:
                self.video_names = sorted(line.strip() for line in f if line.strip())
        else:
            self.video_names = sorted(os.listdir(img_folder))

    def get_video(self, idx: int, rngs: Optional[Rngs] = None):
        from PIL import Image

        name = self.video_names[idx]
        vdir = os.path.join(self.img_folder, name)
        files = sorted(f for f in os.listdir(vdir) if f.endswith((".jpg", ".jpeg", ".png")))
        if self.truncate_video > 0:
            files = files[: self.truncate_video]
        frames = []
        for i, f in enumerate(files[:: self.sample_rate]):
            img = np.asarray(Image.open(os.path.join(vdir, f)).convert("RGB"), np.float32)
            frames.append(VOSFrame(i * self.sample_rate, data=img / 255.0))
        loader = PalettePNGSegmentLoader(os.path.join(self.gt_folder, name))
        return VOSVideo(name, idx, frames), loader

    def __len__(self):
        return len(self.video_names)


# -------------------------------------------------------------------- samplers
@dataclasses.dataclass
class SampledFramesAndObjects:
    frames: List[VOSFrame]
    object_ids: List[int]


class RandomUniformSampler:
    """Random contiguous window whose first frame has ≥1 visible object
    (reference vos_sampler.py:31-78)."""

    def __init__(self, num_frames: int, max_num_objects: int, reverse_time_prob: float = 0.0):
        self.num_frames = num_frames
        self.max_num_objects = max_num_objects
        self.reverse_time_prob = reverse_time_prob

    def sample(self, video: VOSVideo, segment_loader, rngs: Rngs, epoch=None):
        if len(video.frames) < self.num_frames:
            raise ValueError(
                f"cannot sample {self.num_frames} frames from {video.video_name}"
            )
        for retry in range(1000):
            start = rngs.py.randrange(0, len(video.frames) - self.num_frames + 1)
            frames = [video.frames[start + s] for s in range(self.num_frames)]
            if rngs.py.uniform(0, 1) < self.reverse_time_prob:
                frames = frames[::-1]
            visible = [
                oid
                for oid, seg in segment_loader.load(frames[0].frame_idx).items()
                if seg.sum()
            ]
            if visible:
                break
        else:
            raise RuntimeError("no visible objects")
        object_ids = rngs.py.sample(visible, min(len(visible), self.max_num_objects))
        return SampledFramesAndObjects(frames=frames, object_ids=object_ids)


class EvalSampler:
    """All frames, all first-frame objects (reference vos_sampler.py:81-105)."""

    def sample(self, video: VOSVideo, segment_loader, rngs: Optional[Rngs] = None, epoch=None):
        frames = sorted(video.frames, key=lambda x: x.frame_idx)
        object_ids = list(segment_loader.load(frames[0].frame_idx).keys())
        if not object_ids:
            raise ValueError("first frame has no objects")
        return SampledFramesAndObjects(frames=frames, object_ids=object_ids)


# ------------------------------------------------------------------ transforms
class VideoDatapoint:
    def __init__(self, images: List[np.ndarray], masks: List[Dict[int, np.ndarray]]):
        self.images = images  # [H, W, 3] float32 per frame
        self.masks = masks  # {obj_id: [H, W] bool} per frame


class RandomHorizontalFlip:
    def __init__(self, consistent_transform=True, p=0.5):
        self.p = p

    def __call__(self, dp: VideoDatapoint, rngs: Rngs) -> VideoDatapoint:
        if rngs.py.random() < self.p:
            dp.images = [img[:, ::-1] for img in dp.images]
            dp.masks = [
                {k: m[:, ::-1] for k, m in frame.items()} for frame in dp.masks
            ]
        return dp


class RandomVerticalFlip:
    """(reference transforms.py:148-163; used by the shipped FLARE configs,
    efficientmedsam_s_512_FLARE_RECIST.yaml:26)"""

    def __init__(self, consistent_transform=True, p=0.5):
        self.p = p

    def __call__(self, dp: VideoDatapoint, rngs: Rngs) -> VideoDatapoint:
        if rngs.py.random() < self.p:
            dp.images = [img[::-1] for img in dp.images]
            dp.masks = [
                {k: m[::-1] for k, m in frame.items()} for frame in dp.masks
            ]
        return dp


def affine_get_params(degrees, translate, scale_ranges, shears, img_size, rng: random.Random):
    """Sample (angle, (tx, ty), scale, (shear_x, shear_y)) with torchvision
    T.RandomAffine.get_params semantics (the reference samples through it,
    transforms.py:390-412): translate fractions scale by image size and round
    to INTEGER pixels; a scalar shear range means x-shear only. Draws from ``rng``."""
    angle = rng.uniform(degrees[0], degrees[1])
    tx = ty = 0
    if translate is not None:
        max_dx = float(translate[0]) * img_size[0]
        max_dy = float(translate[1]) * img_size[1]
        tx = int(round(rng.uniform(-max_dx, max_dx)))
        ty = int(round(rng.uniform(-max_dy, max_dy)))
    scale = rng.uniform(scale_ranges[0], scale_ranges[1]) if scale_ranges else 1.0
    shear_x = shear_y = 0.0
    if shears is not None:
        shear_x = rng.uniform(shears[0], shears[1])
        if len(shears) == 4:
            shear_y = rng.uniform(shears[2], shears[3])
    return angle, (tx, ty), scale, (shear_x, shear_y)


def affine_inverse_matrix(center, angle, translate, scale, shear):
    """torchvision's inverse affine matrix (output->input mapping;
    torchvision.transforms.functional._get_inverse_affine_matrix with
    inverted=True): rotation/scale/shear about `center`, then translation.
    Returned as a 2x3 matrix in pixel-centre coordinates (cv2.warpAffine's
    WARP_INVERSE_MAP form), which ``warp_affine`` samples with."""
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    cx, cy = center
    tx, ty = translate
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = [d / scale, -b / scale, 0.0, -c / scale, a / scale, 0.0]
    m[2] += m[0] * (-cx - tx) + m[1] * (-cy - ty)
    m[5] += m[3] * (-cx - tx) + m[4] * (-cy - ty)
    m[2] += cx
    m[5] += cy
    return np.asarray(m, np.float64).reshape(2, 3)


def _hwc(img: np.ndarray) -> torch.Tensor:
    """[H, W] or [H, W, C] numpy -> [1, C, H, W] f32 tensor (a view where it can)."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    return (t[None, None] if t.dim() == 2 else t.permute(2, 0, 1)[None])


def _to_hwc(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    out = t[0].permute(1, 2, 0) if like.ndim == 3 else t[0, 0]
    return np.ascontiguousarray(out.numpy())


def _source_coords(m: np.ndarray, h: int, w: int):
    """Each output pixel's source (x, y), f64 [H, W], under the 2x3 inverse
    matrix ``m`` in pixel-centre coordinates."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64), torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    m = torch.from_numpy(np.asarray(m, np.float64))
    return m[0, 0] * xs + m[0, 1] * ys + m[0, 2], m[1, 0] * xs + m[1, 1] * ys + m[1, 2]


def warp_affine(img: np.ndarray, m: np.ndarray, mode: str, fill) -> np.ndarray:
    """``img`` [H, W, C] f32 warped by the inverse matrix ``m`` (cv2.warpAffine
    with WARP_INVERSE_MAP and a constant border ``fill``): ``F.grid_sample``
    ("bicubic" or "bilinear", zeros outside, align_corners=True so that -1
    and 1 are the outer pixel centres), the fill blended in through a warped
    ones-channel as torchvision's ``_apply_grid_transform`` does: with the
    sampling weights w, sum(w·x inside) + fill·(1 - sum(w inside)), which is
    the constant border's result for any linear interpolation."""
    h, w = img.shape[:2]
    sx, sy = _source_coords(m, h, w)
    grid = torch.stack([2 * sx / max(w - 1, 1) - 1, 2 * sy / max(h - 1, 1) - 1], -1)[None].float()
    x = _hwc(img)
    x = torch.cat([x, torch.ones_like(x[:, :1])], 1)
    out = F.grid_sample(x, grid, mode=mode, padding_mode="zeros", align_corners=True)
    inside = out[:, -1:]
    fill_t = torch.as_tensor(fill, dtype=torch.float32).reshape(1, -1, 1, 1)
    return _to_hwc(out[:, :-1] + (1.0 - inside) * fill_t, img)


def warp_mask_nearest(mask: np.ndarray, m: np.ndarray) -> np.ndarray:
    """[H, W] bool warped by the inverse matrix ``m``, nearest, 0 outside:
    the source pixel is floor(x + 0.5), rounding half up as cv2's
    fixed-point INTER_NEAREST does (grid_sample's nearest rounds half to
    even)."""
    h, w = mask.shape
    sx, sy = _source_coords(m, h, w)
    xi, yi = torch.floor(sx + 0.5).long(), torch.floor(sy + 0.5).long()
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    src = torch.from_numpy(np.ascontiguousarray(mask, bool))
    out = src[yi.clamp(0, h - 1), xi.clamp(0, w - 1)] & inside
    return out.numpy()


def resize_image(img: np.ndarray, size_hw) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) of f32 [H, W, C]: bilinear, half-pixel
    centres, no antialias."""
    return _to_hwc(F.interpolate(_hwc(img), size=tuple(size_hw), mode="bilinear", align_corners=False,
                                 antialias=False), img)


def resize_mask(mask: np.ndarray, size_hw) -> np.ndarray:
    """cv2.resize(INTER_NEAREST) of [H, W] bool: source index floor(i · in / out)."""
    x = torch.from_numpy(np.ascontiguousarray(mask, np.uint8))[None, None]
    return F.interpolate(x, size=tuple(size_hw), mode="nearest")[0, 0].numpy().astype(bool)


def gaussian_kernel(ksize: int, sigma: float) -> torch.Tensor:
    """cv2.getGaussianKernel(ksize, sigma) for sigma > 0: exp(-(i - (k-1)/2)² /
    (2σ²)) normalised in f64, then f32 (the kernel type cv2 uses for f32
    images)."""
    i = torch.arange(ksize, dtype=torch.float64) - (ksize - 1) / 2.0
    k = torch.exp(-(i * i) / (2.0 * sigma * sigma))
    return (k / k.sum()).float()


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (k, k), sigma) of f32 [H, W, C]: the separable
    kernel along x, then y, over reflect-101 padding (``F.pad`` "reflect")."""
    k = gaussian_kernel(ksize, sigma)
    x = _hwc(img)
    c, r = x.shape[1], ksize // 2
    x = F.pad(x, (r, r, r, r), mode="reflect")
    x = F.conv2d(x, k.reshape(1, 1, 1, ksize).repeat(c, 1, 1, 1), groups=c)
    x = F.conv2d(x, k.reshape(1, 1, ksize, 1).repeat(c, 1, 1, 1), groups=c)
    return _to_hwc(x, img)


class RandomAffine:
    """Random affine with retry-until-first-frame-objects-visible (reference
    transforms.py:332-441). Full argument fidelity:

    - `consistent_transform=False` re-samples the affine PER FRAME
      (transforms.py:404-412);
    - images warp with `image_interpolation` ('bilinear'/'bicubic'; anything
      else raises like the reference, transforms.py:362-367) and fill with
      `image_mean` (reference default (123,116,103) on the 0-255 scale —
      converted to this pipeline's 0-1 float scale); masks warp nearest with
      fill 0 (``warp_affine``, ``warp_mask_nearest``);
    - parameter sampling matches torchvision get_params (integer-pixel
      translations, scalar shear = x-only);
    - if any first-frame object disappears, the tentative is discarded and the
      ORIGINAL datapoint is returned after `num_tentatives` failures
      (transforms.py:372-383,418-426; reference default num_tentatives=1 —
      kept at 10 here like our samplers' retry budget, configurable)."""

    def __init__(
        self,
        degrees: float = 25.0,
        shear=20.0,
        translate=None,
        scale=None,
        image_interpolation: str = "bicubic",
        image_mean=(123, 116, 103),
        consistent_transform: bool = True,
        num_retries: int = 10,
        p: float = 1.0,
    ):
        self.degrees = list(degrees) if isinstance(degrees, (list, tuple)) else [-degrees, degrees]
        self.shear = (
            list(shear) if isinstance(shear, (list, tuple))
            else ([-shear, shear] if shear else None)
        )
        self.translate = translate
        self.scale = tuple(scale) if scale else None
        if image_interpolation not in ("bicubic", "bilinear"):
            raise NotImplementedError(
                f"image_interpolation={image_interpolation!r} (reference "
                "transforms.py:362-367 supports bicubic/bilinear only)"
            )
        self.interp = image_interpolation
        # reference fill is on the 0-255 PIL scale; this pipeline's images are
        # 0-1 floats at affine time (normalization comes later)
        self.fill = tuple(float(c) / 255.0 for c in image_mean)
        self.consistent_transform = consistent_transform
        self.num_retries = num_retries
        self.p = p  # FLARE config applies a second affine with p=0.1

    def _matrix(self, h, w, rng: random.Random):
        params = affine_get_params(
            self.degrees, self.translate, self.scale, self.shear, (w, h), rng
        )
        # torchvision rotates about the geometric image center, which in
        # pixel-center coordinates is (w/2 - 0.5, h/2 - 0.5)
        return affine_inverse_matrix((w * 0.5 - 0.5, h * 0.5 - 0.5), *params)

    def _tentative(self, dp: VideoDatapoint, rng: random.Random):
        h, w = dp.images[0].shape[:2]
        m = self._matrix(h, w, rng) if self.consistent_transform else None
        new_masks, new_images = [], []
        for idx, (img, frame) in enumerate(zip(dp.images, dp.masks)):
            mi = m if m is not None else self._matrix(h, w, rng)
            fm = {}
            for k, mask in frame.items():
                warped = warp_mask_nearest(mask, mi)
                # a first-frame object vanished -> discard this tentative
                # (reference transforms.py:418-426 checks img_idx == 0)
                if idx == 0 and mask.any() and not warped.any():
                    return None
                fm[k] = warped
            new_masks.append(fm)
            new_images.append(warp_affine(img, mi, self.interp, self.fill))
        dp.images = new_images
        dp.masks = new_masks
        return dp

    def __call__(self, dp: VideoDatapoint, rngs: Rngs) -> VideoDatapoint:
        if rngs.py.random() >= self.p:
            return dp
        for _ in range(self.num_retries):
            res = self._tentative(dp, rngs.py)
            if res is not None:
                return res
        return dp  # give up on augmenting (reference transforms.py:377-383)


class RandomResizeAPI:
    def __init__(self, sizes, square=True, consistent_transform=True):
        # a size is drawn PER datapoint (reference transforms.py RandomResizeAPI
        # picks per __call__); resolving once here would freeze multi-scale aug
        self.sizes = [sizes] if isinstance(sizes, int) else list(sizes)

    def __call__(self, dp: VideoDatapoint, rngs: Rngs) -> VideoDatapoint:
        s = rngs.py.choice(self.sizes)
        dp.images = [resize_image(img, (s, s)) for img in dp.images]
        dp.masks = [{k: resize_mask(m, (s, s)) for k, m in frame.items()} for frame in dp.masks]
        return dp


class ColorJitter:
    def __init__(
        self,
        consistent_transform=True,
        brightness=0.1,
        contrast=0.03,
        saturation=0.03,
        hue=None,
    ):
        self.consistent = consistent_transform
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    def _factors(self, rng: random.Random):
        def f(v):
            return rng.uniform(max(0.0, 1 - v), 1 + v) if v else 1.0

        return f(self.brightness), f(self.contrast), f(self.saturation)

    @staticmethod
    def _apply(img, b, c, s):
        img = img * b
        gray = img.mean(axis=-1, keepdims=True)
        img = (img - gray.mean()) * c + gray.mean()
        img = gray + (img - gray) * s
        return np.clip(img, 0.0, 1.0)

    def __call__(self, dp: VideoDatapoint, rngs: Rngs) -> VideoDatapoint:
        if self.consistent:
            b, c, s = self._factors(rngs.py)
            dp.images = [self._apply(img, b, c, s) for img in dp.images]
        else:
            dp.images = [self._apply(img, *self._factors(rngs.py)) for img in dp.images]
        return dp


class RandomGrayscale:
    def __init__(self, p=0.05, consistent_transform=True):
        self.p = p

    def __call__(self, dp: VideoDatapoint, rngs: Rngs) -> VideoDatapoint:
        if rngs.py.random() < self.p:
            dp.images = [
                np.repeat(img.mean(axis=-1, keepdims=True), 3, axis=-1)
                for img in dp.images
            ]
        return dp


class RandomGaussianNoise:
    """FLARE config extra (reference transforms.py:561-600)."""

    def __init__(self, p=0.5, sigma=0.02):
        self.p = p
        self.sigma = sigma

    def __call__(self, dp: VideoDatapoint, rngs: Rngs) -> VideoDatapoint:
        if rngs.py.random() < self.p:
            dp.images = [
                np.clip(img + rngs.np.randn(*img.shape).astype(np.float32) * self.sigma, 0, 1)
                for img in dp.images
            ]
        return dp


class RandomGaussianBlur:
    def __init__(self, p=0.5, kernel_size=5, sigma=(0.1, 2.0)):
        self.p = p
        self.kernel_size = kernel_size
        self.sigma = sigma

    def __call__(self, dp: VideoDatapoint, rngs: Rngs) -> VideoDatapoint:
        if rngs.py.random() < self.p:
            sig = rngs.py.uniform(*self.sigma)
            dp.images = [gaussian_blur(img, self.kernel_size, sig) for img in dp.images]
        return dp


class NormalizeAPI:
    def __init__(self, mean=IMG_MEAN, std=IMG_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, dp: VideoDatapoint, rngs: Optional[Rngs] = None) -> VideoDatapoint:
        dp.images = [(img - self.mean) / self.std for img in dp.images]
        return dp


class ComposeAPI:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, dp: VideoDatapoint, rngs: Rngs) -> VideoDatapoint:
        for t in self.transforms:
            dp = t(dp, rngs)
        return dp


def flare_train_transforms(resolution: int = 512) -> ComposeAPI:
    """The shipped EfficientMedSAM FLARE recipe's augmentation stack
    (reference efficientmedsam_s_512_FLARE_RECIST.yaml:20-69): h+v flips,
    two affines (strong consistent + weak per-call p=0.1), resize, noise,
    blur, two color jitters, normalize."""
    return ComposeAPI(
        [
            RandomHorizontalFlip(),
            RandomVerticalFlip(),
            RandomAffine(degrees=25, shear=20, scale=(0.7, 1.4)),
            RandomAffine(
                degrees=5, shear=5, scale=(0.95, 1.05), translate=(0.05, 0.05), p=0.1
            ),
            RandomResizeAPI(resolution),
            RandomGaussianNoise(p=0.1),
            RandomGaussianBlur(p=0.2, kernel_size=5, sigma=(0.5, 1.0)),
            ColorJitter(True, 0.2, 0.2, 0.03),
            ColorJitter(False, 0.1, 0.05, 0.05),
            NormalizeAPI(),
        ]
    )


def default_train_transforms(resolution: int = 512) -> ComposeAPI:
    """GFTE_3.yaml:20-54's augmentation stack."""
    return ComposeAPI(
        [
            RandomHorizontalFlip(),
            RandomAffine(degrees=25, shear=20),
            RandomResizeAPI(resolution),
            ColorJitter(True, 0.1, 0.03, 0.03),
            RandomGrayscale(0.05),
            ColorJitter(False, 0.1, 0.05, 0.05),
            NormalizeAPI(),
        ]
    )


# ------------------------------------------------------------------ VOSDataset
class VOSDataset:
    """raw dataset + sampler + transforms with failure retries
    (reference vos_dataset.py:27-162)."""

    def __init__(
        self,
        video_dataset: VOSRawDataset,
        sampler,
        transforms: Optional[ComposeAPI] = None,
        multiplier: int = 1,
        training: bool = True,
        max_num_objects: int = 5,
    ):
        self.video_dataset = video_dataset
        self.sampler = sampler
        self.transforms = transforms
        self.repeat_factors = [multiplier] * len(video_dataset)
        self.training = training
        self.max_num_objects = max_num_objects
        self.curr_epoch = 0

    def set_epoch(self, epoch: int):
        self.curr_epoch = epoch
        self.video_dataset.set_epoch(epoch)

    def __len__(self):
        return len(self.video_dataset)

    def _get_datapoint_once(self, idx: int, rngs: Rngs) -> VideoDatapoint:
        video, segment_loader = self.video_dataset.get_video(idx, rngs)
        sampled = self.sampler.sample(video, segment_loader, rngs, epoch=self.curr_epoch)
        images, masks = [], []
        h, w = sampled.frames[0].data.shape[:2]
        for frame in sampled.frames:
            images.append(np.ascontiguousarray(frame.data))
            segs = segment_loader.load(frame.frame_idx)
            masks.append(
                {
                    oid: np.ascontiguousarray(
                        segs.get(oid, np.zeros((h, w), bool)).astype(bool)
                    )
                    for oid in sampled.object_ids
                }
            )
        dp = VideoDatapoint(images, masks)
        if self.transforms is not None:
            dp = self.transforms(dp, rngs)
        return dp

    def get_datapoint(self, idx: int, rngs: Rngs) -> VideoDatapoint:
        for retry in range(MAX_RETRIES):
            try:
                return self._get_datapoint_once(idx, rngs)
            except Exception as e:  # noqa: BLE001
                if not self.training or retry == MAX_RETRIES - 1:
                    raise
                idx = rngs.py.randrange(0, len(self.video_dataset))
                logging.warning("dataloading retry after: %s", e)


def collate_video_batch(datapoints: List[VideoDatapoint], max_num_objects: int):
    """-> dict(images [T,B,S,S,3] f32, masks [T,B,O,S,S] bool, obj_valid [B,O])
    (reference utils/data_utils.py:114-179 BatchedVideoDatapoint)."""
    b = len(datapoints)
    t = len(datapoints[0].images)
    s = datapoints[0].images[0].shape[0]
    images = np.zeros((t, b, s, s, 3), np.float32)
    masks = np.zeros((t, b, max_num_objects, s, s), bool)
    obj_valid = np.zeros((b, max_num_objects), bool)
    for bi, dp in enumerate(datapoints):
        obj_ids = list(dp.masks[0].keys())[:max_num_objects]
        obj_valid[bi, : len(obj_ids)] = True
        for ti in range(t):
            images[ti, bi] = dp.images[ti]
            for oi, oid in enumerate(obj_ids):
                masks[ti, bi, oi] = dp.masks[ti][oid]
    return {"images": images, "masks": masks, "obj_valid": obj_valid}


# ------------------------------------------------------------- mixing + loader
class RepeatFactorWrapper:
    """Epoch-seeded stochastic repeat-factor oversampling
    (reference dataset/utils.py:42-104)."""

    def __init__(self, dataset: VOSDataset, seed: int = 0):
        self.dataset = dataset
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.dataset.set_epoch(epoch)

    def indices(self) -> List[int]:
        g = np.random.default_rng(self.seed + self.epoch)
        out = []
        for idx, rf in enumerate(self.dataset.repeat_factors):
            n = int(np.floor(rf) + (g.random() < (rf - np.floor(rf))))
            out.extend([idx] * n)
        return out


def mixed_epoch_order(
    counts: Sequence[int],
    prob: Sequence[float],
    rng: np.random.Generator,
    exhaustion: str = "stop",
) -> Iterable[int]:
    """Per-step multinomial dataset-selection order for one epoch (lazy) —
    the reference's MixedDataLoader mixing law (sam2_datasets.py:141-201):
    each batch slot draws a dataset index from `prob`.

    exhaustion="stop": the epoch ends the first time an exhausted dataset is
    drawn (the live vendored `__iter__`, sam2_datasets.py:166-178 — the class
    defines __iter__ twice; the second definition wins in Python).
    exhaustion="renormalize": the exhausted dataset's probability is zeroed
    and drawing continues until every dataset is drained (the upstream
    `__next__` at sam2_datasets.py:180-201, unreachable in the vendored class
    but the behavior of upstream SAM2's MixedDataLoader).
    """
    assert exhaustion in ("stop", "renormalize")
    live = np.asarray(prob, np.float64).copy()
    remaining = list(counts)
    while live.sum() > 0:
        di = int(rng.choice(len(live), p=live / live.sum()))
        if remaining[di] == 0:
            if exhaustion == "stop":
                return
            live[di] = 0.0
            continue
        remaining[di] -= 1
        yield di


class TrainMixedVideoLoader:
    """Probability-mixed multi-dataset loader with per-host sharding and
    phases_per_epoch chunking (reference sam2_datasets.py:19-201).

    Batches are interleaved by a per-step multinomial draw over
    `dataset_prob` (reference MixedDataLoader, sam2_datasets.py:141-178);
    when dataset_prob is None each dataset's probability is proportional to
    its batch count (sam2_datasets.py:64-73 — computed here from the actual
    per-epoch batch lists, which already reflect phase chunking and host
    sharding). See `mixed_epoch_order` for the exhaustion semantics.

    The fork's curriculum switch (sam2_datasets.py:88-118): when
    `use_curriculum=True`, per-epoch curriculum stages come from the raw
    dataset's set_epoch; otherwise each dataset is chunked into
    phases_per_epoch subsets and any staged dataset is forced to 'full'.

    Every datapoint of an epoch draws from one ``Rngs`` seeded by
    ``epoch_seed(epoch)`` (the seed, the epoch and the process index), so an
    epoch's batches are the same in every run and on a resume.
    """

    def __init__(
        self,
        datasets: List[VOSDataset],
        batch_sizes: List[int],
        max_num_objects: int = 5,
        shuffle: bool = True,
        seed: int = 0,
        phases_per_epoch: int = 1,
        use_curriculum: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        dataset_prob: Optional[List[float]] = None,
        exhaustion: str = "stop",
    ):
        assert len(datasets) == len(batch_sizes)
        if dataset_prob is not None:
            assert len(dataset_prob) == len(datasets)
            assert abs(sum(dataset_prob) - 1.0) < 1e-6, "probs must sum to 1.0"
        self.datasets = [RepeatFactorWrapper(d, seed) for d in datasets]
        self.batch_sizes = list(batch_sizes)
        self.max_num_objects = max_num_objects
        self.shuffle = shuffle
        self.seed = seed
        self.phases_per_epoch = phases_per_epoch
        self.use_curriculum = use_curriculum
        self.process_index = process_index
        self.process_count = process_count
        self.dataset_prob = dataset_prob
        self.exhaustion = exhaustion
        if not use_curriculum:
            for d in self.datasets:
                raw = d.dataset.video_dataset
                if hasattr(raw, "force_stage"):
                    raw.force_stage("full")  # sam2_datasets.py:113-118

    def _epoch_batches(self, wrapped: RepeatFactorWrapper, bs: int, epoch: int):
        idxs = wrapped.indices()
        g = np.random.default_rng(self.seed * 100 + epoch)
        if self.shuffle:
            g.shuffle(idxs)
        if self.phases_per_epoch > 1 and not self.use_curriculum:
            chunks = np.array_split(idxs, self.phases_per_epoch)
            idxs = list(chunks[epoch % self.phases_per_epoch])
        # per-host shard (== DistributedSampler, sam2_datasets.py:121-124).
        # Pad by wrapping to a multiple of process_count first (like torch's
        # DistributedSampler): every host must yield the SAME number of
        # batches or a straggler's grad all-reduce deadlocks at epoch end.
        if self.process_count > 1 and len(idxs) % self.process_count:
            pad = self.process_count - len(idxs) % self.process_count
            idxs = list(idxs) + list(idxs[:pad])
        idxs = idxs[self.process_index :: self.process_count]
        if 0 < len(idxs) < bs:
            # fewer videos than one global batch (tiny datasets / many-device
            # hosts): wrap-pad so the epoch still trains one batch instead of
            # silently dropping everything (drop_last would starve the run)
            reps = -(-bs // len(idxs))
            idxs = (list(idxs) * reps)[:bs]
        return [idxs[i : i + bs] for i in range(0, len(idxs) - bs + 1, bs)]

    def epoch_seed(self, epoch: int) -> int:
        """The seed of epoch ``epoch``'s generators on this process."""
        return (self.seed * 1_000_003 + epoch) * 1_009 + self.process_index

    def get_loader(self, epoch: int, rngs: Optional[Rngs] = None) -> Iterable[Dict]:
        """Epoch ``epoch``'s batches, drawing from ``rngs`` (by default
        ``make_rngs(epoch_seed(epoch))``)."""
        rngs = rngs if rngs is not None else make_rngs(self.epoch_seed(epoch))
        for d in self.datasets:
            if self.use_curriculum:
                d.set_epoch(epoch)
        per_ds = [
            self._epoch_batches(d, bs, epoch)
            for d, bs in zip(self.datasets, self.batch_sizes)
        ]
        counts = [len(b) for b in per_ds]
        if self.dataset_prob is not None:
            prob = np.asarray(self.dataset_prob, np.float64)
        else:
            total = sum(counts)
            if total == 0:
                return
            prob = np.asarray(counts, np.float64) / total
        rng = np.random.default_rng((self.seed + 1) * 7919 + epoch)
        cursors = [0] * len(per_ds)
        for di in mixed_epoch_order(counts, prob, rng, self.exhaustion):
            batch_idxs = per_ds[di][cursors[di]]
            cursors[di] += 1
            dps = [self.datasets[di].dataset.get_datapoint(i, rngs) for i in batch_idxs]
            yield collate_video_batch(dps, self.max_num_objects)

    def __len__(self):
        n = 0
        for d, bs in zip(self.datasets, self.batch_sizes):
            n += max(0, len(d.indices()) // max(self.process_count, 1) // bs)
        return n


# ------------------------------------------------------- SA-V / JSON datasets
def _decode_coco_rle_scalar(rle: Dict) -> np.ndarray:
    """Literal per-char port of pycocotools rleFrString + rleDecode — kept as
    the cross-check oracle for the vectorized decoder below (and for the
    speedup benchmark in tests)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        s = counts.encode() if isinstance(counts, str) else counts
        out, i = [], 0
        while i < len(s):
            x, k, more = 0, 0, True
            while more:
                c = s[i] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
            if x & (1 << (5 * k - 1)):  # sign extension
                x |= -1 << (5 * k)
            if len(out) > 2:
                x += out[-2]
            out.append(x)
        counts = out
    flat = np.zeros(h * w, bool)
    idx, val = 0, False
    for c in counts:
        flat[idx : idx + c] = val
        idx += c
        val = not val
    return flat.reshape(w, h).T  # column-major


def decode_coco_rle(rle: Dict) -> np.ndarray:
    """Decode a COCO RLE (compressed string or uncompressed counts) to [H, W] bool.

    Vectorized pure-numpy replacement for pycocotools.mask.decode (the
    reference leans on pycocotools' C impl, vos_segment_loader.py:232-302).
    The LEB128-style char stream is parsed in O(max_token_len) numpy passes
    (tokens end at the first char without the 0x20 continuation bit), the
    m>2 delta recursion is two per-parity cumsums, and the run fill is one
    np.repeat — ~100x the scalar loop on 1080p masks.
    """
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        s = counts.encode() if isinstance(counts, str) else counts
        c6 = np.frombuffer(s, np.uint8) - 48  # 6-bit char payloads, uint8 ops
        ends = np.flatnonzero((c6 & 0x20) == 0)  # last char of each token
        starts = np.empty_like(ends)
        starts[0], starts[1:] = 0, ends[:-1] + 1
        klen = (ends - starts).astype(np.int8) + 1
        kmax = int(klen.max()) if len(klen) else 0
        # int32 carries tokens up to 6 chars (30 payload bits) — every mask
        # under ~2^30 pixels; int64 only for the pathological tail
        dt = np.int32 if kmax <= 6 else np.int64
        payload = (c6 & 0x1F).astype(dt)
        x = payload[starts]
        for j in range(1, kmax):
            sel = np.flatnonzero(klen > j)
            x[sel] |= payload[starts[sel] + j] << dt(5 * j)
        # sign-extend the 5k-bit two's-complement value: shift the sign bit to
        # the dtype's top bit, arithmetic-shift back down (branch/scatter-free)
        sh = dt(np.dtype(dt).itemsize * 8) - klen.astype(dt) * dt(5)
        x = (x << sh) >> sh
        # delta decoding: counts[m] += counts[m-2] for m > 2 (pycocotools
        # rleFrString); per parity chain this is a prefix sum
        if len(x) > 3:
            x[3::2] = np.cumsum(x[1::2])[1:]
        if len(x) > 4:
            x[4::2] = np.cumsum(x[2::2])[1:]
        counts = x
    else:
        counts = np.asarray(counts, np.int64)
    pattern = np.empty(len(counts), bool)
    pattern[0::2] = False
    pattern[1::2] = True
    flat = np.repeat(pattern, counts)
    if flat.size == h * w:
        return flat.reshape(w, h).T  # column-major
    out = np.zeros(h * w, bool)
    n = min(flat.size, h * w)
    out[:n] = flat[:n]
    return out.reshape(w, h).T


class JSONSegmentLoader:
    """SA-V json annotations: per-frame lists of RLE masks per object
    (reference vos_segment_loader.py:23-101)."""

    def __init__(self, video_json_path, ann_every=1, frames_fps=24, valid_obj_ids=None):
        import json

        self.ann_every = ann_every
        self.valid_obj_ids = valid_obj_ids
        with open(video_json_path) as f:
            data = json.load(f)
        if isinstance(data, list):
            self.frame_annots = data
        else:
            field = "masklet" if "masklet" in data else "masks"
            self.frame_annots = data[field]
            if "fps" in data:
                fps = data["fps"][0] if isinstance(data["fps"], list) else data["fps"]
                assert frames_fps % int(fps) == 0
                self.ann_every = frames_fps // int(fps)

    def load(self, frame_id, obj_ids=None):
        assert frame_id % self.ann_every == 0
        rles = self.frame_annots[frame_id // self.ann_every]
        valid = set(range(len(rles)))
        if self.valid_obj_ids is not None:
            valid &= set(self.valid_obj_ids)
        if obj_ids is not None:
            valid &= set(obj_ids)
        return {
            oid: decode_coco_rle(rles[oid])
            for oid in sorted(valid)
            if rles[oid] is not None
        }

    def get_valid_obj_frames_ids(self, num_frames_min=None):
        num_objects = len(self.frame_annots[0])
        res = {oid: [] for oid in range(num_objects)}
        for ai, annot in enumerate(self.frame_annots):
            for oid in range(num_objects):
                if annot[oid] is not None:
                    res[oid].append(int(ai * self.ann_every))
        if num_frames_min is not None:
            res = {o: f for o, f in res.items() if len(f) >= num_frames_min}
        return res


class JSONRawDataset(VOSRawDataset):
    """SA-V style dataset: JPEG frame folders + <video>_manual.json RLE
    annotations (reference vos_raw_dataset.py:1116-1209)."""

    def __init__(
        self,
        img_folder: str,
        gt_folder: str,
        file_list_txt: Optional[str] = None,
        excluded_videos_list_txt=None,
        sample_rate: int = 1,
        rm_unannotated: bool = True,
        ann_every: int = 1,
        frames_fps: int = 24,
    ):
        self.img_folder = img_folder
        self.gt_folder = gt_folder
        self.sample_rate = sample_rate
        self.rm_unannotated = rm_unannotated
        self.ann_every = ann_every
        self.frames_fps = frames_fps
        excluded = set()
        if excluded_videos_list_txt:
            lists = (
                [excluded_videos_list_txt]
                if isinstance(excluded_videos_list_txt, str)
                else list(excluded_videos_list_txt)
            )
            for lst in lists:
                with open(lst) as f:
                    excluded |= {os.path.splitext(line.strip())[0] for line in f}
        if file_list_txt is not None:
            with open(file_list_txt) as f:
                subset = [os.path.splitext(line.strip())[0] for line in f]
        else:
            subset = os.listdir(img_folder)
        self.video_names = sorted(v for v in subset if v not in excluded)

    def get_video(self, idx: int, rngs: Optional[Rngs] = None):
        from PIL import Image

        name = self.video_names[idx]
        loader = JSONSegmentLoader(
            os.path.join(self.gt_folder, name + "_manual.json"),
            ann_every=self.ann_every,
            frames_fps=self.frames_fps,
        )
        vdir = os.path.join(self.img_folder, name)
        files = sorted(os.listdir(vdir))[:: self.sample_rate]
        frames = []
        for i, f in enumerate(files):
            fid = i * self.sample_rate
            if fid % loader.ann_every != 0:
                continue
            img = np.asarray(Image.open(os.path.join(vdir, f)).convert("RGB"), np.float32)
            frames.append(VOSFrame(fid, data=img / 255.0))
        return VOSVideo(name, idx, frames), loader

    def __len__(self):
        return len(self.video_names)


# --------------------------------------------------- additional curricula
class SignalCurriculumMixin:
    """Stochastic temporal-resolution curriculum: dense (stride 1) -> stochastic
    expand (stride 2 with jitter) -> full (reference sam2_datasets.py:499-533).
    Applied by TrainMixedVideoLoader when the dataset exposes these knobs."""

    temporal_stride: int = 1
    use_stochastic: bool = False


class SignalCurriculumNPZRawDataset(NPZRawDataset, SignalCurriculumMixin):
    def __init__(self, folder: str, max_epochs: int = 100, **kw):
        super().__init__(folder, **kw)
        self.max_epochs = max_epochs
        self.temporal_stride = 1
        self.use_stochastic = False

    def set_epoch(self, epoch: int):
        progress = epoch / max(self.max_epochs, 1)
        if progress < 0.2:
            self.temporal_stride, self.use_stochastic = 1, False
        elif progress < 0.6:
            self.temporal_stride, self.use_stochastic = 2, True
        else:
            self.temporal_stride, self.use_stochastic = 1, False

    def get_video(self, idx: int, rngs: Optional[Rngs] = None):
        video, loader = super().get_video(idx)
        stride = self.temporal_stride
        if self.use_stochastic and stride > 1:
            stride = rngs.py.choice([1, stride])
        if stride > 1:
            # Keep the loader at full temporal resolution: the kept frames
            # retain their original frame_idx (0, stride, 2*stride, ...) and
            # NPZSegmentLoader.load() indexes masks by that original index.
            video = VOSVideo(video.video_name, video.video_id, video.frames[::stride])
        return video, loader


class FAPCurriculumNPZRawDataset(NPZRawDataset):
    """Frequency-aware progressive curriculum (reference FAP_CLDataset,
    sam2_datasets.py:212-496): rank videos by their low-frequency energy share
    (2D Haar-like decomposition of the first frame; pywt-free) and grow the
    training pool from low-frequency-dominant (easy) to all (hard)."""

    def __init__(self, folder: str, milestones: Optional[Dict[str, int]] = None, **kw):
        super().__init__(folder, **kw)
        self.milestones = milestones or {"expand": 20, "full": 50}
        self.all_video_names = list(self.video_names)
        self.scores = {v: self._low_freq_share(v) for v in self.all_video_names}
        self.stage = "dense"
        self._apply()

    def _low_freq_share(self, video_name: str) -> float:
        try:
            with np.load(os.path.join(self.folder, f"{video_name}.npz")) as data:
                img = data["imgs"][0]
            if img.ndim == 3:
                img = img.mean(-1)
            img = img.astype(np.float32)
            h, w = (img.shape[0] // 2) * 2, (img.shape[1] // 2) * 2
            img = img[:h, :w]
            a = img[0::2, 0::2]; b = img[0::2, 1::2]
            c = img[1::2, 0::2]; d = img[1::2, 1::2]
            ll = (a + b + c + d) / 4
            lh = (a - b + c - d) / 4
            hl = (a + b - c - d) / 4
            hh = (a - b - c + d) / 4
            e_ll = float((ll**2).sum())
            e_hi = float((lh**2).sum() + (hl**2).sum() + (hh**2).sum())
            return e_ll / max(e_ll + e_hi, 1e-8)
        except Exception:  # noqa: BLE001
            return 0.0

    def set_epoch(self, epoch: int):
        if epoch >= self.milestones.get("full", 50):
            stage = "full"
        elif epoch >= self.milestones.get("expand", 20):
            stage = "expand"
        else:
            stage = "dense"
        if stage != self.stage:
            self.stage = stage
            self._apply()

    def force_stage(self, stage: str):
        self.stage = stage
        self._apply()

    def _apply(self):
        ordered = sorted(self.all_video_names, key=lambda v: -self.scores[v])
        frac = {"dense": 0.3, "expand": 0.6, "full": 1.0}[self.stage]
        n = max(1, int(len(ordered) * frac))
        self.video_names = sorted(ordered[:n])


# -------------------------------------------------------- SA1B image dataset
class SA1BSegmentLoader:
    """Lazy RLE decoding of SA-1B per-image annotations
    (reference vos_segment_loader.py:232-302)."""

    def __init__(
        self,
        mask_path: str,
        mask_area_frac_thresh: float = 1.1,
        video_frame_path: Optional[str] = None,
        uncertain_iou: float = -1,
    ):
        import json

        with open(mask_path) as f:
            annots = json.load(f)
        if isinstance(annots, dict):
            annots = annots["annotations"]
        if uncertain_iou > 0:
            annots = [a for a in annots if a.get("stability_score", 1.0) >= uncertain_iou]
        if mask_area_frac_thresh <= 1.0 and video_frame_path is not None:
            from PIL import Image

            w, h = Image.open(video_frame_path).size
            annots = [
                a for a in annots if a["area"] <= mask_area_frac_thresh * w * h
            ]
        self.rles = {i: a["segmentation"] for i, a in enumerate(annots)}
        self._cache: Dict[int, np.ndarray] = {}

    def load(self, frame_idx: int) -> Dict[int, np.ndarray]:
        return {i: self._decode(i) for i in self.rles}

    def _decode(self, i: int) -> np.ndarray:
        if i not in self._cache:
            self._cache[i] = decode_coco_rle(self.rles[i])
        return self._cache[i]


class SA1BRawDataset(VOSRawDataset):
    """SA-1B static images as 1-frame videos (reference vos_raw_dataset.py:973-1039)."""

    def __init__(
        self,
        img_folder: str,
        gt_folder: str,
        file_list_txt: Optional[str] = None,
        excluded_videos_list_txt: Optional[str] = None,
        num_frames: int = 1,
        mask_area_frac_thresh: float = 1.1,
        uncertain_iou: float = -1,
    ):
        self.img_folder = img_folder
        self.gt_folder = gt_folder
        self.num_frames = num_frames
        self.mask_area_frac_thresh = mask_area_frac_thresh
        self.uncertain_iou = uncertain_iou
        if file_list_txt is not None:
            with open(file_list_txt) as f:
                subset = [os.path.splitext(line.strip())[0] for line in f]
        else:
            subset = [
                p.split(".")[0] for p in os.listdir(img_folder) if p.endswith(".jpg")
            ]
        excluded = set()
        if excluded_videos_list_txt is not None:
            with open(excluded_videos_list_txt) as f:
                excluded = {os.path.splitext(line.strip())[0] for line in f}
        self.video_names = [v for v in subset if v not in excluded]

    def get_video(self, idx: int, rngs: Optional[Rngs] = None):
        from PIL import Image

        name = self.video_names[idx]
        img_path = os.path.join(self.img_folder, name + ".jpg")
        loader = SA1BSegmentLoader(
            os.path.join(self.gt_folder, name + ".json"),
            mask_area_frac_thresh=self.mask_area_frac_thresh,
            video_frame_path=img_path,
            uncertain_iou=self.uncertain_iou,
        )
        img = np.asarray(Image.open(img_path).convert("RGB"), np.float32) / 255.0
        frames = [VOSFrame(i, data=img) for i in range(self.num_frames)]
        vid = name.split("_")[-1]
        return VOSVideo(vid, int(vid) if vid.isdigit() else idx, frames), loader

    def __len__(self):
        return len(self.video_names)


class RandomMosaicVideoAPI:
    """2x2 mosaic distractor augmentation: tile the frame into a grid, keep the
    target's mask only in one cell (reference transforms.py:528-560)."""

    def __init__(self, prob=0.15, grid_h=2, grid_w=2, use_random_hflip=False):
        self.prob = prob
        self.grid_h = grid_h
        self.grid_w = grid_w
        self.use_random_hflip = use_random_hflip

    def __call__(self, dp: VideoDatapoint, rngs: Rngs) -> VideoDatapoint:
        if rngs.py.random() > self.prob:
            return dp
        ty = rngs.py.randint(0, self.grid_h - 1)
        tx = rngs.py.randint(0, self.grid_w - 1)
        hflip = (
            rngs.np.rand(self.grid_h, self.grid_w) < 0.5
            if self.use_random_hflip
            else np.zeros((self.grid_h, self.grid_w), bool)
        )
        h, w = dp.images[0].shape[:2]
        ch, cw = h // self.grid_h, w // self.grid_w
        for fi in range(len(dp.images)):
            img = dp.images[fi]
            small = resize_image(img, (ch, cw))
            canvas = np.zeros_like(img)
            for gy in range(self.grid_h):
                for gx in range(self.grid_w):
                    cell = small[:, ::-1] if hflip[gy, gx] else small
                    canvas[gy * ch : (gy + 1) * ch, gx * cw : (gx + 1) * cw] = cell
            dp.images[fi] = canvas
            new_masks = {}
            for oid, m in dp.masks[fi].items():
                sm = resize_mask(m, (ch, cw))
                if hflip[ty, tx]:
                    sm = sm[:, ::-1]
                mm = np.zeros((h, w), bool)
                mm[ty * ch : (ty + 1) * ch, tx * cw : (tx + 1) * cw] = sm
                new_masks[oid] = mm
            dp.masks[fi] = new_masks
        return dp


class MultiplePNGSegmentLoader:
    """Per-object PNG folders: <root>/<object_id>/<frame>.png
    (reference vos_segment_loader.py:152-231)."""

    def __init__(self, video_png_root: str, single_object_mode: bool = False):
        self.root = video_png_root
        self.single_object_mode = single_object_mode
        if single_object_mode:
            self.obj_dirs = [video_png_root]
        else:
            self.obj_dirs = sorted(
                os.path.join(video_png_root, d)
                for d in os.listdir(video_png_root)
                if os.path.isdir(os.path.join(video_png_root, d))
            )

    def load(self, frame_idx: int) -> Dict[int, np.ndarray]:
        from PIL import Image

        out = {}
        for oi, d in enumerate(self.obj_dirs):
            path = os.path.join(d, f"{frame_idx:05d}.png")
            if not os.path.exists(path):
                path = os.path.join(d, f"{frame_idx}.png")
            if os.path.exists(path):
                out[oi + 1] = np.array(Image.open(path)) > 0
        return out
