"""What the drivers share: the program and the reference built from one state
dict, seeds, the comparison, the reference's counts."""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import plain
from perfbench.reference import propagate as ref
from perfbench.weights import make_state_dict, model_shapes

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for ``path`` under the run's ``--seed`` (any whole number)."""
    return int(np.random.SeedSequence([int(seed) % 2**64, *path]).generate_state(2, np.uint64)[0] >> np.uint64(1))


def state_dict(cfg: dict, seed: int, device) -> dict:
    """The run's weights: float32 on ``device``, from the seed."""
    with torch.device("meta"):
        shapes = model_shapes(ref.SAM2Model(ref.sam2_config_from_dict(cfg["model"])))
    return state_dict_from(shapes, seed, device)


def state_dict_from(shapes: dict, seed: int, device) -> dict:
    return make_state_dict(shapes, sub_seed(seed, 0), device)


def program(cfg: dict, sd: dict, device: str):
    """The port's video predictor on ``device``, built by its own builder
    from the configuration and ``sd``, in the configuration's dtype."""
    from us_video_medsam2_tpu_torch.core.build import build_sam2
    from us_video_medsam2_tpu_torch.core.config import sam2_config_from_dict
    from us_video_medsam2_tpu_torch.inference.video_predictor import SAM2VideoPredictor

    with torch.device(device):
        model = build_sam2(sam2_config_from_dict(cfg["model"]), state_dict=sd)
    model = model.set_compute_dtype(DTYPES[cfg["dtype"]])
    return SAM2VideoPredictor(model, fill_hole_area=cfg["fill_hole_area"], device=device)


def build_kernels(device: str) -> None:
    """The port's kernel library, built into the checkout's ``build/`` when missing."""
    if device == "cuda":
        from us_video_medsam2_tpu_torch.kernels import _lib

        _lib.load()


def synchronize(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def reset_peak(device: str) -> None:
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device: str) -> int:
    return int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0


def free(device: str) -> None:
    import gc

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def frame_norms(program_out: torch.Tensor, reference_out: torch.Tensor) -> torch.Tensor:
    """[..., 2]: each frame's root-mean-square over its pixels (the last two
    axes) of the logit gap p - r and of the reference's logits r, float64."""
    p, r = program_out.double().flatten(-2), reference_out.double().flatten(-2)
    return torch.stack([(p - r).square().mean(-1).sqrt(), r.square().mean(-1).sqrt()], -1)


def compare(run: harness.Run, limits: dict, program: list, witness: list) -> None:
    """The compared frames into the run's checks. ``program`` and ``witness``
    hold ``frame_norms`` (a tensor a request) of the program's outputs and of
    the plain reference computed in bf16, each against the float32
    reference. The numbers are the program's rms logit gap over the bf16
    reference's: their means over every compared frame, and their largest
    frames. With seeded weights bf16's own gap swings from seed to seed with
    how well the seed's model is conditioned (tenfold, and the program's with
    it); over the same inputs a sound bf16 program reads about 1, a lower
    precision several times that, and a wrong answer far more. The cell's
    limits name the numbers it compares (all of them, without limits)."""
    run.gaps = [torch.stack([p[..., 0], w[..., 0]], -1).detach().cpu() for p, w in zip(program, witness)]
    g = torch.cat([x.reshape(-1, 2) for x in run.gaps])
    numbers = {"gap_ratio_mean": float(g[:, 0].mean() / g[:, 1].mean().clamp_min(1e-30)),
               "gap_ratio_max": float(g[:, 0].max() / g[:, 1].max().clamp_min(1e-30))}
    for name, value in numbers.items():
        if name in limits or not limits:  # a cell's limits name the numbers it compares
            run.checks.append((name, value, limits.get(name)))


def reference_outputs(cfg: dict, sd: dict, device: str, jobs: list, control: bool = False, count: bool = False):
    """(float32 outputs, bf16 or fp8-control outputs, FLOPs, kernel calls):
    the reference's outputs of ``jobs`` (kwargs of ``ref.propagate`` without
    the model), each computed alone, float32 without TF32; then the same in
    the configurations' bf16 (the witness of bf16's own gap), or with
    ``control`` under fp8 products. With ``count`` also the first job's
    float32 FLOPs and its kernel sites' calls (``plain.RECORD``)."""
    from perfbench.frozen.flops import fn_flops
    from perfbench.reference.control import fp8_products

    model = ref.build_model(cfg["model"], sd, device)
    exact, low, flops, record = [], [], None, []
    with ref.exact_f32():
        for i, job in enumerate(jobs):
            if count and i == 0:
                plain.RECORD = record
                try:
                    flops, out = fn_flops(ref.propagate, model, **job)
                finally:
                    plain.RECORD = None
            else:
                out = ref.propagate(model, **job)
            exact.append(out)
        if control:
            with fp8_products():
                low = [ref.propagate(model, **job) for job in jobs]
        else:
            model.set_compute_dtype(torch.bfloat16)
            low = [ref.propagate(model, **job) for job in jobs]
    del model
    return exact, low, flops, record


def peak_flops(device_name: str) -> float | None:
    """The card's dense bf16 peak (the frozen ``traceparse`` table), or None."""
    from perfbench.frozen import traceparse

    return traceparse.peak_bf16_flops(device_name)


def card_name(device: str) -> str:
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def now() -> float:
    return time.perf_counter()


class Steps:
    """Records the seconds since the previous call under each name (set-up's parts)."""

    def __init__(self, into: dict, start: float):
        self.into, self.last = into, start

    def __call__(self, name: str) -> None:
        t = now()
        self.into[name] = t - self.last
        self.last = t
