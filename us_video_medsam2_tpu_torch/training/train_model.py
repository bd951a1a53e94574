"""Training-time forward: interactive-prompt simulation + video tracking.

Counterpart of the JAX package's ``training/train_model.py`` (reference
training/model/sam2.py:25-541, SAM2Train). The JAX package draws its plan on
the device and branches with ``lax.cond`` / ``lax.switch`` / ``lax.scan``;
here the plan (prompt mode, initial conditioning frames, processing order,
corrected frames) is drawn on the host from an explicit ``torch.Generator``
and the branches are Python control flow. Kept from the JAX package:

- the image encoder runs once over all T·B frames;
- point prompts live in a fixed [Bo, 2 + num_correction_pt, 2] slot array
  padded with label -1 (the prompt encoder's not-a-point), so every SAM-head
  call sees the same token count;
- every frame emits one output per correction step; steps that did not run
  repeat the previous output with ``corr_valid`` False and add zero loss.

No activation checkpointing: every forward kernel runs once per step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from us_video_medsam2_tpu_torch.models.memory_bank import init_memory_bank, write_memory
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.training.prompt_sampling import get_next_point, sample_box_points


@dataclass(frozen=True)
class TrainSimConfig:
    """SAM2Train's simulation knobs (reference training/model/sam2.py:25-105;
    values from sam2/configs/GFTE_3.yaml:183-201)."""

    prob_to_use_pt_input: float = 0.5
    prob_to_use_box_input: float = 1.0
    num_frames_to_correct: int = 2
    rand_frames_to_correct: bool = True
    num_init_cond_frames: int = 2
    rand_init_cond_frames: bool = True
    add_all_frames_to_correct_as_cond: bool = True
    num_correction_pt_per_frame: int = 7
    pt_sampling_for_eval: str = "center"
    prob_to_sample_from_gt: float = 0.0
    # eval-time variants
    prob_to_use_pt_input_for_eval: float = 0.0
    num_init_cond_frames_for_eval: int = 1
    num_frames_to_correct_for_eval: int = 1


@dataclass
class Plan:
    mode: int  # 0 point, 1 box, 2 mask
    use_pt: bool
    n_init: int
    is_init: list  # [T] bool, by frame
    order: list  # processing order of the frames
    should_correct: list  # [T] bool, by frame


def _rank(x: torch.Tensor) -> torch.Tensor:
    return torch.argsort(torch.argsort(x, stable=True), stable=True)


def sample_plan(gen: torch.Generator, sim: TrainSimConfig, t: int, is_training: bool) -> Plan:
    """The prompt plan (reference prepare_prompt_inputs, model/sam2.py:146-267)."""
    p_pt = sim.prob_to_use_pt_input if is_training else sim.prob_to_use_pt_input_for_eval
    n_init_max = sim.num_init_cond_frames if is_training else sim.num_init_cond_frames_for_eval
    n_corr_max = sim.num_frames_to_correct if is_training else sim.num_frames_to_correct_for_eval
    if t == 1:
        p_pt, n_init_max, n_corr_max = 1.0, 1, 1

    def uniform(n=()):
        return torch.rand(n, generator=gen, dtype=torch.float64)

    use_pt = bool(uniform() < p_pt)
    use_box = bool(uniform() < sim.prob_to_use_box_input)
    mode = (1 if use_box else 0) if use_pt else 2
    if sim.rand_init_cond_frames and n_init_max > 1 and is_training:
        n_init = int(torch.randint(1, n_init_max + 1, (), generator=gen))
    else:
        n_init = n_init_max
    # init frames: frame 0 + (n_init - 1) random others
    r = uniform((t,))
    r[0] = -1.0
    is_init = _rank(r) < n_init
    order = torch.argsort(torch.where(is_init, 0, 1) * t + torch.arange(t), stable=True)
    # corrected frames: the init frames + a random count of others (point input only)
    if sim.rand_frames_to_correct and n_corr_max > 1 and is_training:
        n_corr = max(int(torch.randint(n_init, n_corr_max + 1, (), generator=gen)), n_init)
    else:
        n_corr = max(n_corr_max, n_init)
    r2 = torch.where(is_init, torch.inf, uniform((t,)))
    extra = _rank(r2) < (n_corr - n_init)
    should_correct = (is_init | extra) & use_pt
    return Plan(mode, use_pt, n_init, is_init.tolist(), order.tolist(), should_correct.tolist())


def _tile3(x: torch.Tensor) -> torch.Tensor:
    """A single-mask channel repeated to 3 (loss-equivalent to the reference)."""
    return x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x


def _pack(out: dict, pix, coords, labels) -> dict:
    ious = out["ious"]
    if ious.shape[1] == 1:
        ious = ious.repeat(1, 3)
    return {
        "multimasks": _tile3(out["high_res_multimasks"]).float(),
        "ious": ious.float(),
        "score": out["object_score_logits"].float(),
        "low": out["low_res_masks"].float(),
        "high": out["high_res_masks"].float(),
        "obj_ptr": out["obj_ptr"].float(),
        "pix": pix,
        "coords": coords,
        "labels": labels,
    }


def _stack(xs: list, like: torch.Tensor) -> torch.Tensor:
    """Stack the per-step outputs; [0, *like.shape] when there are no steps."""
    return torch.stack(xs) if xs else like.new_zeros((0, *like.shape))


def train_forward(model: SAM2Model, gen: torch.Generator, images: torch.Tensor, masks: torch.Tensor,
                  sim: TrainSimConfig, is_training: bool = True):
    """images [T, B, H, W, 3] normalized, masks [T, B, O, H, W] bool, on the
    model's device; ``gen`` a CPU generator that draws the plan, the noise
    generator's seed, the temporal fusion's draws and the attention-dropout
    seeds. Returns (stacked outputs by processing position, final logits by
    frame [T, Bo, H, W], the plan)."""
    cfg = model.cfg
    t, b, h, w, _ = images.shape
    o = masks.shape[2]
    bo = b * o
    dev = images.device
    n_corr_pts = sim.num_correction_pt_per_frame
    p_slots = 2 + n_corr_pts
    pt_method = "uniform" if is_training else sim.pt_sampling_for_eval
    plan = sample_plan(gen, sim, t, is_training)
    noise = torch.Generator(dev).manual_seed(int(torch.randint(2**62, (), generator=gen)))

    fpn = model.forward_image(images.reshape(t * b, h, w, 3), deterministic=not is_training, num_frames=t,
                              gen=gen)["backbone_fpn"]

    def per_obj(x):  # [T*B, ...] -> [T, B*O, ...], objects share their frame's features
        return x.reshape(t, b, *x.shape[1:]).repeat_interleave(o, dim=1)

    top_all = per_obj(fpn[-1])
    hr_all = [per_obj(fpn[0]), per_obj(fpn[1])] if cfg.use_high_res_features_in_sam else None
    bank = init_memory_bank(bo, t, cfg.feat_size**2, cfg.mem_dim, cfg.hidden_dim, device=dev)

    def heads(pix, coords, labels, mask_in, hr, multimask):
        return model.sam_heads(pix, coords, labels, mask_in, hr, multimask_output=multimask,
                               is_training=is_training)

    coords0 = torch.zeros(bo, p_slots, 2, device=dev)
    labels0 = -torch.ones(bo, p_slots, dtype=torch.int32, device=dev)
    steps, finals = [], [None] * t
    for i, ti in enumerate(plan.order):
        top = top_all[ti]
        hr = [x[ti] for x in hr_all] if hr_all is not None else None
        gt = masks[ti].reshape(bo, 1, h, w)
        if i < plan.n_init:
            no_mem = model.no_mem_features(top)
            if plan.mode == 2:
                out = model.use_mask_as_output(top, hr, gt[:, 0, :, :, None].float())
                step0 = _pack(out, no_mem, coords0, labels0)
            else:
                if plan.mode == 0:
                    pts, lbls = get_next_point(gt, None, pt_method, noise)
                    n_pts = 1
                else:
                    pts, lbls = sample_box_points(gt, noise)
                    n_pts = 2
                c, lb = coords0.clone(), labels0.clone()
                c[:, :n_pts], lb[:, :n_pts] = pts, lbls
                step0 = _pack(heads(no_mem, c, lb, None, hr, plan.mode == 0), no_mem, c, lb)
        else:
            pix = model.condition_on_memory(ti, top, bank, t, is_training=is_training,
                                            deterministic=not is_training, gen=gen)
            step0 = _pack(heads(pix, coords0, labels0, None, hr, True), pix, coords0, labels0)

        # correction clicks (reference _iter_correct_pt_sampling:448-541)
        carry, corr = step0, []
        for j in range(n_corr_pts):
            if plan.should_correct[ti]:
                pred = carry["high"] > 0
                if is_training and sim.prob_to_sample_from_gt > 0:
                    if bool(torch.rand((), generator=gen) < sim.prob_to_sample_from_gt):
                        pred = torch.zeros_like(pred)
                pts, lbls = get_next_point(gt, pred, pt_method, noise)
                c, lb = carry["coords"].clone(), carry["labels"].clone()
                c[:, 2 + j], lb[:, 2 + j] = pts[:, 0], lbls[:, 0]
                mask_in = carry["low"][:, 0, :, :, None]  # previous logits as the mask prompt
                carry = _pack(heads(carry["pix"], c, lb, mask_in, hr, False), carry["pix"], c, lb)
            corr.append(carry)

        maskmem = model.encode_memory(top, carry["high"], carry["score"], plan.use_pt, is_training)
        is_cond = plan.is_init[ti] or (sim.add_all_frames_to_correct_as_cond and plan.should_correct[ti])
        write_memory(bank, ti, maskmem.reshape(bo, -1, maskmem.shape[-1]), carry["obj_ptr"], is_cond)
        finals[ti] = carry["high"][:, 0]
        steps.append({
            "step0_multimasks": step0["multimasks"], "step0_ious": step0["ious"],
            "step0_score": step0["score"],
            "corr_multimasks": _stack([s["multimasks"][:, :1] for s in corr], step0["multimasks"][:, :1]),
            "corr_ious": _stack([s["ious"][:, :1] for s in corr], step0["ious"][:, :1]),
            "corr_score": _stack([s["score"] for s in corr], step0["score"]),
            "corr_valid": torch.full((n_corr_pts,), plan.should_correct[ti], device=dev),
            "target": gt[:, 0],
        })
    stacked = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    return stacked, torch.stack(finals), plan
