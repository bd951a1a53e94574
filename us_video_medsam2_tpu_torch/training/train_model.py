"""Training-time forward: interactive-prompt simulation + video tracking.

Counterpart of the JAX package's ``training/train_model.py`` (reference
training/model/sam2.py:25-541, SAM2Train). As in the JAX package, the whole
forward stays on the device and runs the same operations whatever the
plan, so one captured program covers every simulation outcome
(``train_step.py`` captures it in a CUDA graph on the card):

- the plan (prompt mode, initial conditioning frames, processing order,
  corrected frames) is drawn on the device from the step's generator
  (``sample_plan``, JAX ``_sample_plan``) and stays there as tensors;
- the frame loop (JAX's ``lax.scan`` over the processing order, the bank as
  its carry) runs over positions 0..T-1, and the frame ``order[i]`` is a
  device index: features and masks are taken by ``index_select`` and the
  memory bank is read and written at a tensor index;
- each ``lax.switch`` / ``lax.cond`` of the JAX step is a selection
  (``torch.where``) between branches that both ran: the prompt modes the
  config can draw (a probability of 0 or 1 rules a mode out), the initial
  and the tracked branch at positions 1..n_init_max-1 (position 0 is always
  an initial frame and every later position always a tracked one), and
  every correction click, whose result is kept where the frame is corrected
  (JAX's ``lambda c: c`` else). The branch not taken gets an exact zero
  gradient through the selection, and every branch sees finite inputs.

Kept from the JAX package:

- the image encoder runs once over all T·B frames;
- point prompts live in a fixed [Bo, 2 + num_correction_pt, 2] slot array
  padded with label -1 (the prompt encoder's not-a-point), so every SAM-head
  call sees the same token count;
- every frame emits one output per correction step; steps that did not run
  repeat the previous output with ``corr_valid`` False and add zero loss.

Rematerialisation, as the JAX step's ``jax.checkpoint`` with
``_remat_policy``: with gradients on, each frame's body (the branches and
their selections, the clicks, the memory encoding and the bank write) runs
under ``torch.utils.checkpoint`` with ``remat_policy``, and each click's
body (a click, one SAM-heads call, the selection) under a checkpoint of its
own inside it. The backward pass recomputes the bodies' activations instead
of keeping them; the frame's checkpoint saves only the dropout-flash
forward's (out, lse) (``FLASH_RESID``), so that kernel runs once a step, and
the values of the draws. Everything the recompute reads is as the forward
left it, so the loss, the gradients and the update keep their bits:
- the bank is the frames' carry, a new ``MemoryBank`` a frame
  (``with_memory``, out of place), as JAX's scan carries it;
- a frame body's draws (the step's generator: prompt noise, dropout-flash
  seeds; the device's default one: the memory attention's residual
  dropouts) are saved by the policy and taken again by the recompute,
  which draws nothing; a click's uniforms are drawn before its body and
  passed in (JAX passes its keys), so the click body draws nothing.
The image encoder and the temporal fusion stay outside the bodies, as in
JAX.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from us_video_medsam2_tpu_torch.kernels.flash_dropout import FLASH_RESID
from us_video_medsam2_tpu_torch.models.memory_bank import init_memory_bank, with_memory
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.training.prompt_sampling import get_next_point, point_noise, sample_box_points


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
    """The step's prompt plan, tensors on the device (JAX ``_sample_plan``'s dict)."""

    mode: torch.Tensor  # 0-d long: 0 point, 1 box, 2 mask
    use_pt: torch.Tensor  # 0-d bool
    n_init: torch.Tensor  # 0-d long: initial conditioning frames
    is_init: torch.Tensor  # [T] bool, by frame
    order: torch.Tensor  # [T] long: the processing order of the frames
    should_correct: torch.Tensor  # [T] bool, by frame


def plan_limits(sim: TrainSimConfig, t: int, is_training: bool) -> tuple:
    """(p_pt, n_init_max, n_corr_max) of a T-frame step (reference
    prepare_prompt_inputs, model/sam2.py:146-267): a one-frame video always
    takes one clicked or boxed initial frame."""
    if t == 1:
        return 1.0, 1, 1
    if is_training:
        return sim.prob_to_use_pt_input, sim.num_init_cond_frames, sim.num_frames_to_correct
    return sim.prob_to_use_pt_input_for_eval, sim.num_init_cond_frames_for_eval, sim.num_frames_to_correct_for_eval


def possible_modes(sim: TrainSimConfig, t: int, is_training: bool) -> tuple:
    """The prompt modes a plan can draw: ``uniform < p`` never holds at p 0
    and always at p 1, so those rule a mode out."""
    p_pt = plan_limits(sim, t, is_training)[0]
    p_box = sim.prob_to_use_box_input
    modes = []
    if p_pt > 0.0:
        modes += ([0] if p_box < 1.0 else []) + ([1] if p_box > 0.0 else [])
    return tuple(modes + ([2] if p_pt < 1.0 else []))


def draw_plan_uniforms(gen: torch.Generator, t: int, device) -> dict:
    """The plan's uniform draws in [0, 1), f32, on ``device`` (one draw of
    2·T + 4): scalars pt, box, n_init, n_corr and [T] vectors init, corr."""
    u = torch.rand(2 * t + 4, generator=gen, device=device)
    return {"pt": u[0], "box": u[1], "n_init": u[2], "n_corr": u[3], "init": u[4: 4 + t], "corr": u[4 + t:]}


def _rank(x: torch.Tensor) -> torch.Tensor:
    return torch.argsort(torch.argsort(x, stable=True), stable=True)


def _randint(u: torch.Tensor, lo, hi: int) -> torch.Tensor:
    """An int uniform in [lo, hi) from a uniform ``u`` in [0, 1) (``lo`` an
    int or a 0-d long tensor)."""
    return torch.clamp(lo + torch.floor(u * (hi - lo)).long(), max=hi - 1)


def plan_from_uniforms(u: dict, sim: TrainSimConfig, t: int, is_training: bool) -> Plan:
    """JAX ``_sample_plan`` over given uniforms (``draw_plan_uniforms``):
    bernoulli(p) is ``u < p`` and randint(lo, hi) ``lo + floor(u·(hi - lo))``."""
    p_pt, n_init_max, n_corr_max = plan_limits(sim, t, is_training)
    dev = u["pt"].device
    use_pt = u["pt"] < p_pt
    use_box = u["box"] < sim.prob_to_use_box_input
    mode = torch.where(use_pt, torch.where(use_box, 1, 0), 2).long()
    if sim.rand_init_cond_frames and n_init_max > 1 and is_training:
        n_init = _randint(u["n_init"], 1, n_init_max + 1)
    else:
        n_init = torch.full((), n_init_max, dtype=torch.long, device=dev)
    # init frames: frame 0 + (n_init - 1) random others
    r = torch.cat([torch.full((1,), -1.0, device=dev), u["init"][1:]])
    is_init = _rank(r) < n_init
    order = torch.argsort(torch.where(is_init, 0, 1) * t + torch.arange(t, device=dev), stable=True)
    # corrected frames: the init frames + a random count of others (point input only)
    if sim.rand_frames_to_correct and n_corr_max > 1 and is_training:
        n_corr = torch.maximum(_randint(u["n_corr"], n_init, n_corr_max + 1), n_init)
    else:
        n_corr = torch.clamp(n_init, min=n_corr_max)
    r2 = torch.where(is_init, torch.full_like(u["corr"], float("inf")), u["corr"])
    extra = _rank(r2) < (n_corr - n_init)
    should_correct = (is_init | extra) & use_pt
    return Plan(mode, use_pt, n_init, is_init, order, should_correct)


def sample_plan(gen: torch.Generator, sim: TrainSimConfig, t: int, is_training: bool, device=None) -> Plan:
    """The prompt plan (reference prepare_prompt_inputs, model/sam2.py:146-267),
    drawn from ``gen`` on ``device`` (``gen``'s by default): nothing is read
    back to the host."""
    return plan_from_uniforms(draw_plan_uniforms(gen, t, device or gen.device), sim, t, is_training)


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


def _select(cond: torch.Tensor, a: dict, b: dict) -> dict:
    """``a`` where the 0-d bool ``cond`` holds, else ``b``, key by key (a
    branch of ``lax.cond`` / ``lax.switch`` that both sides ran)."""
    return {k: torch.where(cond, a[k], b[k]) for k in a}


def remat_policy(ctx, op, *args, **kwargs):
    """The frame body's selective checkpoint (JAX ``_remat_policy``,
    ``save_only_these_names(FLASH_RESID)``): the dropout-flash forward's
    outputs and every draw are saved, everything else is recomputed. A draw
    in place cannot be saved (the recompute would get its value but not
    write it), so one raises."""
    if op is FLASH_RESID:
        return CheckpointPolicy.MUST_SAVE
    if torch.Tag.nondeterministic_seeded in op.tags:
        if op._schema.is_mutable:
            raise RuntimeError(f"remat: the draw {op} writes in place; its value cannot be saved for the recompute")
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_remat_contexts = functools.partial(create_selective_checkpoint_contexts, remat_policy)


def _checkpointed(fn, *args, context_fn=None):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (non-reentrant; the generators are left alone: a body's draws are saved
    or passed in). The tensors inside ``args``' lists and dicts are the
    checkpoint's own inputs, so an enclosing checkpoint recomputes them
    instead of the inner one holding them."""
    leaves, spec = tree_flatten(args)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(lambda *xs: fn(*tree_unflatten(list(xs), spec)), *leaves, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def train_forward(model: SAM2Model, gen: torch.Generator, images: torch.Tensor, masks: torch.Tensor,
                  sim: TrainSimConfig, is_training: bool = True, shard=None, plan: Plan | None = None,
                  remat: bool = True):
    """images [T, B, H, W, 3] normalized, masks [T, B, O, H, W] bool, on the
    model's device; ``gen`` a generator on that device that draws the plan,
    the prompt noise, the temporal fusion's draws and the attention-dropout
    seeds. ``plan``: a given plan (JAX's, in the tests) instead of a drawn
    one. ``shard`` (offset, total): where these B·O objects lie among the
    global batch's under data parallelism (``prompt_sampling``). ``remat``
    False keeps every activation (the step without rematerialisation, which
    the step with it is held against; with gradients off there is nothing
    to recompute). Returns (stacked outputs by processing position, final
    logits by frame [T, Bo, H, W], the plan). Nothing is read back to the
    host."""
    cfg = model.cfg
    t, b, h, w, _ = images.shape
    o = masks.shape[2]
    bo = b * o
    dev = images.device
    n_corr_pts = sim.num_correction_pt_per_frame
    p_slots = 2 + n_corr_pts
    pt_method = "uniform" if is_training else sim.pt_sampling_for_eval
    n_init_max = plan_limits(sim, t, is_training)[1]
    modes = possible_modes(sim, t, is_training)
    clicks = n_corr_pts if plan_limits(sim, t, is_training)[0] > 0.0 else 0  # no point input: no correction
    if plan is None:
        plan = sample_plan(gen, sim, t, is_training, dev)
    remat = remat and torch.is_grad_enabled()

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

    def prompted(pix, pts, lbls, hr, multimask):
        c, lb = coords0.clone(), labels0.clone()
        c[:, :pts.shape[1]], lb[:, :pts.shape[1]] = pts, lbls
        return _pack(heads(pix, c, lb, None, hr, multimask), pix, c, lb)

    def init_branch(top, hr, gt):  # JAX lax.switch over the modes the config can draw
        no_mem = model.no_mem_features(top)
        outs = {}
        if 0 in modes:
            outs[0] = prompted(no_mem, *get_next_point(gt, None, pt_method, gen, shard), hr, True)
        if 1 in modes:
            outs[1] = prompted(no_mem, *sample_box_points(gt, gen, shard=shard), hr, False)
        if 2 in modes:
            out = model.use_mask_as_output(top, hr, gt[:, 0, :, :, None].float())
            outs[2] = _pack(out, no_mem, coords0, labels0)
        step0 = outs[modes[-1]]
        for m in reversed(modes[:-1]):
            step0 = _select(plan.mode == m, outs[m], step0)
        return step0

    def track_branch(ti, top, hr, bank):
        pix = model.condition_on_memory(ti, top, bank, t, is_training=is_training,
                                        deterministic=not is_training, gen=gen)
        return _pack(heads(pix, coords0, labels0, None, hr, True), pix, coords0, labels0)

    def click_draws(gt):
        """A click's draws, made before its body: whether it samples from
        the ground truth alone, and its uniforms."""
        from_gt = None
        if is_training and sim.prob_to_sample_from_gt > 0:
            from_gt = torch.rand((), generator=gen, device=dev) < sim.prob_to_sample_from_gt
        return point_noise(gt, pt_method, gen, shard), from_gt

    def click(gt, hr, should_correct, carry, j, noise, from_gt):
        """Correction click j (reference _iter_correct_pt_sampling:448-541,
        JAX ``corr_body``): it runs, and its result is kept where the frame
        is corrected."""
        pred = carry["high"] > 0
        if from_gt is not None:
            pred = pred & ~from_gt
        pts, lbls = get_next_point(gt, pred, pt_method, None, shard, noise=noise)
        c, lb = carry["coords"].clone(), carry["labels"].clone()
        c[:, 2 + j], lb[:, 2 + j] = pts[:, 0], lbls[:, 0]
        mask_in = carry["low"][:, 0, :, :, None]  # previous logits as the mask prompt
        clicked = _pack(heads(carry["pix"], c, lb, mask_in, hr, False), carry["pix"], c, lb)
        return _select(should_correct, clicked, carry)

    def frame(ti, i, bank):
        """Position i, frame ``ti`` (a 0-d device index), from the bank the
        earlier positions left (JAX ``frame_body``): (the new bank, the
        position's outputs, its final logits)."""
        at = ti.reshape(1)
        top = top_all.index_select(0, at)[0]
        hr = [x.index_select(0, at)[0] for x in hr_all] if hr_all is not None else None
        gt = masks.index_select(0, at)[0].reshape(bo, 1, h, w)
        should_correct = plan.should_correct.index_select(0, at)[0]
        # position 0 is always an initial frame, positions from n_init_max on always tracked
        init = init_branch(top, hr, gt) if i < n_init_max else None
        track = track_branch(ti, top, hr, bank) if i > 0 else None
        if init is None or track is None:
            step0 = init if track is None else track
        else:
            step0 = _select(plan.n_init > i, init, track)

        carry, corr = step0, []
        for j in range(n_corr_pts):
            if j < clicks:
                args = (gt, hr, should_correct, carry, j, *click_draws(gt))
                carry = _checkpointed(click, *args) if remat else click(*args)
            corr.append(carry)

        maskmem = model.encode_memory(top, carry["high"], carry["score"], plan.use_pt, is_training)
        is_cond = plan.is_init.index_select(0, at)[0]
        if sim.add_all_frames_to_correct_as_cond:
            is_cond = is_cond | should_correct
        bank = with_memory(bank, ti, maskmem.reshape(bo, -1, maskmem.shape[-1]), carry["obj_ptr"], is_cond)
        return bank, {
            "step0_multimasks": step0["multimasks"], "step0_ious": step0["ious"],
            "step0_score": step0["score"],
            "corr_multimasks": _stack([s["multimasks"][:, :1] for s in corr], step0["multimasks"][:, :1]),
            "corr_ious": _stack([s["ious"][:, :1] for s in corr], step0["ious"][:, :1]),
            "corr_score": _stack([s["score"] for s in corr], step0["score"]),
            "corr_valid": should_correct.reshape(1).expand(n_corr_pts),
            "target": gt[:, 0],
        }, carry["high"][:, 0]

    steps, final_high = [], []
    for i in range(t):
        ti = plan.order[i]  # a 0-d device index
        if remat:
            bank, step, high = _checkpointed(frame, ti, i, bank, context_fn=_remat_contexts)
        else:
            bank, step, high = frame(ti, i, bank)
        steps.append(step)
        final_high.append(high)
    stacked = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    # finals scattered back to frame order for the temporal loss
    finals = torch.stack(final_high).index_select(0, torch.argsort(plan.order))
    return stacked, finals, plan
