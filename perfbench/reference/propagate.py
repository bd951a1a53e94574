"""The plain reference of the port's two propagation entries, in float32.

``propagate`` works out what ``inference/serve.py::batched_propagate`` and
``SAM2VideoPredictor.init_state`` -> ``add_new_points_or_box`` ->
``propagate_in_video`` compute for single-object videos with one prompt on
frame 0, from the raw uint8 frames, the clicks and a state dict, with the
frozen model code of this folder: frame 0 prompted without memory, its memory
encoded from the binarized mask as a conditioning memory, then every later
frame conditioned on the bank (one conditioning slot) and its own memory
written; the low-res logits of every frame but the prompted one hole-filled
(the prompted one too when ``fill_first``, as serving does). Every row of the
batch is a video. The bank is float32 and has one slot a frame.
"""

from __future__ import annotations

import contextlib

import torch

from perfbench.reference.config import sam2_config_from_dict
from perfbench.reference.models.memory_bank import init_memory_bank, write_memory
from perfbench.reference.models.sam2 import SAM2Model
from perfbench.reference.ops.connected_components import fill_holes_in_mask_scores
from perfbench.reference.ops.resize import resize2d
from perfbench.reference.transforms import prep_frames


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def build_model(model_cfg: dict, state_dict: dict, device) -> SAM2Model:
    """The frozen SAM2Model in float32 on ``device`` with ``state_dict``'s values."""
    with torch.device("meta"):
        model = SAM2Model(sam2_config_from_dict(model_cfg))
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def _encode(model, images):
    fpn = model.forward_image(images)["backbone_fpn"]
    feats = {"top": fpn[-1]}
    if model.cfg.use_high_res_features_in_sam:
        feats["s0"], feats["s1"] = fpn[0], fpn[1]
    return feats


@torch.inference_mode()
def propagate(model: SAM2Model, video_u8: torch.Tensor, coords: torch.Tensor, labels: torch.Tensor,
              fill_hole_area: int, fill_first: bool, video_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """video_u8 [N, T, H, W, 3] uint8 on the model's device, coords [N, P, 2]
    (x, y) at model resolution, labels [N, P] -> f32 logits [N, T, 4fs, 4fs]
    (or [N, T, *video_hw] resized bilinearly when ``video_hw`` is given)."""
    c = model.cfg
    n, t = video_u8.shape[:2]
    dev = video_u8.device
    bank = init_memory_bank(n, t, c.feat_size**2, c.mem_dim, c.hidden_dim, dtype=model.dtype,
                            ptr_dtype=torch.float32, device=dev)
    num_pts = coords.shape[1]
    multimask = c.multimask_output_in_sam and c.multimask_min_pt_num <= num_pts <= c.multimask_max_pt_num
    frames = [prep_frames(video_u8[:, i], c.image_size) for i in range(t)]
    feats0 = _encode(model, frames[0])
    out, _ = model.track_step(0, feats0, bank, t, coords, labels, is_init_cond_frame=True, is_cond_frame=True,
                              multimask_output=multimask, run_mem_encoder=False)
    maskmem = model.encode_memory(feats0["top"], out["high_res_masks"].float(), out["object_score_logits"].float(),
                                  is_mask_from_pts=True)
    write_memory(bank, 0, maskmem.reshape(n, -1, maskmem.shape[-1]), out["obj_ptr"].float(), True)
    lows = [out["low_res_masks"][:, 0].float()]
    for i in range(1, t):
        o, _ = model.track_step(i, _encode(model, frames[i]), bank, t, multimask_output=True,
                                track_in_reverse=False, max_cond_slots=1)
        lows.append(o["low_res_masks"][:, 0].float())
    lows = torch.stack(lows, 1)
    if fill_hole_area > 0:
        first = 0 if fill_first else 1
        filled = fill_holes_in_mask_scores(lows[:, first:].reshape(-1, 1, *lows.shape[2:]), fill_hole_area)
        lows = torch.cat([lows[:, :first], filled.reshape(n, t - first, *lows.shape[2:])], 1)
    if video_hw is not None:
        lows = resize2d(lows.reshape(n * t, *lows.shape[2:], 1), tuple(video_hw))[..., 0]
        lows = lows.reshape(n, t, *video_hw)
    return lows
