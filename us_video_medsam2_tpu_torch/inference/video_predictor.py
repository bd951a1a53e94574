"""Interactive video predictor: init_state, add_new_points_or_box, propagate_in_video.

Counterpart of the JAX package's ``inference/video_predictor.py`` (reference
sam2/sam2_video_predictor_npz.py) for its main path. The memory bank is the
same fixed-shape store (bf16 spatial memories, f32 object pointers) with a
validity mask. Workflow as in the JAX package:

- a prompt call runs track_step without the memory encoder; prompted frames'
  memories are encoded once at the start of propagation, with the mask from
  points binarized (the reference's consolidation, predictor:593-660). The
  prompted frame's features are kept from the prompt call for that encode;
- every object is a batch row sharing the frame's features;
- propagation runs the tracking window first; then, ``EMIT_CHUNK`` tracked
  frames at a time, it fills holes (``fill_hole_area``) in one pass over
  the chunk's low-res logits of every object (misc.py:312-339), resizes them
  to the video resolution, copies them to the host, and yields.

The window is the JAX predictor's one-program propagation (``lax.scan``
over ``_propagate_impl``'s body): each tracked frame is one call of
``graphs.frame_body`` with the frame index as a 0-d device tensor. On a CUDA
device that call is one replay of a CUDA graph of the body, and the host
does not wait on the device until the window has run; on the CPU the body
runs eagerly. ``precompute_features_batch`` has the JAX meaning: 0 or 1, the
body encodes its own frame; N > 1, every frame of the state is encoded in
batches of N before the window and the body reads its row.

Bucketing, host offload, chunked streaming, object removal and prompt
clearing are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from us_video_medsam2_tpu_torch.core.build import build_sam2
from us_video_medsam2_tpu_torch.core.config import SAM2Config
from us_video_medsam2_tpu_torch.core.device import resolve_device
from us_video_medsam2_tpu_torch.core.switches import (
    fused_cxblock_enabled,
    fused_qkv_window_attention_enabled,
)
from us_video_medsam2_tpu_torch.inference.graphs import (
    FrameGraphs,
    copy_bank,
    encode_frames,
    frame_body,
    make_buffers,
    weight_tensors,
)
from us_video_medsam2_tpu_torch.inference.transforms import (
    preprocess_images,
    transform_boxes,
    transform_coords,
)
from us_video_medsam2_tpu_torch.models.memory_bank import MemoryBank, init_memory_bank, write_memory
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.ops.connected_components import fill_holes_in_mask_scores
from us_video_medsam2_tpu_torch.ops.resize import resize2d

NO_OBJ_SCORE = -1024.0
EMIT_CHUNK = 16  # frames hole-filled, resized to the video resolution and copied to the host at once


@dataclasses.dataclass
class VideoPredictorState:
    images: torch.Tensor  # [T, S, S, 3] normalized f32 frames on the predictor's device
    video_height: int
    video_width: int
    num_frames: int
    max_objects: int
    bank: MemoryBank
    obj_ids: List[int] = dataclasses.field(default_factory=list)
    # per prompted frame: obj_idx -> outputs awaiting their memory encode
    pending: Dict[int, Dict[int, Dict]] = dataclasses.field(default_factory=dict)
    # per prompted frame: low-res logits [O, h, w] yielded without recompute
    cond_low_res: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    frames_tracked: set = dataclasses.field(default_factory=set)
    # features of prompted frames, reused by their memory encode
    prompt_feats: Dict[int, Dict[str, torch.Tensor]] = dataclasses.field(default_factory=dict)

    def obj_idx(self, obj_id: int) -> int:
        if obj_id in self.obj_ids:
            return self.obj_ids.index(obj_id)
        if len(self.obj_ids) >= self.max_objects:
            raise ValueError(f"too many objects: allocate init_state(..., max_objects>{self.max_objects})")
        self.obj_ids.append(obj_id)
        return len(self.obj_ids) - 1


class SAM2VideoPredictor:
    def __init__(self, model: SAM2Model, fill_hole_area: int = 8,
                 device: str | torch.device = "cuda", precompute_features_batch: int = 0):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg: SAM2Config = model.cfg
        self.fill_hole_area = fill_hole_area
        # 0/1: the frame body encodes its frame; N > 1: every frame is encoded
        # in batches of N before the window
        self.precompute_batch = precompute_features_batch
        self.graphs = FrameGraphs()  # the frame body's CUDA graphs, by key

    # ------------------------------------------------------------- state mgmt
    @torch.inference_mode()
    def init_state(self, images, video_height: int, video_width: int,
                   max_objects: int = 1) -> VideoPredictorState:
        """images: [T, S, S, 3] normalized float frames at model resolution, or
        [T, H, W, 3] uint8 frames to be normalized and resized here."""
        x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        x = x.to(self.device)
        if x.dtype == torch.uint8 or x.shape[1] != self.cfg.image_size:
            x = preprocess_images(x, self.cfg.image_size)
        c = self.cfg
        bank = init_memory_bank(max_objects, x.shape[0], c.feat_size**2, c.mem_dim, c.hidden_dim,
                                dtype=torch.bfloat16, ptr_dtype=torch.float32, device=self.device)
        return VideoPredictorState(images=x.float(), video_height=video_height,
                                   video_width=video_width, num_frames=int(x.shape[0]),
                                   max_objects=max_objects, bank=bank)

    def _encode_frame(self, state: VideoPredictorState, t: int) -> Dict[str, torch.Tensor]:
        return encode_frames(self.model, state.images[t: t + 1])

    @staticmethod
    def _to_video_res(low_res: torch.Tensor, hw) -> torch.Tensor:
        """[..., h, w] logits -> [..., H, W] f32 (bilinear)."""
        lead = low_res.shape[:-2]
        x = low_res.reshape(-1, *low_res.shape[-2:])
        return resize2d(x[..., None].float(), hw)[..., 0].reshape(*lead, *hw)

    # -------------------------------------------------------------- prompting
    @torch.inference_mode()
    def add_new_points_or_box(self, state: VideoPredictorState, frame_idx: int, obj_id: int,
                              points=None, labels=None, box=None, normalize_coords: bool = True):
        """Returns (frame_idx, obj_ids, video_res_masks [O, 1, H, W] logits as numpy)."""
        c = self.cfg
        hw = (state.video_height, state.video_width)
        pts_list, lbl_list = [], []
        if box is not None:
            bx = np.asarray(box, np.float32).reshape(1, 4)
            bpts = transform_boxes(bx, hw, c.image_size) if normalize_coords else bx.reshape(1, 2, 2)
            pts_list.append(bpts.reshape(1, 2, 2))
            lbl_list.append(np.array([[2, 3]], np.int32))
        if points is not None:
            p = np.asarray(points, np.float32).reshape(1, -1, 2)
            if normalize_coords:
                p = transform_coords(p, hw, c.image_size)
            pts_list.append(p)
            lbl_list.append(np.asarray(labels, np.int32).reshape(1, -1))
        if not pts_list:
            raise ValueError("provide points and/or box")
        coords = torch.as_tensor(np.concatenate(pts_list, axis=1), device=self.device)
        lbls = torch.as_tensor(np.concatenate(lbl_list, axis=1), device=self.device)
        num_pts = coords.shape[1]
        multimask = c.multimask_output_in_sam and c.multimask_min_pt_num <= num_pts <= c.multimask_max_pt_num
        return self._prompt(state, frame_idx, obj_id, coords, lbls, None, multimask)

    @torch.inference_mode()
    def add_new_mask(self, state: VideoPredictorState, frame_idx: int, obj_id: int, mask):
        """mask: [H, W] bool/float at any resolution (reference add_new_mask:321-408).
        Returns as add_new_points_or_box."""
        s = self.cfg.image_size
        m = torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask) else mask)
        m = m.to(self.device).float()[None, ..., None]
        if m.shape[1:3] != (s, s):
            m = (resize2d(m, (s, s), antialias=True) >= 0.5).float()
        return self._prompt(state, frame_idx, obj_id, None, None, m, False)

    def _prompt(self, state, frame_idx, obj_id, coords, labels, mask, multimask):
        hw = (state.video_height, state.video_width)
        obj_idx = state.obj_idx(obj_id)
        is_init = frame_idx not in state.frames_tracked
        feats = state.prompt_feats.get(frame_idx)
        if feats is None:
            feats = state.prompt_feats[frame_idx] = self._encode_frame(state, frame_idx)
        out, _ = self.model.track_step(
            frame_idx, feats, state.bank.rows(obj_idx, obj_idx + 1), state.num_frames,
            coords, labels, mask, is_init_cond_frame=is_init, is_cond_frame=True,
            multimask_output=multimask, run_mem_encoder=False,
        )
        state.pending.setdefault(frame_idx, {})[obj_idx] = {
            "high_res_masks": out["high_res_masks"],
            "low_res_masks": out["low_res_masks"],
            "obj_ptr": out["obj_ptr"],
            "score": out["object_score_logits"],
            "video_res": self._to_video_res(out["low_res_masks"][:, 0], hw)[0].cpu().numpy(),
        }
        video = np.full((state.max_objects, *hw), NO_OBJ_SCORE, np.float32)
        for oi, rec in state.pending[frame_idx].items():
            video[oi] = rec["video_res"]
        return frame_idx, list(state.obj_ids), video[:, None]

    # ------------------------------------------------------------ propagation
    def propagate_in_video_preflight(self, state: VideoPredictorState):
        """Encode the memories of all prompted frames (consolidation)."""
        c = self.cfg
        o = state.max_objects
        for frame_idx, per_obj in sorted(state.pending.items()):
            high = torch.full((o, 1, c.image_size, c.image_size), NO_OBJ_SCORE, device=self.device)
            scores = torch.full((o, 1), NO_OBJ_SCORE, device=self.device)
            ptrs = torch.zeros(o, c.hidden_dim, device=self.device)
            low = torch.full((o, 4 * c.feat_size, 4 * c.feat_size), NO_OBJ_SCORE, device=self.device)
            for oi, rec in per_obj.items():
                high[oi] = rec["high_res_masks"][0].float()
                scores[oi] = rec["score"][0].float()
                ptrs[oi] = rec["obj_ptr"][0].float()
                low[oi] = rec["low_res_masks"][0, 0].float()
            feats = state.prompt_feats.pop(frame_idx, None) or self._encode_frame(state, frame_idx)
            top = feats["top"].expand(o, -1, -1, -1)
            maskmem = self.model.encode_memory(top, high, scores, is_mask_from_pts=True)
            write_memory(state.bank, frame_idx, maskmem.reshape(o, -1, maskmem.shape[-1]), ptrs, True)
            state.cond_low_res[frame_idx] = low
        state.pending = {}

    @torch.inference_mode()
    def propagate_in_video(self, state: VideoPredictorState, start_frame_idx: Optional[int] = None,
                           max_frame_num_to_track: Optional[int] = None, reverse: bool = False
                           ) -> Iterator[Tuple[int, List[int], np.ndarray]]:
        """Yields (frame_idx, obj_ids, video_res_mask_logits [O, 1, H, W] numpy)
        in tracking order, once the whole window has run."""
        self.propagate_in_video_preflight(state)
        cond_frames = sorted(state.cond_low_res)
        if not cond_frames:
            raise RuntimeError("No prompts provided; add points or boxes first")
        t0 = min(cond_frames) if start_frame_idx is None else start_frame_idx
        nf = state.num_frames
        if reverse:
            end = max(t0 - (max_frame_num_to_track or nf), 0)
            order = range(t0, end - 1, -1) if t0 > 0 else []
        else:
            end = min(t0 + (max_frame_num_to_track or nf), nf - 1)
            order = range(t0, end + 1)
        hw = (state.video_height, state.video_width)
        # with N prompted frames only N conditioning slots can ever be valid
        mcs = max(1, min(self.cfg.max_cond_frame_slots, len(cond_frames)))
        # the tracking window is (t0, end]; prompted frames keep their output
        ran = [t for t in order if t not in state.cond_low_res and t != t0]
        if ran:
            lo = min(ran)
            # off the graph's buffer, which the next window writes
            lows = self._run_window(state, ran, reverse, mcs)[lo: max(ran) + 1].clone()
        chunk, c0 = None, 0
        for t in order:
            if t in state.cond_low_res:
                video = self._to_video_res(state.cond_low_res[t], hw).cpu().numpy()
            elif t != t0:
                # hole-filled, resized and copied to the host EMIT_CHUNK frames at a
                # time: the hole filling's memory is bounded by the chunk, not the video
                if chunk is None or not c0 <= t - lo < c0 + len(chunk):
                    c0 = (t - lo) // EMIT_CHUNK * EMIT_CHUNK
                    filled = fill_holes_in_mask_scores(lows[c0: c0 + EMIT_CHUNK], self.fill_hole_area)
                    chunk = self._to_video_res(filled, hw).cpu().numpy()
                video = chunk[t - lo - c0]
                state.frames_tracked.add(t)
            else:
                continue
            yield t, list(state.obj_ids), video[:, None]

    def _graph_key(self, state: VideoPredictorState, reverse: bool, mcs: int) -> tuple:
        """What a captured frame body depends on beyond its buffers' contents:
        shapes, direction, the encoding mode, the two switches (read when
        the body runs, so at capture) and the compute dtype."""
        return (state.num_frames, state.max_objects, mcs, reverse, self.precompute_batch > 1,
                fused_cxblock_enabled(), fused_qkv_window_attention_enabled(), self.model.dtype)

    def _run_window(self, state: VideoPredictorState, frames: List[int], reverse: bool,
                    mcs: int) -> torch.Tensor:
        """The frame body for each of ``frames`` in order; returns the
        [F, O, 4fs, 4fs] low-res logits, row t written for each t run. On the
        card each frame is one graph replay and nothing waits on the device."""
        model, nf = self.model, state.num_frames
        precompute = self.precompute_batch > 1
        on_card = self.device.type == "cuda"
        if on_card:
            graph = self.graphs.get(
                self._graph_key(state, reverse, mcs),
                lambda: make_buffers(model, state.bank, precompute, new_bank=True),
                lambda b: frame_body(model, b, nf, reverse, mcs),
                weight_tensors(model),
            )
            bufs = graph.bufs
        else:
            bufs = make_buffers(model, state.bank, precompute, new_bank=False)
        if precompute:
            n = self.precompute_batch
            for s in range(0, nf, n):
                for k, v in encode_frames(model, state.images[s: s + n]).items():
                    bufs.feats[k][s: s + n].copy_(v)
        if on_card:
            copy_bank(bufs.bank, state.bank)
        for t in frames:
            bufs.t.fill_(t)
            if bufs.frame is not None:
                bufs.frame.copy_(state.images[t: t + 1])
            if on_card:
                graph.replay()
            else:
                frame_body(model, bufs, nf, reverse, mcs)
        if on_card:
            copy_bank(state.bank, bufs.bank)
        return bufs.lows


def build_sam2_video_predictor(config="sam2.1_hiera_t512", state_dict=None, device="cuda",
                               dtype=torch.bfloat16, seed: int = 0, fill_hole_area: int = 8,
                               precompute_features_batch: int = 0, **overrides):
    """Build the model (weights from ``state_dict``, else made from ``seed``),
    move it to ``device`` in compute ``dtype`` and wrap it in the predictor."""
    dev = resolve_device(device)
    model = build_sam2(config, state_dict, seed=seed, **overrides)
    return SAM2VideoPredictor(model.to(dev).set_compute_dtype(dtype), fill_hole_area, device=dev,
                              precompute_features_batch=precompute_features_batch)


def build_efficienttam_video_predictor(config="efficientmedsam_s_512", state_dict=None, device="cuda",
                                       **kwargs):
    """The EfficientTAM family's predictor (reference
    efficient_track_anything/build_efficienttam.py): ``build_sam2_video_predictor``
    with an EfficientTAM preset."""
    return build_sam2_video_predictor(config, state_dict, device, **kwargs)
