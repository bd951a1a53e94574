"""Interactive video predictor: init_state, prompts, editing, propagate_in_video.

Counterpart of the JAX package's ``inference/video_predictor.py`` (reference
sam2/sam2_video_predictor_npz.py). The memory bank is the same fixed-shape
store (bf16 spatial memories, f32 object pointers) with a validity mask.
Workflow as in the JAX package:

- a prompt call runs track_step without the memory encoder; prompted frames'
  memories are encoded once at the start of propagation, with the mask from
  points binarized (the reference's consolidation, predictor:593-660). The
  prompted frame's features are kept from the prompt call for that encode;
- every object is a batch row sharing the frame's features;
- propagation runs the tracking window a chunk at a time (the whole window
  is one chunk unless ``chunk_size`` is given); after each chunk's window,
  ``EMIT_CHUNK`` tracked frames at a time, it fills holes
  (``fill_hole_area``) in one pass over the low-res logits of every object
  (misc.py:312-339), resizes them to the video resolution, copies them to
  the host, and yields, before the next chunk runs.

The window is the JAX predictor's one-program propagation (``lax.scan``
over ``_propagate_impl``'s body): each tracked frame is one call of
``graphs.frame_body`` with the frame index and the video's length as 0-d
device tensors. On a CUDA device that call is one replay of a CUDA graph of
the body, keyed by the bank's slot count (so every length in a
``t_bucket`` shares one capture), and the host does not wait on the device
inside a window; on the CPU the body runs eagerly. ``precompute_features_batch``
has the JAX meaning: 0 or 1, the body encodes its own frame; N > 1, every
frame of a resident video is encoded in batches of N before a window that is
not streamed and the body reads its row.

Long videos (JAX ``init_state``'s options): ``t_bucket`` pads the bank's slot
axis to a bucket of lengths; ``offload_video_to_host`` keeps the frames in
host memory (raw uint8 at model resolution, else preprocessed into
``host_dtype``) and streams them onto the card a chunk at a time through
page-locked buffers (``graphs.ChunkStager``). Editing: ``reset_state``,
``clear_all_prompts_in_frame``, ``remove_object``, re-prompting from
``prev_low_res_mask``, ``non_overlap_masks`` and the scrub of
non-conditioning memories around a prompted frame
(``clear_non_cond_mem_around_input``), as in JAX.
"""

from __future__ import annotations

import dataclasses
import threading
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
    ChunkStager,
    FrameGraphs,
    copy_bank,
    encode_frames,
    frame_body,
    make_buffers,
    weight_tensors,
)
from us_video_medsam2_tpu_torch.inference.transforms import prep_frames, transform_boxes, transform_coords
from us_video_medsam2_tpu_torch.models.memory_bank import (
    MemoryBank,
    clear_window,
    downgrade_frame,
    init_memory_bank,
    permute_rows,
    write_memory,
)
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model, apply_non_overlapping_constraints
from us_video_medsam2_tpu_torch.ops.connected_components import fill_holes_in_mask_scores
from us_video_medsam2_tpu_torch.ops.resize import resize2d

NO_OBJ_SCORE = -1024.0
EMIT_CHUNK = 16  # frames hole-filled, resized to the video resolution and copied to the host at once
OFFLOAD_CHUNK = 64  # chunk_size of an offloaded state's propagation when none is given


@dataclasses.dataclass
class VideoPredictorState:
    images: Optional[torch.Tensor]  # [T, S, S, 3] normalized f32 frames on the device (None if offloaded)
    video_height: int
    video_width: int
    num_frames: int
    max_objects: int
    bank: MemoryBank
    bucket: int = 0  # the bank's slot count (num_frames unless bucketed)
    images_host: Optional[np.ndarray] = None  # [T, S, S, 3] host frames: raw uint8 or host_dtype
    offloaded: bool = False
    obj_ids: List[int] = dataclasses.field(default_factory=list)
    # per prompted frame: obj_idx -> outputs awaiting their memory encode
    pending: Dict[int, Dict[int, Dict]] = dataclasses.field(default_factory=dict)
    # per prompted frame: low-res logits [O, h, w] yielded without recompute
    cond_low_res: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    # tracked frame -> {"reverse": direction it was tracked in}
    frames_tracked: Dict[int, Dict] = dataclasses.field(default_factory=dict)
    # features of prompted frames, reused by their memory encode
    prompt_feats: Dict[int, Dict[str, torch.Tensor]] = dataclasses.field(default_factory=dict)
    # obj_idx -> frames that received point or mask input (reference
    # point_inputs_per_obj / mask_inputs_per_obj, predictor:79-80)
    prompt_frames: Dict[int, set] = dataclasses.field(default_factory=dict)

    def obj_idx(self, obj_id: int) -> int:
        if obj_id in self.obj_ids:
            return self.obj_ids.index(obj_id)
        if len(self.obj_ids) >= self.max_objects:
            raise ValueError(f"too many objects: allocate init_state(..., max_objects>{self.max_objects})")
        self.obj_ids.append(obj_id)
        return len(self.obj_ids) - 1


def round_bucket(t: int) -> int:
    """The bank's slot bucket for ``t`` frames: the next power of two, at least
    16 (37 -> 64, 64 -> 64, 1000 -> 1024)."""
    b = 16
    while b < t:
        b *= 2
    return b


def _non_overlap(x: torch.Tensor) -> torch.Tensor:
    """``apply_non_overlapping_constraints`` over the object axis of
    [O, H, W] or [F, O, H, W] logits."""
    if x.dim() == 3:
        return apply_non_overlapping_constraints(x[:, None])[:, 0]
    return apply_non_overlapping_constraints(x.transpose(0, 1)).transpose(0, 1)


class SAM2VideoPredictor:
    def __init__(self, model: SAM2Model, fill_hole_area: int = 8,
                 device: str | torch.device = "cuda", precompute_features_batch: int = 0,
                 non_overlap_masks: bool = False, clear_non_cond_mem_around_input: bool = False,
                 clear_non_cond_mem_for_multi_obj: bool = False, bank_dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg: SAM2Config = model.cfg
        self.fill_hole_area = fill_hole_area
        self.non_overlap_masks = non_overlap_masks
        # correction-click memory scrubbing (reference predictor:27-30): a
        # prompted frame invalidates the non-conditioning memories around it;
        # single-object only unless clear_non_cond_mem_for_multi_obj
        self.clear_non_cond_mem_around_input = clear_non_cond_mem_around_input
        self.clear_non_cond_mem_for_multi_obj = clear_non_cond_mem_for_multi_obj
        self.bank_dtype = bank_dtype
        # 0/1: the frame body encodes its frame; N > 1: every frame is encoded
        # in batches of N before the window
        self.precompute_batch = precompute_features_batch
        self.graphs = FrameGraphs()  # the frame body's CUDA graphs, by key
        # each tracked frame a replay of a captured body (on the card), else the body run eagerly
        self.use_graphs = self.device.type == "cuda"
        # held by callers that share the predictor across threads around each
        # call that reaches the device (apps/app.py): the graphs' buffers are
        # the predictor's, one set a key, so two windows at once would share them
        self.lock = threading.Lock()

    # ------------------------------------------------------------- state mgmt
    @torch.inference_mode()
    def init_state(self, images, video_height: int, video_width: int, max_objects: int = 1,
                   t_bucket=None, offload_video_to_host: bool = False, io_chunk: int = 32,
                   host_dtype=np.float16) -> VideoPredictorState:
        """images: [T, S, S, 3] normalized float frames at model resolution, or
        [T, H, W, 3] uint8 frames to be normalized and resized here.

        ``t_bucket``: None keeps the bank's slots at T; "auto" rounds them up
        to ``round_bucket(T)``, so every length in the bucket reuses one
        captured frame body; an int pins the bucket. ``offload_video_to_host``
        keeps the frames in host memory and implies "auto": a uint8 video at
        model resolution as its raw bytes (normalized on the card a frame at
        a time), any other video preprocessed here on the CPU, ``io_chunk``
        frames at a time, into ``host_dtype`` (float16 halves the store;
        float32 gives the resident path's bits)."""
        c = self.cfg
        t = int(images.shape[0])
        if offload_video_to_host and t_bucket is None:
            t_bucket = "auto"
        bucket = t if t_bucket is None else round_bucket(t) if t_bucket == "auto" else int(t_bucket)
        if bucket < t:
            raise ValueError(f"t_bucket {bucket} < num_frames {t}")
        images_host = None
        if offload_video_to_host:
            src = images.cpu().numpy() if torch.is_tensor(images) else np.asarray(images)
            if src.dtype == np.uint8 and src.shape[1:3] == (c.image_size, c.image_size):
                images_host = np.ascontiguousarray(src)
            else:
                for a in range(0, t, io_chunk):
                    chunk = torch.from_numpy(np.ascontiguousarray(src[a: a + io_chunk]))
                    out = prep_frames(chunk, c.image_size).numpy().astype(host_dtype)
                    if images_host is None:
                        images_host = np.empty((t, *out.shape[1:]), host_dtype)
                    images_host[a: a + io_chunk] = out
            images = None
        else:
            x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
            images = prep_frames(x.to(self.device), c.image_size)
        return VideoPredictorState(images=images, video_height=video_height, video_width=video_width,
                                   num_frames=t, max_objects=max_objects, bank=self._new_bank(max_objects, bucket),
                                   bucket=bucket, images_host=images_host, offloaded=offload_video_to_host)

    def _new_bank(self, objects: int, slots: int) -> MemoryBank:
        c = self.cfg
        return init_memory_bank(objects, slots, c.feat_size**2, c.mem_dim, c.hidden_dim,
                                dtype=self.bank_dtype, ptr_dtype=torch.float32, device=self.device)

    def reset_state(self, state: VideoPredictorState) -> VideoPredictorState:
        """Every object, prompt and memory dropped; the video and its bucket kept."""
        self._reset_tracking_results(state)
        state.obj_ids = []
        state.prompt_frames = {}
        return state

    def _reset_tracking_results(self, state: VideoPredictorState) -> None:
        """Every input and output dropped, object ids kept (reference
        ``_reset_tracking_results``, sam2_video_predictor.py:860-877)."""
        state.bank = self._new_bank(state.max_objects, state.bank.valid.shape[1])
        state.pending = {}
        state.cond_low_res = {}
        state.frames_tracked = {}
        state.prompt_feats = {}
        for frames in state.prompt_frames.values():
            frames.clear()

    def _frame(self, state: VideoPredictorState, t: int) -> torch.Tensor:
        """Frame ``t`` as normalized f32 [1, S, S, 3] on the device."""
        if state.offloaded:
            x = torch.from_numpy(state.images_host[t: t + 1]).to(self.device)
            return prep_frames(x, self.cfg.image_size)
        return state.images[t: t + 1]

    def _encode_frame(self, state: VideoPredictorState, t: int) -> Dict[str, torch.Tensor]:
        return encode_frames(self.model, self._frame(state, t))

    def _to_video_res(self, low_res: torch.Tensor, hw, non_overlap: bool = False) -> torch.Tensor:
        """[..., O, h, w] logits -> [..., O, H, W] f32 (bilinear), the
        objects then kept apart per pixel when ``non_overlap``."""
        lead = low_res.shape[:-2]
        x = low_res.reshape(-1, *low_res.shape[-2:])
        x = resize2d(x[..., None].float(), hw)[..., 0].reshape(*lead, *hw)
        return _non_overlap(x) if non_overlap else x

    def _num_frames(self, state: VideoPredictorState) -> torch.Tensor:
        return torch.full((), state.num_frames, dtype=torch.long, device=self.device)

    # -------------------------------------------------------------- prompting
    @torch.inference_mode()
    def add_new_points_or_box(self, state: VideoPredictorState, frame_idx: int, obj_id: int,
                              points=None, labels=None, box=None, normalize_coords: bool = True,
                              prev_low_res_mask=None):
        """Returns (frame_idx, obj_ids, video_res_masks [O, 1, H, W] logits as numpy).
        ``prev_low_res_mask`` ([4fs, 4fs] logits, e.g. a frame's earlier
        output) is the decoder's mask prompt beside the clicks."""
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
        prev = None
        if prev_low_res_mask is not None:
            low = 4 * c.feat_size
            prev = torch.as_tensor(prev_low_res_mask, dtype=torch.float32).reshape(1, low, low, 1)
            prev = prev.to(self.device)
        return self._prompt(state, frame_idx, obj_id, coords, lbls, None, multimask, prev)

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

    def _prompt(self, state, frame_idx, obj_id, coords, labels, mask, multimask, prev=None):
        hw = (state.video_height, state.video_width)
        obj_idx = state.obj_idx(obj_id)
        is_init = frame_idx not in state.frames_tracked
        feats = state.prompt_feats.get(frame_idx)
        if feats is None:
            feats = state.prompt_feats[frame_idx] = self._encode_frame(state, frame_idx)
        out, _ = self.model.track_step(
            frame_idx, feats, state.bank.rows(obj_idx, obj_idx + 1), self._num_frames(state),
            coords, labels, mask, prev_sam_mask_logits=prev, is_init_cond_frame=is_init,
            is_cond_frame=True, multimask_output=multimask, run_mem_encoder=False,
        )
        state.prompt_frames.setdefault(obj_idx, set()).add(frame_idx)
        state.pending.setdefault(frame_idx, {})[obj_idx] = {
            "high_res_masks": out["high_res_masks"],
            "low_res_masks": out["low_res_masks"],
            "obj_ptr": out["obj_ptr"],
            "score": out["object_score_logits"],
            "video_res": self._to_video_res(out["low_res_masks"][:, 0], hw)[0].cpu().numpy(),
        }
        return frame_idx, list(state.obj_ids), self._assemble_frame_masks(state, frame_idx, cond=False)

    def _assemble_frame_masks(self, state: VideoPredictorState, frame_idx: int, cond: bool = True) -> np.ndarray:
        """Video-res logits [O, 1, H, W] of one frame from the kept outputs, no
        inference (reference ``_consolidate_temp_output_across_obj(...,
        run_mem_encoder=False)``): the frame's conditioning output where
        ``cond`` and it has one, each pending prompt output over it."""
        hw = (state.video_height, state.video_width)
        low = state.cond_low_res.get(frame_idx) if cond else None
        if low is not None:
            video = self._to_video_res(low, hw, self.non_overlap_masks).cpu().numpy()
        else:
            video = np.full((state.max_objects, *hw), NO_OBJ_SCORE, np.float32)
        for oi, rec in state.pending.get(frame_idx, {}).items():
            video[oi] = rec["video_res"]
        if self.non_overlap_masks:
            video = _non_overlap(torch.from_numpy(video)).numpy()
        return video[:, None]

    # ---------------------------------------------------------------- editing
    def _clear_enabled(self, state: VideoPredictorState) -> bool:
        """Reference gate: single-object only unless the multi-object flag is
        set (sam2_video_predictor.py:627-629, 680-682)."""
        return self.clear_non_cond_mem_around_input and (
            self.clear_non_cond_mem_for_multi_obj or len(state.obj_ids) <= 1)

    def _clear_radius(self) -> int:
        return max(1, self.cfg.memory_temporal_stride_for_eval) * self.cfg.num_maskmem

    @torch.inference_mode()
    def clear_all_prompts_in_frame(self, state: VideoPredictorState, frame_idx: int, obj_id: int,
                                   need_output: bool = True):
        """Remove every point and mask input of ``obj_id`` on ``frame_idx``
        (reference sam2_video_predictor.py:777-845). Returns (frame_idx,
        obj_ids, video_res_masks) when ``need_output``."""
        if obj_id not in state.obj_ids:
            raise ValueError(f"unknown object id {obj_id}")
        obj_idx = state.obj_ids.index(obj_id)
        per = state.pending.get(frame_idx, {})
        per.pop(obj_idx, None)
        if not per:
            state.pending.pop(frame_idx, None)
            state.prompt_feats.pop(frame_idx, None)
        state.prompt_frames.get(obj_idx, set()).discard(frame_idx)
        if not any(frame_idx in frames for frames in state.prompt_frames.values()):
            # no input left on the frame: its conditioning output becomes a
            # non-conditioning memory (:804-821)
            if frame_idx in state.cond_low_res:
                state.cond_low_res.pop(frame_idx)
                downgrade_frame(state.bank, frame_idx)
                state.frames_tracked.pop(frame_idx, None)
            if not state.cond_low_res:  # no conditioning output anywhere: reset (:823-825)
                self._reset_tracking_results(state)
        if not need_output:
            return None
        return frame_idx, list(state.obj_ids), self._assemble_frame_masks(state, frame_idx)

    @torch.inference_mode()
    def remove_object(self, state: VideoPredictorState, obj_id: int, strict: bool = False,
                      need_output: bool = True):
        """Remove an object id from the state (reference
        sam2_video_predictor.py:1042-1153). Returns (obj_ids, updated_frames),
        updated_frames the (frame_idx, video_res_masks) of the frames where
        the object had prompts."""
        updated: List[Tuple[int, np.ndarray]] = []
        if obj_id not in state.obj_ids:
            if not strict:
                return list(state.obj_ids), updated
            raise RuntimeError(f"Cannot remove object id {obj_id} as it doesn't exist. "
                               f"All existing object ids: {state.obj_ids}.")
        if len(state.obj_ids) == 1:  # the last object: a plain reset (:1088-1091)
            self.reset_state(state)
            return list(state.obj_ids), updated
        rm = state.obj_ids.index(obj_id)
        # its inputs cleared frame by frame, which may downgrade conditioning
        # frames that only it prompted (:1097-1107)
        input_frames = sorted(state.prompt_frames.get(rm, set()))
        for f in input_frames:
            self.clear_all_prompts_in_frame(state, f, obj_id, need_output=False)
        remain = [i for i in range(len(state.obj_ids)) if i != rm]
        state.obj_ids = [state.obj_ids[i] for i in remain]
        old2new = {o: n for n, o in enumerate(remain)}
        state.pending = {f: {old2new[oi]: rec for oi, rec in per.items() if oi in old2new}
                         for f, per in state.pending.items()}
        state.pending = {f: per for f, per in state.pending.items() if per}
        state.prompt_frames = {old2new[oi]: fr for oi, fr in state.prompt_frames.items() if oi in old2new}
        # the object rows shift up: the bank's and the kept conditioning logits'
        perm = remain + [0] * (state.max_objects - len(remain))
        keep = [True] * len(remain) + [False] * (state.max_objects - len(remain))
        permute_rows(state.bank, perm, keep)
        for f, low in list(state.cond_low_res.items()):
            state.cond_low_res[f] = torch.stack(
                [low[p] if k else torch.full_like(low[0], NO_OBJ_SCORE) for p, k in zip(perm, keep)])
        if need_output:
            updated = [(f, self._assemble_frame_masks(state, f)) for f in input_frames]
        return list(state.obj_ids), updated

    # ------------------------------------------------------------ propagation
    @torch.inference_mode()
    def propagate_in_video_preflight(self, state: VideoPredictorState):
        """Encode the memories of all prompted frames (consolidation); with
        the scrub on, invalidate the non-conditioning memories around each
        (reference preflight, sam2_video_predictor.py:627-632)."""
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
            if self._clear_enabled(state):
                clear_window(state.bank, frame_idx, self._clear_radius())
        state.pending = {}

    @torch.inference_mode()
    def propagate_in_video(self, state: VideoPredictorState, start_frame_idx: Optional[int] = None,
                           max_frame_num_to_track: Optional[int] = None, reverse: bool = False,
                           chunk_size: Optional[int] = None
                           ) -> Iterator[Tuple[int, List[int], np.ndarray]]:
        """Yields (frame_idx, obj_ids, video_res_mask_logits [O, 1, H, W] numpy)
        in tracking order. ``chunk_size`` None runs the whole window before
        the first yield; K runs it K frames at a time and yields each chunk
        before the next runs (an offloaded state streams, 64 by default)."""
        self.propagate_in_video_preflight(state)
        cond_frames = sorted(state.cond_low_res)
        if not cond_frames:
            raise RuntimeError("No prompts provided; add points or boxes first")
        t0 = min(cond_frames) if start_frame_idx is None else start_frame_idx
        nf = state.num_frames
        if reverse:
            end = max(t0 - (max_frame_num_to_track or nf), 0)
            order = list(range(t0, end - 1, -1)) if t0 > 0 else []
        else:
            end = min(t0 + (max_frame_num_to_track or nf), nf - 1)
            order = list(range(t0, end + 1))
        hw = (state.video_height, state.video_width)
        # with N prompted frames only N conditioning slots can ever be valid
        mcs = max(1, min(self.cfg.max_cond_frame_slots, len(cond_frames)))
        radius = self._clear_radius() if self._clear_enabled(state) else None
        if state.offloaded and chunk_size is None:
            chunk_size = OFFLOAD_CHUNK  # the device never holds more than a chunk of frames
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size {chunk_size} < 1")
        streamed = chunk_size is not None
        k = chunk_size if streamed else max(len(order), 1)
        chunks = [order[a: a + k] for a in range(0, len(order), k)]
        stager = ChunkStager(state.images_host, k, self.device) if state.offloaded else None
        staged = stager.stage(0, chunks[0]) if stager and chunks else None
        for ci, frames in enumerate(chunks):
            # processing order: the frame body for each frame past t0 without a
            # conditioning output; with the scrub on, a scrub at each
            # conditioning frame passed (JAX _propagate_impl's clear_radius)
            steps = []
            for t in frames:
                if t in state.cond_low_res:
                    if radius is not None:
                        steps.append((t, False))
                elif t != t0:
                    steps.append((t, True))
            ran = [t for t, run in steps if run]
            if stager:
                rows = {t: i for i, t in enumerate(frames)}
                frame_of = lambda t, c=staged, r=rows: c[r[t]: r[t] + 1]  # noqa: E731
            else:
                frame_of = lambda t: state.images[t: t + 1]  # noqa: E731
            lows = self._run_window(state, steps, reverse, mcs, radius, frame_of,
                                    precompute=self.precompute_batch > 1 and not streamed)
            if stager and ci + 1 < len(chunks):
                # the next chunk's host gather while the card runs this one
                staged = stager.stage(ci + 1, chunks[ci + 1])
            if ran:
                lo = min(ran)
                # off the graph's buffer, which the next window writes
                lows = lows[lo: max(ran) + 1].clone()
            yield from self._emit(state, frames, ran, lows, t0, hw, reverse)

    def _emit(self, state, frames, ran, lows, t0, hw, reverse):
        """A chunk's frames in order: a conditioning frame's kept output, a
        tracked frame's logits hole-filled, resized and copied to the host
        ``EMIT_CHUNK`` frames at a time (the hole filling's memory is bounded
        by that, not by the video)."""
        lo = min(ran) if ran else 0
        ran = set(ran)
        chunk, c0 = None, 0
        for t in frames:
            if t in state.cond_low_res:
                video = self._to_video_res(state.cond_low_res[t], hw, self.non_overlap_masks).cpu().numpy()
            elif t in ran:
                if chunk is None or not c0 <= t - lo < c0 + len(chunk):
                    c0 = (t - lo) // EMIT_CHUNK * EMIT_CHUNK
                    filled = fill_holes_in_mask_scores(lows[c0: c0 + EMIT_CHUNK], self.fill_hole_area)
                    chunk = self._to_video_res(filled, hw, self.non_overlap_masks).cpu().numpy()
                video = chunk[t - lo - c0]
                state.frames_tracked[t] = {"reverse": reverse}
            else:
                continue
            yield t, list(state.obj_ids), video[:, None]

    def _graph_key(self, state: VideoPredictorState, reverse: bool, mcs: int, precompute: bool,
                   frame_dtype: Optional[torch.dtype]) -> tuple:
        """What a captured frame body depends on beyond its buffers' contents:
        the bank's shape (its slots: the video's length is a buffer),
        direction, the encoding mode and the frame store's dtype, the two
        switches (read when the body runs, so at capture) and the compute
        dtype."""
        return (state.bank.valid.shape[1], state.max_objects, mcs, reverse, precompute, frame_dtype,
                fused_cxblock_enabled(), fused_qkv_window_attention_enabled(), self.model.dtype,
                state.bank.maskmem.dtype)

    def _run_window(self, state: VideoPredictorState, steps: List[Tuple[int, bool]], reverse: bool,
                    mcs: int, radius: Optional[int], frame_of, precompute: bool = False
                    ) -> Optional[torch.Tensor]:
        """``steps`` in order: (t, True) runs the frame body for frame t,
        (t, False) scrubs the non-conditioning memories within ``radius`` of
        conditioning frame t; ``frame_of(t)`` is frame t's [1, S, S, 3] on the
        device. Returns the [F, O, 4fs, 4fs] low-res logits, row t written for
        each t run (None when nothing ran). On the card each frame is one
        graph replay and each scrub an in-place op on the graph's bank, in
        stream order; nothing waits on the device."""
        model = self.model
        if not any(run for _, run in steps):
            for t, _ in steps:
                clear_window(state.bank, t, radius)
            return None
        frame_dtype = None if precompute else frame_of(steps[0][0]).dtype
        on_card = self.use_graphs
        if on_card:
            graph = self.graphs.get(
                self._graph_key(state, reverse, mcs, precompute, frame_dtype),
                lambda: make_buffers(model, state.bank, precompute, new_bank=True, frame_dtype=frame_dtype),
                lambda b: frame_body(model, b, b.num_frames, reverse, mcs),
                weight_tensors(model),
            )
            bufs = graph.bufs
        else:
            bufs = make_buffers(model, state.bank, precompute, new_bank=False, frame_dtype=frame_dtype)
        bufs.num_frames.fill_(state.num_frames)
        if precompute:
            n, nf = self.precompute_batch, state.num_frames
            for s in range(0, nf, n):
                for k, v in encode_frames(model, state.images[s: s + n]).items():
                    bufs.feats[k][s: s + n].copy_(v)
        if on_card:
            copy_bank(bufs.bank, state.bank)
        for t, run in steps:
            if not run:
                clear_window(bufs.bank, t, radius)
                continue
            bufs.t.fill_(t)
            if bufs.frame is not None:
                bufs.frame.copy_(frame_of(t))
            if on_card:
                graph.replay()
            else:
                frame_body(model, bufs, bufs.num_frames, reverse, mcs)
        if on_card:
            copy_bank(state.bank, bufs.bank)
        return bufs.lows


def build_sam2_video_predictor(config="sam2.1_hiera_t512", state_dict=None, device="cuda",
                               dtype=torch.bfloat16, seed: int = 0, fill_hole_area: int = 8,
                               precompute_features_batch: int = 0, ckpt_path: Optional[str] = None,
                               non_overlap_masks: bool = False, clear_non_cond_mem_around_input: bool = False,
                               clear_non_cond_mem_for_multi_obj: bool = False, **overrides):
    """Build the model (weights from ``state_dict``, else from the checkpoint
    at ``ckpt_path``, else made from ``seed``), move it to ``device`` in
    compute ``dtype`` and wrap it in the predictor."""
    dev = resolve_device(device)
    model = build_sam2(config, state_dict, seed=seed, ckpt_path=ckpt_path, **overrides)
    return SAM2VideoPredictor(
        model.to(dev).set_compute_dtype(dtype), fill_hole_area, device=dev,
        precompute_features_batch=precompute_features_batch, non_overlap_masks=non_overlap_masks,
        clear_non_cond_mem_around_input=clear_non_cond_mem_around_input,
        clear_non_cond_mem_for_multi_obj=clear_non_cond_mem_for_multi_obj)


# the NPZ variant is the same builder (init_state takes arrays), as in JAX
build_sam2_video_predictor_npz = build_sam2_video_predictor


def build_efficienttam_video_predictor(config="efficientmedsam_s_512", state_dict=None, device="cuda",
                                       **kwargs):
    """The EfficientTAM family's predictor (reference
    efficient_track_anything/build_efficienttam.py): ``build_sam2_video_predictor``
    with an EfficientTAM preset."""
    return build_sam2_video_predictor(config, state_dict, device, **kwargs)
