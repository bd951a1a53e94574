"""SAM2 core model: promptable video segmentation with a streaming memory bank.

Counterpart of the JAX package's ``models/sam2.py`` (reference
sam2/modeling/sam2_base.py:764-1682) with the Hiera trunk and FPN neck, or the
ViTDet trunk and its one-level neck (EfficientTAM): ``forward_image``,
``condition_on_memory``, ``no_mem_features``, ``sam_heads``,
``use_mask_as_output``, ``encode_memory`` and ``track_step``, each with the
training switches of the JAX package (``is_training``, ``deterministic``).
NHWC features, [B, N, C] tokens, f32 parameters run in the compute dtype
(``set_compute_dtype``), NO_OBJ_SCORE = -1024 (sam2_base.py:19).

The four steps of a frame are spans (``utils/profiling.py``), each with the
batch it ran as its rows, in a CUDA graph's replays as in eager calls:
``sam2.encoder`` (``forward_image``), ``sam2.memory_attention``
(``condition_on_memory``), ``sam2.heads`` (``sam_heads``) and
``sam2.memory_encoder`` (``write_frame_memory``: the encode and the bank
write).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from us_video_medsam2_tpu_torch.core.config import SAM2Config
from us_video_medsam2_tpu_torch.models.hiera import Hiera
from us_video_medsam2_tpu_torch.models.layers import MLP, Conv2d, Linear, cast_weight_matrices
from us_video_medsam2_tpu_torch.models.mask_decoder import MaskDecoder, dynamic_multimask_via_stability
from us_video_medsam2_tpu_torch.models.memory import MemoryAttention, MemoryEncoder
from us_video_medsam2_tpu_torch.models.memory_bank import (
    MemoryBank,
    gather_memories,
    select_memories,
    write_memory,
)
from us_video_medsam2_tpu_torch.models.neck import FpnNeck, ImageEncoder, ViTDetNeck
from us_video_medsam2_tpu_torch.models.prompt_encoder import PromptEncoder
from us_video_medsam2_tpu_torch.models.temporal_fusion import build_temporal_fusion
from us_video_medsam2_tpu_torch.models.vitdet import ViTDet
from us_video_medsam2_tpu_torch.ops.posenc import sine_pe_1d, sine_pos_embed_2d
from us_video_medsam2_tpu_torch.ops.resize import resize2d
from us_video_medsam2_tpu_torch.utils.profiling import span

NO_OBJ_SCORE = -1024.0


class SAM2Model(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = torch.float32
        if c.hiera is not None:
            trunk, neck = Hiera(c.hiera), FpnNeck(c.neck)
        else:
            trunk, neck = ViTDet(c.vitdet), ViTDetNeck(c.neck)
        self.image_encoder = ImageEncoder(trunk, neck, scalp=c.neck_scalp)
        self.memory_attention = MemoryAttention(c.memory_attention)
        self.memory_encoder = MemoryEncoder(c.memory_encoder)
        self.sam_prompt_encoder = PromptEncoder(c.hidden_dim, c.feat_size, c.image_size, 16)
        self.sam_mask_decoder = MaskDecoder(
            transformer_dim=c.hidden_dim,
            use_high_res_features=c.use_high_res_features_in_sam,
            iou_prediction_use_sigmoid=c.iou_prediction_use_sigmoid,
            pred_obj_scores=c.pred_obj_scores,
            pred_obj_scores_mlp=c.pred_obj_scores_mlp,
            use_multimask_token_for_obj_ptr=c.use_multimask_token_for_obj_ptr,
        )
        d = c.hidden_dim
        if c.use_high_res_features_in_sam:
            self.conv_s0 = Conv2d(d, d // 8, 1)
            self.conv_s1 = Conv2d(d, d // 4, 1)
        if c.use_obj_ptrs_in_encoder:
            self.mask_downsample = Conv2d(1, 1, 4, stride=4)
            self.obj_ptr_proj = MLP(d, d, d, 3) if c.use_mlp_for_obj_ptr_proj else Linear(d, d)
        if c.proj_tpos_enc_in_obj_ptrs:
            self.obj_ptr_tpos_proj = Linear(d, c.mem_dim)
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(c.num_maskmem, c.mem_dim))
        self.no_mem_embed = nn.Parameter(torch.zeros(d))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(d))
        if c.pred_obj_scores and c.use_obj_ptrs_in_encoder:
            self.no_obj_ptr = nn.Parameter(torch.zeros(d))
        if c.no_obj_embed_spatial:
            self.no_obj_embed_spatial = nn.Parameter(torch.zeros(c.mem_dim))
        # last, so the other parameters keep their order (and seeded values);
        # named temporal_fusion_{i} as in the JAX parameter tree
        fusion = build_temporal_fusion(c.temporal_fusion) or []
        for i, m in enumerate(fusion):
            self.add_module(f"temporal_fusion_{i}", m)
        self.n_fusion = len(fusion)

    def set_compute_dtype(self, dtype: torch.dtype, cast_weights: bool = True) -> "SAM2Model":
        """Run in ``dtype`` (bf16 on the card). Serving casts the weight
        matrices once (LayerNorm parameters, biases and embeddings stay f32);
        training passes ``cast_weights=False`` and keeps every parameter in
        f32 as the master copy, cast at use."""
        if cast_weights:
            cast_weight_matrices(self, dtype)
        self.dtype = dtype
        return self

    # ------------------------------------------------------------------ images
    def forward_image(self, images: torch.Tensor, deterministic: bool = True, num_frames: int = 1,
                      gen: torch.Generator | None = None) -> dict:
        """images [B(·T), H, W, 3] -> feature dict (sam2_base.py:1220-1232).

        With temporal fusion configured and ``num_frames`` > 1 (the training
        forward only), the top levels of the FPN are mixed across the frame
        axis before the high-res projections (sam2_base.py:1249-1262), one
        module a level, zipped against ``fpn[-n:]`` as in JAX; ``gen`` draws
        their training randomness."""
        with span("sam2.encoder", images.shape[0], images.device):
            out = self.image_encoder(images.to(self.dtype), deterministic)
            fpn = list(out["backbone_fpn"])
            if self.n_fusion and num_frames > 1:
                n = self.n_fusion
                mods = [getattr(self, f"temporal_fusion_{i}") for i in range(n)]
                fpn = fpn[:-n] + [tf(f, num_frames, deterministic, gen) for tf, f in zip(mods, fpn[-n:])]
            if self.cfg.use_high_res_features_in_sam:
                fpn[0] = self.conv_s0(fpn[0])
                fpn[1] = self.conv_s1(fpn[1])
            out["backbone_fpn"] = fpn
            return out

    # ------------------------------------------------------- memory attention
    def condition_on_memory(self, frame_idx: int | torch.Tensor, curr_feat: torch.Tensor, bank: MemoryBank,
                            num_frames: int | torch.Tensor, track_in_reverse: bool = False,
                            max_cond_slots: int | None = None, is_training: bool = False,
                            deterministic: bool = True,
                            gen: torch.Generator | None = None) -> torch.Tensor:
        """Cross-attend the current frame to the memory bank (sam2_base.py:1271-1448).
        ``frame_idx`` is an int or a 0-d long tensor on the bank's device
        (``select_memories``). ``gen`` draws the attention-dropout seeds when
        ``deterministic`` is False."""
        with span("sam2.memory_attention", curr_feat.shape[0], curr_feat.device):
            c = self.cfg
            dt = self.dtype
            b, h, w, ch = curr_feat.shape
            dev = curr_feat.device
            sel = select_memories(bank, frame_idx, c, num_frames, track_in_reverse, max_cond_slots,
                                  is_training)
            mem, ptrs = gather_memories(bank, sel)
            B, M, HWm, md = mem.shape
            mem_tokens = mem.reshape(B, M * HWm, md).to(dt)
            side = int(round(HWm**0.5))
            spatial_pe = sine_pos_embed_2d(side, side, md, c.memory_encoder.pos_temperature, dev)
            tpos = self.maskmem_tpos_enc[sel.mem_tpos]
            mem_pos = (spatial_pe.reshape(1, HWm, md) + tpos[:, None, :]).to(dt)
            mem_pos = mem_pos[None].expand(B, M, HWm, md).reshape(B, M * HWm, md)
            mem_mask = sel.mem_valid.repeat_interleave(HWm, dim=1)

            num_ptr_tokens = 0
            memory, memory_pos, key_mask = mem_tokens, mem_pos, mem_mask
            if c.use_obj_ptrs_in_encoder:
                P = ptrs.shape[1]
                tok = c.tokens_per_obj_ptr
                if c.add_tpos_enc_to_obj_ptrs:
                    tpos_dim = c.hidden_dim if c.proj_tpos_enc_in_obj_ptrs else md
                    ptr_pos = sine_pe_1d(sel.ptr_pos / sel.t_diff_max, tpos_dim)
                    if c.proj_tpos_enc_in_obj_ptrs:
                        ptr_pos = self.obj_ptr_tpos_proj(ptr_pos.to(dt))
                    ptr_pos = ptr_pos.to(dt)
                else:
                    ptr_pos = torch.zeros(B, P, md, dtype=dt, device=dev)
                ptr_tokens = ptrs.reshape(B, P * tok, md).to(dt)
                num_ptr_tokens = P * tok
                memory = torch.cat([mem_tokens, ptr_tokens], 1)
                memory_pos = torch.cat([mem_pos, ptr_pos.repeat_interleave(tok, dim=1)], 1)
                key_mask = torch.cat([mem_mask, sel.ptr_valid.repeat_interleave(tok, dim=1)], 1)

            curr_pos = sine_pos_embed_2d(h, w, ch, c.neck.pos_temperature, dev).reshape(1, h * w, ch)
            out = self.memory_attention(
                curr_feat.reshape(b, h * w, ch), memory, curr_pos.expand(b, -1, -1).to(dt),
                memory_pos, num_obj_ptr_tokens=num_ptr_tokens, key_mask=key_mask,
                deterministic=deterministic, gen=gen,
            )
            return out.reshape(b, h, w, ch)

    def no_mem_features(self, curr_feat: torch.Tensor) -> torch.Tensor:
        """Initial conditioning frames skip memory attention (sam2_base.py:1423-1429)."""
        return curr_feat + self.no_mem_embed.to(curr_feat.dtype)

    # -------------------------------------------------------------- SAM heads
    def sam_heads(self, backbone_features, point_coords=None, point_labels=None,
                  mask_inputs=None, high_res_features=None, multimask_output=False,
                  is_training: bool = False) -> dict:
        """Prompt encoder + mask decoder (sam2_base.py:1010-1166). In training
        the single-mask output skips the stability fallback, and a multimask
        output keeps every channel at image resolution for the loss."""
        with span("sam2.heads", backbone_features.shape[0], backbone_features.device):
            c = self.cfg
            dt = self.dtype
            b = backbone_features.shape[0]
            dev = backbone_features.device
            if point_coords is None:
                point_coords = torch.zeros(b, 1, 2, device=dev)
                point_labels = -torch.ones(b, 1, dtype=torch.int32, device=dev)
            sam_mask_prompt = None
            if mask_inputs is not None:
                target = 4 * c.feat_size
                sam_mask_prompt = mask_inputs
                if mask_inputs.shape[1] != target:
                    sam_mask_prompt = resize2d(mask_inputs.float(), (target, target), "linear", antialias=True)
            sparse, dense = self.sam_prompt_encoder(point_coords, point_labels, sam_mask_prompt, dt)
            out_masks, out_ious, sam_tokens, obj_logits, all_masks, all_ious = self.sam_mask_decoder(
                backbone_features, self.sam_prompt_encoder.dense_pe(dt), sparse, dense,
                multimask_output=multimask_output, high_res_features=high_res_features,
            )
            if not multimask_output and not is_training and c.dynamic_multimask_via_stability:
                out_masks, out_ious = dynamic_multimask_via_stability(
                    all_masks, all_ious, c.dynamic_multimask_stability_delta,
                    c.dynamic_multimask_stability_thresh,
                )
            is_obj_appearing = obj_logits > 0
            if c.pred_obj_scores:
                out_masks = torch.where(is_obj_appearing[..., None, None], out_masks,
                                        torch.full_like(out_masks, NO_OBJ_SCORE))
            low_res_multimasks = out_masks.float()

            def upsample(m):  # [B, M, h, w] -> image resolution
                return resize2d(m.permute(0, 2, 3, 1), (c.image_size, c.image_size)).permute(0, 3, 1, 2)

            sam_output_token = sam_tokens[:, 0]
            if multimask_output:
                best = out_ious.argmax(-1)
                rows = torch.arange(b, device=dev)
                low_res_masks = low_res_multimasks[rows, best][:, None]
                if sam_tokens.shape[1] > 1:
                    sam_output_token = sam_tokens[rows, best]
                if is_training:
                    high_res_multimasks = upsample(low_res_multimasks)
                    high_res_masks = high_res_multimasks[rows, best][:, None]
                else:  # the selection commutes with upsampling: upsample the chosen mask only
                    high_res_masks = upsample(low_res_masks)
                    high_res_multimasks = high_res_masks
            else:
                high_res_multimasks = upsample(low_res_multimasks)
                low_res_masks, high_res_masks = low_res_multimasks, high_res_multimasks

            obj_ptr = self.obj_ptr_proj(sam_output_token)
            if c.pred_obj_scores:
                lam = torch.sigmoid(obj_logits) if c.soft_no_obj_ptr else is_obj_appearing.to(obj_ptr.dtype)
                if c.fixed_no_obj_ptr:
                    obj_ptr = lam * obj_ptr
                obj_ptr = obj_ptr + (1.0 - lam) * self.no_obj_ptr.to(obj_ptr.dtype)
            return {
                "low_res_multimasks": low_res_multimasks,
                "high_res_multimasks": high_res_multimasks,
                "ious": out_ious,
                "low_res_masks": low_res_masks,
                "high_res_masks": high_res_masks,
                "obj_ptr": obj_ptr,
                "object_score_logits": obj_logits,
            }

    def use_mask_as_output(self, backbone_features, high_res_features, mask_inputs) -> dict:
        """Adopt a mask prompt [B, S, S, 1] directly as the output (sam2_base.py:1168-1218)."""
        c = self.cfg
        mask_f = mask_inputs.float()
        scaled = mask_f * 20.0 - 10.0
        high_res_masks = scaled.permute(0, 3, 1, 2)
        low = resize2d(scaled, (mask_inputs.shape[1] // 4, mask_inputs.shape[2] // 4),
                       "linear", antialias=True)
        low_res_masks = low.permute(0, 3, 1, 2)
        b = mask_inputs.shape[0]
        if not c.use_obj_ptrs_in_encoder:
            obj_ptr = torch.zeros(b, c.hidden_dim, dtype=self.dtype, device=mask_f.device)
        else:
            obj_ptr = self.sam_heads(backbone_features, mask_inputs=self.mask_downsample(mask_f),
                                     high_res_features=high_res_features)["obj_ptr"]
        lam = (mask_f.reshape(b, -1) > 0).any(dim=1, keepdim=True).float()
        obj_logits = 20.0 * lam - 10.0
        if c.pred_obj_scores:
            if c.fixed_no_obj_ptr:
                obj_ptr = lam * obj_ptr
            obj_ptr = obj_ptr + (1.0 - lam) * self.no_obj_ptr.to(obj_ptr.dtype)
        return {
            "low_res_multimasks": low_res_masks,
            "high_res_multimasks": high_res_masks,
            "ious": torch.ones(b, 1, device=mask_f.device),
            "low_res_masks": low_res_masks,
            "high_res_masks": high_res_masks,
            "obj_ptr": obj_ptr,
            "object_score_logits": obj_logits,
        }

    # ---------------------------------------------------------- memory encode
    def encode_memory(self, curr_feat, high_res_masks, object_score_logits,
                      is_mask_from_pts: bool | torch.Tensor = False, is_training: bool = False) -> torch.Tensor:
        """Predicted mask + pixels -> memory feature [B, Hm, Wm, mem_dim] (sam2_base.py:1450-1498).
        ``is_mask_from_pts`` may be a 0-d bool tensor (the training step's
        plan, as JAX traces it): then both masks are made and selected."""
        c = self.cfg
        masks = high_res_masks.permute(0, 2, 3, 1)
        if c.non_overlap_masks_for_mem_enc and not is_training:
            masks = apply_non_overlapping_constraints(high_res_masks).permute(0, 2, 3, 1)
        binarize = c.binarize_mask_from_pts_for_mem_enc and not is_training
        if binarize and isinstance(is_mask_from_pts, torch.Tensor):
            mask_for_mem = torch.where(is_mask_from_pts, (masks > 0).float(), torch.sigmoid(masks.float()))
        elif binarize and is_mask_from_pts:
            mask_for_mem = (masks > 0).float()
        else:
            mask_for_mem = torch.sigmoid(masks.float())
        mask_for_mem = mask_for_mem * c.sigmoid_scale_for_mem_enc + c.sigmoid_bias_for_mem_enc
        maskmem, _ = self.memory_encoder(curr_feat, mask_for_mem.to(self.dtype))
        if c.no_obj_embed_spatial:
            is_obj = (object_score_logits > 0).to(maskmem.dtype)
            maskmem = maskmem + (1.0 - is_obj[:, :, None, None]) * (
                self.no_obj_embed_spatial.to(maskmem.dtype)[None, None, None, :]
            )
        return maskmem

    # --------------------------------------------------------------- one step
    def track_step(self, frame_idx: int | torch.Tensor, feats: dict, bank: MemoryBank,
                   num_frames: int | torch.Tensor, point_coords=None, point_labels=None, mask_inputs=None,
                   prev_sam_mask_logits=None, is_init_cond_frame=False, is_cond_frame=False,
                   multimask_output=False, track_in_reverse=False, run_mem_encoder=True,
                   max_cond_slots=None):
        """One tracking step (sam2_base.py:1586-1651), eval mode.

        feats: {'top': [B, Hc, Wc, C], 's0', 's1': decoder-projected high-res
        features}. ``prev_sam_mask_logits`` ([B, 4fs, 4fs, 1], a re-prompt's
        previous low-res logits) replaces ``mask_inputs`` as the decoder's mask
        prompt. With the memory encoder on, the frame's memory is written
        into ``bank`` in place. ``frame_idx`` may be a 0-d long tensor on the
        bank's device: then nothing from the inputs to the memory write reads
        a value back to the host, and the step can be captured in a CUDA
        graph (``inference/graphs.py``). Returns (out dict, bank)."""
        c = self.cfg
        hr = [feats["s0"], feats["s1"]] if c.use_high_res_features_in_sam else None
        if mask_inputs is not None and c.use_mask_input_as_output_without_sam:
            out = self.use_mask_as_output(feats["top"], hr, mask_inputs)
        else:
            if is_init_cond_frame and c.directly_add_no_mem_embed:
                pix_feat = self.no_mem_features(feats["top"])
            else:
                pix_feat = self.condition_on_memory(frame_idx, feats["top"], bank, num_frames,
                                                    track_in_reverse, max_cond_slots)
            mi = prev_sam_mask_logits if prev_sam_mask_logits is not None else mask_inputs
            out = self.sam_heads(pix_feat, point_coords, point_labels, mi, hr,
                                 multimask_output=multimask_output)
        if run_mem_encoder and c.num_maskmem > 0:
            self.write_frame_memory(bank, frame_idx, feats["top"], out["high_res_masks"], out["object_score_logits"],
                                    out["obj_ptr"], is_cond_frame or is_init_cond_frame,
                                    is_mask_from_pts=point_coords is not None)
        return out, bank

    def write_frame_memory(self, bank: MemoryBank, frame_idx: int | torch.Tensor, curr_feat, high_res_masks,
                           object_score_logits, obj_ptr, is_cond: bool,
                           is_mask_from_pts: bool | torch.Tensor = False) -> None:
        """``encode_memory`` of one frame's rows and its write, with ``obj_ptr``,
        into slot ``frame_idx`` of ``bank`` (in place)."""
        with span("sam2.memory_encoder", curr_feat.shape[0], curr_feat.device):
            maskmem = self.encode_memory(curr_feat, high_res_masks, object_score_logits, is_mask_from_pts)
            b, hm, wm, md = maskmem.shape
            write_memory(bank, frame_idx, maskmem.reshape(b, hm * wm, md), obj_ptr, is_cond)


def apply_non_overlapping_constraints(pred_masks: torch.Tensor) -> torch.Tensor:
    """Keep only the argmax object per pixel (sam2_base.py:1663-1681); [O, 1, H, W]."""
    if pred_masks.shape[0] == 1:
        return pred_masks
    max_obj = pred_masks.argmax(0, keepdim=True)
    ids = torch.arange(pred_masks.shape[0], device=pred_masks.device)[:, None, None, None]
    return torch.where(max_obj == ids, pred_masks, pred_masks.clamp(max=-10.0))
