# Frozen copy of us_video_medsam2_tpu_torch/models/mask_decoder.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""SAM mask decoder (reference sam/mask_decoder.py:15-295), NHWC.

Counterpart of the JAX package's ``models/mask_decoder.py``, including the
dynamic multimask stability fallback used at inference.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from perfbench.reference.models.layers import MLP, ConvTranspose2x, LayerNorm, Linear, gelu_exact
from perfbench.reference.models.transformer import TwoWayTransformer


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim=256, num_multimask_outputs=3, iou_head_depth=3,
                 iou_head_hidden_dim=256, use_high_res_features=False,
                 iou_prediction_use_sigmoid=False, pred_obj_scores=False,
                 pred_obj_scores_mlp=False, use_multimask_token_for_obj_ptr=False):
        super().__init__()
        d = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.use_high_res_features = use_high_res_features
        self.pred_obj_scores = pred_obj_scores
        self.use_multimask_token_for_obj_ptr = use_multimask_token_for_obj_ptr
        self.transformer = TwoWayTransformer(2, d, 8, 2048)
        self.iou_token = nn.Parameter(torch.randn(1, d))
        self.mask_tokens = nn.Parameter(torch.randn(self.num_mask_tokens, d))
        if pred_obj_scores:
            self.obj_score_token = nn.Parameter(torch.randn(1, d))
        self.upscale_dc1 = ConvTranspose2x(d, d // 4)
        self.upscale_ln = LayerNorm(d // 4, eps=1e-6)
        self.upscale_dc2 = ConvTranspose2x(d // 4, d // 8)
        for i in range(self.num_mask_tokens):
            self.add_module(f"hyper_mlps_{i}", MLP(d, d, d // 8, 3))
        self.iou_head = MLP(d, iou_head_hidden_dim, self.num_mask_tokens, iou_head_depth,
                            sigmoid_output=iou_prediction_use_sigmoid)
        if pred_obj_scores:
            self.obj_score_head = MLP(d, d, 1, 3) if pred_obj_scores_mlp else Linear(d, 1)

    def forward(self, image_embeddings, image_pe, sparse, dense, multimask_output,
                high_res_features=None):
        """Returns (masks, ious, sam_tokens_out, object_score_logits, all_masks, all_ious);
        masks [B, M, 4H, 4W] with M = 3 (multimask) or 1."""
        masks, iou_pred, mask_tokens_out, obj_logits = self.predict_masks(
            image_embeddings, image_pe, sparse, dense, high_res_features
        )
        sl = slice(1, None) if multimask_output else slice(0, 1)
        tok = (mask_tokens_out[:, 1:] if multimask_output and self.use_multimask_token_for_obj_ptr
               else mask_tokens_out[:, 0:1])
        return masks[:, sl], iou_pred[:, sl], tok, obj_logits, masks, iou_pred

    def predict_masks(self, image_embeddings, image_pe, sparse, dense, high_res_features=None):
        b, h, w, c = image_embeddings.shape
        dtype = image_embeddings.dtype
        tok = [self.iou_token, self.mask_tokens]
        s = 0
        if self.pred_obj_scores:
            tok = [self.obj_score_token] + tok
            s = 1
        out_tokens = torch.cat(tok, dim=0).to(dtype)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse], dim=1)
        src = (image_embeddings + dense).reshape(b, h * w, c)
        pe = image_pe.reshape(1, h * w, c).expand(b, h * w, c).to(dtype)
        hs, src = self.transformer(src, pe, tokens)
        iou_token_out = hs[:, s]
        mask_tokens_out = hs[:, s + 1: s + 1 + self.num_mask_tokens]

        up = self.upscale_dc1(src.reshape(b, h, w, c))
        if self.use_high_res_features:
            feat_s0, feat_s1 = high_res_features
            up = up + feat_s1
        up = self.upscale_dc2(gelu_exact(self.upscale_ln(up)))
        if self.use_high_res_features:
            up = up + feat_s0
        up = gelu_exact(up)
        hyper_in = torch.stack(
            [getattr(self, f"hyper_mlps_{i}")(mask_tokens_out[:, i]) for i in range(self.num_mask_tokens)],
            dim=1,
        )
        uh, uw = up.shape[1:3]
        masks = torch.matmul(hyper_in, up.reshape(b, uh * uw, -1).transpose(1, 2))
        masks = masks.reshape(b, -1, uh, uw)
        iou_pred = self.iou_head(iou_token_out)
        if self.pred_obj_scores:
            obj_logits = self.obj_score_head(hs[:, 0])
        else:
            obj_logits = 10.0 * torch.ones(b, 1, dtype=dtype, device=hs.device)
        return masks, iou_pred, mask_tokens_out, obj_logits


def get_stability_scores(mask_logits: torch.Tensor, delta: float) -> torch.Tensor:
    flat = mask_logits.flatten(-2)
    area_i = (flat > delta).sum(-1).float()
    area_u = (flat > -delta).sum(-1).float()
    return torch.where(area_u > 0, area_i / area_u.clamp(min=1), torch.ones_like(area_u))


def dynamic_multimask_via_stability(all_mask_logits, all_iou_scores, delta=0.05, thresh=0.98):
    """Fall back from the single-mask token to the best multimask when unstable
    (reference mask_decoder.py:259-295)."""
    multi_logits, multi_iou = all_mask_logits[:, 1:], all_iou_scores[:, 1:]
    best = multi_iou.argmax(-1)
    rows = torch.arange(best.shape[0], device=best.device)
    best_logits = multi_logits[rows, best][:, None]
    best_iou = multi_iou[rows, best][:, None]
    single_logits, single_iou = all_mask_logits[:, 0:1], all_iou_scores[:, 0:1]
    stable = get_stability_scores(single_logits, delta) >= thresh
    out_logits = torch.where(stable[..., None, None], single_logits, best_logits)
    out_iou = torch.where(stable, single_iou, best_iou)
    return out_logits, out_iou
