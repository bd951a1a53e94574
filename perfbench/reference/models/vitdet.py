# Frozen copy of us_video_medsam2_tpu_torch/models/vitdet.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""Plain ViT (ViTDet) trunk, the EfficientTAM image encoder (reference
sam2/modeling/backbones/vitdet.py:24-299), NHWC.

Counterpart of the JAX package's ``models/vitdet.py``: a patch-16 embed, the
absolute position embedding of the pretrain grid (cls token dropped) resized
bicubically to the token map, windowed blocks interleaved with global blocks,
and the last global block's map as the one output. A ViT block is the Hiera
block at ``dim_out == dim`` without q-pooling (``hiera.MultiScaleBlock``):
norm1 through the LayerNorm kernel, ``MultiScaleAttention`` (the
window-attention kernel at ws 14 on the map zero-padded to whole windows with
bias-filled pad tokens, the plain attention in the global blocks), the
residual, and the MLP tail through the LN -> MLP -> residual kernel. The
parameter names are the JAX tree's (``patch_embed``, ``pos_embed``,
``blocks_{i}/{norm1,attn/{qkv,proj},norm2,mlp}``). The JAX package's
space-to-depth patch embed exists only for the TPU; here it is one stride-16
convolution.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from perfbench.reference.config import ViTDetConfig
from perfbench.reference.models.hiera import MultiScaleBlock
from perfbench.reference.models.layers import NHWCConv
from perfbench.reference.ops.resize import resize2d


class ViTDet(nn.Module):
    """Trunk producing one feature map: the last global block's output."""

    def __init__(self, cfg: ViTDetConfig):
        super().__init__()
        self.cfg = cfg
        c, ps = cfg.embed_dim, cfg.patch_size
        self.patch_embed = NHWCConv(3, c, ps, ps, 0)
        self.grid = cfg.pretrain_img_size // ps
        n_pos = self.grid * self.grid + (1 if cfg.pretrain_use_cls_token else 0)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, c))
        for i in range(cfg.depth):
            ws = cfg.window_size if i in cfg.window_block_indexes else 0
            self.add_module(f"blocks_{i}", MultiScaleBlock(c, c, cfg.num_heads, ws, None, cfg.mlp_ratio))
        self.last_global = max(i for i in range(cfg.depth) if i not in cfg.window_block_indexes)
        # (map size, dtype) -> (pos_embed's tensor, its version, table): pos_embed_table's tables
        self._pe_tables: dict = {}

    def _resized_pos_embed(self, hw, dtype) -> torch.Tensor:
        cfg = self.cfg
        pe = self.pos_embed[:, 1:] if cfg.pretrain_use_cls_token else self.pos_embed
        pe = resize2d(pe.float().reshape(1, self.grid, self.grid, cfg.embed_dim), hw, mode="cubic")
        return pe.to(dtype)

    def pos_embed_table(self, hw, dtype) -> torch.Tensor:
        """[1, h, w, C] position embedding of the token map ``hw`` in ``dtype``:
        the pretrain grid's embedding resized bicubically. It depends only on
        the weights and the map size, so when no gradient is wanted it is made
        once a map size and dtype and kept, with the parameter's tensor and
        ``_version`` it was made from: an in-place update or another tensor
        in the parameter (``.data =``, a cast) makes it anew. The source is
        held, so its memory cannot pass to another tensor while the table
        lives. The kept table is made outside ``torch.inference_mode()``, so a
        later training step may save it for backward (as ``ops/posenc.py``'s
        tables). With a gradient (training), or when the parameter is an
        inference tensor (which has no version to key on), it is computed on
        every call; so it is too in a CUDA graph captured from a module in
        training mode (the training step's eval capture), whose replays
        follow the weights that the train step's replays update in place."""
        p = self.pos_embed
        if ((torch.is_grad_enabled() and p.requires_grad) or p.is_inference()
                or (self.training and p.is_cuda and torch.cuda.is_current_stream_capturing())):
            return self._resized_pos_embed(hw, dtype)
        key = (tuple(hw), dtype)
        kept = self._pe_tables.get(key)
        if (kept is None or kept[0].device != p.device or kept[0].data_ptr() != p.data_ptr()
                or kept[1] != p._version):
            with torch.inference_mode(False), torch.no_grad():
                kept = self._pe_tables[key] = (p.detach(), p._version, self._resized_pos_embed(hw, dtype))
        return kept[2]

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> list[torch.Tensor]:
        cfg = self.cfg
        x = self.patch_embed(x)
        x = (x + self.pos_embed_table(tuple(x.shape[1:3]), x.dtype)).contiguous()
        outputs = []
        for i in range(cfg.depth):
            x = getattr(self, f"blocks_{i}")(x, deterministic)
            if i == self.last_global:
                outputs.append(x)
        return outputs
