# Frozen copy of us_video_medsam2_tpu_torch/ops/attention.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""Scaled dot-product attention over [B, H, L, D] with an optional key mask.

Counterpart of the JAX package's ``ops/attention.py``. ``sdpa`` is the memory
attention's path: on a CUDA tensor it is the hand-written flash kernel
(``kernels/flash_attention.py``), on a CPU tensor that kernel's plain version.
``attention_plain`` is the plain composition used where the JAX package never
reaches its kernel (the mask decoder's small token attentions and the Hiera
global blocks): f32 logits and softmax, probabilities rounded to the value
dtype, f32 accumulation.
"""

from __future__ import annotations

import torch

from perfbench.reference.plain import (
    flash_attention,
    flash_attention_plain,
)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q·kᵀ/√D) v with masked keys (key_mask [B, Lk], True = attend)
    contributing exact zeros."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), key_mask)


attention_plain = flash_attention_plain
