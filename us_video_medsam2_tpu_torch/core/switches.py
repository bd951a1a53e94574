"""The JAX package's two opt-in kernel switches, read at call time.

- ``US_MEDSAM2_ENABLE_FUSED_CXBLOCK``: the memory encoder's ConvNeXt blocks
  run the whole-block kernel (``kernels/cxblock.py``) instead of their plain
  composition. JAX site: ``us_video_medsam2_tpu/kernels/fused_cxblock.py:116``.
- ``US_MEDSAM2_FUSE_QKV_WINDOW_ATTN``: every windowed Hiera block runs its qkv
  projection inside the window-attention kernel
  (``kernels/qkv_window_attention.py``). JAX site:
  ``us_video_medsam2_tpu/models/hiera.py:300``.

Both are off unless set, as in the JAX package, and any non-empty value turns
one on (the JAX package tests ``os.environ.get(...)`` for truth). JAX reads them
when it traces; the port reads them at every call.
"""

from __future__ import annotations

import os


def fused_cxblock_enabled() -> bool:
    return bool(os.environ.get("US_MEDSAM2_ENABLE_FUSED_CXBLOCK"))


def fused_qkv_window_attention_enabled() -> bool:
    return bool(os.environ.get("US_MEDSAM2_FUSE_QKV_WINDOW_ATTN"))
