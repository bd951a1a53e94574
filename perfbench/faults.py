"""Faults planted in the port's timed path, for showing that ``correct`` catches them.

Each fault is a function of (an object with ``setattr(obj, name, value)``:
pytest's ``monkeypatch``, or ``Patches`` here, which can undo; the cell's
name) that breaks the port where the timed path produces its answer:

- ``state_unchanged``: each tracked frame's step returns without running,
  leaving the frame body's buffers (bank and logits) as they were: a
  replay of the captured body that does nothing on the card, the eager body
  skipped elsewhere;
- ``half_the_batch``: the first half of a batch's videos served, their logits
  standing in for the rest (serving only: an interactive request is one video);
- ``answer_altered``: one tracked frame's logits negated as its holes are
  filled (the frame of index 1 of each filled stack of two frames or more);
- ``memory_unread``: memory attention's reads of the bank add nothing (each
  layer's cross-attention output zeroed): a memory path that does nothing.

``PROBES`` holds a subtler break that ``readings.py --fault`` can plant too.
"""

from __future__ import annotations

import torch


class Patches:
    """``setattr`` with an ``undo``."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            obj, name, value = self.saved.pop()
            setattr(obj, name, value)


def state_unchanged(mp, cell: str) -> None:
    from us_video_medsam2_tpu_torch.inference import serve, video_predictor
    from us_video_medsam2_tpu_torch.utils import graphs

    mp.setattr(graphs.FrameGraph, "replay", lambda self: None)
    mp.setattr(serve if "serve" in cell else video_predictor, "frame_body", lambda *a, **k: None)


def memory_unwritten(mp, cell: str) -> None:
    """No tracked frame's memory is written (the bank keeps only the prompt's):
    not one of the faults the tests hold the cells to, since with seeded
    weights its effect on some seeds is the size of bf16's (``PERF.md``)."""
    from us_video_medsam2_tpu_torch.models import sam2

    mp.setattr(sam2, "write_memory", lambda *a, **k: None)


def memory_unread(mp, cell: str) -> None:
    from us_video_medsam2_tpu_torch.models import transformer

    real = transformer.RoPEAttention.forward

    def forward(self, q, k, *a, **kw):
        out = real(self, q, k, *a, **kw)
        return out * 0 if k.shape[-2] != q.shape[-2] else out  # cross-attention: keys from the bank

    mp.setattr(transformer.RoPEAttention, "forward", forward)


def half_the_batch(mp, cell: str) -> None:
    from us_video_medsam2_tpu_torch.inference import serve

    real = serve.batched_propagate

    def half(pred, videos, coords, labels, *a, **k):
        h = videos.shape[0] // 2
        out = real(pred, videos[:h], coords[:h], labels[:h], *a, **k)
        return torch.cat([out, out[: videos.shape[0] - h]])

    mp.setattr(serve, "batched_propagate", half)


def answer_altered(mp, cell: str) -> None:
    from us_video_medsam2_tpu_torch.inference import serve, video_predictor

    module = serve if "serve" in cell else video_predictor
    real = module.fill_holes_in_mask_scores

    def fill(x, area, *a, **k):
        y = real(x, area, *a, **k).clone()
        if y.shape[0] > 1:  # a stack of one frame (a video's last chunk) is left alone
            y[1] = -y[1]
        return y

    mp.setattr(module, "fill_holes_in_mask_scores", fill)


FAULTS = {"state_unchanged": state_unchanged, "half_the_batch": half_the_batch, "answer_altered": answer_altered,
          "memory_unread": memory_unread}
PROBES = {"memory_unwritten": memory_unwritten}


def applies(fault: str, kind: str) -> bool:
    """Whether a cell whose traffic is of ``kind`` can have ``fault``."""
    return not (fault == "half_the_batch" and kind != "batched")
