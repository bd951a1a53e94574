"""The predictor's frame body, and its CUDA graphs.

Counterpart of the body of the JAX predictor's ``lax.scan``
(``inference/video_predictor.py``, ``_propagate_impl``): ``frame_body`` reads
one frame's features, runs ``SAM2Model.track_step`` (memory write included)
and writes the frame's low-res logits into its row of a ``[F, O, 4·fs,
4·fs]`` buffer. Everything it reads or writes lies in a ``FrameBuffers`` at
fixed addresses, and the frame index and the video's length are 0-d long
tensors there (JAX traces both), so one capture of the body serves every
frame of the window and every video length whose bank has the same slots
(a ``t_bucket``): the host writes the index and the length (``fill_``) and,
where the body encodes its own frame, copies the frame in, then replays. The
frame buffer has the dtype of the video's store: f32 for a resident video,
the host dtype of an offloaded one, or raw uint8, which the body normalizes
(JAX ``_propagate_chunk_impl``). On the CPU the predictor calls the same
body eagerly. The same body serves batched multi-video serving
(``inference/serve.py``): there the frame buffer holds one frame for each of
the bank's rows, each row a video, and each row keeps its own features.

``FrameGraphs`` keeps a predictor's captures (``utils/graphs.py``'s
``FrameGraph``), one a key, and drops every graph once a weight has other
memory or another version (an in-place update, ``.data =``, a cast). It
keeps at most ``MAX_GRAPHS``, the last used.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from us_video_medsam2_tpu_torch.inference.transforms import prep_frames
from us_video_medsam2_tpu_torch.models.memory_bank import MemoryBank
from us_video_medsam2_tpu_torch.utils.graphs import MAX_GRAPHS, FrameGraph, read_counts  # noqa: F401


@dataclasses.dataclass
class FrameBuffers:
    """What the frame body reads and writes."""

    t: torch.Tensor  # 0-d long: the frame index
    num_frames: torch.Tensor  # 0-d long: the video's length (the bank may have more slots)
    bank: MemoryBank  # [O, F, ...]: the body reads it and writes row t
    lows: torch.Tensor  # [F, O, 4fs, 4fs] f32 low-res logits: the body writes row t
    frame: Optional[torch.Tensor]  # [1 or O, S, S, 3] f32, f16 or raw uint8: the frame(s) the body encodes, or
    feats: Optional[Dict[str, torch.Tensor]]  # {top, s0, s1} [F, ...]: precomputed rows


def encode_frames(model, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """images [B, S, S, 3] -> {'top'[, 's0', 's1']}: what ``track_step`` reads."""
    fpn = model.forward_image(images)["backbone_fpn"]
    feats = {"top": fpn[-1]}
    if model.cfg.use_high_res_features_in_sam:
        feats["s0"], feats["s1"] = fpn[0], fpn[1]
    return feats


def feature_shapes(cfg) -> Dict[str, tuple]:
    """Per-frame shapes of ``encode_frames``' outputs."""
    fs, d = cfg.feat_size, cfg.hidden_dim
    shapes = {"top": (fs, fs, d)}
    if cfg.use_high_res_features_in_sam:
        shapes["s0"], shapes["s1"] = (4 * fs, 4 * fs, d // 8), (2 * fs, 2 * fs, d // 4)
    return shapes


def make_buffers(model, bank: MemoryBank, precompute: bool, new_bank: bool,
                 frame_dtype: torch.dtype = torch.float32, per_row_frames: bool = False) -> FrameBuffers:
    """Buffers for ``bank``'s shape on its device; the bank itself unless
    ``new_bank`` (then a zeroed bank of the same shape that the caller copies
    a state's bank into). The frame buffer has ``frame_dtype`` and one frame,
    whose features every row (object) shares, or with ``per_row_frames`` a
    frame for each row (batched serving: each row a video)."""
    cfg = model.cfg
    o, nf = bank.valid.shape
    dev = bank.valid.device
    if new_bank:
        bank = MemoryBank(*(torch.zeros_like(x) for x in bank_tensors(bank)))
    lows = torch.zeros(nf, o, 4 * cfg.feat_size, 4 * cfg.feat_size, device=dev)
    frame = feats = None
    if precompute:
        feats = {k: torch.zeros((nf, *s), dtype=model.dtype, device=dev) for k, s in feature_shapes(cfg).items()}
    else:
        rows = o if per_row_frames else 1
        frame = torch.zeros(rows, cfg.image_size, cfg.image_size, 3, dtype=frame_dtype, device=dev)
    index = torch.zeros((), dtype=torch.long, device=dev)
    return FrameBuffers(index, torch.zeros_like(index), bank, lows, frame, feats)


def frame_body(model, bufs: FrameBuffers, num_frames: int | torch.Tensor, reverse: bool,
               max_cond_slots: int) -> None:
    """One tracked frame: features of frame ``bufs.t``, ``track_step`` with
    the memory encoder (its memory written into ``bufs.bank``), the chosen
    low-res logits into row ``bufs.t`` of ``bufs.lows``. ``num_frames`` is
    the video's length, an int or ``bufs.num_frames``. The features of a
    one-frame buffer are expanded to the O rows; those of a buffer of O
    frames (one a row) are already the rows' own, and expand to themselves."""
    t = bufs.t.reshape(1)
    if bufs.frame is not None:
        feats1 = encode_frames(model, prep_frames(bufs.frame, model.cfg.image_size))
    else:
        feats1 = {k: v.index_select(0, t) for k, v in bufs.feats.items()}
    o = bufs.lows.shape[1]
    feats = {k: v.expand(o, -1, -1, -1) for k, v in feats1.items()}
    out, _ = model.track_step(bufs.t, feats, bufs.bank, num_frames, multimask_output=True,
                              track_in_reverse=reverse, max_cond_slots=max_cond_slots)
    bufs.lows.index_copy_(0, t, out["low_res_masks"][:, 0].float()[None])


def bank_tensors(bank: MemoryBank) -> tuple:
    # not dataclasses.astuple, which returns deep copies
    return tuple(getattr(bank, f.name) for f in dataclasses.fields(bank))


def copy_bank(dst: MemoryBank, src: MemoryBank) -> None:
    for d, s in zip(bank_tensors(dst), bank_tensors(src)):
        d.copy_(s)


def weight_tensors(model) -> list:
    """What a captured body reads of the model: its parameters and buffers."""
    return list(model.parameters()) + list(model.buffers())


class FrameGraphs:
    """A predictor's graphs: one ``FrameGraph`` a key, made at the first
    window of that key and kept for later states of the same shape (the
    predictor copies a state's bank in before its window and out after).
    At most ``MAX_GRAPHS`` are kept, the last used; all are dropped when
    the weights they read change. A dropped graph's memory pool goes back
    to the allocator, and the capture that follows every drop returns it to
    the card (``warm_up_and_capture`` empties the cache). ``captures`` counts
    the captures made."""

    def __init__(self):
        self.entries: "collections.OrderedDict[tuple, FrameGraph]" = collections.OrderedDict()
        self.captures = 0

    def get(self, key: tuple, make: Callable[[], FrameBuffers], body: Callable[[FrameBuffers], None],
            weights: Sequence[torch.Tensor] = ()) -> FrameGraph:
        if not all(g.reads(weights) for g in self.entries.values()):
            self.entries.clear()
        g = self.entries.get(key)
        if g is not None:
            self.entries.move_to_end(key)
            return g
        while len(self.entries) >= MAX_GRAPHS:
            self.entries.popitem(last=False)
        g = FrameGraph(make(), weights)
        g.warm_up_and_capture(lambda: body(g.bufs))
        self.entries[key] = g
        self.captures += 1
        return g


class ChunkStager:
    """An offloaded video's frames onto the device a chunk at a time (JAX
    ``propagate_in_video``'s host gather, ``:1047-1055``). On the card each
    chunk goes through one of two page-locked host buffers, used in turn,
    into a device buffer of its own by one copy that does not block the
    host; an event recorded after the copy says when the host buffer may be
    filled again. The host therefore waits only when it refills a buffer,
    before the window of the chunk after next, and never inside a window.
    The video itself is never pinned. On the CPU a chunk is gathered into a
    plain buffer."""

    def __init__(self, store, chunk: int, device: torch.device):
        shape = (chunk, *store.shape[1:])
        dtype = torch.from_numpy(store[:0]).dtype
        self.store = store
        self.on_card = device.type == "cuda"
        self.host = [torch.empty(shape, dtype=dtype, pin_memory=self.on_card) for _ in range(2)]
        self.dev = ([torch.empty(shape, dtype=dtype, device=device) for _ in range(2)]
                    if self.on_card else self.host)
        self.ready: list = [None, None]

    def stage(self, i: int, frames) -> torch.Tensor:
        """Chunk ``i``'s ``frames`` (video indices) into rows 0.. of buffer
        ``i % 2`` on the device; the buffer is returned."""
        j = i % 2
        if self.ready[j] is not None:
            self.ready[j].synchronize()  # the copy out of this host buffer has ended
        n = len(frames)
        np.take(self.store, np.asarray(frames, np.int64), axis=0, out=self.host[j].numpy()[:n])
        if self.on_card:
            self.dev[j][:n].copy_(self.host[j][:n], non_blocking=True)
            self.ready[j] = torch.cuda.Event()
            self.ready[j].record()
        return self.dev[j]
