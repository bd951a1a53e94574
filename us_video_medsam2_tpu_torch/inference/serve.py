"""Batched multi-video propagation (the serving path).

Counterpart of the JAX package's ``inference/serve.py`` (``_serve_impl``,
``batched_propagate``). The interactive predictor drives ONE video with
host-side prompt state; serving wants N independent videos, one prompt each,
propagated at once. The video axis is the model's batch axis: every model
function (``track_step``, ``encode_memory``, the memory bank) is batched over
rows, and here each row is a different video with its own features, so the
memory attention runs at [N, 1, 1024, Lk].

Frame 0 of every video is prompted at once (``track_step`` without the
memory encoder), then its memory is encoded and written as a conditioning
memory (the interactive predictor's consolidation). Frames 1 to T-1 are the
JAX ``lax.scan``: each is one call of ``graphs.frame_body`` over a frame
buffer of N frames (one a video), with ``max_cond_slots=1``, writing the
bank; on a CUDA device that call is one replay of a CUDA graph of the body,
kept here for each predictor (``serve_graphs``) by what the body depends on (N, T,
the two kernel switches, the dtypes; the multimask choice shapes only the
eager prompt step), and the host does not wait on the device inside the
window. On the CPU the same body runs eagerly. Holes are then filled over
all N·T frames at once, the prompted frame's too, as JAX's serving does
(the interactive predictor yields a prompted frame's output unfilled).

With ``mesh`` (``parallel/mesh.py``: one process a card under ``torchrun``)
the video axis is sharded over the mesh's data axis as JAX's
``in_shardings`` shard it: each rank serves its contiguous N / ranks videos
on its card through the same path (one replay a frame over its rows) and
the [N, T, 4fs, 4fs] logits are gathered on every rank. JAX replicates the
weights and assumes every process holds the same ones; here the first call
with a given predictor and mesh gathers a digest of each rank's weights and
raises if two differ.

Not ported: ``prepare_images``' fold (a TPU relayout; ``prep_frames`` takes
its place).

Per-video semantics match the interactive predictor's. At N > 1 the kernels'
plans (the flash kernel's key splits, window attention's tiles) differ from
those at a batch of 1, so a batched run need not give the bits of N single
runs.
"""

from __future__ import annotations

import hashlib
import weakref

import numpy as np
import torch

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
from us_video_medsam2_tpu_torch.inference.transforms import prep_frames
from us_video_medsam2_tpu_torch.models.memory_bank import write_memory
from us_video_medsam2_tpu_torch.ops.connected_components import fill_holes_in_mask_scores
from us_video_medsam2_tpu_torch.parallel.mesh import all_gather_objects, gather_batch, shard_batch

MAX_COND_SLOTS = 1  # one prompted frame per video

# each predictor's batched frame bodies, freed with the predictor
SERVE_GRAPHS: "weakref.WeakKeyDictionary[object, FrameGraphs]" = weakref.WeakKeyDictionary()


# the meshes over which each predictor's weights were found equal on every rank
REPLICAS_CHECKED: "weakref.WeakKeyDictionary[object, list]" = weakref.WeakKeyDictionary()


def weights_digest(model) -> str:
    """SHA-256 of the model's state_dict: names, dtypes, shapes and bytes."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(f"{name} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def check_replicated(predictor, mesh) -> None:
    """On the first call with ``predictor`` and ``mesh``: every rank's
    weights the same bits, else ``RuntimeError`` on every rank."""
    checked = REPLICAS_CHECKED.setdefault(predictor, [])
    if any(m is mesh for m in checked):
        return
    digests = all_gather_objects(weights_digest(predictor.model))
    if len(set(digests)) > 1:
        raise RuntimeError(f"the ranks hold different weights (digests by rank {[d[:12] for d in digests]}); "
                           "sharded serving replicates one model")
    checked.append(mesh)


def serve_graphs(predictor) -> FrameGraphs:
    """The batched frame bodies captured for ``predictor``, by key."""
    graphs = SERVE_GRAPHS.get(predictor)
    if graphs is None:
        graphs = SERVE_GRAPHS[predictor] = FrameGraphs()
    return graphs


def serve_graph_key(predictor, n: int, t: int) -> tuple:
    """What a captured batched body depends on beyond its buffers' contents:
    the rows (videos) and slots (frames), the two switches (read at capture)
    and the compute and bank dtypes."""
    return (n, t, fused_cxblock_enabled(), fused_qkv_window_attention_enabled(), predictor.model.dtype,
            predictor.bank_dtype)


def _run_window(predictor, bank, frames: torch.Tensor) -> torch.Tensor:
    """Frames 1..T-1 of ``frames`` [N, T, S, S, 3]: the frame body over the N
    rows from the prompted ``bank``, a replay a frame on the card, where
    nothing waits on the device. Returns the body's [T, N, 4fs, 4fs] logits
    buffer (row 0 not written)."""
    model = predictor.model
    n, t = frames.shape[:2]
    if predictor.use_graphs:
        graph = serve_graphs(predictor).get(
            serve_graph_key(predictor, n, t),
            lambda: make_buffers(model, bank, False, new_bank=True, per_row_frames=True),
            lambda b: frame_body(model, b, b.num_frames, False, MAX_COND_SLOTS),
            weight_tensors(model),
        )
        bufs = graph.bufs
        copy_bank(bufs.bank, bank)
    else:
        graph = None
        bufs = make_buffers(model, bank, False, new_bank=False, per_row_frames=True)
    bufs.num_frames.fill_(t)
    for i in range(1, t):
        bufs.t.fill_(i)
        bufs.frame.copy_(frames[:, i])
        if graph is not None:
            graph.replay()
        else:
            frame_body(model, bufs, bufs.num_frames, False, MAX_COND_SLOTS)
    return bufs.lows


def _serve(predictor, frames: torch.Tensor, coords: torch.Tensor, labels: torch.Tensor,
           multimask: bool) -> torch.Tensor:
    """frames [N, T, S, S, 3] normalized f32 on the device; coords [N, P, 2];
    labels [N, P]. Returns low-res mask logits [N, T, 4fs, 4fs]."""
    model = predictor.model
    n, t = frames.shape[:2]
    bank = predictor._new_bank(n, t)

    # prompt frame 0 of every video at once, then its consolidation
    feats0 = encode_frames(model, frames[:, 0])
    out, _ = model.track_step(0, feats0, bank, t, coords, labels, is_init_cond_frame=True, is_cond_frame=True,
                              multimask_output=multimask, run_mem_encoder=False)
    maskmem = model.encode_memory(feats0["top"], out["high_res_masks"].float(),
                                  out["object_score_logits"].float(), is_mask_from_pts=True)
    write_memory(bank, 0, maskmem.reshape(n, -1, maskmem.shape[-1]), out["obj_ptr"].float(), True)

    if t > 1:
        lows = _run_window(predictor, bank, frames).clone()  # off the buffer the next call writes
    else:
        lows = torch.empty(1, n, *out["low_res_masks"].shape[-2:], device=frames.device)
    lows[0] = out["low_res_masks"][:, 0].float()
    lows = lows.transpose(0, 1)
    if predictor.fill_hole_area > 0:
        lows = fill_holes_in_mask_scores(lows.reshape(n * t, 1, *lows.shape[2:]),
                                         predictor.fill_hole_area).reshape(lows.shape)
    return lows.contiguous()


@torch.inference_mode()
def batched_propagate(predictor, videos, point_coords, point_labels, mesh=None, data_axis: str = "data"
                      ) -> torch.Tensor:
    """Propagate N single-object videos at once on the predictor's device.

    videos: [N, T, S, S, 3] float normalized at model resolution (or uint8
    frames, or frames at another size, normalized and resized here by
    ``prep_frames``), numpy or a tensor; point_coords: [N, P, 2] (x, y) at
    model resolution; point_labels: [N, P]. Returns the low-res mask logits
    [N, T, 4fs, 4fs] (f32, on the device), holes filled when the predictor
    fills them. Multimask follows ``cfg.multimask_*`` and P, as a prompt
    call of the interactive predictor decides it. With ``mesh`` (a
    ``DeviceMesh`` of ``parallel/mesh.py``) every rank passes the same N
    videos, serves its block of them along ``data_axis`` (N must divide by
    that axis's size, else ``ValueError``) and returns all N."""
    cfg = predictor.cfg
    dev = predictor.device
    v = torch.as_tensor(np.asarray(videos) if not torch.is_tensor(videos) else videos)
    coords = np.asarray(point_coords, np.float32)
    labels = np.asarray(point_labels, np.int32)
    if mesh is not None:
        v, coords, labels = (shard_batch(x, mesh, 0, data_axis) for x in (v, coords, labels))
        check_replicated(predictor, mesh)
    v = v.to(dev)
    n, t = v.shape[:2]
    frames = prep_frames(v.reshape(n * t, *v.shape[2:]), cfg.image_size)
    frames = frames.reshape(n, t, *frames.shape[1:])
    coords = torch.as_tensor(coords, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    num_pts = coords.shape[1]
    multimask = cfg.multimask_output_in_sam and cfg.multimask_min_pt_num <= num_pts <= cfg.multimask_max_pt_num
    out = _serve(predictor, frames, coords, labels, multimask)
    return out if mesh is None else gather_batch(out, mesh, 0, data_axis)
