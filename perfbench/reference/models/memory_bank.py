# Frozen copy of us_video_medsam2_tpu_torch/models/memory_bank.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""Fixed-shape streaming memory bank.

Counterpart of the JAX package's ``models/memory_bank.py``: the bank holds
per-object, per-frame memories in static-shape tensors indexed by absolute
frame, and per-frame selection is an index computation + gather + validity
mask. Key layout fed to memory attention, always in this order:
[cond-frame slots (K) | non-cond slots (num_maskmem - 1) | object pointers].
``write_memory`` updates the bank in place; ``with_memory`` returns a new
bank, as the JAX ``write_memory`` does (the training forward's bank, carried
from frame to frame as JAX's scan carries it, so that a frame's body
recomputed in the backward pass reads the bank it was given).

The frame index is an int or a 0-d ``torch.long`` tensor on the bank's device
(JAX traces it): with a tensor, selection and write are device ops only, so
a captured frame body (``inference/graphs.py``) serves every frame. Indexing
with a 0-d tensor (``bank.valid[:, t]``) would read it back to the host, so
the tensor form writes through ``index_copy_`` / ``index_fill_``.
``num_frames`` may be a 0-d tensor too (JAX's traced length): then the
pointer slots are sized at ``max_obj_ptrs_in_encoder`` and masked, so every
video length in one bank bucket shares one captured body.

``clear_window``, ``downgrade_frame`` and ``permute_rows`` are the JAX
predictor's three bank edits (``_clear_window``, ``_downgrade_frame``,
``_permute_rows``), done in place with device ops only.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from perfbench.reference.config import SAM2Config


@dataclass
class MemoryBank:
    maskmem: torch.Tensor  # [B, S, Hm*Wm, mem_dim]
    obj_ptr: torch.Tensor  # [B, S, C]
    valid: torch.Tensor  # [B, S] bool
    is_cond: torch.Tensor  # [B, S] bool

    def rows(self, start: int, stop: int) -> "MemoryBank":
        """View of object rows [start, stop)."""
        return MemoryBank(self.maskmem[start:stop], self.obj_ptr[start:stop],
                          self.valid[start:stop], self.is_cond[start:stop])


def init_memory_bank(batch, num_frames, mem_hw, mem_dim, hidden_dim, dtype=torch.float32,
                     ptr_dtype=None, device="cpu") -> MemoryBank:
    """The video predictor stores maskmem in bf16 and object pointers in f32."""
    return MemoryBank(
        maskmem=torch.zeros(batch, num_frames, mem_hw, mem_dim, dtype=dtype, device=device),
        obj_ptr=torch.zeros(batch, num_frames, hidden_dim, dtype=ptr_dtype or dtype, device=device),
        valid=torch.zeros(batch, num_frames, dtype=torch.bool, device=device),
        is_cond=torch.zeros(batch, num_frames, dtype=torch.bool, device=device),
    )


def write_memory(bank: MemoryBank, frame_idx: int | torch.Tensor, maskmem: torch.Tensor,
                 obj_ptr: torch.Tensor, is_cond: bool | torch.Tensor) -> MemoryBank:
    """Store frame_idx's memory ([B, Hm*Wm, mem_dim], [B, C]) in place.
    ``is_cond`` is a bool or, with a tensor index, may be a 0-d bool tensor
    on the bank's device (the training step's plan), written by
    ``index_copy_`` so that nothing is read back to the host."""
    if isinstance(frame_idx, torch.Tensor):
        t = frame_idx.reshape(1)
        bank.maskmem.index_copy_(1, t, maskmem.to(bank.maskmem.dtype)[:, None])
        bank.obj_ptr.index_copy_(1, t, obj_ptr.to(bank.obj_ptr.dtype)[:, None])
        bank.valid.index_fill_(1, t, True)
        if isinstance(is_cond, torch.Tensor):
            bank.is_cond.index_copy_(1, t, is_cond.to(torch.bool).reshape(1, 1).expand(bank.is_cond.shape[0], 1))
        else:
            bank.is_cond.index_fill_(1, t, bool(is_cond))
        return bank
    bank.maskmem[:, frame_idx] = maskmem.to(bank.maskmem.dtype)
    bank.obj_ptr[:, frame_idx] = obj_ptr.to(bank.obj_ptr.dtype)
    bank.valid[:, frame_idx] = True
    bank.is_cond[:, frame_idx] = bool(is_cond)
    return bank


def with_memory(bank: MemoryBank, frame_idx: torch.Tensor, maskmem: torch.Tensor, obj_ptr: torch.Tensor,
                is_cond: torch.Tensor) -> MemoryBank:
    """A new bank: ``bank`` with frame_idx's memory ([B, Hm*Wm, mem_dim],
    [B, C]) and its 0-d bool ``is_cond`` written (``write_memory`` with a
    tensor index, out of place); ``bank`` is left as it was."""
    t = frame_idx.reshape(1)
    return MemoryBank(
        maskmem=bank.maskmem.index_copy(1, t, maskmem.to(bank.maskmem.dtype)[:, None]),
        obj_ptr=bank.obj_ptr.index_copy(1, t, obj_ptr.to(bank.obj_ptr.dtype)[:, None]),
        valid=bank.valid.index_fill(1, t, True),
        is_cond=bank.is_cond.index_copy(1, t, is_cond.to(torch.bool).reshape(1, 1).expand(bank.is_cond.shape[0], 1)),
    )


@dataclass
class MemorySelection:
    mem_idx: torch.Tensor  # [B, K + R] frame indices into the bank
    mem_valid: torch.Tensor  # [B, K + R] bool
    mem_tpos: torch.Tensor  # [K + R] index into maskmem_tpos_enc
    ptr_idx: torch.Tensor  # [B, P]
    ptr_valid: torch.Tensor  # [B, P] bool
    ptr_pos: torch.Tensor  # [B, P] f32 temporal distances
    t_diff_max: int | torch.Tensor  # pointer sine-embedding normalizer (f32 0-d with a tensor length)


def select_memories(bank: MemoryBank, frame_idx: int | torch.Tensor, cfg: SAM2Config,
                    num_frames: int | torch.Tensor,
                    track_in_reverse: bool = False, max_cond_slots: int | None = None,
                    is_training: bool = False) -> MemorySelection:
    """The reference's memory-frame selection (sam2_base.py:1296-1422) as a
    static gather plan: conditioning slots are the K closest valid
    conditioning frames (ties to the lower frame index); non-conditioning slots
    follow the stride-r schedule (r = 1 in training); pointer slots cover the
    last min(num_frames, max_obj_ptrs) frames (conditioning pointers only from
    the past at eval, if so configured). Conditioning frames that did not
    make the top K stay eligible as non-conditioning memories and pointers.
    ``frame_idx`` is an int or a 0-d long tensor on the bank's device.
    ``num_frames`` is an int (the pointer slots cover min(num_frames,
    max_obj_ptrs)) or a 0-d long tensor there (JAX's traced form: the
    slots are sized at max_obj_ptrs and those past the video masked, which
    attention turns into exact zeros)."""
    B, S = bank.valid.shape
    dev = bank.valid.device
    K = max(min(cfg.max_cond_frame_slots if max_cond_slots is None else max_cond_slots, S), 1)
    sign = -1 if track_in_reverse else 1

    all_t = torch.arange(S, device=dev)
    dist = (all_t - frame_idx).abs()[None].expand(B, S)
    cond_ok = bank.valid & bank.is_cond
    score = torch.where(cond_ok, -dist.float(), torch.full_like(dist, float("-inf"), dtype=torch.float32))
    top_scores, order = torch.sort(score, dim=1, descending=True, stable=True)
    top_scores, cond_idx = top_scores[:, :K], order[:, :K]
    cond_valid = torch.isfinite(top_scores)
    selected_as_cond = torch.zeros(B, S, dtype=torch.bool, device=dev)
    selected_as_cond.scatter_(1, cond_idx, cond_valid)

    r = 1 if is_training else max(1, cfg.memory_temporal_stride_for_eval)
    t_pos = torch.arange(1, cfg.num_maskmem, device=dev)
    t_rel = cfg.num_maskmem - t_pos
    if not track_in_reverse:
        last = frame_idx - 1
        base = ((frame_idx - 2) // r) * r
        strided = base - (t_rel - 2) * r
    else:
        last = frame_idx + 1
        base = -(-(frame_idx + 2) // r) * r
        strided = base + (t_rel - 2) * r
    noncond_idx = torch.where(t_rel == 1, last, strided)
    noncond_idx = noncond_idx[None].expand(B, -1)
    in_range = (noncond_idx >= 0) & (noncond_idx < num_frames)
    safe = noncond_idx.clamp(0, S - 1)
    noncond_valid = in_range & bank.valid.gather(1, safe) & ~selected_as_cond.gather(1, safe)

    mem_idx = torch.cat([cond_idx.clamp(0, S - 1), safe], dim=1)
    mem_valid = torch.cat([cond_valid, noncond_valid], dim=1)
    mem_tpos = torch.cat([
        torch.full((K,), cfg.num_maskmem - 1, device=dev, dtype=torch.long),
        cfg.num_maskmem - t_pos - 1,
    ])

    if isinstance(num_frames, torch.Tensor):
        max_ptrs = cfg.max_obj_ptrs_in_encoder
        t_diff_max = (num_frames.clamp(max=cfg.max_obj_ptrs_in_encoder) - 1).clamp(min=1).float()
    else:
        max_ptrs = min(num_frames, cfg.max_obj_ptrs_in_encoder)
        t_diff_max = max(max_ptrs - 1, 1)
    cond_ptr_valid = cond_valid
    if not is_training and cfg.only_obj_ptrs_in_the_past_for_eval:
        in_past = (cond_idx >= frame_idx) if track_in_reverse else (cond_idx <= frame_idx)
        cond_ptr_valid = cond_ptr_valid & in_past
    if cfg.use_signed_tpos_enc_to_obj_ptrs:
        cond_pos = ((frame_idx - cond_idx) * sign).float()
    else:
        cond_pos = (frame_idx - cond_idx).abs().float()
    t_diff = torch.arange(1, max_ptrs, device=dev)
    nc_t = (frame_idx + t_diff if track_in_reverse else frame_idx - t_diff)[None].expand(B, -1)
    nc_in = (nc_t >= 0) & (nc_t < num_frames)
    nc_safe = nc_t.clamp(0, S - 1)
    nc_valid = nc_in & bank.valid.gather(1, nc_safe) & ~selected_as_cond.gather(1, nc_safe)
    nc_pos = t_diff.float()[None].expand(B, -1)

    return MemorySelection(
        mem_idx=mem_idx,
        mem_valid=mem_valid,
        mem_tpos=mem_tpos,
        ptr_idx=torch.cat([cond_idx.clamp(0, S - 1), nc_safe], dim=1),
        ptr_valid=torch.cat([cond_ptr_valid, nc_valid], dim=1),
        ptr_pos=torch.cat([cond_pos, nc_pos], dim=1),
        t_diff_max=t_diff_max,
    )


def gather_memories(bank: MemoryBank, sel: MemorySelection):
    """([B, M, HW, mem_dim] spatial memories, [B, P, C] object pointers)."""
    b = bank.maskmem.shape[0]
    rows = torch.arange(b, device=bank.maskmem.device)[:, None]
    return bank.maskmem[rows, sel.mem_idx], bank.obj_ptr[rows, sel.ptr_idx]


def clear_window(bank: MemoryBank, frame_idx: int | torch.Tensor, radius: int) -> MemoryBank:
    """Invalidate the non-conditioning memories within ``radius`` frames of
    ``frame_idx``, in place (reference ``_clear_non_cond_mem_around_input``,
    sam2_video_predictor.py:1155-1172): validity is a mask, so the scrub is a
    bitwise update."""
    s = bank.valid.shape[1]
    tt = torch.arange(s, device=bank.valid.device)
    win = (tt >= frame_idx - radius) & (tt <= frame_idx + radius)
    bank.valid &= ~(win[None] & ~bank.is_cond)
    return bank


def downgrade_frame(bank: MemoryBank, frame_idx: int | torch.Tensor) -> MemoryBank:
    """Conditioning frame -> non-conditioning, its memory kept, in place
    (reference clear_all_prompts_in_frame:804-821)."""
    if isinstance(frame_idx, torch.Tensor):
        bank.is_cond.index_fill_(1, frame_idx.reshape(1), False)
    else:
        bank.is_cond[:, frame_idx] = False
    return bank


def permute_rows(bank: MemoryBank, perm, keep) -> MemoryBank:
    """Row n of every field becomes row ``perm[n]`` where ``keep[n]``, else
    zeros, in place (reference remove_object Step 3,
    sam2_video_predictor.py:1110-1131). ``perm`` and ``keep`` are host
    sequences, so the moves are device copies with no host transfer."""
    for x in (bank.maskmem, bank.obj_ptr, bank.valid, bank.is_cond):
        src = x.clone()
        for row, (p, k) in enumerate(zip(perm, keep)):
            if k:
                x[row].copy_(src[int(p)])
            else:
                x[row].zero_()
    return bank
