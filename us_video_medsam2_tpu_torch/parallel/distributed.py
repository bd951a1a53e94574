"""Data parallelism through ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py`` for training (the
reference's torch.distributed/DDP stack, training/utils/distributed.py,
trainer.py:291-311). One process a card, started by ``torchrun``: the group
is set up from its environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), NCCL on the card and gloo on the CPU;
without that environment every function here is the single-process no-op.
In a group every collective runs, one rank alone included.

The JAX step is written over the global batch and sharded, so it equals the
single-device step; the port gets the same by reducing what the loss
normalises by: ``all_reduce_sum`` of the valid-object count gives every
rank the global ``num_objects``, each rank's loss is then its share of the
global loss, and ``all_reduce_gradients`` sums (not averages) the
gradients. No ``DistributedDataParallel`` wrapper: the optimizer takes a
dict of gradients. On the card these NCCL collectives are captured with the
rest of the training step (``training/train_step.py``) and replayed with
it; gloo on the CPU runs them eagerly. Sharded serving is not here.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist


def launched() -> bool:
    """True when the environment describes a process group (``torchrun``'s,
    or one set by hand, one rank included)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def maybe_initialize_distributed(device: str | torch.device = "cuda") -> torch.device:
    """Join the process group ``torchrun`` describes, if any (NCCL for a
    CUDA ``device``, gloo for the CPU), and return this process's device
    (``cuda:LOCAL_RANK`` on the card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local)
        if torch.cuda.is_available():
            torch.cuda.set_device(dev)
    if launched() and not dist.is_initialized():
        kw = {"device_id": dev} if dev.type == "cuda" else {}  # NCCL binds this process to its card
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                                timeout=timedelta(minutes=30), **kw)
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (reference distributed.py:411-483)."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_objects(obj) -> list:
    """Every rank's ``obj``, by rank."""
    if not is_initialized():
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor; ``x`` itself when alone)."""
    if not is_initialized():
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    return y


def all_reduce_gradients(grads: dict) -> dict:
    """The gradients summed over the ranks, in place, flattened into one
    buffer a dtype so that one collective carries them."""
    if not is_initialized():
        return grads
    by_dtype: dict = {}
    for n, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(n)
    for names in by_dtype.values():
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        off = 0
        for n in names:
            k = grads[n].numel()
            grads[n].copy_(flat[off: off + k].view_as(grads[n]))
            off += k
    return grads


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()
