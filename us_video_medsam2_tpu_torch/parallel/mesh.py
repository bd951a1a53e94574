"""Device mesh and batch sharding, in ``torch.distributed`` terms.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX builds one
``jax.sharding.Mesh`` over every chip in one program; here each process
drives one card (started by ``torchrun``: ``parallel/distributed.py`` joins
the group from its environment, NCCL on the card and gloo on the CPU), and
the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
over the group's ranks.

- ``create_mesh``: the mesh, with JAX's single ``-1`` size inferred and its
  size check.
- ``shard_batch``: this rank's contiguous block of an axis, the layout of
  ``PartitionSpec("data")``; an axis that does not divide by the mesh dim
  raises ``ValueError``, as JAX's ``jit`` does.
- ``gather_batch``: its inverse, an ``all_gather`` into the global tensor on
  every rank.
- ``broadcast_object``, ``all_gather_objects``, ``sync_hosts``: those of
  ``parallel/distributed.py``.

JAX's ``replicated``, ``replicate_pytree`` and ``batch_sharding`` place an
array on every chip or shard it across them inside one program. With one
process a card they have no separate meaning: each process already holds
its own copy of the weights (``inference/serve.py`` checks that the ranks'
copies are equal on the first sharded call), and a batch is sharded and
gathered by ``shard_batch`` / ``gather_batch`` (JAX's ``shard_pytree_batch``
is ``shard_batch`` of each leaf).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from us_video_medsam2_tpu_torch.parallel import distributed
from us_video_medsam2_tpu_torch.parallel.distributed import all_gather_objects, broadcast_object  # noqa: F401

__all__ = ["create_mesh", "shard_batch", "gather_batch", "broadcast_object", "all_gather_objects", "sync_hosts"]


def create_mesh(
    axis_names: Sequence[str] = ("data",),
    axis_sizes: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A mesh over every rank of the process group (joined here from
    ``torchrun``'s environment when not yet joined). Default: pure data
    parallelism. ``axis_sizes``: per-axis sizes; a single -1 is inferred
    from the number of ranks."""
    distributed.maybe_initialize_distributed(device_type)
    if not distributed.is_initialized():
        raise RuntimeError("create_mesh needs a process group: run under torchrun, or set RANK, WORLD_SIZE, "
                           "MASTER_ADDR and MASTER_PORT")
    n = distributed.world()
    sizes = [n] + [1] * (len(axis_names) - 1) if axis_sizes is None else list(axis_sizes)
    if len(sizes) != len(axis_names):
        raise ValueError(f"{len(axis_names)} axis names for {len(sizes)} sizes")
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh {sizes}: at most one -1")
    if -1 in sizes:
        sizes[sizes.index(-1)] = n // math.prod(s for s in sizes if s != -1)
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {sizes} != {n} ranks")
    return init_device_mesh(torch.device(device_type).type, tuple(sizes), mesh_dim_names=tuple(axis_names))


def _dim(mesh: DeviceMesh, mesh_axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if mesh_axis not in names:
        raise ValueError(f"the mesh has no axis {mesh_axis!r} (axes {names})")
    return names.index(mesh_axis)


def shard_batch(x, mesh: DeviceMesh, axis: int = 0, mesh_axis: str = "data"):
    """This rank's contiguous block of ``x`` (a tensor or numpy array) along
    ``axis``, split over the mesh dim ``mesh_axis``."""
    d = _dim(mesh, mesh_axis)
    n, r = mesh.size(d), mesh.get_local_rank(d)
    total = x.shape[axis]
    if total % n:
        raise ValueError(f"axis {axis} of size {total} does not divide by the mesh axis {mesh_axis!r} of size {n}")
    k = total // n
    return x[(slice(None),) * axis + (slice(r * k, (r + 1) * k),)]


def gather_batch(x: torch.Tensor, mesh: DeviceMesh, axis: int = 0, mesh_axis: str = "data") -> torch.Tensor:
    """The global tensor on every rank from each rank's block along ``axis``
    (every block of one shape), in rank order: ``shard_batch``'s inverse."""
    d = _dim(mesh, mesh_axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(d))]
    dist.all_gather(parts, x, group=mesh.get_group(d))
    return torch.cat(parts, dim=axis)


def sync_hosts(name: str = "barrier") -> None:
    """Cross-process barrier (reference distributed.py barrier(); ``name`` as JAX's, unused)."""
    distributed.barrier()
