"""Matmul and convolution FLOP counting: the numerator of MFU.

Counterpart of the JAX package's ``utils/flops.py``, which walks a jaxpr and
counts ``dot_general`` and ``conv_general_dilated`` at 2 FLOPs per
multiply-add. Here ``fn`` runs once under a dispatch mode that counts every
operator ``torch.utils.flop_counter`` has a formula for, the same way: the
matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``), the convolutions
(per group) and their backward ops; elementwise work is not counted, as in
JAX. A backward pass run inside the count is counted too. (Its
``FlopCounterMode`` also tracks modules through autograd hooks, which fail
on parameters used under ``torch.inference_mode()``, as the predictor runs.)

The port's kernels are counted through their plain versions, the
counterpart of JAX's ``flops_env()``: run the count on the CPU, where every
kernel wrapper takes its plain version. A CUDA tensor launches its kernel,
whose products no operator shows, so a count during which any
kernel launched raises instead of returning too little. The count is of
what ``fn`` runs: eager PyTorch has no scan to multiply, and of two branches
only the one taken is counted.

The JAX package's numbers differ where its TPU layouts compute more
(``tests/test_torch_flops.py`` computes each difference): Hiera's 7x7/4
patch embed as a 2x2 neighbourhood of space-to-depth cells (an 8x8
footprint), windows of 64 keys or fewer packed G = 128 // keys to an
attention under a block-diagonal bias (G times the keys per query, over a
window count padded to a multiple of G), and the position-embedding
resizes as two interpolation matmuls (``F.interpolate`` here, not a
product).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        formula = flop_registry.get(func._overloadpacket)
        if formula is None and func is not torch.ops.prim.device.default:
            # a composite (aten::matmul, aten::linear under inference mode)
            # reaches the mode undecomposed: count the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def _launches() -> int:
    from us_video_medsam2_tpu_torch.kernels import _lib

    return sum(w.launches for w in _lib.COUNTED.values())


def fn_flops(fn, *args, **kwargs) -> int:
    """Matmul and convolution FLOPs of ``fn(*args, **kwargs)``, which runs
    once (on the CPU, so that the kernels' plain versions run). Raises if a
    kernel launched while it ran."""
    before = _launches()
    with _Count() as counter:
        fn(*args, **kwargs)
    launched = _launches() - before
    if launched:
        raise RuntimeError(f"{launched} kernel launches during the FLOP count: a kernel's products are not "
                           "counted; count on the CPU, where the kernels' plain versions run")
    return counter.total
