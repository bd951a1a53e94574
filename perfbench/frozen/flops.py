"""Matrix-product and convolution FLOPs of a run: the numerator of the MFU metrics.

Frozen copy of the method of ``us_video_medsam2_tpu_torch/utils/flops.py`` at
commit 40a6c6c: the function runs once under a dispatch mode that counts every
operator ``torch.utils.flop_counter`` has a formula for (matrix products and
convolutions at 2 FLOPs a multiply-add, their backward ops too); elementwise
work is not counted. A composite that reaches the mode undecomposed is counted
through the ops it decomposes into. The benchmark counts its own plain
reference (``perfbench/reference``), which launches no kernel of the port, so
the original's check for kernel launches has nothing to guard here.
"""

from __future__ import annotations

from torch.utils._python_dispatch import TorchDispatchMode


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        import torch
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        formula = flop_registry.get(func._overloadpacket)
        if formula is None and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def fn_flops(fn, *args, **kwargs):
    """(FLOPs of ``fn(*args, **kwargs)``, its result); ``fn`` runs once."""
    with _Count() as counter:
        out = fn(*args, **kwargs)
    return counter.total, out
