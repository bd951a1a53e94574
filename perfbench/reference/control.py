"""The correctness control: the reference computed one precision below bf16.

The configurations state bfloat16; the next precision below it is fp8. Under
``fp8_products()`` every matrix product and convolution of the reference
rounds its two operands to float8 e4m3 with one scale a tensor (its largest
magnitude mapped to 448, e4m3's largest finite value), as an fp8 path would,
and accumulates in float32. The comparison that decides ``correct`` has to
fail this control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
_PRODUCTS = {F.linear, torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.bmm, torch.mm,
             torch.einsum, F.conv2d, F.conv_transpose2d}


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, back in x's dtype."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


class fp8_products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            if func is torch.einsum:
                args = (args[0], *[to_fp8(a) if torch.is_tensor(a) and a.is_floating_point() else a
                                   for a in args[1:]])
            else:
                # the two operands; a bias (the third argument) keeps its precision
                args = tuple(to_fp8(a) if i < 2 and torch.is_tensor(a) and a.is_floating_point() else a
                             for i, a in enumerate(args))
        return func(*args, **kwargs)
