"""PyTorch port: the forward-only kernels' call path (``kernels/_lib.py``).

``with_plain_grad`` runs a kernel whose gradient is its plain version's,
recomputed in the backward pass. When no gradient is wanted it must call
the kernel alone, with no autograd node; when one is, it must give autograd
of the plain version and run the kernel once, in the forward only. A
stand-in kernel (the plain LayerNorm under a call counter) takes the place
of the CUDA kernel on the CPU.
"""

import contextlib

import numpy as np
import pytest
import torch

from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels.layer_norm import layer_norm, layer_norm_plain


class CountedPlain:
    """The plain LayerNorm as a stand-in kernel, counting its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        return layer_norm_plain(*args)


def _inputs(requires_grad: bool):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((48, 96)), dtype=torch.float32)
    w = torch.tensor(1.0 + 0.1 * rng.standard_normal(96), dtype=torch.float32)
    b = torch.tensor(0.1 * rng.standard_normal(96), dtype=torch.float32)
    return [a.requires_grad_(requires_grad) for a in (x, w, b)]


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "no input requires a gradient"])
def test_no_gradient_wanted_calls_the_kernel_alone(mode):
    kernel = CountedPlain()
    ctx = {"inference_mode": torch.inference_mode(), "no_grad": torch.no_grad()}.get(mode, contextlib.nullcontext())
    x, w, b = _inputs(requires_grad=mode != "no input requires a gradient")
    with ctx:
        out = _lib.with_plain_grad(kernel, layer_norm_plain, x, w, b, 1e-6)
    assert out.grad_fn is None and not out.requires_grad
    assert kernel.calls == 1
    assert torch.equal(out, layer_norm_plain(x.detach(), w.detach(), b.detach(), 1e-6))


def test_gradient_wanted_gives_autograd_of_the_plain_version():
    kernel = CountedPlain()
    got, want = _inputs(requires_grad=True), _inputs(requires_grad=True)
    out = _lib.with_plain_grad(kernel, layer_norm_plain, *got, 1e-6)
    assert out.grad_fn is not None
    assert kernel.calls == 1
    g = torch.tensor(np.random.default_rng(1).standard_normal(out.shape), dtype=torch.float32)
    out.backward(g)
    assert kernel.calls == 1  # the backward recomputes through the plain version, not the kernel
    layer_norm_plain(*want, 1e-6).backward(g)
    for a, r in zip(got, want):
        torch.testing.assert_close(a.grad, r.grad, rtol=0, atol=0)


def test_gradient_only_for_the_inputs_that_require_one():
    kernel = CountedPlain()
    x, w, b = _inputs(requires_grad=False)
    w.requires_grad_(True)
    out = _lib.with_plain_grad(kernel, layer_norm_plain, x, w, b, 1e-6)
    out.sum().backward()
    w_ref = w.detach().clone().requires_grad_(True)
    layer_norm_plain(x, w_ref, b, 1e-6).sum().backward()
    assert x.grad is None and b.grad is None
    torch.testing.assert_close(w.grad, w_ref.grad, rtol=0, atol=0)


def test_the_kernel_path_still_raises_off_the_cpu_under_inference_mode():
    """A meta tensor stands in for a foreign device: without an autograd
    node the wrapper reaches the kernel's checks directly, and they raise."""
    m = dict(device="meta")
    with torch.inference_mode(), pytest.raises(ValueError):
        layer_norm(torch.empty(8, 96, **m), torch.empty(96, **m), torch.empty(96, **m))
