# Frozen copy of us_video_medsam2_tpu_torch/models/layers.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""Shared building blocks, channels-last (NHWC) / batch-first.

Counterpart of the JAX package's ``models/layers.py``. Parameters are created
in f32 and cast to the input dtype at use, as the JAX modules do;
``cast_weight_matrices`` turns the weight matrices of Linear, convolution and
transposed-convolution modules into the compute dtype once for serving, and
every other parameter (biases, LayerNorm scale/bias, embeddings) stays f32.
Numerics: exact-erf GELU, LayerNorm eps per site, f32 LayerNorm statistics.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.plain import layer_norm_plain


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


ACTIVATIONS = {"relu": F.relu, "gelu": gelu_exact}


class Linear(nn.Linear):
    """nn.Linear whose weight and bias are cast to the input dtype at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, fast-variance form (mean and E[x²] from one
    pass), f32 statistics and f32 scale/bias, output in the input dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_plain(x, self.weight, self.bias, self.eps)


class MLP(nn.Module):
    """Stacked Linear layers with an activation between them (children
    ``layers_0`` .. ``layers_{n-1}``, as in the JAX parameter tree)."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers,
                 activation: str = "relu", sigmoid_output: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.act = ACTIVATIONS[activation]
        self.sigmoid_output = sigmoid_output
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layers_{i}", Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = self.act(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class NHWCConv(nn.Module):
    """2-D convolution on NHWC tensors with a torch-layout weight [out, in/g, kh, kw]."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, groups=1, bias=True):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=5**0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     self.stride, self.padding, 1, self.groups)
        return y.permute(0, 2, 3, 1)


class Conv2d(nn.Module):
    """The JAX ``layers.Conv2d`` wrapper: an NHWC convolution held as ``conv``."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, groups=1, bias=True):
        super().__init__()
        self.conv = NHWCConv(cin, cout, kernel, stride, padding, groups, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ConvTranspose2x(nn.Module):
    """2x2 / stride-2 transposed convolution on NHWC; weight [in, out, 2, 2]."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=5**0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                               self.bias.to(x.dtype), stride=2)
        return y.permute(0, 2, 3, 1)


def cast_weight_matrices(module: nn.Module, dtype: torch.dtype) -> None:
    """Cast the weight matrices of Linear / convolution modules to ``dtype``
    in place; everything else keeps f32."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, NHWCConv, ConvTranspose2x)):
            m.weight.data = m.weight.data.to(dtype)
