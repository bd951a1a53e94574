"""LayerNorm -> Linear -> exact GELU -> Linear -> residual — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/fused_mlp.py``
(``ln_mlp_residual``, body ``_kernel``): the MLP tail of every Hiera and
ViTDet block, out = x + W2·GELU(W1·LN(x) + b1) + b2. LN uses the two-pass
variance with f32 statistics; the bf16 rounding points are those of the JAX
``_xla_ref``: LN output, W1 product plus bias, GELU output, W2 product plus
bias, residual sum. GELU is the exact erf form (``erff``), not the TPU's
polynomial.

On the H100 it is bound by operations at D 96-384 and by the weights' bytes
at t512's stage 4 (256 tokens of 768): 4·N·D·F flop against 4·N·D + 4·D·F
bytes. The CUDA kernel (``csrc/ln_mlp_residual.cu``) keeps the [tile, F]
hidden activation out of device memory. At batch 1 token tiles alone leave
most of the 132 SMs idle, so ``mlp_splits`` also splits the hidden axis F
across blocks, from the shape alone, as far as one wave of blocks holds.
Block (tile, s) normalises its tokens into shared memory, streams the W1 and
W2 slices of its hidden chunks through cp.async stages, runs both products on
``mma.sync`` bf16 tensor cores with GELU applied in registers, and keeps its
[tile, D] output partial in f32 registers. One split writes the output;
several write f32 partials that a second kernel sums in the fixed order
0..S−1 before b2, the bf16 round and the residual, so two calls give the same
bits. This is the JAX kernel's own ``f_chunks`` reassociation of the W2
contraction.
``ln_mlp_residual_split_plain`` is the plain model of that split, for the
tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from us_video_medsam2_tpu_torch.kernels import _lib

SUPPORTED_D = (96, 192, 384, 768)
F_CHUNK = 128  # the wrapper takes F in multiples of this
# the kernel's token tile and hidden chunk at each D (Cfg in csrc/ln_mlp_residual.cu),
# and how many of its blocks an SM holds (registers and shared memory; chip_smoke.py
# holds this against cudaOccupancyMaxActiveBlocksPerMultiprocessor)
BLOCK_M = {96: 64, 192: 64, 384: 64, 768: 32}
HIDDEN_CHUNK = {96: 64, 192: 64, 384: 64, 768: 32}
BLOCKS_PER_SM = {96: 2, 192: 2, 384: 1, 768: 1}
SMS = 132  # the H100's


def _hidden(x, ln_w, ln_b, w1, b1, eps):
    """bf16(GELU(bf16(W1·LN(x) + b1))) [N, F], rounded to x's dtype at each step."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()).to(x.dtype)
    h = (F.linear(y.float(), w1.to(x.dtype).float()) + b1.float()).to(x.dtype)
    return F.gelu(h.float(), approximate="none").to(x.dtype)


def ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-6):
    """Plain PyTorch version over x [N, D]; w1 [F, D], w2 [D, F] (Linear layout).
    Products run in f32 on the rounded operands, as f32-accumulating
    tensor-core products do."""
    h = _hidden(x, ln_w, ln_b, w1, b1, eps)
    o = (F.linear(h.float(), w2.to(x.dtype).float()) + b2.float()).to(x.dtype)
    return x + o


def mlp_splits(n: int, d: int, f: int) -> int:
    """Hidden splits of the kernel for x [n, d] and F = ``f``: as many as let
    the (token tile, split) blocks run in one wave (SMS x BLOCKS_PER_SM[d]
    blocks at once), at most one split per hidden chunk, and one where the
    token tiles alone fill the wave or there is no token. One block more than
    a wave holds starts a second wave, which costs as much as the first: at
    (1024, 384, 1536) 9 splits (144 blocks) took 0.0450 ms on an H100 against
    0.0279 for 8 (128 blocks)."""
    tiles = -(-n // BLOCK_M[d])
    if tiles <= 0:
        return 1
    return max(1, min(f // HIDDEN_CHUNK[d], SMS * BLOCKS_PER_SM[d] // tiles))


def split_ranges(f: int, splits: int, chunk: int) -> list[tuple[int, int]]:
    """The [lo, hi) hidden units of each split: the f // chunk chunks shared
    out evenly in order, as the kernel's block s takes chunks
    [s·C // S, (s+1)·C // S)."""
    chunks = f // chunk
    if f % chunk or not 1 <= splits <= chunks:
        raise ValueError(f"F={f} in chunks of {chunk} cannot take {splits} splits")
    return [(s * chunks // splits * chunk, (s + 1) * chunks // splits * chunk) for s in range(splits)]


def ln_mlp_residual_split_partials(x, ln_w, ln_b, w1, b1, w2, splits: int, eps: float = 1e-6,
                                   chunk: int | None = None):
    """Each split's f32 partial W2[:, lo:hi]·h[:, lo:hi] [splits, N, D], from
    the rounded operands; ``chunk`` defaults to the kernel's at x's D."""
    h = _hidden(x, ln_w, ln_b, w1, b1, eps).float()
    w2f = w2.to(x.dtype).float()
    ranges = split_ranges(w1.shape[0], splits, chunk or HIDDEN_CHUNK[x.shape[-1]])
    return torch.stack([F.linear(h[:, lo:hi], w2f[:, lo:hi]) for lo, hi in ranges])


def combine_partials(x, partials, b2):
    """x + bf16(sum of the partials in order 0..S−1, in f32, + b2): the combine kernel."""
    o = partials[0]
    for p in partials[1:]:
        o = o + p
    return x + (o + b2.float()).to(x.dtype)


def ln_mlp_residual_split_plain(x, ln_w, ln_b, w1, b1, w2, b2, splits: int, eps: float = 1e-6,
                                chunk: int | None = None):
    """The plain model of the kernel's split of F over ``splits`` blocks and
    its combine."""
    return combine_partials(x, ln_mlp_residual_split_partials(x, ln_w, ln_b, w1, b1, w2, splits, eps, chunk), b2)


def ln_mlp_residual(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-6):
    """x [N, D] -> x + MLP(LN(x)). CPU tensors take the plain version; a CUDA
    tensor launches the kernel (bf16 x/w1/w2, f32 LN params and biases) or
    raises. The gradient is the plain version's, recomputed in the backward
    pass (cast w1/w2 at use to keep f32 master weights)."""
    if x.is_cpu:
        return ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    return _lib.with_plain_grad(_kernel, ln_mlp_residual_plain, x, ln_w, ln_b, w1, b1, w2, b2, eps)


def _kernel(x, ln_w, ln_b, w1, b1, w2, b2, eps, splits=None):
    """The launch; ``splits`` overrides ``mlp_splits`` (for measurements)."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("ln_mlp_residual kernel takes contiguous bf16 CUDA x [N, D]")
    n, d = x.shape
    f = w1.shape[0]
    if d not in SUPPORTED_D or f % F_CHUNK:
        raise ValueError(f"ln_mlp_residual kernel: D={d} not in {SUPPORTED_D} or F={f} % {F_CHUNK}")
    expect = {
        "ln_w": (ln_w, (d,), torch.float32), "ln_b": (ln_b, (d,), torch.float32),
        "w1": (w1, (f, d), torch.bfloat16), "b1": (b1, (f,), torch.float32),
        "w2": (w2, (d, f), torch.bfloat16), "b2": (b2, (d,), torch.float32),
    }
    for name, (t, shape, dt) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ln_mlp_residual kernel: {name} must be contiguous {dt} {shape}")
    splits = mlp_splits(n, d, f) if splits is None else splits
    if not 1 <= splits <= f // HIDDEN_CHUNK[d]:
        raise ValueError(f"ln_mlp_residual kernel: {splits} splits of F={f} in chunks of {HIDDEN_CHUNK[d]}")
    out = torch.empty_like(x)
    part = torch.empty((splits, n, d), dtype=torch.float32, device=x.device) if splits > 1 else None
    global _fn
    if _fn is None:
        _fn = _lib.fn("usm_ln_mlp_residual_bf16", [_lib.P] * 9 + [_lib.I] * 4 + [_lib.F, _lib.P])
    rc = _fn(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
             w2.data_ptr(), b2.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
             n, d, f, splits, float(eps), _lib.stream_ptr(x))
    _lib.check(rc, "ln_mlp_residual")
    ln_mlp_residual.launches += 1
    return out


def blocks_per_sm(d: int, split: bool) -> int:
    """How many blocks of the kernel at this D one SM of the card holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); needs the card."""
    import ctypes

    n = ctypes.c_int(0)
    fn = _lib.fn("usm_ln_mlp_residual_blocks_per_sm", [_lib.I, _lib.I, ctypes.POINTER(ctypes.c_int)])
    _lib.check(fn(d, int(split), ctypes.byref(n)), "ln_mlp_residual occupancy")
    return n.value


_lib.counted(ln_mlp_residual)
_fn = None  # usm_ln_mlp_residual_bf16, bound at the first launch
