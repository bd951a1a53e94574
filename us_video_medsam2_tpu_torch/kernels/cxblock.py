"""The whole ConvNeXt block of the memory encoder's fuser — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/fused_cxblock.py``
(``fused_cxblock``, body ``_kernel``): out = x + γ·pwconv2(GELU(pwconv1(LN(
dwconv7x7(x))))) over [B, H, W, C]. Rounding points are those of the JAX
``_xla_ref``: the depthwise conv sums x·taps in f32, adds its f32 bias and
rounds; the LayerNorm (fast variance, f32 statistics) rounds; each pointwise
product accumulates in f32 and rounds, then adds its bias in the input dtype;
GELU is the exact erf form in f32, rounded; the layer scale multiplies and the
residual adds in the input dtype. Weights take the port's layouts: depthwise
[C, 1, k, k], Linear [out, in].

On the H100 the block at [1, 32, 32, 256] is bound by operations: 4·HW·C·4C
flop of the two pointwise products (1.07 GFLOP) against ~2.6 MB of x, out and
weights. The CUDA kernel (``csrc/cxblock.cu``) cannot hold the image in shared
memory as the TPU kernel holds it in VMEM (512 KB against 227 KB), so its unit
is an 8x8 token tile, and at B 1 there are only 16 of them for 132 SMs. So the
channels and the hidden axis 4C are split too, across the S blocks (ranks) of
a thread-block cluster, one cluster a tile (``plan_for``: the most splits
whose clusters all run at once). Rank r computes the depthwise conv of its
share of the channels (a run of 8-channel groups) and stores it into its
peers' shared memory, every rank normalises the whole tile, then streams its
hidden units in 64-wide chunks of W1 and W2 through a cp.async ring into
``mma.sync`` products with GELU in registers, and the ranks combine their f32
partials of the output through distributed shared memory in the fixed order
0..S−1, each rank summing the columns of its share, so two calls give the
same bits. ``plan_blocks`` walks the grid by the kernel's index arithmetic
and ``cxblock_split_plain`` computes the function as a plan cuts it up (for
the tests).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels.layer_norm import layer_norm_plain

SUPPORTED_C = (256,)
KERNEL_SIZE = 7
TILE = 8  # the kernel's token tile is TILE x TILE
F_CHUNK = 64  # hidden units of one stage of the kernel's cp.async ring
SPLIT_CHOICES = (8, 7, 6, 5, 4, 3, 2, 1)  # blocks a cluster: 8 is the portable cluster size
GROUP = 8  # a rank's channels and output columns are a run of 8-channel groups
THREADS = 256
# registers a thread of the kernel, from nvcc -Xptxas -v on sm_90a (chip_smoke.py
# prints the build's figure beside it and holds blocks_per_sm against the card)
REGISTERS = 222


def cxblock_plain(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps: float = 1e-6):
    """Plain PyTorch version (the JAX ``_xla_ref``) over x [B, H, W, C];
    dw_w [C, 1, k, k], w1 [4C, C], w2 [C, 4C]. Products run in f32 on the
    rounded operands, as f32-accumulating tensor-core products do."""
    dt = x.dtype
    c, k = x.shape[-1], dw_w.shape[-1]
    dw = F.conv2d(x.float().permute(0, 3, 1, 2), dw_w.float(), dw_b.float(), padding=k // 2, groups=c)
    y = layer_norm_plain(dw.permute(0, 2, 3, 1).to(dt), ln_w, ln_b, eps)
    h = F.linear(y.float(), w1.to(dt).float()).to(dt) + b1.to(dt)
    h = F.gelu(h.float(), approximate="none").to(dt)
    o = F.linear(h.float(), w2.to(dt).float()).to(dt) + b2.to(dt)
    return x + gamma.to(dt) * o


def split_ranges(n: int, splits: int, chunk: int) -> list[tuple[int, int]]:
    """The [lo, hi) of each split of n: the n // chunk chunks shared out
    evenly in order, as the kernel's rank r takes hidden chunks
    [r·K // S, (r+1)·K // S) (``chunk`` F_CHUNK) and its channels and
    output columns (``chunk`` GROUP)."""
    chunks = n // chunk
    if n % chunk or not 1 <= splits <= chunks:
        raise ValueError(f"{n} in chunks of {chunk} cannot take {splits} splits")
    return [(s * chunks // splits * chunk, (s + 1) * chunks // splits * chunk) for s in range(splits)]


def tiles(b: int, h: int, w: int) -> int:
    """Token tiles of the kernel's grid (clusters of a plan)."""
    return b * -(-h // TILE) * -(-w // TILE)


def smem_bytes(splits: int, c: int = 256) -> int:
    """Dynamic shared memory of a block (``Layout`` in the CUDA source): the
    tile's LN slab, the hidden slab, three ring slots, then the larger of a
    depthwise pass's halo and taps and the S partials a rank receives."""
    def a128(n):
        return -(-n // 128) * 128

    bm, pw = TILE * TILE, 64
    hs = a128(2 * bm * (c + 8))
    ring = a128(hs + 2 * bm * (F_CHUNK + 8))
    slot = a128(2 * max(F_CHUNK * (c + 8), c * (F_CHUNK + 8)))
    front = ring + 3 * slot
    halo = a128(2 * (TILE + KERNEL_SIZE - 1) ** 2 * (pw + 8)) + 4 * KERNEL_SIZE**2 * pw
    recv = 4 * splits * bm * max(hi - lo for lo, hi in split_ranges(c, splits, GROUP))
    return front + max(halo, recv)


def blocks_per_sm(splits: int) -> int:
    """Blocks of the kernel at ``splits`` one SM holds (``_lib.blocks_per_sm``)."""
    return _lib.blocks_per_sm(REGISTERS, smem_bytes(splits), THREADS)


def clusters_at_once(splits: int) -> int | None:
    """Clusters of ``splits`` blocks the card runs at once (blocks, at one
    split), or None where the table does not say."""
    per_sm = blocks_per_sm(splits)
    if per_sm == 0:
        return None
    return _lib.SMS * per_sm if splits == 1 else _lib.CLUSTERS_AT_ONCE.get((splits, per_sm))


@functools.lru_cache(maxsize=None)  # Python on every launch otherwise
def plan_for(b: int, h: int, w: int, f: int = 1024) -> int:
    """The kernel's splits (blocks a cluster) for x [b, h, w, C] and 4C =
    ``f``, from the shape alone: the most whose clusters, one a token tile,
    all run at once (one wave), else one. A rank's work falls with S (its
    share of the conv and of the hidden units) while its fixed part (the
    tile's LN, the combine's S slots of its columns) does not grow; a
    cluster past the card's clusters at once starts a second wave: at B 1
    (16 tiles) 8 splits would be 16 clusters of 8, 15 at once."""
    n = tiles(b, h, w)
    return next(s for s in SPLIT_CHOICES
                if s == 1 or (s <= f // F_CHUNK and n <= (clusters_at_once(s) or 0)))


def plan_blocks(b: int, h: int, w: int, c: int, f: int, splits: int):
    """Yield a dict for every block of the kernel's grid in launch order, by
    its own index arithmetic: block, tile, rank, batch, the tile's first row
    and column, its tokens inside the image [(row, column)], its hidden
    units and its channels (those of its depthwise conv and of the output
    columns it combines) as [lo, hi)."""
    tiles_w = -(-w // TILE)
    tiles_img = -(-h // TILE) * tiles_w
    hidden = split_ranges(f, splits, F_CHUNK)
    channels = split_ranges(c, splits, GROUP)
    for block in range(tiles(b, h, w) * splits):
        tile, rank = divmod(block, splits)
        bi, ti = divmod(tile, tiles_img)
        ty0, tx0 = ti // tiles_w * TILE, ti % tiles_w * TILE
        tokens = [(ty0 + r // TILE, tx0 + r % TILE) for r in range(TILE * TILE)
                  if ty0 + r // TILE < h and tx0 + r % TILE < w]
        yield {"block": block, "tile": tile, "rank": rank, "batch": bi, "origin": (ty0, tx0), "tokens": tokens,
               "hidden": hidden[rank], "channels": channels[rank]}


def cxblock_split_plain(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, splits: int, eps: float = 1e-6,
                        drop_split: int | None = None):
    """The plain model of the kernel's split over ``splits`` ranks: the
    depthwise conv by the ranks' channel shares, each rank's f32 partial
    W2[:, lo:hi]·h[..., lo:hi] over its hidden units, the partials summed in
    f32 in the order 0..S−1, then b2, γ and the residual, rounded as the
    kernel rounds. ``drop_split`` leaves that rank's partial out (a check's
    self-test)."""
    dt = x.dtype
    c, k = x.shape[-1], dw_w.shape[-1]
    xf = x.float().permute(0, 3, 1, 2)
    dw = torch.cat([F.conv2d(xf[:, lo:hi], dw_w[lo:hi].float(), dw_b[lo:hi].float(), padding=k // 2,
                             groups=hi - lo) for lo, hi in split_ranges(c, splits, GROUP)], 1)
    y = layer_norm_plain(dw.permute(0, 2, 3, 1).to(dt), ln_w, ln_b, eps)
    h = F.linear(y.float(), w1.to(dt).float()).to(dt) + b1.to(dt)
    h = F.gelu(h.float(), approximate="none").to(dt).float()
    w2f = w2.to(dt).float()
    o = None
    for s, (lo, hi) in enumerate(split_ranges(w1.shape[0], splits, F_CHUNK)):
        if s != drop_split:
            part = F.linear(h[..., lo:hi], w2f[:, lo:hi])
            o = part if o is None else o + part
    return x + gamma.to(dt) * (o.to(dt) + b2.to(dt))


def cxblock(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps: float = 1e-6):
    """x [B, H, W, C] -> the ConvNeXt block's output. CPU tensors take the
    plain version; a CUDA tensor launches the kernel (bf16 x/w1/w2, f32 taps,
    biases, LN parameters and γ) or raises. The gradient is the plain
    version's, recomputed in the backward pass (cast w1/w2 at use to keep f32
    master weights)."""
    if x.is_cpu:
        return cxblock_plain(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)
    return _lib.with_plain_grad(_kernel, cxblock_plain, x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2,
                                gamma, eps)


def _kernel(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, splits: int | None = None):
    """The launch; ``splits`` overrides ``plan_for`` (for measurements)."""
    if (x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError("cxblock kernel takes contiguous, 16-byte aligned bf16 CUDA x [B, H, W, C]")
    b, h, w, c = x.shape
    f = w1.shape[0]
    if c not in SUPPORTED_C or f % F_CHUNK:
        raise ValueError(f"cxblock kernel: C={c} not in {SUPPORTED_C} or 4C={f} % {F_CHUNK}")
    expect = {
        "dw_w": (dw_w, (c, 1, KERNEL_SIZE, KERNEL_SIZE), torch.float32),
        "dw_b": (dw_b, (c,), torch.float32), "ln_w": (ln_w, (c,), torch.float32),
        "ln_b": (ln_b, (c,), torch.float32), "w1": (w1, (f, c), torch.bfloat16),
        "b1": (b1, (f,), torch.float32), "w2": (w2, (c, f), torch.bfloat16),
        "b2": (b2, (c,), torch.float32), "gamma": (gamma, (c,), torch.float32),
    }
    for name, (t, shape, dt) in expect.items():
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"cxblock kernel: {name} must be contiguous, 16-byte aligned {dt} {shape}")
    splits = plan_for(b, h, w, f) if splits is None else splits
    if not 1 <= splits <= min(SPLIT_CHOICES[0], f // F_CHUNK):
        raise ValueError(f"cxblock kernel: {splits} splits of 4C={f} in chunks of {F_CHUNK}")
    out = torch.empty_like(x)
    global _fn
    if _fn is None:
        _fn = _lib.fn("usm_cxblock_bf16", [_lib.P] * 11 + [_lib.I] * 6 + [_lib.F, _lib.P])
    rc = _fn(x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
             w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
             out.data_ptr(), b, h, w, c, f, splits, float(eps), _lib.stream_ptr(x))
    _lib.check(rc, "cxblock")
    cxblock.launches += 1
    return out


def card_occupancy(splits: int) -> tuple[int, int, int]:
    """(shared-memory bytes of a block, blocks an SM holds, clusters the card
    runs at once) of the kernel at ``splits``, as the card's occupancy API
    gives them; needs the card."""
    n = [ctypes.c_int(0) for _ in range(3)]
    fn = _lib.fn("usm_cxblock_occupancy", [_lib.I] + [ctypes.POINTER(ctypes.c_int)] * 3)
    _lib.check(fn(splits, *map(ctypes.byref, n)), "cxblock occupancy")
    return n[0].value, n[1].value, n[2].value


_lib.counted(cxblock)
_fn = None  # usm_cxblock_bf16, bound at the first launch
