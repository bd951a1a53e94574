"""PyTorch port, ``utils/flops.py`` (the MFU numerator) against the JAX
package's ``utils/flops.py`` on the CPU.

- JAX's unit cases (tests/test_flops.py: a dot, a batched dot_general, a
  convolution and a depthwise one) as exact integers, equal to JAX's count;
- a kernel wrapper counts what its plain version counts (the wrapper takes
  the plain version on the CPU), and a count during which a kernel launched
  raises;
- the MINI predictor: FLOPs grow linearly in the tracked frames (8 frames
  ~2x 4, as the JAX test holds, and every tracked frame adds the same count:
  the memory bank has a fixed shape);
- the TINY (Hiera) and TINY_VIT (ViTDet) encoders against JAX's ``fn_flops``
  of ``forward_image``: the port's count plus each difference, computed from
  the shapes, equals JAX's exactly. The differences are JAX's TPU layouts:
  Hiera's 7x7/4 patch embed as an 8x8 space-to-depth footprint, windows of
  at most 64 keys packed G = 128 // keys to one attention under a
  block-diagonal bias (over a window count padded to a multiple of G), and
  the position-embedding resize as two interpolation matmuls where the port
  calls ``F.interpolate``.
"""

from __future__ import annotations

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_parity import MINI
from tests.test_train_step import TINY
from tests.test_train_step_vit import TINY_VIT
from tests.torch_port_helpers import mini_port_model, port_config
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu.utils.flops import fn_flops as jax_fn_flops
from us_video_medsam2_tpu_torch.core.weights import from_jax_params
from us_video_medsam2_tpu_torch.inference.video_predictor import SAM2VideoPredictor
from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from us_video_medsam2_tpu_torch.kernels.ln_mlp_residual import ln_mlp_residual, ln_mlp_residual_plain
from us_video_medsam2_tpu_torch.kernels.window_attention import window_attention, window_attention_plain
from us_video_medsam2_tpu_torch.models.hiera import MultiScaleAttention
from us_video_medsam2_tpu_torch.models.layers import NHWCConv
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.utils.flops import fn_flops


def test_dot_flops():
    a, b = torch.zeros(8, 32), torch.zeros(32, 16)
    assert fn_flops(lambda x, y: x @ y, a, b) == 2 * 8 * 16 * 32
    assert jax_fn_flops(lambda x, y: x @ y, jnp.zeros((8, 32)), jnp.zeros((32, 16))) == 2 * 8 * 16 * 32


def test_batched_dot_general_flops():
    want = 2 * (2 * 3 * 5 * 11) * 7
    got = fn_flops(lambda a, b: torch.einsum("bhqd,bhkd->bhqk", a, b), torch.zeros(2, 3, 5, 7),
                   torch.zeros(2, 3, 11, 7))
    jgot = jax_fn_flops(lambda a, b: jnp.einsum("bhqd,bhkd->bhqk", a, b), jnp.zeros((2, 3, 5, 7)),
                        jnp.zeros((2, 3, 11, 7)))
    assert got == jgot == want


@pytest.mark.parametrize("cin,cout,groups", [(3, 4, 1), (6, 6, 6)])
def test_conv_flops_incl_groups(cin, cout, groups):
    """The port's NHWC convolution against flax's nn.Conv, SAME 3x3 on 8x8;
    a depthwise convolution counts C_in / G = 1 per output."""
    want = 2 * (8 * 8 * cout) * (cin // groups) * 3 * 3
    conv = NHWCConv(cin, cout, 3, 1, 1, groups)
    assert fn_flops(conv, torch.zeros(1, 8, 8, cin)) == want
    jconv = nn.Conv(cout, (3, 3), padding="SAME", feature_group_count=groups)
    x = jnp.zeros((1, 8, 8, cin))
    assert jax_fn_flops(jconv.apply, jconv.init(jax.random.PRNGKey(0), x), x) == want


def test_a_kernel_wrapper_counts_its_plain_version():
    rng = np.random.default_rng(0)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    qkv = r(2, 16, 16, 3 * 2 * 64)
    assert fn_flops(window_attention, qkv, 8, 2, True) == fn_flops(window_attention_plain, qkv, 8, 2, True) > 0
    x, d, f = r(64, 96), 96, 384
    mlp = (x, 1 + r(d), r(d), r(f, d), r(f), r(d, f), r(d), 1e-6)
    assert fn_flops(ln_mlp_residual, *mlp) == fn_flops(ln_mlp_residual_plain, *mlp) == 2 * 2 * 64 * d * f
    q, k, v = r(1, 1, 32, 16), r(1, 1, 48, 16), r(1, 1, 48, 16)
    mask = torch.ones(1, 48, dtype=torch.bool)
    assert fn_flops(flash_attention, q, k, v, mask) == fn_flops(flash_attention_plain, q, k, v, mask) == \
        2 * 2 * 32 * 48 * 16


def test_a_count_during_which_a_kernel_launched_raises(monkeypatch):
    wrapper = next(iter(_lib.COUNTED.values()))
    monkeypatch.setattr(wrapper, "launches", wrapper.launches)

    def launches_once(x):
        wrapper.launches += 1  # what a wrapper does where it launches its kernel
        return x @ x

    with pytest.raises(RuntimeError, match="kernel launches during the FLOP count"):
        fn_flops(launches_once, torch.zeros(4, 4))


def test_propagation_scale_mini():
    """The MINI predictor's propagation (init_state and the prompt outside
    the count): 8 tracked frames ~2x 4 (the prompted frame is yielded
    without tracking, so these are videos of 9 and 5 frames), and each
    tracked frame adds the same FLOPs (the per-frame step has static shapes)."""
    pred = SAM2VideoPredictor(mini_port_model(), fill_hole_area=0, device="cpu")
    video = np.random.default_rng(0).standard_normal((9, MINI.image_size, MINI.image_size, 3)).astype(np.float32)

    def total(nf):
        state = pred.init_state(video[:nf], MINI.image_size, MINI.image_size, max_objects=1)
        pred.add_new_points_or_box(state, 0, 1, points=np.array([[30.0, 40.0]]), labels=np.array([1]))
        return fn_flops(lambda: list(pred.propagate_in_video(state)))

    f = {nf: total(nf) for nf in (2, 3, 5, 9)}
    assert f[5] > 0
    assert 1.7 < f[9] / f[5] < 2.3
    per_frame = f[3] - f[2]
    assert per_frame > 0 and f[5] - f[3] == 2 * per_frame and f[9] - f[5] == 4 * per_frame


@functools.lru_cache(maxsize=None)
def _encoders(name):
    """(JAX forward_image FLOPs, the port's, the port model, input) at 2 frames."""
    cfg = {"tiny": TINY, "tiny_vit": TINY_VIT}[name]
    model = JaxSAM2Model(cfg)
    s = cfg.image_size
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)))
    x = np.random.default_rng(0).standard_normal((2, s, s, 3)).astype(np.float32)
    want = jax_fn_flops(lambda p, a: model.apply(p, a, method=model.forward_image), params, jnp.asarray(x))
    port = SAM2Model(port_config(cfg))
    port.load_state_dict(from_jax_params(params), strict=True)
    port.set_compute_dtype(torch.float32, cast_weights=False)
    return int(want), port, torch.from_numpy(x)


def _attention_calls(port, x):
    """(B, H, W, window size, module) of every MultiScaleAttention call of the trunk."""
    calls = []
    hooks = [m.register_forward_pre_hook(lambda m, args, kw: calls.append((*args[0].shape[:3], kw.get(
        "window_size", args[1] if len(args) > 1 else 0), m)), with_kwargs=True)
        for m in port.modules() if isinstance(m, MultiScaleAttention)]
    try:
        with torch.no_grad():
            total = fn_flops(port.forward_image, x)
    finally:
        for h in hooks:
            h.remove()
    return total, calls


def packed_windows_extra(b, h, w, ws, attn) -> int:
    """FLOPs JAX's packed windows add to one windowed attention call: the
    port attends each (window, head) over its ws² keys, 2·lq·lk·hd for q·kᵀ
    and again for p·v; JAX packs G = 128 // lk of them into one attention
    over G·lk keys under a block-diagonal bias, after padding their count n
    to a multiple of G."""
    if ws == 0:
        return 0
    hs, wsp = -(-h // ws) * ws, -(-w // ws) * ws
    n = b * (hs // ws) * (wsp // ws) * attn.num_heads
    lk = ws * ws
    lq = (ws // 2) ** 2 if attn.q_pool else lk
    hd = attn.dim_out // attn.num_heads
    g = 128 // lk if lk <= 64 else 1
    padded = n + (-n) % g
    return 4 * lq * lk * hd * (padded * g - n)


def resize_matmuls(src_hw, dst_hw, c) -> int:
    """JAX's ``resize2d`` of a [1, h, w, C] table to (H, W): ``oh,...hwc``
    then ``ow,...hwc``; nothing when the sizes are equal."""
    (h, w), (oh, ow) = src_hw, dst_hw
    return 0 if (h, w) == (oh, ow) else 2 * oh * h * w * c + 2 * oh * ow * w * c


@pytest.mark.parametrize("name", ["tiny", "tiny_vit"])
def test_encoder_flops_match_jax_with_each_difference_computed(name):
    want, port, x = _encoders(name)
    got, calls = _attention_calls(port, x)
    trunk = port.image_encoder.trunk
    b = x.shape[0]
    windows = sum(packed_windows_extra(cb, ch, cw, ws, m) for cb, ch, cw, ws, m in calls)
    assert windows > 0
    if name == "tiny":
        conv = trunk.patch_embed
        k, s = conv.weight.shape[-1], conv.stride[0] if isinstance(conv.stride, tuple) else conv.stride
        cout, cin = conv.weight.shape[:2]
        positions = b * (x.shape[1] // s) * (x.shape[2] // s)
        s2d = 2 * positions * cout * cin * ((2 * s) ** 2 - k * k)  # the 8x8 footprint against the 7x7 kernel
        _, bh, bw, c = trunk.pos_embed.shape
        resize = resize_matmuls((bh, bw), (x.shape[1] // s, x.shape[2] // s), c)
    else:
        s2d = 0  # the 16x16/16 patch embed is one fold and one product on both sides
        grid = int(round((trunk.pos_embed.shape[1] - int(trunk.cfg.pretrain_use_cls_token)) ** 0.5))
        p = trunk.cfg.patch_size
        resize = resize_matmuls((grid, grid), (x.shape[1] // p, x.shape[2] // p), trunk.pos_embed.shape[-1])
    assert resize > 0
    assert got + s2d + windows + resize == want, (got, s2d, windows, resize, want)
