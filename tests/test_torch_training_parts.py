"""PyTorch port, training pieces against the JAX package on the CPU: the
losses, the prompt samplers, the optimizer, and the gradients of the four
ported kernels' wrappers (their CPU path, autograd through the plain version)
against ``jax.grad`` of the JAX custom_vjp functions (forward in Pallas
interpret mode, backward the XLA recompute).

Tolerances, all f32: losses 1e-5 relative (same formulas, reassociated
sums); deterministic prompt functions exact (integer and min/max
arithmetic); random samplers in distribution (the two packages' generators
differ): a click lies in the error region its label names, box noise within
its bound; optimizer updates 1e-6 relative per leaf (the same f32 ops in the
same order); kernel gradients 1e-4 relative (the same math, reassociated).
``_lib.with_plain_grad``, which gives the kernels their gradient on the card,
is driven here with the plain version in the kernel's place: its output and
every gradient equal plain autograd exactly (the same ops on the same
inputs), and an argument that needs no gradient gets none.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_train_step import TINY
from tests.test_train_step_vit import TINY_VIT
from tests.torch_port_helpers import n, t
from us_video_medsam2_tpu.kernels import flash_attention as jfa
from us_video_medsam2_tpu.kernels import fused_ln, fused_mlp
from us_video_medsam2_tpu.kernels import fused_window_attention as jwin
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu.training import losses as jl
from us_video_medsam2_tpu.training import optimizer as jopt
from us_video_medsam2_tpu.training import prompt_sampling as jps
from us_video_medsam2_tpu_torch.core.weights import from_jax_params
from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels.cxblock import cxblock_plain
from us_video_medsam2_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from us_video_medsam2_tpu_torch.kernels.layer_norm import layer_norm, layer_norm_plain
from us_video_medsam2_tpu_torch.kernels.ln_mlp_residual import ln_mlp_residual, ln_mlp_residual_plain
from us_video_medsam2_tpu_torch.kernels.qkv_window_attention import qkv_window_attention_plain
from us_video_medsam2_tpu_torch.kernels.window_attention import window_attention, window_attention_plain
from us_video_medsam2_tpu_torch.training import losses as tl
from us_video_medsam2_tpu_torch.training import prompt_sampling as tps
from us_video_medsam2_tpu_torch.training.optimizer import AdamW, OptimConfig

LOSS_TOL = dict(rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------- losses
def _loss_inputs(nn=6, m=3, h=24, w=20, seed=0):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((nn, m, h, w))).astype(np.float32)
    target = rng.random((nn, 1, h, w)) > 0.6
    target[0] = False  # an object absent from its frame
    ious = rng.random((nn, m)).astype(np.float32)
    score = (2 * rng.standard_normal((nn, 1))).astype(np.float32)
    return logits, target, ious, score


def _close(got, want, **tol):
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **(tol or LOSS_TOL))


def test_mask_losses_match_jax():
    logits, target, ious, _ = _loss_inputs()
    tgt = np.broadcast_to(target, logits.shape).astype(np.float32)
    _close(tl.sigmoid_focal_loss(t(logits), t(tgt)), jl.sigmoid_focal_loss(logits, tgt))
    _close(tl.sigmoid_focal_loss(t(logits), t(tgt), -1.0, 0.0), jl.sigmoid_focal_loss(logits, tgt, -1.0, 0.0))
    _close(tl.dice_loss_multimask(t(logits), t(tgt)), jl.dice_loss_multimask(logits, tgt))
    for l1 in (True, False):
        _close(tl.iou_loss_multimask(t(logits), t(tgt), t(ious), l1),
               jl.iou_loss_multimask(logits, tgt, ious, l1))


@pytest.mark.parametrize("supervise_all_iou", [True, False])
@pytest.mark.parametrize("m", [1, 3])
def test_step_losses_match_jax(m, supervise_all_iou):
    logits, target, ious, score = _loss_inputs(m=m, seed=1)
    kw = dict(supervise_all_iou=supervise_all_iou)
    got = tl._step_losses(tl.LossConfig(**kw), t(logits), t(target), t(ious), t(score))
    want = jl._step_losses(jl.LossConfig(**kw), logits, target, ious, score)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("variant", ["consistency", "graph", "spectral"])
@pytest.mark.parametrize("frames", [1, 2, 4])
def test_temporal_losses_match_jax(variant, frames):
    logits = (3 * np.random.default_rng(2).standard_normal((frames, 16, 12))).astype(np.float32)
    _close(tl.TEMPORAL_LOSSES[variant](t(logits)), jl.TEMPORAL_LOSSES[variant](jnp.asarray(logits)))


def _stacked(frames=3, steps=2, bo=2, h=16, w=16, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "step0_multimasks": (3 * rng.standard_normal((frames, bo, 3, h, w))).astype(np.float32),
        "step0_ious": rng.random((frames, bo, 3)).astype(np.float32),
        "step0_score": rng.standard_normal((frames, bo, 1)).astype(np.float32),
        "corr_multimasks": (3 * rng.standard_normal((frames, steps, bo, 1, h, w))).astype(np.float32),
        "corr_ious": rng.random((frames, steps, bo, 1)).astype(np.float32),
        "corr_score": rng.standard_normal((frames, steps, bo, 1)).astype(np.float32),
        "corr_valid": np.array([[True, True], [False, False], [True, False]][:frames]),
        "target": rng.random((frames, bo, h, w)) > 0.5,
    }


@pytest.mark.parametrize("variant", ["consistency", "spectral"])
def test_multi_step_losses_match_jax(variant):
    st = _stacked()
    finals = (3 * np.random.default_rng(4).standard_normal((3, 2, 16, 16))).astype(np.float32)
    obj_valid = np.array([True, False])
    kw = dict(weight_temporal=0.5, temporal_variant=variant)
    want = jl.multi_step_loss_stacked(jl.LossConfig(**kw), {k: jnp.asarray(v) for k, v in st.items()},
                                      jnp.asarray(obj_valid), final_logits_by_frame=jnp.asarray(finals))
    got = tl.multi_step_loss_stacked(tl.LossConfig(**kw), {k: t(v) for k, v in st.items()}, t(obj_valid),
                                     final_logits_by_frame=t(finals))
    for k in want:
        _close(got[k], want[k])
    # the list form over the same steps gives the same losses
    frames, targets = [], []
    for f in range(3):
        steps = [{"multimasks": st["step0_multimasks"][f], "ious": st["step0_ious"][f],
                  "score": st["step0_score"][f], "valid": True}]
        steps += [{"multimasks": st["corr_multimasks"][f, s], "ious": st["corr_ious"][f, s],
                   "score": st["corr_score"][f, s], "valid": bool(st["corr_valid"][f, s])} for s in range(2)]
        frames.append(steps)
        targets.append(st["target"][f])
    jvalid, jfinals = jnp.asarray(obj_valid), jnp.asarray(finals)
    want_list = jl.multi_step_multimasks_and_ious(jl.LossConfig(**kw), frames, targets, jvalid,
                                                  final_logits_by_frame=jfinals)

    def as_torch(step):
        return {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in step.items()}

    tframes = [[as_torch(s) for s in f] for f in frames]
    got_list = tl.multi_step_multimasks_and_ious(tl.LossConfig(**kw), tframes, [t(x) for x in targets],
                                                 t(obj_valid), final_logits_by_frame=t(finals))
    for k in want_list:
        _close(got_list[k], want_list[k])


# -------------------------------------------------------------- prompt sampling
def _prompt_masks(seed=5, b=4, h=40, w=36):
    rng = np.random.default_rng(seed)
    gt = np.zeros((b, 1, h, w), bool)
    gt[0, 0, 5:20, 8:30] = True
    gt[1, 0, 10:12, 3:4] = True
    gt[3, 0] = rng.random((h, w)) > 0.7  # b=2 stays empty
    pred = np.zeros_like(gt)
    pred[0, 0, 8:25, 4:20] = True
    pred[2, 0, 30:38, 30:35] = True
    pred[3] = gt[3]  # all correct
    return gt, pred


def test_deterministic_prompt_functions_match_jax_exactly():
    gt, pred = _prompt_masks()
    np.testing.assert_array_equal(tps.mask_to_box(t(gt)).numpy(),
                                  np.asarray(jps.mask_to_box(jnp.asarray(gt))))
    dt_in = gt[:, 0] | pred[:, 0]
    np.testing.assert_array_equal(tps._distance_transform(t(dt_in), 16).numpy(),
                                  np.asarray(jps._distance_transform(jnp.asarray(dt_in), 16)))
    x = np.random.default_rng(6).random((3, 2, 9, 7)).astype(np.float32)
    x[0, 0, 4, 2] = x[0, 0, 1, 5] = 2.0  # a tie: the first in flat order wins
    for got, want in zip(tps._argmax2d(t(x)), jps._argmax2d(jnp.asarray(x))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for p in (None, pred):
        got = tps.sample_one_point_from_error_center(t(gt), None if p is None else t(p))
        want = jps.sample_one_point_from_error_center(jnp.asarray(gt), None if p is None else jnp.asarray(p))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        got = tps.get_next_point(t(gt), None if p is None else t(p), "center", None)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_random_clicks_lie_in_the_error_region_they_name():
    gt, pred = _prompt_masks()
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        pts, lbl = tps.get_next_point(t(gt), t(pred), "uniform", gen)
        x, y = pts[:, 0, 0].long().numpy(), pts[:, 0, 1].long().numpy()
        for i in range(gt.shape[0]):
            g, p = gt[i, 0, y[i], x[i]], pred[i, 0, y[i], x[i]]
            if i == 3:  # prediction all correct: a background click
                assert lbl[i, 0] == 0 and not g
            elif lbl[i, 0] == 1:
                assert g and not p, "a positive click must fall on a false negative"
            else:
                assert p and not g, "a negative click must fall on a false positive"


def test_box_noise_stays_within_its_bounds():
    gt, _ = _prompt_masks()
    h, w = gt.shape[-2:]
    box = tps.mask_to_box(t(gt))[:, 0]
    bound = torch.clamp(torch.stack([box[:, 2] - box[:, 0], box[:, 3] - box[:, 1]] * 2, -1) * 0.1, max=20.0)
    gen = torch.Generator().manual_seed(1)
    moved = False
    for _ in range(20):
        pts, lbl = tps.sample_box_points(t(gt), gen)
        got = pts.reshape(-1, 4)
        assert (lbl == torch.tensor([2, 3], dtype=torch.int32)).all()
        assert ((got - box).abs() <= bound + 1e-5).all()
        assert (got >= 0).all() and (got[:, 0::2] <= w - 1).all() and (got[:, 1::2] <= h - 1).all()
        moved |= bool((got - box).abs().max() > 0)
    assert moved


# ------------------------------------------------------------------- optimizer
@functools.lru_cache(maxsize=None)
def _tiny_params(config="tiny"):
    cfg = {"tiny": TINY, "tiny_vit": TINY_VIT}[config]
    return jax.jit(JaxSAM2Model(cfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, cfg.image_size,
                                                                            cfg.image_size, 3)))


@pytest.mark.parametrize("accum_steps,config", [(1, "tiny"), (2, "tiny"), (1, "tiny_vit")],
                         ids=["1", "2", "tiny_vit-1"])
def test_optimizer_updates_match_jax(accum_steps, config):
    """TINY (Hiera) with and without accumulation, and TINY_VIT: layer decay
    on the ViTDet trunk's names (blocks_i, patch_embed, pos_embed)."""
    params = _tiny_params(config)
    cfg = dict(total_steps=10, freeze_patterns=("*sam_prompt_encoder*",), accum_steps=accum_steps)
    tx = jopt.build_optimizer(params, jopt.OptimConfig(**cfg))
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(*tx.update(g, s, p)))
    port = {k: v.clone() for k, v in from_jax_params(params).items()}
    opt = AdamW(port, OptimConfig(**cfg))
    rng = np.random.default_rng(7)
    for step in range(2 * accum_steps):
        jgrads = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.01).astype(np.float32), params)
        params, state = update(jgrads, state, params)
        opt.step(from_jax_params(jgrads))
        want = from_jax_params(params)
        for name, p in port.items():
            w = want[name].numpy()
            d = np.linalg.norm(p.numpy() - w) / max(np.linalg.norm(w), 1e-30)
            assert d <= 1e-6, f"step {step} {name}: rel {d:.3e}"
    metas = opt.meta
    assert metas["sam_prompt_encoder.point_embed"].mult == 0.0
    blocks = 4 if config == "tiny" else TINY_VIT.vitdet.depth  # blocks_0 decays by 0.9^blocks
    assert metas["image_encoder.trunk.blocks_0.attn.qkv.weight"].mult == pytest.approx(0.9**blocks)
    assert metas["image_encoder.trunk.patch_embed.weight"].mult == pytest.approx(0.9**(blocks + 1))
    assert metas["image_encoder.trunk.pos_embed"].mult == 1.0
    assert not metas["image_encoder.trunk.blocks_0.norm1.weight"].wd_on
    assert metas["memory_attention.layers_0.linear1.weight"].wd_on


# ------------------------------------------------------------ kernel gradients
def _grads(f, args):
    args = [t(a).requires_grad_(True) for a in args]
    out = f(*args)
    g = torch.from_numpy(np.cos(np.arange(out.numel(), dtype=np.float32)).reshape(out.shape))
    (out * g).sum().backward()
    return [a.grad for a in args], g.numpy()


def _check_grads(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        rel = np.linalg.norm(n(a) - b) / np.linalg.norm(b)
        assert rel <= 1e-4, f"argument {i}: gradient rel {rel:.3e}"


@pytest.mark.parametrize("ws,nh,q_pool", [(4, 2, False), (4, 2, True)])
def test_window_attention_gradient_matches_jax(ws, nh, q_pool):
    qkv = np.random.default_rng(8).standard_normal((2, 8, 8, 3 * nh * 64)).astype(np.float32)
    got, g = _grads(lambda a: window_attention(a, ws, nh, q_pool), [qkv])
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda a: jnp.sum(jwin.fused_window_attention(a, ws, nh, 64, q_pool) * g))(
            jnp.asarray(qkv))
    _check_grads(got, [want])


def test_layer_norm_gradient_matches_jax():
    rng = np.random.default_rng(9)
    args = [rng.standard_normal((64, 96)) * 2 + 1, 1 + 0.1 * rng.standard_normal(96),
            0.1 * rng.standard_normal(96)]
    args = [a.astype(np.float32) for a in args]
    got, g = _grads(lambda x, w, b: layer_norm(x, w, b, 1e-6), args)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda *a: jnp.sum(fused_ln.layer_norm_pallas(*a, 1e-6) * g), argnums=(0, 1, 2))(
            *map(jnp.asarray, args))
    _check_grads(got, want)


def test_ln_mlp_residual_gradient_matches_jax():
    rng = np.random.default_rng(10)
    d, f = 96, 384
    args = [rng.standard_normal((64, d)), 1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
            rng.standard_normal((d, f)) / d**0.5, 0.1 * rng.standard_normal(f),
            rng.standard_normal((f, d)) / f**0.5, 0.1 * rng.standard_normal(d)]
    args = [a.astype(np.float32) for a in args]  # x, LN scale/bias, w1 [D, F], b1, w2 [F, D], b2 (JAX layout)

    def port(x, lw, lb, w1, b1, w2, b2):
        return ln_mlp_residual(x, lw, lb, w1.T, b1, w2.T, b2, 1e-6)

    got, g = _grads(port, args)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda *a: jnp.sum(fused_mlp.ln_mlp_residual(*a, 1e-6, "gelu", 64) * g),
                        argnums=tuple(range(7)))(*map(jnp.asarray, args))
    _check_grads(got, want)


def test_flash_attention_gradient_matches_jax():
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 1, lx, 128)).astype(np.float32) for lx in (128, 256, 256))
    mask = rng.random((2, 256)) > 0.3
    got, g = _grads(lambda a, b, c: flash_attention(a, b, c, t(mask)), [q, k, v])
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda *a: jnp.sum(jfa.flash_attention(*a, jnp.asarray(mask)) * g),
                        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _check_grads(got, want)


def _with_plain_grad_cases():
    rng = np.random.default_rng(12)

    def a(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(shape)).astype(np.float32))

    d, f = 32, 128
    ln = (a(40, d, scale=2, offset=1), a(d, scale=0.1, offset=1), a(d, scale=0.1), 1e-6)
    mlp = (a(40, d), a(d, scale=0.1, offset=1), a(d, scale=0.1), a(f, d, scale=d**-0.5), a(f, scale=0.1),
           a(d, f, scale=f**-0.5), a(d, scale=0.1), 1e-6)
    win = (a(2, 8, 8, 3 * 2 * 96), 4, 2, True)
    qkv = (a(2, 1, 16, 256), a(2, 1, 24, 256), a(2, 1, 24, 256))
    mask = torch.from_numpy(rng.random((2, 24)) > 0.3)
    c = 32
    cx = (a(2, 8, 8, c), a(c, 1, 7, 7, scale=0.1), a(c, scale=0.1), a(c, scale=0.1, offset=1), a(c, scale=0.1),
          a(4 * c, c, scale=c**-0.5), a(4 * c, scale=0.3), a(c, 4 * c, scale=(4 * c) ** -0.5), a(c, scale=0.1),
          a(c, scale=0.1, offset=1), 1e-6)
    qwin = (a(2, 8, 8, 48), a(3 * 2 * 96, 48, scale=48**-0.5), a(3 * 2 * 96, scale=0.5), 4, 2, True)
    return [
        ("layer_norm", layer_norm_plain, ln, (0, 1, 2)),
        ("layer_norm, weight only", layer_norm_plain, ln, (1,)),
        ("ln_mlp_residual", ln_mlp_residual_plain, mlp, tuple(range(7))),
        ("ln_mlp_residual, weights and bias 2", ln_mlp_residual_plain, mlp, (3, 5, 6)),
        ("window_attention", window_attention_plain, win, (0,)),
        ("window_attention, no pooling", window_attention_plain, (win[0], 4, 2, False), (0,)),
        ("flash_attention, key mask", flash_attention_plain, (*qkv, mask), (0, 1, 2)),
        ("flash_attention, no mask, k and v", flash_attention_plain, (*qkv, None), (1, 2)),
        ("cxblock", cxblock_plain, cx, tuple(range(10))),
        ("cxblock, pointwise weights and gamma", cxblock_plain, cx, (5, 7, 9)),
        ("qkv_window_attention", qkv_window_attention_plain, qwin, (0, 1, 2)),
        ("qkv_window_attention, weight only, no pooling", qkv_window_attention_plain, (*qwin[:5], False), (1,)),
    ]


@pytest.mark.parametrize("case", range(12))
def test_with_plain_grad_equals_plain_autograd(case):
    name, plain, args, wrt = _with_plain_grad_cases()[case]

    def run(f):
        leaves = [x.clone().requires_grad_(i in wrt) if torch.is_tensor(x) and x.is_floating_point() else x
                  for i, x in enumerate(args)]
        out = f(*leaves)
        g = torch.from_numpy(np.cos(np.arange(out.numel(), dtype=np.float32)).reshape(out.shape))
        out.backward(g)
        return out.detach(), [x.grad if torch.is_tensor(x) else None for x in leaves]

    got_out, got = run(lambda *a: _lib.with_plain_grad(plain, plain, *a))
    want_out, want = run(plain)
    assert torch.equal(got_out, want_out), name
    for i, (a, b) in enumerate(zip(got, want)):
        if i in wrt:
            assert a is not None and torch.equal(a, b), f"{name}: argument {i}"
        else:
            assert a is None and b is None, f"{name}: argument {i} got a gradient"
