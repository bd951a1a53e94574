"""PyTorch port, the training step with temporal fusion wired in: the TINY
step of tests/test_torch_training.py with ``TemporalFusionConfig(variant,
32, 3)`` against the JAX package's ``train_forward`` +
``multi_step_loss_stacked`` under ``jax.value_and_grad``, and one full
``make_train_step`` step on the CPU (the counterpart of
tests/test_temporal_fusion.py::test_gfte_wired_train_step).

Weights from the JAX initialiser with the BatchNorm running statistics,
through ``from_jax_params`` (variables and gradients). GFTE's attention
dropout is set to 0 on both sides (``functools.partial`` in each package's
``VARIANTS``; the module tests hold its keep mask), so that neither draws.
Everything in f32. Tolerances as tests/test_torch_training.py: loss rel
1e-4; per leaf rel-L2 1e-3 where the leaf's norm exceeds 1e-6, else abs
1e-6. A leaf that misses that bound must be one whose f32 gradient is
rounding noise in the port itself: more than 1e-2 from the port's f64
gradient (rel-L2), with JAX's f32 gradient no farther from the f64 one than
4x the port's. At B 1 these are the SE gates' leaves and the BatchNorm bias
ahead of them on the coarsest level, since the gate reads the per-channel
mean of a batch-normalised tensor, which is that BatchNorm's bias whatever
the input, and the leaves whose exact gradient is 0.

The B 2 case holds the frame layout as the JAX package has it: the step
flattens the frames T-major ([T·B]) and the fusion modules view them
B-major (``reshape(bt // T, T, ...)``), so at B >= 2 they mix frames of
both videos, on both sides alike.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_training import LOSS, SETTINGS, SIZE, TINY
from tests.torch_port_helpers import port_config, t
from us_video_medsam2_tpu.core.config import TemporalFusionConfig as JaxFusionConfig
from us_video_medsam2_tpu.models import temporal_fusion as jtf
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu.training import losses as jlosses
from us_video_medsam2_tpu.training import train_model as jtm
from us_video_medsam2_tpu_torch.core.weights import from_jax_params
from us_video_medsam2_tpu_torch.models import temporal_fusion as ttf
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.training.losses import LossConfig, multi_step_loss_stacked
from us_video_medsam2_tpu_torch.training.optimizer import OptimConfig
from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig, train_forward
from us_video_medsam2_tpu_torch.training.train_step import TrainBatch, TrainConfig, create_train_state, make_train_step

C = 32


@pytest.fixture(autouse=True)
def _no_gfte_dropout(monkeypatch):
    monkeypatch.setitem(jtf.VARIANTS, "gfte", functools.partial(jtf.GFTE, dropout=0.0))
    monkeypatch.setitem(ttf.VARIANTS, "gfte", functools.partial(ttf.GFTE, dropout=0.0))


def _video(frames=3, batch=1, objects=2, seed=0):
    """[T, B, S, S, 3] noise frames and [T, B, O, S, S] boxes that drift, a
    different drift in each video."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((frames, batch, objects, SIZE, SIZE), bool)
    for f in range(frames):
        for b in range(batch):
            masks[f, b, 0, 20 + f + 3 * b: 45 + f, 15:40 - 2 * b] = True
            masks[f, b, 1, 5 + b:18, 38 + 2 * f: 60] = True
    return rng.standard_normal((frames, batch, SIZE, SIZE, 3)).astype(np.float32), masks


@functools.lru_cache(maxsize=None)
def _jax_setup(variant):
    cfg = dataclasses.replace(TINY, memory_attention=dataclasses.replace(TINY.memory_attention, dropout=0.0),
                              temporal_fusion=JaxFusionConfig(variant=variant, channels=C, num_levels=3))
    model = JaxSAM2Model(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    # running statistics other than the init's zeros and ones, so that eval
    # mode reads something and "unchanged" means something
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var" else
                         rng.normal(0, 0.1, a.shape)).astype(np.float32), variables["batch_stats"])
    return cfg, model, {"params": variables["params"], "batch_stats": stats}


def _port_model(cfg, variables) -> SAM2Model:
    model = SAM2Model(port_config(cfg))
    model.load_state_dict(from_jax_params(variables), strict=True)
    return model.set_compute_dtype(torch.float32, cast_weights=False)


CASES = {"gfte_train": ("gfte", "train_mask_prompt_no_dropout", 1),
         "gfte_eval": ("gfte", "eval_points_center_clicks", 1),
         "tce_train": ("tce", "train_mask_prompt_no_dropout", 1),
         "gfte_train_b2": ("gfte", "train_mask_prompt_no_dropout", 2)}


@pytest.mark.parametrize("case", list(CASES))
def test_fusion_train_step_loss_and_every_gradient_match_jax(case):
    variant, setting, batch = CASES[case]
    is_training, sim_kw = SETTINGS[setting]
    cfg, jmodel, variables = _jax_setup(variant)
    images, masks = _video(batch=batch)
    obj_valid = np.ones((batch, 2), bool)

    jsim = jtm.TrainSimConfig(**sim_kw)
    jloss_cfg = jlosses.LossConfig(**LOSS)

    def loss_fn(p):
        stacked, finals = jtm.train_forward(jmodel, p, jax.random.PRNGKey(1), jnp.asarray(images),
                                            jnp.asarray(masks), jsim, is_training=is_training,
                                            dropout_rng=jax.random.PRNGKey(2) if is_training else None)
        out = jlosses.multi_step_loss_stacked(jloss_cfg, stacked, jnp.asarray(obj_valid).reshape(-1),
                                              final_logits_by_frame=finals)
        return out["core_loss"], out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)

    model = _port_model(cfg, variables)
    stacked, finals, plan = train_forward(model, torch.Generator().manual_seed(0), t(images), t(masks),
                                          TrainSimConfig(**sim_kw), is_training)
    assert int(plan.n_init) == 1
    got = multi_step_loss_stacked(LossConfig(**LOSS), stacked, t(obj_valid).reshape(-1),
                                  final_logits_by_frame=finals)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    got["core_loss"].backward()
    ref64 = _port_grads_f64(cfg, variables, images, masks, obj_valid, sim_kw, is_training)

    want_grads = from_jax_params({"params": jgrads["params"]})
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    fusion = [k for k in named if k.startswith("temporal_fusion_")]
    assert {k.split(".")[0] for k in fusion} == {f"temporal_fusion_{i}" for i in range(3)}
    noisy, moved = [], 0.0
    for name, p in named.items():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        wn = np.linalg.norm(w)
        ok = np.linalg.norm(g - w) <= 1e-3 * wn if wn > 1e-6 else np.abs(g - w).max(initial=0.0) <= 1e-6
        if not ok:
            r = ref64[name]
            own = np.linalg.norm(g - r)
            assert own > 1e-2 * np.linalg.norm(r), f"{name}: rel-L2 {np.linalg.norm(g - w) / wn:.3e}"
            assert np.linalg.norm(w - r) <= 4 * own, name
            noisy.append(name)
        if name in fusion:
            moved = max(moved, float(np.abs(g).max(initial=0.0)))
    assert moved > 0.0  # gradients reach the fusion
    assert len(noisy) <= 12, noisy


def _port_grads_f64(cfg, variables, images, masks, obj_valid, sim_kw, is_training) -> dict:
    """The port's gradients of the same step in f64 (a reference for how far
    f32 rounding moves each leaf)."""
    model = _port_model(cfg, variables).double().set_compute_dtype(torch.float64, cast_weights=False)
    stacked, finals, _ = train_forward(model, torch.Generator().manual_seed(0), t(images).double(), t(masks),
                                       TrainSimConfig(**sim_kw), is_training)
    multi_step_loss_stacked(LossConfig(**LOSS), stacked, t(obj_valid).reshape(-1),
                            final_logits_by_frame=finals)["core_loss"].backward()
    return {n: np.zeros(p.shape) if p.grad is None else p.grad.numpy() for n, p in model.named_parameters()}


def test_fusion_changes_the_step_and_b2_mixes_videos_as_jax():
    """The fusion is on the path: the GFTE step's loss differs from the same
    weights' step without it; at B 2 the fused features of video 0 depend on
    video 1's frames (the B-major view of T-major frames), as in JAX."""
    cfg, jmodel, variables = _jax_setup("gfte")
    model = _port_model(cfg, variables)
    images, _ = _video(batch=2)
    x = t(images).reshape(-1, SIZE, SIZE, 3)
    with torch.no_grad():
        base = model.forward_image(x, deterministic=False, num_frames=3)["backbone_fpn"][-1]
        y = x.clone()
        y[1::2] += 1.0  # video 1's frames only (T-major: rows 1, 3, 5)
        moved = model.forward_image(y, deterministic=False, num_frames=3)["backbone_fpn"][-1]
    jbase = jmodel.apply(variables, jnp.asarray(x.numpy()), False, 3, method=jmodel.forward_image)["backbone_fpn"][-1]
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase), rtol=1e-4, atol=1e-4)
    assert not torch.allclose(moved[0], base[0])  # row 0 is video 0's frame 0
    no_fusion = SAM2Model(dataclasses.replace(port_config(cfg), temporal_fusion=port_config(TINY).temporal_fusion))
    no_fusion.load_state_dict({k: v for k, v in model.state_dict().items() if not k.startswith("temporal_fusion_")})
    with torch.no_grad():
        plain = no_fusion.forward_image(x, deterministic=False, num_frames=3)["backbone_fpn"][-1]
        served = model.forward_image(x, deterministic=False)["backbone_fpn"][-1]  # no num_frames: serving
    assert not torch.allclose(plain, base) and torch.equal(served, plain)


def test_make_train_step_moves_fusion_parameters_and_keeps_the_buffers():
    cfg, _, variables = _jax_setup("gfte")
    images, masks = _video()
    model = _port_model(cfg, variables)
    tcfg = TrainConfig(sim=TrainSimConfig(num_correction_pt_per_frame=1), loss=LossConfig(**LOSS),
                       optim=OptimConfig(total_steps=10))
    state = create_train_state(model, tcfg, device="cpu", dtype=torch.float32)
    assert not any(n.startswith("temporal_fusion_") and n.endswith((".mean", ".var"))
                   for n in state.optimizer.params)
    batch = TrainBatch(t(images), t(masks), torch.ones(1, 2, dtype=torch.bool))
    params0 = {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith("temporal_fusion_")}
    bufs0 = {n: b.clone() for n, b in model.named_buffers()}
    assert len(bufs0) == 3 * 4 and all(n.startswith("temporal_fusion_") for n in bufs0)
    metrics = make_train_step(tcfg)(state, batch, 3)
    assert np.isfinite(float(metrics["core_loss"])) and float(metrics["grad_norm"]) > 0
    named = dict(model.named_parameters())
    assert max(float((named[n] - p).abs().max()) for n, p in params0.items()) > 0.0
    for n, b in model.named_buffers():
        assert torch.equal(b, bufs0[n]), n
