"""PyTorch port, training: one whole step (prompt simulation, tracking forward,
multi-step loss, every gradient) against the JAX package's ``train_forward``
+ ``multi_step_loss_stacked`` under ``jax.value_and_grad``, and one full
``make_train_step`` step on the CPU.

TINY config of tests/test_train_step.py with weights from the JAX
initialiser, mapped through ``from_jax_params`` (gradients too). Two
deterministic settings, so that both packages draw nothing at random:
(a) eval mode with point prompts and one corrected frame of centre clicks;
(b) training mode with mask prompts, one initial frame and memory-attention
dropout 0. Everything in f32 on the CPU. Tolerances: loss rel 1e-4; per
leaf rel-L2 1e-3 where the leaf's norm exceeds 1e-6, else abs 1e-6 — the same
math, reassociated, through a 3-frame video of mask decoders and memory
attention (the loss sums tens of thousands of terms).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_train_step import TINY
from tests.torch_port_helpers import port_config, t
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu.training import losses as jlosses
from us_video_medsam2_tpu.training import train_model as jtm
from us_video_medsam2_tpu_torch.core.weights import from_jax_params
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.training.losses import LossConfig, multi_step_loss_stacked
from us_video_medsam2_tpu_torch.training.optimizer import OptimConfig
from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig, train_forward
from us_video_medsam2_tpu_torch.training.train_step import (
    TrainBatch,
    TrainConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
)

SIZE = TINY.image_size
LOSS = dict(weight_temporal=0.5, temporal_variant="consistency")
SETTINGS = {
    "eval_points_center_clicks": (False, dict(prob_to_use_pt_input_for_eval=1.0, prob_to_use_box_input=0.0,
                                              num_correction_pt_per_frame=2)),
    "train_mask_prompt_no_dropout": (True, dict(prob_to_use_pt_input=0.0, rand_init_cond_frames=False,
                                                num_init_cond_frames=1, num_correction_pt_per_frame=2)),
}


def _video(frames=3, objects=2, seed=0):
    """[T, 1, S, S, 3] noise frames and [T, 1, O, S, S] boxes that drift."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((frames, 1, objects, SIZE, SIZE), bool)
    for f in range(frames):
        masks[f, :, 0, 20 + f: 45 + f, 15:40] = True
        masks[f, :, 1, 5:18, 38 + 2 * f: 60] = True
    return rng.standard_normal((frames, 1, SIZE, SIZE, 3)).astype(np.float32), masks


@functools.lru_cache(maxsize=None)
def _jax_setup():
    cfg = dataclasses.replace(TINY, memory_attention=dataclasses.replace(TINY.memory_attention, dropout=0.0))
    model = JaxSAM2Model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    return cfg, model, params


def _port_model(cfg, params) -> SAM2Model:
    model = SAM2Model(port_config(cfg))
    model.load_state_dict(from_jax_params(params), strict=True)
    return model.set_compute_dtype(torch.float32, cast_weights=False)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_train_step_loss_and_every_gradient_match_jax(setting):
    train_step_matches_jax(setting)


def train_step_matches_jax(setting):
    is_training, sim_kw = SETTINGS[setting]
    cfg, jmodel, params = _jax_setup()
    images, masks = _video()
    obj_valid = np.ones((1, 2), bool)

    jsim = jtm.TrainSimConfig(**sim_kw)
    jloss_cfg = jlosses.LossConfig(**LOSS)

    def loss_fn(p):
        stacked, finals = jtm.train_forward(jmodel, p, jax.random.PRNGKey(1), jnp.asarray(images),
                                            jnp.asarray(masks), jsim, is_training=is_training,
                                            dropout_rng=jax.random.PRNGKey(2) if is_training else None)
        out = jlosses.multi_step_loss_stacked(jloss_cfg, stacked, jnp.asarray(obj_valid).reshape(-1),
                                              final_logits_by_frame=finals)
        return out["core_loss"], out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = _port_model(cfg, params)
    stacked, finals, plan = train_forward(model, torch.Generator().manual_seed(0), t(images), t(masks),
                                          TrainSimConfig(**sim_kw), is_training)
    assert int(plan.n_init) == 1 and int(plan.mode) == (0 if not is_training else 2)
    assert plan.should_correct.tolist() == [not is_training, False, False]
    got = multi_step_loss_stacked(LossConfig(**LOSS), stacked, t(obj_valid).reshape(-1),
                                  final_logits_by_frame=finals)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    got["core_loss"].backward()

    want_grads = from_jax_params(jgrads)
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    for name, p in named.items():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        wn = np.linalg.norm(w)
        if wn > 1e-6:
            rel = np.linalg.norm(g - w) / wn
            assert rel <= 1e-3, f"{name}: gradient rel-L2 {rel:.3e} (norm {wn:.3e})"
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_make_train_step_updates_parameters_on_cpu(grad_dtype):
    cfg, _, params = _jax_setup()
    images, masks = _video()
    model = _port_model(cfg, params)
    tcfg = TrainConfig(sim=TrainSimConfig(num_correction_pt_per_frame=1), loss=LossConfig(**LOSS),
                       optim=OptimConfig(total_steps=10, grad_dtype=grad_dtype))
    state = create_train_state(model, tcfg, device="cpu", dtype=torch.float32)
    batch = TrainBatch(t(images), t(masks), torch.ones(1, 2, dtype=torch.bool))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = make_train_step(tcfg)(state, batch, 3)
    assert np.isfinite(float(metrics["core_loss"])) and float(metrics["grad_norm"]) > 0
    grads = list(metrics["grads"].values())
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    torch.testing.assert_close(metrics["grad_norm"], norm, rtol=1e-6, atol=0)
    if grad_dtype == "bfloat16":  # the optimizer and the norm see bf16-rounded gradients
        assert all(torch.equal(g, g.to(torch.bfloat16).float()) for g in grads)
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert len(moved) > 0.5 * len(before)
    assert state.step == 1 and state.optimizer.count == 1
    losses = make_eval_step(tcfg)(model, batch, 3)
    assert np.isfinite(float(losses["core_loss"]))


def test_train_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg, _, params = _jax_setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(_port_model(cfg, params), TrainConfig())


def test_position_tables_made_under_inference_mode_can_be_saved_for_backward():
    """The predictor makes the cached RoPE and sine tables under
    torch.inference_mode(); a training step in the same process saves them
    for backward (f32 on the CPU, where the dtype cast returns the table)."""
    from us_video_medsam2_tpu_torch.ops import posenc

    posenc._device_tables.clear()
    with torch.inference_mode():
        cos, sin = posenc.compute_axial_rope(16, 4, 4)
        pe = posenc.sine_pos_embed_2d(4, 4, 16)
    x = torch.randn(1, 1, 16, 16, requires_grad=True)
    (posenc.apply_rope_halfsplit(x, cos, sin) * pe.reshape(16, 16)).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
