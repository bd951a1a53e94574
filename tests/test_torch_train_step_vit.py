"""PyTorch port, the EfficientTAM (ViTDet trunk) training half against the
JAX package on the CPU: the counterpart of tests/test_train_step_vit.py at
its ``TINY_VIT`` config (windowed and global blocks, the patch-16 embed, no
high-res SAM features), weights from the JAX initialiser through
``from_jax_params``.

- One whole step (prompt simulation, tracking forward, multi-step loss,
  every gradient) against ``train_forward`` + ``multi_step_loss_stacked``
  under ``jax.value_and_grad``, in the two settings of
  tests/test_torch_training.py (eval mode with point prompts and centre
  clicks; training mode with mask prompts and no dropout), f32. Losses rel
  1e-4; every gradient rel-L2 1e-3 where the leaf's norm exceeds 1e-6, else
  abs 1e-6, but the ``sam_prompt_encoder.mask_down_*`` leaves, held at
  rel-L2 5e-3. The float64 evidence for that one wider bound: in the eval
  setting the correction clicks feed the previous step's mask logits through
  the prompt encoder's mask downsampler, whose first LayerNorm sees 4
  channels with mean² / var up to 829. Against the port's gradient computed
  wholly in float64, the port's f32 gradient of ``mask_down_ln1.bias`` is
  4.1e-5 away (rel-L2) and JAX's f32 one 8.15e-4; with that one LayerNorm
  of the JAX prompt encoder taking the centred variance (in place of its
  E[x²] - mean²), JAX's f32 gradients come within 2e-5 of float64 on every
  leaf, and with float32 aliased to float64 in both packages (T 2, one
  click) the two packages' worst leaf differs by 7.5e-6. So the port-vs-JAX
  gap at ``mask_down_*`` (8.4e-4 here, up to 1.9e-3 in another run of the
  same step) is JAX's f32 rounding at that LayerNorm, not a fault of the
  port; it also moves the mask decoder's leaves, which stay under 1e-3
  (6.5e-4). Why the port's own LayerNorm, also E[x²] - mean² in f32, stays
  near float64 there is not known.
- ``make_train_step`` on the CPU moves most parameters (JAX's test: > 90%).
- ``freeze_patterns=("*image_encoder*",)`` (EfficientTAMTrain's
  freeze_image_encoder) freezes exactly the leaves JAX's optimizer freezes,
  the layer-decay multipliers on the ViTDet names are JAX's leaf for leaf,
  and after a step the encoder is bit-identical while the rest moved.
- A ViT checkpoint written by the port reads in JAX (strict), one written
  by JAX reads in the port, both bit for bit.
- ``apps/train.py --cfg <TINY_VIT YAML> --init_ckpt <reference-name .pt>``
  trains, and its checkpoint loads strictly into JAX's model.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_trainer import corpus  # noqa: F401  (the fixture)
from tests.test_torch_training import LOSS, SETTINGS, _video
from tests.test_train_step_vit import TINY_VIT
from tests.torch_port_helpers import port_config, t
from us_video_medsam2_tpu.core import checkpoint as jckpt
from us_video_medsam2_tpu.core.build import load_params as jax_load_params
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu.training import losses as jlosses
from us_video_medsam2_tpu.training import optimizer as jopt
from us_video_medsam2_tpu.training import train_model as jtm
from us_video_medsam2_tpu_torch.core import checkpoint as pckpt
from us_video_medsam2_tpu_torch.core.build import load_params
from us_video_medsam2_tpu_torch.core.weights import from_jax_params, to_jax_params
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.training.losses import LossConfig, multi_step_loss_stacked
from us_video_medsam2_tpu_torch.training.optimizer import AdamW, OptimConfig
from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig, train_forward
from us_video_medsam2_tpu_torch.training.train_step import TrainBatch, TrainConfig, create_train_state, make_train_step

SIZE = TINY_VIT.image_size
MASK_DOWN = "sam_prompt_encoder.mask_down_"
MASK_DOWN_TOL = 5e-3


@functools.lru_cache(maxsize=None)
def _jax_setup():
    cfg = dataclasses.replace(TINY_VIT, memory_attention=dataclasses.replace(TINY_VIT.memory_attention, dropout=0.0))
    model = JaxSAM2Model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    return cfg, model, params


def _port_model(cfg, params) -> SAM2Model:
    model = SAM2Model(port_config(cfg))
    model.load_state_dict(from_jax_params(params), strict=True)
    return model.set_compute_dtype(torch.float32, cast_weights=False)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_vit_train_step_loss_and_every_gradient_match_jax(setting):
    is_training, sim_kw = SETTINGS[setting]
    cfg, jmodel, params = _jax_setup()
    images, masks = _video()
    obj_valid = np.ones((1, 2), bool)
    jsim, jloss_cfg = jtm.TrainSimConfig(**sim_kw), jlosses.LossConfig(**LOSS)

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
    got = multi_step_loss_stacked(LossConfig(**LOSS), stacked, t(obj_valid).reshape(-1),
                                  final_logits_by_frame=finals)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    got["core_loss"].backward()

    want_grads = from_jax_params(jgrads)
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    assert any(n.startswith("image_encoder.trunk.blocks_") for n in named)  # the ViTDet trunk is trained
    for name, p in named.items():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        wn = np.linalg.norm(w)
        if wn > 1e-6:
            rel = np.linalg.norm(g - w) / wn
            tol = MASK_DOWN_TOL if name.startswith(MASK_DOWN) else 1e-3
            assert rel <= tol, f"{name}: gradient rel-L2 {rel:.3e} (norm {wn:.3e})"
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)


def _step(freeze=()):
    cfg, _, params = _jax_setup()
    images, masks = _video()
    model = _port_model(cfg, params)
    tcfg = TrainConfig(sim=TrainSimConfig(num_correction_pt_per_frame=1), loss=LossConfig(**LOSS),
                       optim=OptimConfig(total_steps=10, freeze_patterns=freeze))
    state = create_train_state(model, tcfg, device="cpu", dtype=torch.float32)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = make_train_step(tcfg)(state, TrainBatch(t(images), t(masks), torch.ones(1, 2, dtype=torch.bool)), 3)
    assert np.isfinite(float(metrics["core_loss"])) and float(metrics["core_loss"]) > 0
    assert float(metrics["grad_norm"]) > 0
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
    return state, before, moved


def test_vit_make_train_step_moves_most_parameters():
    _, before, moved = _step()
    assert len(moved) > 0.9 * len(before), f"{len(moved)} of {len(before)} parameters moved"


def _jax_multipliers(params, optim) -> dict:
    """JAX's per-leaf lr multiplier as the port's parameter names: each leaf
    filled with its multiplier, through the port's weight map."""
    _, mults, _ = jopt.compute_param_meta(params, optim)
    filled = jax.tree.map(lambda p, m: np.full(p.shape, m, np.float32), params, mults)
    return {n: float(v.flatten()[0]) for n, v in from_jax_params(filled).items()}


@pytest.mark.parametrize("freeze", [(), ("*image_encoder*",)])
def test_vit_layer_decay_and_freeze_match_jax(freeze):
    _, _, params = _jax_setup()
    want = _jax_multipliers(params, jopt.OptimConfig(freeze_patterns=freeze))
    port = AdamW(from_jax_params(params), OptimConfig(freeze_patterns=freeze))
    got = {n: m.mult for n, m in port.meta.items()}
    assert sorted(got) == sorted(want)
    for n in got:
        assert got[n] == pytest.approx(want[n], rel=1e-6), n
    frozen = {n for n, m in got.items() if m == 0.0}
    assert frozen == {n for n, m in want.items() if m == 0.0}
    if freeze:
        assert frozen == {n for n in got if n.startswith("image_encoder.")}
    else:
        assert not frozen
        depth = TINY_VIT.vitdet.depth  # blocks_i decays by 0.9^(depth + 1 - (i + 1)); the embed by 0.9^(depth + 1)
        assert got["image_encoder.trunk.blocks_0.attn.qkv.weight"] == pytest.approx(0.9 ** depth)
        assert got["image_encoder.trunk.patch_embed.weight"] == pytest.approx(0.9 ** (depth + 1))
        assert got["image_encoder.trunk.pos_embed"] == 1.0


def test_vit_freeze_image_encoder_keeps_it_bit_identical():
    _, before, moved = _step(freeze=("*image_encoder*",))
    encoder = {n for n in before if n.startswith("image_encoder.")}
    assert encoder and not (moved & encoder)
    assert len(moved) > 0.5 * (len(before) - len(encoder))


def test_vit_checkpoint_round_trips_through_the_jax_layout(tmp_path):
    cfg, jmodel, params = _jax_setup()
    pcfg = port_config(cfg)
    sd = from_jax_params(params)
    # the port writes, JAX reads (strict)
    path = str(tmp_path / "port")
    pckpt.save_checkpoint(path, {"params": to_jax_params(sd, pcfg), "step": np.asarray(1, np.int32)})
    loaded = jax_load_params(jmodel, cfg, path + ".npz", strict=True)
    for (kp, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(loaded),
                               jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, params))):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(kp))
    # JAX writes, the port reads
    jpath = str(tmp_path / "jax")
    jckpt.save_checkpoint(jpath, {"params": params})
    back = load_params(pcfg, jpath + ".npz", strict=True)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_train_cli_trains_a_vit_config_from_a_reference_pt(corpus, tmp_path):  # noqa: F811
    import yaml

    import chip_smoke
    from us_video_medsam2_tpu_torch.apps import train

    cfg, jmodel, params = _jax_setup()
    pcfg = port_config(cfg)
    yaml_path = tmp_path / "tiny_vit.yaml"
    yaml_path.write_text(yaml.safe_dump({"model": dataclasses.asdict(pcfg)}))
    sd = from_jax_params(params)
    pt = tmp_path / "tiny_vit.pt"
    torch.save({"model": chip_smoke.to_reference_state_dict(sd, pcfg)}, pt)
    start = train.build_model(pcfg, str(pt)).state_dict()
    assert all(torch.equal(start[k], sd[k]) for k in sd)

    out = tmp_path / "run"
    tr = train.main(["--data_dir", corpus, "--out_dir", str(out), "--cfg", str(yaml_path), "--init_ckpt", str(pt),
                     "--resolution", str(SIZE), "--num_frames", "3", "--max_num_objects", "2", "--curriculum",
                     "none", "--epochs", "1", "--device", "cpu"])
    assert tr.epoch == 1 and tr.state.step == 3
    assert tr.state.model.cfg.vitdet is not None and tr.state.model.cfg.hiera is None
    trained = jax_load_params(jmodel, cfg, os.path.join(out, "checkpoint.npz"), strict=True)
    final = to_jax_params(tr.state.model.state_dict(), pcfg)
    for (kp, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(trained), jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, final["params"] if "params" in final else final))):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(kp))


def test_a_step_without_a_tracked_frame_gives_zero_gradients_as_jax():
    """T 2 with both frames mask-prompted conditioning frames: their outputs
    are the masks themselves, so no parameter reaches the loss, and JAX's
    ``value_and_grad`` gives 0 gradients (its AdamW still applies the weight
    decay). The port's step raised instead (a backward of a loss without a
    graph; ``apps/train.py --num_frames 2`` draws such a plan on a quarter
    of its steps). Now: JAX's outputs bit for bit, its losses, 0 gradients,
    and each parameter moved by its decoupled weight decay alone. The losses
    are held at abs 2e-5: at masks this near their targets the f32 dice sums
    4,096 sigmoids of ~1e-4 into a total near 700 (an ulp of 6e-5), so its
    value rounds by ~1e-5 with the order of the sum (JAX's own value moves
    by as much between a jit of the forward and one of ``value_and_grad``)."""
    cfg, jmodel, params = _jax_setup()
    images, masks = _video(frames=2)
    obj_valid = np.ones((1, 2), bool)
    sim_kw = dict(prob_to_use_pt_input=0.0, rand_init_cond_frames=False, num_init_cond_frames=2)
    stacked, finals = jax.jit(lambda p: jtm.train_forward(
        jmodel, p, jax.random.PRNGKey(1), jnp.asarray(images), jnp.asarray(masks), jtm.TrainSimConfig(**sim_kw),
        is_training=True, dropout_rng=jax.random.PRNGKey(2)))(params)
    want = jlosses.multi_step_loss_stacked(jlosses.LossConfig(**LOSS), stacked, jnp.asarray(obj_valid).reshape(-1),
                                           final_logits_by_frame=finals)

    model = _port_model(cfg, params)
    tcfg = TrainConfig(sim=TrainSimConfig(**sim_kw), loss=LossConfig(**LOSS), optim=OptimConfig(total_steps=10))
    state = create_train_state(model, tcfg, device="cpu", dtype=torch.float32)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    got, _, plan = train_forward(model, torch.Generator().manual_seed(0), t(images), t(masks), tcfg.sim, True)
    assert plan.is_init.tolist() == [True, True] and int(plan.mode) == 2
    for k, v in got.items():
        np.testing.assert_array_equal(v.detach().numpy(), np.asarray(stacked[k]), err_msg=k)
    metrics = make_train_step(tcfg)(state, TrainBatch(t(images), t(masks), t(obj_valid)), 0)
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=0, atol=2e-5, err_msg=k)
    assert float(metrics["grad_norm"]) == 0.0 and all(not g.any() for g in metrics["grads"].values())
    lr0, lr1 = state.optimizer.lr_at(0)
    for n, p in model.named_parameters():
        meta = state.optimizer.meta[n]
        lr = float(np.float32(lr1 if meta.group == 1 else lr0) * np.float32(meta.mult))
        want_p = before[n] - lr * (tcfg.optim.weight_decay * before[n]) if meta.wd_on else before[n]
        torch.testing.assert_close(p.detach(), want_p, rtol=0, atol=0, msg=n)


def test_a_loss_without_a_graph_still_raises_when_a_frame_is_tracked():
    """Every plan's loss has a graph now: positions 1..n_init_max-1 run the
    tracked branch under a selection, so the step has no special case for a
    plan whose every frame is a mask-prompted conditioning frame. A step
    whose graph is lost (here: run under ``torch.no_grad``) raises at its
    backward, on a plan with one conditioning frame of three and on one
    whose two frames are both conditioning frames, and no parameter moves;
    with its graph, the second gives zero gradients and moves each parameter
    by its decoupled weight decay alone."""
    cfg, _, params = _jax_setup()
    for frames, n_init in ((3, 1), (2, 2)):
        images, masks = _video(frames=frames)
        model = _port_model(cfg, params)
        tcfg = TrainConfig(sim=TrainSimConfig(prob_to_use_pt_input=0.0, rand_init_cond_frames=False,
                                              num_init_cond_frames=n_init), loss=LossConfig(**LOSS),
                           optim=OptimConfig(total_steps=10))
        state = create_train_state(model, tcfg, device="cpu", dtype=torch.float32)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        batch = TrainBatch(t(images), t(masks), torch.ones(1, 2, dtype=torch.bool))
        with torch.no_grad(), pytest.raises(RuntimeError, match="does not require grad"):
            make_train_step(tcfg)(state, batch, 0)
        assert state.step == 0 and all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    metrics = make_train_step(tcfg)(state, batch, 0)
    assert float(metrics["grad_norm"]) == 0.0 and all(not g.any() for g in metrics["grads"].values())
    lr0, lr1 = state.optimizer.lr_at(0)
    for n, p in model.named_parameters():
        meta = state.optimizer.meta[n]
        lr = float(np.float32(lr1 if meta.group == 1 else lr0) * np.float32(meta.mult))
        want_p = before[n] - lr * (tcfg.optim.weight_decay * before[n]) if meta.wd_on else before[n]
        torch.testing.assert_close(p.detach(), want_p, rtol=0, atol=0, msg=n)
