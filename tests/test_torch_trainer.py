"""PyTorch port, the training loop and its launcher: ``training/trainer.py``
and ``apps/train.py`` against the JAX package's.

- one epoch of 3 steps of the port's ``Trainer`` against the JAX ``Trainer``
  at TINY (the JAX mesh patched to one device, as
  tests/test_trainer_resilience.py does), each on its own loader over the
  same NPZ corpus with the JAX globals seeded as the port's epoch
  generators are: a deterministic simulation with no dropout (the settings
  of tests/test_torch_training.py: mask prompts, one initial frame,
  memory-attention dropout 0) and the transforms without the affine, in
  f32. Each step's ``core_loss`` within 1e-4 relative (the one-step
  test's tolerance: a wrong update shows in the next step's loss); the
  parameters after the epoch within rel-L2 1e-3 of JAX's (measured
  4.6e-6), and their change over the epoch within rel-L2 2e-2 of JAX's
  change (measured 6.6e-3: AdamW's first steps move an element by about
  lr · sign(g), so an element whose gradient is rounding noise near 0 can
  move the other way; the gradients themselves agree at rel-L2 1e-3,
  tests/test_torch_training.py);
- the stats files hold the JAX keys;
- a pre-emption signal gives a checkpoint and exit 0, then the run
  resumes; the NaN guard raises;
- the launcher end to end: tests/test_torch_train_app.py.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_train_step import TINY
from tests.torch_port_helpers import port_config
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu_torch.core.weights import from_jax_params, to_jax_params
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model

SIM = dict(prob_to_use_pt_input=0.0, rand_init_cond_frames=False, num_init_cond_frames=1,
           num_correction_pt_per_frame=2)
LOSS = dict(weight_temporal=0.5, temporal_variant="consistency")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 NPZ videos of 6 frames, 72x80, two moving objects each."""
    root = tmp_path_factory.mktemp("train_npz")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:72, 0:80]
    for v in range(3):
        imgs = np.zeros((6, 72, 80), np.uint8)
        gts = np.zeros((6, 72, 80), np.uint8)
        for f in range(6):
            imgs[f] = (40 + 60 * np.sin(xx / (5 + v)) * np.cos(yy / 7) + rng.integers(0, 30, (72, 80))).clip(0, 255)
            gts[f][(yy - 25 - f) ** 2 + (xx - 30 - v * 3) ** 2 < 150] = 1
            gts[f][(yy - 50) ** 2 / 60 + (xx - 55 + f) ** 2 / 150 < 1] = 2
            imgs[f][gts[f] == 1] = 200
            imgs[f][gts[f] == 2] = 140
        np.savez_compressed(root / f"v{v}.npz", imgs=imgs, gts=gts)
    return str(root)


def no_affine(mod, res):
    return mod.ComposeAPI([t for t in mod.default_train_transforms(res).transforms
                           if not isinstance(t, mod.RandomAffine)])


@pytest.fixture(scope="module")
def jax_setup():
    cfg = dataclasses.replace(TINY, memory_attention=dataclasses.replace(TINY.memory_attention, dropout=0.0))
    model = JaxSAM2Model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, cfg.image_size, cfg.image_size, 3)))
    return cfg, model, params


def make_loader(mod, corpus, seed=3):
    ds = mod.VOSDataset(mod.NPZRawDataset(corpus), mod.RandomUniformSampler(3, 2), no_affine(mod, TINY.image_size),
                        max_num_objects=2)
    return mod.TrainMixedVideoLoader([ds], [1], max_num_objects=2, seed=seed)


def port_trainer(cfg, params, corpus, save_dir, **kw):
    from us_video_medsam2_tpu_torch.training import data
    from us_video_medsam2_tpu_torch.training.losses import LossConfig
    from us_video_medsam2_tpu_torch.training.optimizer import OptimConfig
    from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig
    from us_video_medsam2_tpu_torch.training.train_step import TrainConfig
    from us_video_medsam2_tpu_torch.training.trainer import Trainer, TrainerConfig

    model = SAM2Model(port_config(cfg))
    model.load_state_dict(from_jax_params(params), strict=True)
    tcfg = TrainConfig(sim=TrainSimConfig(**SIM), loss=LossConfig(**LOSS), optim=OptimConfig(total_steps=6))
    return Trainer(model, tcfg, TrainerConfig(save_dir=str(save_dir), **kw), make_loader(data, corpus),
                   device="cpu", dtype=torch.float32)


@pytest.fixture
def no_tensorboard(monkeypatch):
    from us_video_medsam2_tpu_torch.training import trainer

    monkeypatch.setattr(trainer.Trainer, "_make_tb_writer", lambda self: None)


def record_losses(trainer, to_float):
    losses = []
    step = trainer.step_fn

    def recorded(*a):
        out = step(*a)
        m = out[-1] if isinstance(out, tuple) else out
        losses.append(to_float(m["core_loss"]))
        return out

    trainer.step_fn = recorded
    return losses


def test_trainer_epoch_matches_jax(jax_setup, corpus, tmp_path, monkeypatch, no_tensorboard):
    from us_video_medsam2_tpu.parallel.mesh import create_mesh
    from us_video_medsam2_tpu.training import data as jdata
    from us_video_medsam2_tpu.training import losses as jlosses
    from us_video_medsam2_tpu.training import trainer as jtrainer
    from us_video_medsam2_tpu.training.optimizer import OptimConfig as JOptim
    from us_video_medsam2_tpu.training.train_model import TrainSimConfig as JSim
    from us_video_medsam2_tpu.training.train_step import TrainConfig as JTrainConfig

    cfg, jmodel, params = jax_setup
    monkeypatch.setattr(jtrainer, "create_mesh", lambda axes: create_mesh(axes, devices=jax.devices()[:1]))
    monkeypatch.setattr(jtrainer.Trainer, "_make_tb_writer", lambda self: None)
    jt = jtrainer.Trainer(jmodel, jax.tree.map(jnp.array, params),
                          JTrainConfig(sim=JSim(**SIM), loss=jlosses.LossConfig(**LOSS), optim=JOptim(total_steps=6)),
                          jtrainer.TrainerConfig(max_epochs=1, save_dir=str(tmp_path / "jax")),
                          make_loader(jdata, corpus))
    pt = port_trainer(cfg, params, corpus, tmp_path / "port", max_epochs=1)
    jl, pl = record_losses(jt, float), record_losses(pt, float)
    seed = pt.train_loader.epoch_seed(0)
    random.seed(seed)
    np.random.seed(seed % 2**32)
    jt.run()
    pt.run()
    assert len(pl) == len(jl) == 3
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    after = to_jax_params(pt.model.state_dict(), pt.model_cfg)
    flat = {}

    def walk(a, b, c, path=""):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], c[k], f"{path}/{k}")
            else:
                flat[f"{path}/{k}"] = (np.asarray(a[k]), np.asarray(b[k]), np.asarray(c[k]))

    walk(params, after, jax.tree.map(np.asarray, jt.state.params))
    def rel(keep, of_change):
        a = np.concatenate([(port - (p0 if of_change else 0)).ravel() for k, (p0, port, _) in flat.items() if keep(k)])
        b = np.concatenate([(jax_ - (p0 if of_change else 0)).ravel() for k, (p0, _, jax_) in flat.items() if keep(k)])
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(lambda k: True, False) <= 1e-3  # the parameters (measured 4.6e-6)
    assert rel(lambda k: True, True) <= 2e-2  # their change over the epoch (measured 6.6e-3)
    # the stats files hold the JAX keys
    for name in ("train_stats.json", "best_stats.json"):
        with open(tmp_path / "jax" / name) as f:
            want = [json.loads(line) for line in f]
        with open(tmp_path / "port" / name) as f:
            got = [json.loads(line) for line in f]
        assert [sorted(r) for r in got] == [sorted(r) for r in want]
        assert [r["steps"] for r in got] == [r["steps"] for r in want] == [3]
        assert math.isclose(got[0]["Losses/train_all_loss"], want[0]["Losses/train_all_loss"], rel_tol=1e-4)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_preemption_checkpoints_exits_and_resumes(jax_setup, corpus, tmp_path, no_tensorboard):
    cfg, _, params = jax_setup
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    try:
        pt = port_trainer(cfg, params, corpus, tmp_path, max_epochs=3, save_freq=0)
        assert signal.getsignal(signal.SIGTERM) == pt._on_preempt_signal  # installed: the test runs on the main thread
        signal.raise_signal(signal.SIGTERM)
        assert pt._preempted
        with pytest.raises(SystemExit) as e:
            pt.run()
        assert e.value.code == 0
        assert (tmp_path / "checkpoint.npz").exists() and pt.state.step == 1
        again = port_trainer(cfg, params, corpus, tmp_path, max_epochs=1, save_freq=0)
        assert (again.epoch, again.state.step, again.state.optimizer.count) == (0, 1, 1)
        for (n, p), q in zip(pt.model.named_parameters(), again.model.parameters()):
            assert torch.equal(p, q), n
        again.run()
        assert again.epoch == 1 and again.state.step == 4
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def test_nan_guard(jax_setup, corpus, tmp_path, no_tensorboard):
    cfg, _, params = jax_setup
    pt = port_trainer(cfg, params, corpus, tmp_path, max_epochs=1)
    pt.step_fn = lambda state, batch, gen: {"core_loss": torch.tensor(float("nan"))}
    with pytest.raises(FloatingPointError, match="nan"):
        pt.run()


def test_orbax_backend_refused(jax_setup, corpus, tmp_path, no_tensorboard):
    cfg, _, params = jax_setup
    with pytest.raises(NotImplementedError, match="Orbax"):
        port_trainer(cfg, params, corpus, tmp_path, checkpoint_backend="orbax")
