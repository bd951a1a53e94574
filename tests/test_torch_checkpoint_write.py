"""PyTorch port, checkpoints: the write half of ``core/checkpoint.py``, the
inverse weight map ``core/weights.py::to_jax_params`` and the optimizer's
JAX-layout state, against the JAX package.

- ``to_jax_params(from_jax_params(p)) == p`` bit for bit on the full-width
  trees of ``sam2.1_hiera_t512``, ``efficientmedsam_s_512`` and the GFTE
  config (``configs/gfte_tpu.yaml``: ``batch_stats`` included), made with
  ``jax.eval_shape`` and filled from a seed;
- a checkpoint the port writes is read by the JAX ``restore_checkpoint`` /
  ``restore_params`` and its ``load_params`` (strict) into equal arrays;
- a checkpoint the JAX ``Trainer.save_checkpoint`` writes at TINY resumes in
  the port's ``Trainer`` with equal parameters, moments, counts, epoch and
  best, and the port's trainer writes it back key for key;
- skip patterns, the format marker, ``get_resume_checkpoint``, the Orbax
  backend refused, ``load_state_dict_into_params``;
- a resume in the middle of gradient accumulation (``accum_steps`` 2).
Everything compared exactly: the maps are transposes and copies.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_train_step import TINY
from tests.torch_port_helpers import port_config
from us_video_medsam2_tpu.core import checkpoint as jckpt
from us_video_medsam2_tpu.core.build import load_params as jax_load_params
from us_video_medsam2_tpu.core.build import resolve_config as jax_resolve_config
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu_torch.core import checkpoint as pckpt
from us_video_medsam2_tpu_torch.core.weights import from_jax_params, to_jax_params
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.training.optimizer import AdamW, OptimConfig

SIZE = TINY.image_size


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_trees_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb), (sorted(set(fa) ^ set(fb))[:5])
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("name", ["sam2.1_hiera_t512", "efficientmedsam_s_512", "configs/gfte_tpu.yaml"])
def test_to_jax_params_inverts_from_jax_params_at_full_width(name):
    cfg = jax_resolve_config(name)
    shapes = jax.eval_shape(JaxSAM2Model(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, cfg.image_size, cfg.image_size, 3)))
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    pcfg = port_config(cfg)
    sd = from_jax_params(p, pcfg)
    back = to_jax_params(sd, pcfg)
    assert_trees_equal(back, jax.tree.map(np.asarray, p))
    assert ("batch_stats" in back) == (name.endswith(".yaml"))
    # and the other way round: the port's state_dict survives the trip
    again = from_jax_params(back, pcfg)
    assert sorted(again) == sorted(sd)
    assert all(torch.equal(again[k], sd[k]) for k in sd)


@pytest.fixture(scope="module")
def tiny():
    model = JaxSAM2Model(TINY)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    pmodel = SAM2Model(port_config(TINY))
    pmodel.load_state_dict(from_jax_params(params), strict=True)
    return model, params, pmodel


def filled_optimizer(pmodel, accum_steps=1, seed=1):
    opt = AdamW(dict(pmodel.named_parameters()), OptimConfig(accum_steps=accum_steps))
    g = torch.Generator().manual_seed(seed)
    for d in (opt.mu, opt.nu) + ((opt.acc,) if opt.acc is not None else ()):
        for t in d.values():
            t.copy_(torch.rand(t.shape, generator=g))
    opt.count, opt.mini_step = 7, 1 if accum_steps > 1 else 0
    return opt


def test_port_checkpoint_reads_in_jax(tiny, tmp_path):
    model, params, pmodel = tiny
    opt = filled_optimizer(pmodel)
    state = {"params": to_jax_params(pmodel.state_dict(), pmodel.cfg), "opt_state": opt.state_dict(pmodel.cfg),
             "step": np.asarray(7, np.int32), "epoch": np.asarray(3, np.int64), "best": np.asarray(0.25)}
    path = str(tmp_path / "checkpoint")
    pckpt.save_checkpoint(path, state)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint.meta.json", "checkpoint.npz"]  # no temporary left
    with open(tmp_path / "checkpoint.meta.json") as f:
        assert json.load(f) == {"_ckpt_format/version": 2, "_ckpt_format/rope_layout": "halfsplit"}
    restored = jckpt.restore_checkpoint(path)
    assert_trees_equal(restored, state)
    assert_trees_equal(jckpt.restore_params(path + ".npz"), jax.tree.map(np.asarray, params))
    loaded = jax_load_params(model, TINY, path + ".npz", strict=True)
    assert_trees_equal(loaded, jax.tree.map(np.asarray, params))
    # and the port's own reader and builder
    assert_trees_equal(pckpt.restore_checkpoint(path), state)


def test_optimizer_state_has_the_jax_layout(tiny):
    """The keys, shapes and dtypes of the JAX optimizer's state, with and
    without accumulation (optax.MultiSteps)."""
    from us_video_medsam2_tpu.training.train_step import TrainConfig as JTrainConfig
    from us_video_medsam2_tpu.training.train_step import create_train_state as jax_state
    from us_video_medsam2_tpu.training.optimizer import OptimConfig as JOptimConfig

    model, params, pmodel = tiny
    for accum in (1, 2):
        jst = jax_state(model, params, JTrainConfig(optim=JOptimConfig(accum_steps=accum)))
        from flax import serialization

        want = flat(serialization.to_state_dict(jax.tree.map(np.asarray, jst.opt_state)))
        got = flat(filled_optimizer(pmodel, accum).state_dict(pmodel.cfg))
        got = {k: v for k, v in got.items()}
        want_keys = {k for k in want}
        if accum > 1:  # the empty skip_state: {} here, an empty dict (no leaves) there too
            assert got.keys() == want_keys
        assert got.keys() == want_keys
        for k in want:
            assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def jax_trainer(tmp_path, monkeypatch, model, params, accum=1):
    from us_video_medsam2_tpu.parallel.mesh import create_mesh
    from us_video_medsam2_tpu.training import trainer as jtrainer_mod
    from us_video_medsam2_tpu.training.optimizer import OptimConfig as JOptimConfig
    from us_video_medsam2_tpu.training.train_model import TrainSimConfig as JSim
    from us_video_medsam2_tpu.training.train_step import TrainConfig as JTrainConfig

    monkeypatch.setattr(jtrainer_mod, "create_mesh", lambda axes: create_mesh(axes, devices=jax.devices()[:1]))
    return jtrainer_mod.Trainer(
        model, jax.tree.map(jnp.array, params),
        JTrainConfig(sim=JSim(num_correction_pt_per_frame=1), optim=JOptimConfig(total_steps=4, accum_steps=accum)),
        jtrainer_mod.TrainerConfig(max_epochs=5, save_dir=str(tmp_path), save_freq=0), None)


def port_trainer(tmp_path, pmodel, accum=1):
    from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig
    from us_video_medsam2_tpu_torch.training.train_step import TrainConfig
    from us_video_medsam2_tpu_torch.training.trainer import Trainer, TrainerConfig

    cfg = TrainConfig(sim=TrainSimConfig(num_correction_pt_per_frame=1),
                      optim=OptimConfig(total_steps=4, accum_steps=accum))
    return Trainer(pmodel, cfg, TrainerConfig(max_epochs=5, save_dir=str(tmp_path), save_freq=0), None,
                   device="cpu", dtype=torch.float32)


def test_jax_trainer_checkpoint_resumes_in_the_port(tiny, tmp_path, monkeypatch):
    model, params, _ = tiny
    jt = jax_trainer(tmp_path / "jax", monkeypatch, model, params)
    rng = np.random.default_rng(3)
    jt.state = jt.state._replace(
        params=jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), jt.state.params),
        opt_state=jax.tree.map(lambda x: jnp.asarray(rng.random(x.shape) * 2, x.dtype) if x.dtype == jnp.float32
                               else jnp.asarray(5, x.dtype), jt.state.opt_state),
        step=jnp.asarray(5, jnp.int32))
    jt.epoch, jt.best = 2, 0.75
    jt.save_checkpoint()
    written = jckpt.restore_checkpoint(str(tmp_path / "jax" / "checkpoint.npz"))

    pmodel = SAM2Model(port_config(TINY))
    pt = port_trainer(tmp_path / "jax", pmodel)
    assert (pt.epoch, pt.best, pt.state.step, pt.state.optimizer.count) == (2, 0.75, 5, 5)
    want = from_jax_params(written["params"])
    for n, p in pt.model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    mu = from_jax_params(written["opt_state"]["adam"]["mu"])
    nu = from_jax_params(written["opt_state"]["adam"]["nu"])
    for n in mu:
        assert torch.equal(pt.state.optimizer.mu[n], mu[n]) and torch.equal(pt.state.optimizer.nu[n], nu[n]), n
    # the port writes the same tree back, key for key and bit for bit
    assert_trees_equal(pt.checkpoint_state(), written)


def test_port_checkpoint_resumes_in_the_jax_trainer(tiny, tmp_path, monkeypatch):
    model, params, pmodel0 = tiny
    pmodel = SAM2Model(port_config(TINY))
    pmodel.load_state_dict(pmodel0.state_dict())
    pt = port_trainer(tmp_path, pmodel)
    opt = filled_optimizer(pt.model)
    pt.state.optimizer = opt
    pt.state.step, pt.epoch, pt.best = 7, 3, 0.5
    pt.save_checkpoint()
    assert pt.save_times and pt.save_times[0] > 0
    jt = jax_trainer(tmp_path, monkeypatch, model, params)
    assert (jt.epoch, jt.best, int(jt.state.step)) == (3, 0.5, 7)
    from flax import serialization

    got = {"params": jt.state.params, "opt_state": serialization.to_state_dict(jt.state.opt_state)}
    assert_trees_equal(jax.tree.map(np.asarray, got),
                       {"params": to_jax_params(pt.model.state_dict(), pt.model_cfg),
                        "opt_state": opt.state_dict(pt.model_cfg)})


def test_skip_patterns_marker_and_resume_lookup(tmp_path):
    state = {"params": {"a": {"kernel": np.ones((2, 3), np.float32)}, "b": {"bias": np.zeros(3, np.float32)}},
             "step": np.asarray(1, np.int32), "note": "x", "lr": 0.5}
    pckpt.save_checkpoint(str(tmp_path / "c.npz"), state, skip_patterns=["params/b/*"])
    back = jckpt.restore_checkpoint(str(tmp_path / "c"))
    assert sorted(flat(back)) == ["lr", "note", "params/a/kernel", "step"]
    assert back["note"] == "x" and back["lr"] == 0.5
    assert jckpt.read_checkpoint_format(str(tmp_path / "c.npz")) == {"version": 2, "rope_layout": "halfsplit"}
    assert pckpt.exclude_params_matching_unix_pattern(["params/b/*"], state)["params"].keys() == {"a"}
    assert flat(pckpt.filter_params_matching_unix_pattern(["params/*"], state)).keys() == {"params/a/kernel",
                                                                                           "params/b/bias"}
    assert pckpt.get_resume_checkpoint(str(tmp_path)) is None
    pckpt.save_checkpoint(str(tmp_path / "checkpoint"), state)
    assert pckpt.get_resume_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint.npz")
    (tmp_path / "checkpoint").mkdir()
    with pytest.raises(NotImplementedError, match="Orbax"):
        pckpt.get_resume_checkpoint(str(tmp_path))
    with pytest.raises(NotImplementedError, match="Orbax"):
        pckpt.save_checkpoint_any(str(tmp_path / "o"), state, backend="orbax")


def test_rope_projections_are_marked_and_guarded(tmp_path):
    key = "params/memory_attention/layers_0/self_attn/q_proj/kernel"
    tree = {"params": {"memory_attention": {"layers_0": {"self_attn": {"q_proj": {"kernel": np.eye(4, dtype=np.float32)}}}}}}
    pckpt.save_checkpoint(str(tmp_path / "ok"), tree)
    assert flat(jckpt.restore_checkpoint(str(tmp_path / "ok")))[key].shape == (4, 4)
    np.savez(tmp_path / "old.npz", **{key: np.eye(4, dtype=np.float32)})  # written without the marker
    with pytest.raises(RuntimeError, match="half-split"):
        pckpt.restore_checkpoint(str(tmp_path / "old"))


def test_load_state_dict_into_params_matches_jax():
    params = {"a": {"kernel": np.ones((2, 2), np.float32), "bias": np.zeros(2, np.float32)}, "c": np.zeros(3)}
    loaded = {"a": {"kernel": np.full((2, 2), 3.0, np.float32)}, "x": np.ones(1)}
    kw = dict(strict=False, ignore_missing_keys=["c"], ignore_unexpected_keys=["x"])
    assert_trees_equal(pckpt.load_state_dict_into_params(params, loaded, **kw),
                       jckpt.load_state_dict_into_params(params, loaded, **kw))
    for mod in (pckpt, jckpt):
        with pytest.raises((RuntimeError, AssertionError)):
            mod.load_state_dict_into_params(params, loaded, strict=True)
    with pytest.raises(ValueError):
        pckpt.load_state_dict_into_params(params, {"a": {"kernel": np.ones(3)}}, strict=False)


def test_resume_in_the_middle_of_accumulation(tiny):
    """accum_steps 2: one micro-step, the state through state_dict /
    load_state_dict into a fresh optimizer, then the second micro-step on
    both: the same parameters and moments, bit for bit."""
    _, _, pmodel0 = tiny

    def model():
        m = SAM2Model(port_config(TINY))
        m.load_state_dict(pmodel0.state_dict())
        return m

    ma, mb = model(), model()
    cfg = OptimConfig(accum_steps=2, total_steps=10)
    a = AdamW(dict(ma.named_parameters()), cfg)
    g = torch.Generator().manual_seed(0)
    grads = [{n: torch.randn(p.shape, generator=g) for n, p in ma.named_parameters()} for _ in range(4)]
    a.step(grads[0])
    assert a.mini_step == 1 and a.count == 0
    b = AdamW(dict(mb.named_parameters()), cfg)
    b.load_state_dict(a.state_dict(ma.cfg))
    assert b.mini_step == 1 and all(torch.equal(b.acc[n], a.acc[n]) for n in a.acc)
    for gr in grads[1:]:
        a.step(gr)
        b.step(gr)
    assert a.count == b.count == 2
    for (n, p), q in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(p, q), n
    for n in a.mu:
        assert torch.equal(a.mu[n], b.mu[n]) and torch.equal(a.nu[n], b.nu[n])
    with pytest.raises(ValueError, match="accumulation"):
        AdamW(dict(mb.named_parameters()), OptimConfig()).load_state_dict(a.state_dict(ma.cfg))
