"""PyTorch port, the training step's rematerialisation (the JAX step's
``jax.checkpoint`` over each frame body and each correction click with
``_remat_policy``): the step with it against the step without it, bit for
bit (loss, every gradient, the updated weights, both generators after the
step), for the TINY Hiera config, ``TINY_VIT`` and TINY with GFTE, with
memory-attention dropout 0.1 and point prompts, so that the step's
generator (the click's uniforms, the dropout-flash seeds) and the default
one (the residual dropouts) both draw inside the bodies; the dropout-flash
forward operator once an attention call; a bank written in place under the
checkpoint giving other gradients (why ``with_memory`` carries it out of
place); the policy refusing a draw in place; no checkpoint without
gradients; the click's uniforms drawn ahead. Weights made from a seed, f32
on the CPU. (The JAX parity of the same steps: tests/test_torch_training.py,
test_torch_train_plans.py, test_torch_train_fusion.py,
test_torch_train_step_vit.py.)
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_train_step import TINY
from tests.test_train_step_vit import TINY_VIT
from tests.torch_port_helpers import port_config
from us_video_medsam2_tpu_torch.core.config import TemporalFusionConfig
from us_video_medsam2_tpu_torch.core.weights import init_random_
from us_video_medsam2_tpu_torch.kernels.flash_dropout import FLASH_RESID
from us_video_medsam2_tpu_torch.models.memory_bank import init_memory_bank, with_memory, write_memory
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.training import prompt_sampling as pps
from us_video_medsam2_tpu_torch.training import train_model as ptm
from us_video_medsam2_tpu_torch.training.losses import LossConfig
from us_video_medsam2_tpu_torch.training.optimizer import OptimConfig
from us_video_medsam2_tpu_torch.training.train_step import TrainBatch, TrainConfig, create_train_state, make_train_step

FRAMES, OBJECTS, SEED = 3, 2, 5
# point prompts, one initial frame and every frame corrected: positions 1.. track
# through the bank, every frame is a conditioning memory, and every click is kept
SIM = ptm.TrainSimConfig(prob_to_use_pt_input=1.0, prob_to_use_box_input=0.0, num_init_cond_frames=1,
                         rand_init_cond_frames=False, num_frames_to_correct=FRAMES, rand_frames_to_correct=False,
                         num_correction_pt_per_frame=2)
TCFG = TrainConfig(sim=SIM, loss=LossConfig(weight_temporal=0.5, temporal_variant="consistency"),
                   optim=OptimConfig(total_steps=10))


def _config(case: str):
    cfg = port_config(TINY_VIT if case == "vit" else TINY)
    cfg = dataclasses.replace(cfg, memory_attention=dataclasses.replace(cfg.memory_attention, dropout=0.1))
    if case == "gfte":
        cfg = dataclasses.replace(cfg, temporal_fusion=TemporalFusionConfig("gfte", 32, 3))
    return cfg


CASES = ("hiera", "vit", "gfte")


def _batch(size: int) -> TrainBatch:
    rng = np.random.default_rng(0)
    masks = np.zeros((FRAMES, 1, OBJECTS, size, size), bool)
    for f in range(FRAMES):
        masks[f, :, 0, 20 + f: 45 + f, 15:40] = True
        masks[f, :, 1, 5:18, 38 + 2 * f: 60] = True
    images = rng.standard_normal((FRAMES, 1, size, size, 3)).astype(np.float32)
    return TrainBatch(torch.from_numpy(images), torch.from_numpy(masks), torch.ones(1, OBJECTS, dtype=torch.bool))


def _step(case: str, remat: bool) -> dict:
    """One eager step of ``case`` from seeded weights: its loss, gradients,
    updated weights, plan, and both generators' states after it."""
    cfg = _config(case)
    model = init_random_(SAM2Model(cfg), 0)
    with torch.no_grad():  # objects present, so every frame's memory is written and read
        model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
    state = create_train_state(model, TCFG, device="cpu", dtype=torch.float32)
    step = make_train_step(TCFG)
    m = step.eager(state, _batch(cfg.image_size), SEED, remat=remat)
    return {"loss": m["core_loss"].detach().clone(), "grads": {n: g.clone() for n, g in m["grads"].items()},
            "weights": {n: p.detach().clone() for n, p in state.model.named_parameters()}, "plan": m["plan"],
            "gen": step.captured.generator(torch.device("cpu")).get_state(), "default": torch.get_rng_state()}


def _differing(a: dict, b: dict) -> list:
    return [n for n in a if not torch.equal(a[n], b[n])]


@pytest.mark.parametrize("case", CASES)
def test_remat_step_keeps_the_bits_of_the_step_without_it(case):
    plain, remat = _step(case, False), _step(case, True)
    plan = plain["plan"]
    assert int(plan.mode) == 0 and int(plan.n_init) == 1 and bool(plan.should_correct.all())
    assert torch.equal(plain["loss"], remat["loss"])
    assert _differing(plain["grads"], remat["grads"]) == []
    assert _differing(plain["weights"], remat["weights"]) == []
    # the recompute drew nothing: both generators stand where the forward left them
    assert torch.equal(plain["gen"], remat["gen"]) and torch.equal(plain["default"], remat["default"])
    attn = [n for n in plain["grads"] if n.startswith("memory_attention.") and "cross_attn" in n]
    assert attn and all(float(plain["grads"][n].abs().sum()) > 0 for n in attn)


def test_a_bank_written_in_place_under_remat_changes_the_gradients(monkeypatch):
    """The in-place write the predictor uses, as the training forward's bank
    write: without remat the same bits (the old carry), under remat the
    recompute of frame 1 reads a bank that it and frame 2 have written since,
    selects them as conditioning memories, and gives other gradients with no
    error."""
    ref = _step("hiera", False)

    def in_place(bank, frame_idx, maskmem, obj_ptr, is_cond):
        return write_memory(bank, frame_idx, maskmem, obj_ptr, is_cond)

    monkeypatch.setattr(ptm, "with_memory", in_place)
    carried = _step("hiera", False)
    bad = _step("hiera", True)
    assert torch.equal(carried["loss"], ref["loss"]) and _differing(carried["grads"], ref["grads"]) == []
    assert torch.equal(bad["loss"], ref["loss"])  # the forward is the same
    assert _differing(bad["grads"], ref["grads"]) != []


class _CountOp(TorchDispatchMode):
    """Executions of one operator (SAC's recompute takes a saved output
    without running it)."""

    def __init__(self, op):
        super().__init__()
        self.op, self.n = op, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is self.op
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", [False, True])
def test_dropout_flash_forward_runs_once_an_attention_call(remat):
    """Through the whole step, backward included: 2 attention calls (self,
    cross) a memory-attention layer at each tracked position."""
    with _CountOp(FLASH_RESID) as count:
        _step("hiera", remat)
    assert count.n == 2 * TINY.memory_attention.num_layers * (FRAMES - 1)


def test_policy_refuses_a_draw_in_place():
    x = torch.randn(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="writes in place"):
        ptm._checkpointed(lambda y: torch.nn.functional.dropout(y, 0.5, True).sum(), x,
                          context_fn=ptm._remat_contexts)


def test_no_checkpoint_without_gradients(monkeypatch):
    """The eval step (no gradients) runs the bodies as they are."""
    def refuse(*a, **k):
        raise AssertionError("checkpoint called without gradients")

    monkeypatch.setattr(ptm, "checkpoint", refuse)
    cfg = _config("hiera")
    model = init_random_(SAM2Model(cfg), 0).train()
    b = _batch(cfg.image_size)
    with torch.no_grad():
        stacked, finals, _ = ptm.train_forward(model, torch.Generator().manual_seed(1), b.images, b.masks, SIM)
    assert torch.isfinite(finals).all()


def test_with_memory_is_write_memory_out_of_place():
    rng = np.random.default_rng(0)
    bank = init_memory_bank(3, 5, 4, 6, 7)
    bank.maskmem.copy_(torch.from_numpy(rng.standard_normal(bank.maskmem.shape).astype(np.float32)))
    before = [x.clone() for x in (bank.maskmem, bank.obj_ptr, bank.valid, bank.is_cond)]
    mm, ptr = torch.randn(3, 4, 6), torch.randn(3, 7)
    for t, cond in ((2, True), (0, False)):
        got = with_memory(bank, torch.tensor(t), mm, ptr, torch.tensor(cond))
        want = write_memory(init_memory_bank(3, 5, 4, 6, 7), t, mm, ptr, cond)
        want.maskmem.copy_(before[0])
        want.maskmem[:, t] = mm
        for g, w in zip((got.maskmem, got.obj_ptr, got.valid, got.is_cond),
                        (want.maskmem, want.obj_ptr, want.valid, want.is_cond)):
            assert torch.equal(g, w)
    for x, y in zip((bank.maskmem, bank.obj_ptr, bank.valid, bank.is_cond), before):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shard", [None, (2, 6)])
def test_click_uniforms_drawn_ahead_give_the_same_click(shard):
    rng = np.random.default_rng(1)
    gt = torch.from_numpy(rng.random((3, 1, 16, 20)) > 0.6)
    pred = torch.from_numpy(rng.random((3, 1, 16, 20)) > 0.5)
    a = pps.get_next_point(gt, pred, "uniform", torch.Generator().manual_seed(4), shard)
    gen = torch.Generator().manual_seed(4)
    b = pps.get_next_point(gt, pred, "uniform", None, shard, noise=pps.point_noise(gt, "uniform", gen, shard))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert pps.point_noise(gt, "center", gen) is None
