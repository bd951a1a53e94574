"""PyTorch port, the fused configuration: the JAX package's two opt-in kernel
switches (``US_MEDSAM2_ENABLE_FUSED_CXBLOCK``, ``US_MEDSAM2_FUSE_QKV_WINDOW_ATTN``)
set, through the whole slice on the CPU.

On the CPU the JAX package's switches select no Pallas kernel, so the JAX side
computes the same function as unset; the port's wrappers take their plain
versions, through the fused call sites. Tolerances are those of the unfused
tests they reuse: the predictor at MINI as ``test_predictor_matches_jax_predictor``
(tests/test_torch_predictor.py), one training step at TINY as
``test_train_step_loss_and_every_gradient_match_jax`` (tests/test_torch_training.py).
Each test also counts the fused call sites it went through.
"""

import pytest

from tests.test_torch_predictor import fx, predictor_matches_jax_predictor  # noqa: F401 (fixture)
from tests.test_torch_training import train_step_matches_jax
from us_video_medsam2_tpu_torch.models import hiera as hiera_mod
from us_video_medsam2_tpu_torch.models import memory as memory_mod

SWITCHES = ("US_MEDSAM2_ENABLE_FUSED_CXBLOCK", "US_MEDSAM2_FUSE_QKV_WINDOW_ATTN")


@pytest.fixture
def fused_calls(monkeypatch):
    """Both switches set; {call site: calls} of the two fused wrappers."""
    for k in SWITCHES:
        monkeypatch.setenv(k, "1")
    calls = {"cxblock": 0, "qkv_window_attention": 0}

    def spy(mod, name):
        fn = getattr(mod, name)

        def counted(*a):
            calls[name] += 1
            return fn(*a)

        monkeypatch.setattr(mod, name, counted)

    spy(memory_mod, "cxblock")
    spy(hiera_mod, "qkv_window_attention")
    return calls


def test_fused_predictor_matches_jax_predictor(fx, fused_calls):  # noqa: F811
    predictor_matches_jax_predictor(fx)
    # every encoded frame runs the windowed blocks, every memory encoding its CXBlocks
    assert fused_calls["cxblock"] > 0 and fused_calls["qkv_window_attention"] > 0


def test_fused_train_step_matches_jax(fused_calls):
    train_step_matches_jax("train_mask_prompt_no_dropout")
    assert fused_calls["cxblock"] > 0 and fused_calls["qkv_window_attention"] > 0
