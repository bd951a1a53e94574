"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same weights: the reference state dict fixture goes
through the JAX importer, and the JAX parameter tree through the port's
``from_jax_params``. Configs are converted field by field from the JAX
dataclasses, so a test names one config for both sides.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tests.conftest import require_fixture
from tests.test_parity import MINI
from us_video_medsam2_tpu_torch.core import config as port_config_mod
from us_video_medsam2_tpu_torch.core.weights import from_jax_params
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model as TorchSAM2Model

torch.set_num_threads(1)


def port_config(jcfg) -> port_config_mod.SAM2Config:
    """The port's SAM2Config with every field the port has taken from ``jcfg``."""

    def conv(cls, obj):
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):  # the port's dataclass of the same name
                v = conv(getattr(port_config_mod, type(v).__name__), v)
            kw[f.name] = v
        return cls(**kw)

    return conv(port_config_mod.SAM2Config, jcfg)


@functools.lru_cache(maxsize=1)
def mini_weights():
    """(JAX params, port state_dict) for the MINI config, from the reference fixture."""
    from us_video_medsam2_tpu.core.import_torch import convert_reference_state_dict

    sd = dict(np.load(require_fixture("mini_state_dict.npz")))
    params = convert_reference_state_dict(sd, MINI)
    return params, from_jax_params(params, port_config(MINI))


def mini_port_model() -> TorchSAM2Model:
    _, psd = mini_weights()
    model = TorchSAM2Model(port_config(MINI))
    model.load_state_dict(psd, strict=True)
    return model.eval()


def nchw_to_nhwc(x) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(x), (0, 2, 3, 1)))


def t(x) -> torch.Tensor:
    """numpy / JAX array -> torch tensor (CPU)."""
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    """torch tensor / JAX array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def mini_jax_predictor(**kwargs):
    """The JAX package's video predictor of the MINI model (fixture weights)."""
    from us_video_medsam2_tpu.inference.video_predictor import SAM2VideoPredictor
    from us_video_medsam2_tpu.models.sam2 import SAM2Model

    params, _ = mini_weights()
    return SAM2VideoPredictor(SAM2Model(MINI), params, **kwargs)


def mini_port_predictor(**kwargs):
    """The port's video predictor of the MINI model (the same weights) on the CPU."""
    from us_video_medsam2_tpu_torch.inference.video_predictor import SAM2VideoPredictor

    return SAM2VideoPredictor(mini_port_model(), device="cpu", **kwargs)


def iou(a, b) -> float:
    a, b = np.asarray(a) > 0, np.asarray(b) > 0
    union = (a | b).sum()
    return 1.0 if union == 0 else float((a & b).sum() / union)


def assert_masks_close(got: dict, want: dict, what: str = "") -> None:
    """The same frames, each [O, 1, H, W] within the JAX predictor tests' own
    tolerances (tests/test_video_predictor.py): logits rtol 1e-3 / atol 1e-3,
    every object's mask IoU > 0.999."""
    assert list(got) == list(want), (what, list(got), list(want))
    for t in want:
        a, b = np.asarray(got[t]), np.asarray(want[t])
        assert a.shape == b.shape, (what, t, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3, err_msg=f"{what} frame {t}")
        for o in range(b.shape[0]):
            assert iou(a[o], b[o]) > 0.999, (what, t, o)
