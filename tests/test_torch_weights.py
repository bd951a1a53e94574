"""PyTorch port: configs, the JAX -> port weight bridge, and package isolation.

``from_jax_params`` must cover every parameter of the JAX model (no missing
or extra keys, right shapes) at MINI and at the full sam2.1_hiera_t512 width,
map each layout correctly (checked module by module against flax), and the
port must import neither JAX nor the JAX package.
"""

import ast
import pathlib
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_parity import MINI
from tests.torch_port_helpers import mini_weights, n, port_config, t
from us_video_medsam2_tpu.core.config import PRESETS as JAX_PRESETS
from us_video_medsam2_tpu.models import layers as jlayers
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu_torch.core.config import PRESETS
from us_video_medsam2_tpu_torch.core.weights import from_jax_params
from us_video_medsam2_tpu_torch.models import layers as tlayers
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "us_video_medsam2_tpu_torch"


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_port_presets_match_jax(name):
    assert PRESETS[name]() == port_config(JAX_PRESETS[name]())


def _load_strict(cfg, sd):
    model = SAM2Model(cfg)
    ref = model.state_dict()
    assert sorted(sd) == sorted(ref), (
        f"missing {sorted(set(ref) - set(sd))[:5]}, extra {sorted(set(sd) - set(ref))[:5]}"
    )
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(v.shape), (k, sd[k].shape, v.shape)
    model.load_state_dict(sd, strict=True)
    return model


def test_from_jax_params_covers_every_parameter_mini():
    params, psd = mini_weights()
    _load_strict(port_config(MINI), psd)
    assert len(psd) == len(jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("name", ["sam2.1_hiera_t512", "tiny64_test"])
def test_from_jax_params_covers_every_parameter_preset(name):
    jcfg = JAX_PRESETS[name]()
    s = jcfg.image_size
    shapes = jax.eval_shape(
        lambda: JaxSAM2Model(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)))
    )
    params = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    sd = from_jax_params(params, port_config(jcfg))
    _load_strict(port_config(jcfg), sd)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))


class _Mods(fnn.Module):
    @fnn.compact
    def __call__(self, x, x1):
        return {
            "dense": fnn.Dense(5, name="dense")(x),
            "conv": jlayers.Conv2d(6, 3, padding=1, name="conv")(x),
            "conv_s2": jlayers.Conv2d(6, 3, stride=2, padding=1, name="conv_s2")(x),
            "dw": jlayers.Conv2d(4, 7, padding=3, groups=4, name="dw")(x),
            "upscale_dc1": jlayers.ConvTranspose2x(3, name="upscale_dc1")(x),
            "ln": jlayers.LayerNorm(eps=1e-6, name="ln")(x),
            "conv_1ch": jlayers.Conv2d(4, 3, stride=2, padding=1, name="conv_1ch")(x1),
        }


def test_layer_layouts_match_flax():
    """Each layout rule of from_jax_params on the module it serves."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    x1 = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    m = _Mods()
    params = m.init(jax.random.PRNGKey(0), x, x1)
    params = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    want = m.apply(params, x, x1)
    sd = from_jax_params(params)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dense = tlayers.Linear(4, 5)
            self.conv = tlayers.Conv2d(4, 6, 3, padding=1)
            self.conv_s2 = tlayers.Conv2d(4, 6, 3, stride=2, padding=1)
            self.dw = tlayers.Conv2d(4, 4, 7, padding=3, groups=4)
            self.upscale_dc1 = tlayers.ConvTranspose2x(4, 3)
            self.ln = tlayers.LayerNorm(4, eps=1e-6)
            self.conv_1ch = tlayers.Conv2d(1, 4, 3, stride=2, padding=1)

    p = Port()
    p.load_state_dict(sd, strict=True)
    with torch.no_grad():
        for name, mod in p.named_children():
            got = mod(t(x1) if name == "conv_1ch" else t(x))
            np.testing.assert_allclose(n(got), np.asarray(want[name]), rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def test_importing_the_port_leaves_jax_out():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'us_video_medsam2_tpu'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_jax_imports_in_port_sources():
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for nm in names:
                root = nm.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "us_video_medsam2_tpu"), (path, nm)


TRAINING_ENTRY_MODULES = ["training/data.py", "training/trainer.py", "training/native_npz.py", "apps/train.py",
                          "parallel/distributed.py", "core/checkpoint.py", "core/weights.py"]


@pytest.mark.parametrize("rel", TRAINING_ENTRY_MODULES)
def test_training_entry_modules_leave_jax_out(rel):
    """The training entry point's modules, function-level imports included:
    no import of JAX or the JAX package in the source, and none in
    sys.modules after importing the module and calling in the launcher's
    lazy imports."""
    path = PORT / rel
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
            assert not any(nm.split(".")[0] in ("jax", "jaxlib", "flax", "us_video_medsam2_tpu") for nm in names)
    mod = ".".join(path.relative_to(REPO).with_suffix("").parts)
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({mod!r})\n"
        "from us_video_medsam2_tpu_torch.apps import train\n"
        "train.make_loader\n"
        "import us_video_medsam2_tpu_torch.training.trainer, us_video_medsam2_tpu_torch.parallel.distributed\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'us_video_medsam2_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # the C++ reader's copy sits under the port, outside csrc/ (the kernels' hash)
    assert (PORT / "native" / "npz_reader.cpp").exists() and not list((PORT / "csrc").glob("*.cpp"))


def test_predictor_without_device_raises_without_cuda(monkeypatch):
    from us_video_medsam2_tpu_torch.core.build import build_sam2
    from us_video_medsam2_tpu_torch.inference.video_predictor import (
        SAM2VideoPredictor,
        build_sam2_video_predictor,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_sam2("tiny64_test")
    with pytest.raises(RuntimeError, match="CUDA"):
        SAM2VideoPredictor(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_sam2_video_predictor("tiny64_test")
    SAM2VideoPredictor(model, device="cpu")
