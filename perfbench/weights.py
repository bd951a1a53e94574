"""Seeded weights, made on the device and handed alike to the port and the reference.

The rules are those of ``us_video_medsam2_tpu_torch/core/weights.py::init_random_``
at commit 40a6c6c (weight matrices N(0, 1/fan_in), biases N(0, 0.02²),
LayerNorm scales 1, learned tokens and Fourier features N(0, 1), other
embeddings N(0, 0.02²)), drawn from one ``torch.Generator`` on the device in
one call over every parameter. Three choices make random weights track an
object as trained weights do:

- the memory fuser's layer scales ``gamma`` are 0.1, not their initial 1e-6,
  at which the fuser's ConvNeXt blocks would return their input and no fault
  in them could show;
- the object-score head's output bias is +10, so every frame holds the object
  (else every mask is the empty -1024 and a comparison sees nothing);
- one IoU-head output gets +4 on its logit, so the multimask pick is one mask
  by a wide margin: with random weights the three IoU predictions can tie
  within bf16's resolution, and a tie decided by rounding swaps a whole mask.
"""

from __future__ import annotations

import torch

_CONV_TRANSPOSE = ("upscale_dc1", "upscale_dc2")
_UNIT_NORMAL = ("pe_gaussian", "point_embed", "no_mask_embed", "iou_token", "mask_tokens", "obj_score_token")
OBJ_SCORE_BIAS = ("sam_mask_decoder.obj_score_head.layers_2.bias", 10.0)
IOU_MARGIN = ("sam_mask_decoder.iou_head.layers_2.bias", 1, 4.0)
LAYER_SCALE = 0.1


def _scale(name: str, shape: torch.Size) -> tuple[float, float]:
    """(multiplier of a unit normal, constant) for the parameter ``name``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "gamma":
        return 0.0, LAYER_SCALE
    if leaf == "weight" and len(shape) >= 2:
        fan_in = shape[0] if name.rsplit(".", 2)[-2] in _CONV_TRANSPOSE else shape[1:].numel()
        return fan_in**-0.5, 0.0
    if leaf == "weight":
        return 0.0, 1.0
    if leaf in _UNIT_NORMAL:
        return 1.0, 0.0
    return 0.02, 0.0


@torch.no_grad()
def make_state_dict(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} for ``shapes`` ({name: shape})."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    total = sum(torch.Size(s).numel() for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = torch.Size(shape).numel()
        mul, const = _scale(name, torch.Size(shape))
        out[name] = flat[off: off + n].view(shape) * mul + const
        off += n
    if OBJ_SCORE_BIAS[0] in out:
        out[OBJ_SCORE_BIAS[0]].fill_(OBJ_SCORE_BIAS[1])
    name, index, margin = IOU_MARGIN
    if name in out:
        out[name][index] += margin
    return out



def model_shapes(model: torch.nn.Module) -> dict:
    """{name: shape} of a model's parameters (a model on the meta device will do)."""
    return {n: tuple(p.shape) for n, p in model.named_parameters()}
