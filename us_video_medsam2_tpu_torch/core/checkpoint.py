"""Native checkpoints of the JAX package, read without JAX.

The read half of the JAX package's ``core/checkpoint.py``: a ``.npz`` of
'/'-joined parameter paths with its ``.meta.json`` (scalars and the format
marker), as ``save_checkpoint`` writes it, back to the nested tree
(``restore_checkpoint``, ``restore_params``), in numpy and json only. The
restored parameter tree goes through ``core/weights.py::from_jax_params``.

The format marker guards the RoPE layout (``docs/PARITY.md`` #13): the
memory attention's q/k projections are stored permuted into the half-split
layout, and a checkpoint written before that change holds torch's
interleaved layout, which would load without error and attend wrongly. An
unmarked checkpoint with RoPE projections raises; one declared interleaved
is migrated. Saving, Orbax and resumption are not ported here.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

import numpy as np

from us_video_medsam2_tpu_torch.ops.posenc import rope_halfsplit_perm

_EMPTY = "__empty_dict__"  # marks an empty subtree in the flat layout
CKPT_FORMAT_VERSION = 2
CKPT_ROPE_LAYOUT = "halfsplit"
_FORMAT_PREFIX = "_ckpt_format/"


def _is_rope_proj(key: str) -> bool:
    """A '/'-joined path of a RoPE-rotated q/k projection: the memory
    attention's self and cross attention only (the mask decoder's
    ``self_attn`` has no RoPE)."""
    return ("memory_attention/" in key and ("/self_attn/" in key or "/cross_attn_image/" in key)
            and key.endswith(("q_proj/kernel", "q_proj/bias", "k_proj/kernel", "k_proj/bias")))


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        if not tree and prefix:
            out["/".join(prefix + (_EMPTY,))] = np.zeros((0,), np.int8)
            return out
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out["/".join(prefix)] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict:
    tree: Dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] != _EMPTY:
            node[parts[-1]] = val
    return tree


def migrate_rope_layout(params: Dict, num_heads: int) -> Dict:
    """An interleaved-layout tree's RoPE q/k projections permuted into the
    half-split layout (the importer's transform)."""
    out = {}
    for k, v in _flatten(params).items():
        if _is_rope_proj(k):
            v = np.asarray(v)
            v = v[..., rope_halfsplit_perm(v.shape[-1], num_heads)]
        out[k] = v
    return _unflatten(out)


def _check_rope_layout(flat: Dict[str, Any], fmt: Dict[str, Any], path: str,
                       assume_rope_layout: Optional[str], rope_num_heads: Optional[int]) -> Dict[str, Any]:
    rope_keys = [k for k in flat if _is_rope_proj(k)]
    if not rope_keys:
        return flat
    layout = fmt.get("rope_layout", assume_rope_layout)
    if layout == CKPT_ROPE_LAYOUT:
        return flat
    if layout == "interleaved":
        if rope_num_heads is None:
            raise RuntimeError(f"checkpoint {path!r} has interleaved RoPE layout; pass "
                               "rope_num_heads (memory_attention.num_heads) to migrate it")
        logging.warning("checkpoint %s: migrating %d RoPE q/k projections from interleaved "
                        "to half-split layout", path, len(rope_keys))
        for k in rope_keys:
            v = np.asarray(flat[k])
            flat[k] = v[..., rope_halfsplit_perm(v.shape[-1], rope_num_heads)]
        return flat
    raise RuntimeError(
        f"checkpoint {path!r} predates the RoPE half-split layout marker "
        f"(format {fmt or 'none'}): its memory-attention q/k projections may be "
        "in torch's interleaved layout, which would silently produce wrong "
        "outputs. If it was saved by this framework after the half-split "
        "change, pass assume_rope_layout='halfsplit'; if it is older, pass "
        "assume_rope_layout='interleaved' plus rope_num_heads to migrate "
        "(or call core.checkpoint.migrate_rope_layout).")


def restore_checkpoint(path: str, assume_rope_layout: Optional[str] = None,
                       rope_num_heads: Optional[int] = None) -> Dict:
    """The nested tree of a native ``.npz`` checkpoint and its ``.meta.json``."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    meta_path = npz_path[:-4] + ".meta.json"
    with np.load(npz_path) as data:
        flat: Dict[str, Any] = dict(data)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            flat.update(json.load(f))
    fmt = {k[len(_FORMAT_PREFIX):]: flat.pop(k) for k in [k for k in flat if k.startswith(_FORMAT_PREFIX)]}
    flat = _check_rope_layout(flat, fmt, path, assume_rope_layout, rope_num_heads)
    return _unflatten(flat)


def restore_params(path: str, assume_rope_layout: Optional[str] = None,
                   rope_num_heads: Optional[int] = None) -> Dict:
    """The parameter tree of a native checkpoint (its ``params`` entry, or
    the whole tree when it has none)."""
    state = restore_checkpoint(path, assume_rope_layout, rope_num_heads)
    return state.get("params", state)
