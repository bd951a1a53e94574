"""Native checkpoints of the JAX package, read and written without JAX.

The JAX package's ``core/checkpoint.py`` in numpy and json only: a ``.npz``
of '/'-joined paths with its ``.meta.json`` (scalars and the format marker),
written atomically through a temporary file and a rename
(``save_checkpoint``, with unix-pattern ``skip_patterns``) and read back to
the nested tree (``restore_checkpoint``, ``restore_params``); the
auto-resume lookup (``get_resume_checkpoint``), the pattern filters and
``load_state_dict_into_params``. The parameter tree is the JAX tree's
(``core/weights.py``: ``to_jax_params`` on the way out, ``from_jax_params``
on the way in), so either package reads what the other wrote.

The format marker guards the RoPE layout (``docs/PARITY.md`` #13): the
memory attention's q/k projections are stored permuted into the half-split
layout, and a checkpoint written before that change holds torch's
interleaved layout, which would load without error and attend wrongly. An
unmarked checkpoint with RoPE projections raises; one declared interleaved
is migrated; every save stamps the marker. The JAX package's Orbax backend
is not ported: asking for it raises, and so does an Orbax checkpoint
directory where a resume looks.
"""

from __future__ import annotations

import fnmatch
import json
import logging
import os
from typing import Any, Dict, List, Optional

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


def _matches(key: str, patterns) -> bool:
    return any(fnmatch.fnmatch(key, p) for p in patterns)


def exclude_params_matching_unix_pattern(patterns: List[str], state_dict: Dict) -> Dict:
    """The tree without the leaves whose '/'-joined path matches a pattern
    (reference checkpoint_utils.py:30-60)."""
    return _unflatten({k: v for k, v in _flatten(state_dict).items() if not _matches(k, patterns)})


def filter_params_matching_unix_pattern(patterns: List[str], state_dict: Dict) -> Dict:
    """The tree of the leaves whose '/'-joined path matches a pattern."""
    return _unflatten({k: v for k, v in _flatten(state_dict).items() if _matches(k, patterns)})


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


def save_checkpoint(path: str, state: Dict, skip_patterns: Optional[List[str]] = None) -> None:
    """``state`` (nested dicts; numpy arrays, 0-d included, go to the
    ``.npz``, other scalars to the ``.meta.json`` with the format marker) as
    ``path`` + ``.npz`` (``path`` itself when it ends so), each file written
    to a temporary name and renamed into place (reference trainer.py:363-380);
    leaves whose path matches one of ``skip_patterns`` are left out."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(state)
    if skip_patterns:
        flat = {k: v for k, v in flat.items() if not _matches(k, skip_patterns)}
    arrays = {k: v for k, v in flat.items() if isinstance(v, np.ndarray)}
    scalars = {k: (v.item() if isinstance(v, np.generic) else v) for k, v in flat.items()
               if not isinstance(v, np.ndarray)}
    scalars[_FORMAT_PREFIX + "version"] = CKPT_FORMAT_VERSION
    scalars[_FORMAT_PREFIX + "rope_layout"] = CKPT_ROPE_LAYOUT
    npz_path = path if path.endswith(".npz") else path + ".npz"
    tmp = npz_path[:-4] + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, npz_path)
    meta_path = npz_path[:-4] + ".meta.json"
    with open(meta_path + ".tmp", "w") as f:
        json.dump(scalars, f, default=str)
    os.replace(meta_path + ".tmp", meta_path)


def save_checkpoint_any(path: str, state: Dict, skip_patterns: Optional[List[str]] = None,
                        backend: str = "npz") -> None:
    """``save_checkpoint`` for ``backend`` "npz"; the JAX package's "orbax"
    backend is not ported and raises."""
    if backend != "npz":
        raise NotImplementedError(f"checkpoint_backend={backend!r}: the port writes the npz backend only "
                                  "(the JAX package's Orbax backend is not ported)")
    save_checkpoint(path, state, skip_patterns)


def get_resume_checkpoint(save_dir: str) -> Optional[str]:
    """``<save_dir>/checkpoint.npz`` when it exists (reference
    train_utils.py:281-288), else None; an Orbax ``checkpoint/`` directory
    of the JAX package raises rather than being passed over."""
    orbax_dir = os.path.join(save_dir, "checkpoint")
    if os.path.isdir(orbax_dir):
        raise NotImplementedError(f"{orbax_dir} is an Orbax checkpoint directory, which the port cannot "
                                  "read; resume it with the JAX package or remove it")
    npz_path = os.path.join(save_dir, "checkpoint.npz")
    return npz_path if os.path.exists(npz_path) else None


def load_state_dict_into_params(params: Dict, loaded: Dict, strict: bool = True,
                                ignore_missing_keys: Optional[List[str]] = None,
                                ignore_unexpected_keys: Optional[List[str]] = None) -> Dict:
    """``loaded``'s leaves merged into the tree ``params`` by path, with
    ignorable unix patterns of missing and unexpected keys (reference
    checkpoint_utils.py:330-361); shapes must agree."""
    cur, new = _flatten(params), _flatten(loaded)
    missing = [k for k in cur if k not in new and not _matches(k, ignore_missing_keys or ())]
    unexpected = [k for k in new if k not in cur and not _matches(k, ignore_unexpected_keys or ())]
    if strict and (missing or unexpected):
        raise RuntimeError(f"missing={missing[:5]} unexpected={unexpected[:5]}")
    merged = dict(cur)
    for k, v in new.items():
        if k in cur:
            if np.shape(cur[k]) != np.shape(v):
                raise ValueError(f"{k}: {np.shape(cur[k])} vs {np.shape(v)}")
            merged[k] = v
    return _unflatten(merged)
