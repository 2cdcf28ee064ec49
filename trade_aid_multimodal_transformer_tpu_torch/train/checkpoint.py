"""Model checkpoints in the JAX package's ``.npz`` format (port of its
``train/checkpoint.py``, parameters only).

One ``.npz`` file of flattened leaves keyed by the JAX key-path strings that
``jax.tree_util.keystr`` writes, e.g. ``params['blocks'][0]['sa']['w1_q']``;
bf16 leaves are stored as uint16 bit views under the key plus ``::bf16``.
The port writes and reads these strings itself. A checkpoint written by
either package loads in the other. Optimizer state, which the JAX trainer
also stores, is ignored here; loading the reference model's ``.pth`` is not
ported yet.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import params_from_jax
from ..models.config import ModelConfig
from ..models.init import param_shapes

_META_STEP = "__meta_step__"
_PARAMS_PREFIX = "params"
_BF16_SUFFIX = "::bf16"
_KEY_PART = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]")


def _keystr(path: Tuple) -> str:
    return "".join(f"[{p!r}]" if isinstance(p, str) else f"[{p}]" for p in path)


def _parse_keystr(s: str) -> List:
    parts, pos = [], 0
    for m in _KEY_PART.finditer(s):
        if m.start() != pos:
            break
        parts.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"unrecognised checkpoint key {s!r}")
    return parts


def _leaves(tree, path=()):
    """(path, tensor) for every leaf; dict keys in sorted order, as JAX
    flattens them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def save_checkpoint(path: str, params, step: Optional[int] = None) -> int:
    """Write the parameters (and optionally the step) as an ``.npz`` that the
    JAX package's ``load_checkpoint`` reads; returns the file size in bytes."""
    out: Dict[str, np.ndarray] = {}
    for p, t in _leaves(params):
        key = _PARAMS_PREFIX + _keystr(p)
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[key + _BF16_SUFFIX] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = t.numpy()
    if step is not None:
        out[_META_STEP] = np.asarray(step, np.int64)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **out)
    os.replace(tmp, path)
    return os.path.getsize(path)


def _bf16_bits_to_f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _insert(tree: dict, path: List, leaf: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = leaf


def _conform(node, template, where: str):
    """Rebuild ``node`` (nested dicts, list indices as int keys) in the shape
    of ``template`` (param_shapes leaves), checking every leaf's shape. Empty
    containers of the template, which an .npz cannot record, come back
    empty."""
    if isinstance(template, dict):
        if not template:
            return {}
        if not isinstance(node, dict):
            raise KeyError(f"checkpoint missing {where}")
        return {k: _conform(node.get(k, {} if template[k] == {} else None), template[k],
                            f"{where}[{k!r}]") for k in template}
    if isinstance(template, list):
        if not isinstance(node, dict) or sorted(node) != list(range(len(template))):
            raise KeyError(f"checkpoint {where} does not hold {len(template)} entries")
        return [_conform(node[i], t, f"{where}[{i}]") for i, t in enumerate(template)]
    if node is None:
        raise KeyError(f"checkpoint missing leaf {where}")
    if tuple(node.shape) != tuple(template[1]):
        raise ValueError(f"{where}: shape {node.shape} != expected {template[1]}")
    return node


def load_checkpoint(
    path: str, cfg: ModelConfig, device: str | torch.device
) -> Tuple[Dict[str, Any], Optional[int]]:
    """Read an ``.npz`` checkpoint into the port's parameter tree on
    ``device`` (f32 leaves, as the JAX loader casts to its f32 template).
    Returns (params, step)."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    tree: dict = {}
    for key, arr in data.items():
        if not key.startswith(_PARAMS_PREFIX + "["):
            continue
        key = key[len(_PARAMS_PREFIX):]
        if key.endswith(_BF16_SUFFIX):
            key = key[: -len(_BF16_SUFFIX)]
            arr = _bf16_bits_to_f32(arr)
        _insert(tree, _parse_keystr(key), arr.astype(np.float32))
    if not tree:
        raise ValueError(f"{path} holds no parameters of the .npz checkpoint format")
    params = params_from_jax(_conform(tree, param_shapes(cfg), "params"), device)
    step = int(data[_META_STEP]) if _META_STEP in data else None
    return params, step
