"""Checkpoints in the JAX package's ``.npz`` format (port of its
``train/checkpoint.py``).

One ``.npz`` file of flattened leaves keyed by the JAX key-path strings that
``jax.tree_util.keystr`` writes, e.g. ``params['blocks'][0]['sa']['w1_q']``;
bf16 leaves are stored as uint16 bit views under the key plus ``::bf16``.
The port writes and reads these strings itself. The optimizer state goes
under the ``opt`` prefix in the layout of the JAX optimizer's state:
``opt[0].count`` / ``opt[0].mu[...]`` / ``opt[0].nu[...]`` for optax.adamw
(plus ``opt[2].count`` with a schedule), ``opt.count`` / ``opt.mu[...]`` /
``opt.nu[...]`` for ``_adamw_lowmem``. A checkpoint written by either
package loads in the other, moments included, so a resumed run continues
them. ``load_checkpoint`` also reads the reference model's ``.pth``
state_dict (utils/torch_compat.py): weights only, no step and no optimizer
state. A ``.pth`` is a zip as an ``.npz`` is, so a file counts as this
format only where it holds parameter keys.
"""

from __future__ import annotations

import os
import re
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import params_from_jax
from ..models.config import ModelConfig
from ..models.init import map_tree, param_shapes, tree_paths
from ..utils.torch_compat import load_reference_checkpoint

_META_STEP = "__meta_step__"
_PARAMS_PREFIX = "params"
_OPT_PREFIX = "opt"
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


def _put(out: Dict[str, np.ndarray], key: str, t: torch.Tensor) -> None:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        out[key + _BF16_SUFFIX] = t.view(torch.int16).numpy().view(np.uint16)
    else:
        out[key] = t.numpy()


def _opt_prefix(optimizer) -> str:
    return _OPT_PREFIX + optimizer.jax_state_prefix


def save_checkpoint(path: str, params, step: Optional[int] = None, opt_state=None,
                    optimizer=None) -> int:
    """Write the parameters (and optionally the step and the optimizer state
    of ``optimizer``, train/steps.AdamW) as an ``.npz`` that the JAX
    package's ``load_checkpoint`` reads; returns the file size in bytes."""
    out: Dict[str, np.ndarray] = {}
    for p, t in tree_paths(params):
        _put(out, _PARAMS_PREFIX + _keystr(p), t)
    if opt_state is not None:
        pre = _opt_prefix(optimizer)
        count = np.asarray(opt_state["count"], np.int32)
        out[pre + ".count"] = count
        for name in ("mu", "nu"):
            for p, t in tree_paths(opt_state[name]):
                _put(out, f"{pre}.{name}{_keystr(p)}", t)
        if optimizer.schedule_count:
            out[_OPT_PREFIX + "[2].count"] = count
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


def _read_native(path: str) -> Optional[Dict[str, np.ndarray]]:
    """The arrays of a checkpoint in this format, or None for another file
    (a ``.pth`` zip without parameter keys, or no archive at all)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            data = {k: z[k] for k in z.files}
    except (ValueError, EOFError, zipfile.BadZipFile):  # not an .npy / .npz archive
        return None
    if not any(k.startswith(_PARAMS_PREFIX + "[") for k in data):
        return None
    return data


def load_checkpoint(
    path: str, cfg: ModelConfig, device: str | torch.device
) -> Tuple[Dict[str, Any], Optional[int]]:
    """Read a checkpoint into the port's parameter tree on ``device`` (f32
    leaves, as the JAX loader casts to its f32 template): an ``.npz`` of
    either package, or else the reference model's ``.pth`` (step None).
    Returns (params, step)."""
    data = _read_native(path)
    if data is None:
        params = load_reference_checkpoint(path, cfg)
        if map_tree(lambda t: tuple(t.shape), params) != map_tree(lambda leaf: leaf[1],
                                                                  param_shapes(cfg)):
            raise ValueError(f"{path}: the reference state_dict's shapes are not the config's")
        return map_tree(lambda t: t.to(device, torch.float32), params), None
    tree: dict = {}
    for key, arr in data.items():
        if not key.startswith(_PARAMS_PREFIX + "["):
            continue
        key = key[len(_PARAMS_PREFIX):]
        if key.endswith(_BF16_SUFFIX):
            key = key[: -len(_BF16_SUFFIX)]
            arr = _bf16_bits_to_f32(arr)
        _insert(tree, _parse_keystr(key), arr.astype(np.float32))
    params = params_from_jax(_conform(tree, param_shapes(cfg), "params"), device)
    step = int(data[_META_STEP]) if _META_STEP in data else None
    return params, step


def load_optimizer_state(path: str, params, optimizer) -> Optional[Dict[str, Any]]:
    """The optimizer state of ``optimizer`` stored in a checkpoint, on the
    parameters' devices, or None when the checkpoint holds none (a
    weights-only file, a reference ``.pth``, or another optimizer's
    layout)."""
    data = _read_native(path)
    pre = _opt_prefix(optimizer)
    if data is None or pre + ".count" not in data:
        return None
    state = optimizer.init(params)
    for name in ("mu", "nu"):
        for p, t in tree_paths(state[name]):
            key = f"{pre}.{name}{_keystr(p)}"
            if key + _BF16_SUFFIX in data:
                arr = _bf16_bits_to_f32(data[key + _BF16_SUFFIX])
            elif key in data:
                arr = data[key]
            else:
                return None
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.asarray(arr, np.float32)).to(t.dtype))
    state["count"] = int(data[pre + ".count"])
    return state
