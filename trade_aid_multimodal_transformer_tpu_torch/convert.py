"""Carry a JAX-package parameter tree across into the port.

``params_from_jax`` takes the JAX package's parameter tree with numpy leaves
(``jax.tree.map(np.asarray, params)``, or a tree read back from an ``.npz``
checkpoint) and returns the port's tree: the same keys and nesting, torch
tensors of the same dtypes on ``device``. The checkpoint loader and the
parity tests share it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(arr: Any, device: str | torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: carry the bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree: Any, device: str | torch.device) -> Any:
    """Nested dicts/lists of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _tensor(tree, device)
