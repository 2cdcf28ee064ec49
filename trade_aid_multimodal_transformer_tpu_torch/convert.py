"""Carry a JAX-package parameter tree across into the port.

``params_from_jax`` takes the JAX package's parameter tree with numpy leaves
(``jax.tree.map(np.asarray, params)``, or a tree read back from an ``.npz``
checkpoint) and returns the port's tree: the same keys and nesting, torch
tensors of the same dtypes on ``device``. The checkpoint loader and the
parity tests share it. The weights carried across are whole;
``shard_params`` then gives one rank's parts of them, the block that
device (m, d, t) of the JAX package's ``shard_params(model_axis=True)``
holds.
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


def shard_params(params: Any, model_rank: int, model_size: int, data_rank: int = 0,
                 data_size: int = 1, fsdp: bool = False, mod_rank: int = 0,
                 mod_size: int = 1) -> Any:
    """Rank (mod_rank, data_rank, model_rank)'s parts of a whole port tree
    over a model axis of ``model_size``, a modality axis of ``mod_size``
    (and, with ``fsdp``, a data axis of ``data_size``): every leaf that
    ``param_pspecs`` places on 'model', 'mod' (and 'data') sliced as a
    tensor of its own, the others as they are."""
    from .parallel.mesh import param_pspecs, shard_tree

    data_size = data_size if fsdp else 1
    specs = param_pspecs(params, n_head=0, model_axis=model_size > 1, model_size=model_size,
                         mod_axis=mod_size > 1, mod_size=mod_size, fsdp_size=data_size)
    return shard_tree(params, specs, {"model": (model_rank, model_size),
                                      "mod": (mod_rank, mod_size),
                                      "data": (data_rank, data_size)})


def params_from_jax(tree: Any, device: str | torch.device) -> Any:
    """Nested dicts/lists of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _tensor(tree, device)
