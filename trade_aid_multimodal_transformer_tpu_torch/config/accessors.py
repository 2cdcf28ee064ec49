"""Lazy, cached hyperparameter accessors (reference: config_utils.py:8-69; a
copy of the JAX package's ``config/accessors.py``).

The reference reads hyperparameters deep inside layer constructors through
these cached getters; the port passes an explicit ``ModelConfig`` through
the model instead (models/transformer.py), but the accessors are kept for
user code written against the reference.
"""

from __future__ import annotations

_config_cache = None


def _get_config():
    global _config_cache
    if _config_cache is None:
        from .compat import get_system_configuration

        _config_cache = get_system_configuration()
    return _config_cache


def reset_config_cache() -> None:
    global _config_cache
    _config_cache = None


def _get_device():
    return _get_config()["device"]


def _get_block_size():
    return _get_config()["block_size"]


def _get_batch_size():
    return _get_config()["batch_size"]


def _get_eval_iters():
    return _get_config()["eval_iters"]


def _get_n_embd():
    return _get_config()["n_embd"]


def _get_n_head():
    return _get_config()["n_head"]


def _get_n_layer():
    return _get_config()["n_layer"]


def _get_dropout():
    return _get_config()["dropout"]


def _get_fixed_values():
    return _get_config()["fixed_values"]
