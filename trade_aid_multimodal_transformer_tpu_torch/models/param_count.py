"""Analytic parameter-count estimate, matching the reference's printed number
(a copy of the JAX package's ``models/param_count.py`` estimate).

The reference prints an analytic estimate (not the true count) at model
creation (reference: main.py:400-449, printed :458). Console parity requires
reproducing that exact formula, quirks included — the true count is available
from models.init.count_params.
"""

from __future__ import annotations

from typing import Sequence


def estimate_model_params(
    n_embd: int,
    n_head: int,
    n_layer: int,
    block_size: int,
    vocab_sizes: Sequence[int],
    cross_flags: Sequence[bool],
) -> int:
    """Reference formula (main.py:400-449)."""
    num_modalities = len(vocab_sizes)
    head_size = n_embd // n_head

    token_embeddings = sum(v * n_embd for v in vocab_sizes)
    positional_embeddings = block_size * n_embd

    per_layer_params = 0
    for _ in range(num_modalities):
        attention_params = n_head * 3 * (
            n_embd * (head_size // 2) + (head_size // 2) * head_size
        )
        attention_params += (head_size * n_head) * (n_embd // 2) + (n_embd // 2) * n_embd
        feedforward_params = n_embd * (4 * n_embd) + (4 * n_embd) * n_embd
        layernorm_params = 2 * n_embd
        per_layer_params += attention_params + feedforward_params + layernorm_params

    cross_attention_params = 0
    for enabled in cross_flags:
        if enabled:
            num_other = num_modalities - 1
            cross_attention_params += num_other * (
                2
                * (
                    n_embd * (n_head * (n_embd // n_head) // 2)
                    + (n_embd // n_head) // 2 * (n_embd // n_head)
                )
            ) + n_embd * (n_embd // 2) + (n_embd // 2) * n_embd
            cross_attention_params += n_embd  # cross-attention LayerNorm

    output_params = 0
    for v in vocab_sizes:
        output_params += n_embd + n_embd * (v // 2) + (v // 2) * v

    return (
        token_embeddings
        + positional_embeddings
        + n_layer * (per_layer_params + cross_attention_params)
        + output_params
    )
