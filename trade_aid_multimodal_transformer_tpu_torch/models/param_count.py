"""Analytic parameter-count estimate, matching the reference's printed number,
and the analytic matmul FLOPs of a training step (a copy of the JAX
package's ``models/param_count.py``).

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


def training_flops_per_step(cfg, batch_size: int) -> float:
    """Analytic matmul FLOPs of one forward + backward training step: the
    numerator of a step's model-FLOPs utilisation.

    Counts the actual factored projections (Quirk Q6): each QKV projection is
    Linear(C, hs/2) -> Linear(hs/2, hs) per head, about 2.5 C^2 MACs a token
    for all three, not the 4 C^2 of standard attention; plus the tanh-MLP
    output projection, feed-forward, the attention einsums, cross-attention
    for every cross-enabled modality (q/kv projections and J KV-stream
    attention), and the vocab//2 output heads. Backward ~= 2x forward, so
    total = 3 x forward. Elementwise ops (LN, tanh, dropout, softmax) and the
    embedding gather are excluded."""
    C = cfg.n_embd
    T = cfg.block_size
    H = cfg.n_head
    hs = C // H
    hs2 = hs // 2
    M = cfg.num_modalities

    # per token, per layer, per modality (MACs)
    qkv = 3 * (H * C * hs2 + H * hs2 * hs)      # = 1.5 C^2 + 1.5 C*hs
    attn = 2 * T * C                            # q.k^T and att.v over the full tile grid
    proj = (H * hs) * (C // 2) + (C // 2) * C   # = C^2
    ff = C * 4 * C + 4 * C * C                  # = 8 C^2
    per_mod = qkv + attn + proj + ff

    # cross-attention per cross-enabled modality (MACs a token a layer)
    cross_total = 0
    for enabled in cfg.cross_attention:
        if not enabled or M == 1:
            continue
        J = M - 1
        cross_total += (
            H * C * hs                            # q:  C^2
            + J * H * C * 2 * hs                  # kv: 2 J C^2
            + J * 2 * T * C                       # J KV-stream attentions
            + (H * hs) * (C // 2) + (C // 2) * C  # out proj: C^2
        )

    # vocab heads (MACs a token)
    heads = sum(C * (V // 2) + (V // 2) * V for V in cfg.vocab_sizes)

    macs_per_token = cfg.n_layer * (M * per_mod + cross_total) + heads
    fwd_flops = 2.0 * macs_per_token * batch_size * T
    return 3.0 * fwd_flops
