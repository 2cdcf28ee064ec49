"""Model configuration.

The reference reads hyperparameters from module-global config inside layer
constructors (reference: model.py:25-27, 37, 55, 186); here the architecture
is fully described by one immutable ``ModelConfig`` so the model is a pure
function of (params, config, inputs). A copy of the JAX package's
``models/config.py``; ``cdtype`` names a ``torch.dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the multimodal transformer (reference: model.py:355-369).

    vocab_sizes and cross_attention are per-modality; their length defines
    num_modalities. ``attn_impl`` selects the attention core (ops/attention.py
    dispatch): 'auto' | 'jnp' | 'pallas'.
    """

    vocab_sizes: Tuple[int, ...]
    cross_attention: Tuple[bool, ...]
    n_embd: int = 32
    n_head: int = 4
    n_layer: int = 2
    block_size: int = 4
    dropout: float = 0.0
    attn_impl: str = "auto"
    # 'float32' (exact reference parity) or 'bfloat16' (mixed precision:
    # f32 master params, bf16 activations/matmul inputs, f32 accumulation,
    # f32 layernorm/softmax).
    compute_dtype: str = "float32"
    # Training option: rematerialise each block in the backward pass
    # (models/transformer.py ``forward``): changes memory, not values.
    # ``dropout`` above applies in the forward of a training step
    # (``forward(..., train=True)``).
    remat: bool = False

    def __post_init__(self):
        object.__setattr__(self, "vocab_sizes", tuple(int(v) for v in self.vocab_sizes))
        object.__setattr__(
            self, "cross_attention", tuple(bool(c) for c in self.cross_attention)
        )
        if len(self.vocab_sizes) != len(self.cross_attention):
            raise ValueError("vocab_sizes and cross_attention must have equal length")
        if len(self.vocab_sizes) == 0:
            raise ValueError("at least one modality is required")
        if self.n_embd % self.n_head != 0:
            raise ValueError(
                f"n_embd ({self.n_embd}) must be divisible by n_head ({self.n_head})"
            )
        if self.head_size % 2 != 0:
            raise ValueError(
                "head_size (n_embd // n_head) must be even — the factored QKV "
                "tanh-MLP uses a head_size//2 hidden layer (reference model.py:36-50)"
            )

    @property
    def num_modalities(self) -> int:
        return len(self.vocab_sizes)

    @property
    def cdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def head_size(self) -> int:
        return self.n_embd // self.n_head

    @classmethod
    def from_modality_params(
        cls,
        system_config: dict,
        vocab_sizes: Sequence[int],
        all_modality_params: Sequence[Sequence],
        **overrides,
    ) -> "ModelConfig":
        """Build from the legacy interchange format: cross-attention is slot
        [8] of each modality's parameter list (reference: model.py:196)."""
        cross = tuple(
            bool(p[8]) if len(p) > 8 and p[8] is not None else False
            for p in all_modality_params
        )
        defaults = dict(
            compute_dtype=system_config.get("compute_dtype", "float32"),
            attn_impl=system_config.get("attn_impl", "auto"),
            remat=bool(system_config.get("remat", False)),
        )
        defaults.update(overrides)
        return cls(
            vocab_sizes=tuple(vocab_sizes),
            cross_attention=cross,
            n_embd=system_config["n_embd"],
            n_head=system_config["n_head"],
            n_layer=system_config["n_layer"],
            block_size=system_config["block_size"],
            dropout=system_config["dropout"],
            **defaults,
        )

    def kv_modalities(self, i: int) -> Tuple[int, ...]:
        """Indices of the other modalities modality i attends to
        (reference: model.py:198-199: all j != i, ascending)."""
        return tuple(j for j in range(self.num_modalities) if j != i)
