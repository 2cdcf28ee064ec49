"""Model: configuration, parameters, inference forward and sampling."""

from .config import ModelConfig
from .init import count_params, init_params
from .sampler import generate_fast
from .transformer import forward, generate

__all__ = ["ModelConfig", "count_params", "init_params", "generate_fast", "forward", "generate"]
