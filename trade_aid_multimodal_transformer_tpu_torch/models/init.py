"""Parameter initialization (port of the JAX package's ``models/init.py``).

The parameter tree is a nested dict of tensors with the same keys, nesting
and shapes as the JAX package's (M = num_modalities, C = n_embd, H = n_head,
hs = C//H, hs2 = hs//2, C2 = C//2):

    pre:
      tok_emb: [ (V_i, C) per modality ]
      pos_emb: (block_size, C)
    blocks: [ per layer:
      ln1/ln2:  scale (M, C), bias (M, C)
      sa:       w1_{k,q,v} (M, C, H*hs2), b1_* (M, H*hs2),
                w2_{k,q,v} (M, H, hs2, hs),
                proj_w1 (M, H*hs, C2), proj_b1 (M, C2),
                proj_w2 (M, C2, C),   proj_b2 (M, C)
      ffwd:     w1 (M, C, 4C), b1 (M, 4C), w2 (M, 4C, C), b2 (M, C)
      cross:    { str(i): per cross-enabled modality i:
                  q_w (H, C, hs), kv_w (J_i, H, C, 2*hs),
                  proj_w1 (H*hs, C2), proj_b1 (C2,),
                  proj_w2 (C2, C),    proj_b2 (C,),
                  ln_scale (C,), ln_bias (C,) } ]
    post:
      ln_scale (M, C), ln_bias (M, C)
      heads: [ per modality: w1 (C, V_i//2), b1 (V_i//2,),
                             w2 (V_i//2, V_i), b2 (V_i,) ]

Weights and tables ~ N(0, 0.02), biases 0, LayerNorm scale 1 and bias 0, as
in the JAX package; the draws differ (another generator).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .config import ModelConfig

INIT_STD = 0.02

# A leaf of the shape tree: (kind, shape), kind in {"normal", "zeros", "ones"}.
Leaf = Tuple[str, Tuple[int, ...]]


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree with (kind, shape) leaves."""
    M, C, H = cfg.num_modalities, cfg.n_embd, cfg.n_head
    hs = cfg.head_size
    hs2, C2 = hs // 2, C // 2

    def n(*s):
        return ("normal", s)

    def z(*s):
        return ("zeros", s)

    def o(*s):
        return ("ones", s)

    blocks = []
    for _ in range(cfg.n_layer):
        sa = {
            "proj_w1": n(M, H * hs, C2), "proj_b1": z(M, C2),
            "proj_w2": n(M, C2, C), "proj_b2": z(M, C),
        }
        for name in ("k", "q", "v"):
            sa[f"w1_{name}"] = n(M, C, H * hs2)
            sa[f"b1_{name}"] = z(M, H * hs2)
            sa[f"w2_{name}"] = n(M, H, hs2, hs)
        cross = {}
        for i in range(M):
            if cfg.cross_attention[i] and M > 1:
                cross[str(i)] = {
                    "q_w": n(H, C, hs), "kv_w": n(M - 1, H, C, 2 * hs),
                    "proj_w1": n(H * hs, C2), "proj_b1": z(C2),
                    "proj_w2": n(C2, C), "proj_b2": z(C),
                    "ln_scale": o(C), "ln_bias": z(C),
                }
        blocks.append({
            "ln1": {"scale": o(M, C), "bias": z(M, C)},
            "ln2": {"scale": o(M, C), "bias": z(M, C)},
            "sa": sa,
            "ffwd": {"w1": n(M, C, 4 * C), "b1": z(M, 4 * C),
                     "w2": n(M, 4 * C, C), "b2": z(M, C)},
            "cross": cross,
        })
    return {
        "pre": {"tok_emb": [n(V, C) for V in cfg.vocab_sizes],
                "pos_emb": n(cfg.block_size, C)},
        "blocks": blocks,
        "post": {
            "ln_scale": o(M, C), "ln_bias": z(M, C),
            "heads": [{"w1": n(C, V // 2), "b1": z(V // 2),
                       "w2": n(V // 2, V), "b2": z(V)} for V in cfg.vocab_sizes],
        },
    }


def _is_leaf(node) -> bool:
    return isinstance(node, tuple) and len(node) == 2 and isinstance(node[0], str)


def map_tree(fn, tree):
    """Apply fn to every leaf of a nested dict/list tree, keeping its
    structure; dict keys are visited in sorted order."""
    if _is_leaf(tree) or isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    raise TypeError(f"unexpected node {type(tree).__name__} in a parameter tree")


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``map_tree``'s order (sorted dict keys), which
    is the JAX package's flattening order."""
    out: list = []
    map_tree(lambda t: out.append(t) or t, tree)
    return out


def tree_paths(tree, path=()):
    """(path, leaf) for every leaf, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (i,))
    else:
        yield path, tree


def init_params(
    cfg: ModelConfig, generator: torch.Generator, device: str | torch.device
) -> Dict[str, Any]:
    """Draw a parameter tree from a CPU ``generator`` (so one seed gives the
    same weights on every device) and place it on ``device``, in f32."""

    def draw(leaf: Leaf) -> torch.Tensor:
        kind, shape = leaf
        if kind == "normal":
            t = torch.randn(shape, generator=generator, dtype=torch.float32) * INIT_STD
        elif kind == "zeros":
            t = torch.zeros(shape, dtype=torch.float32)
        else:
            t = torch.ones(shape, dtype=torch.float32)
        return t.to(device)

    return map_tree(draw, param_shapes(cfg))


def count_params(params) -> int:
    """Exact trainable parameter count."""
    total = 0

    def add(t):
        nonlocal total
        total += t.numel()
        return t

    map_tree(add, params)
    return total
