"""The model's parameter tree and the benchmark's weights.

The tree has the program's nesting, keys and shapes (M modalities, C =
n_embd, H heads of hs, hs2 = hs // 2, C2 = C // 2). Leaves are visited in
sorted-key order. The benchmark makes the weights itself, on the device,
from the seed: one draw of N(0, 0.02) for every normal leaf together,
biases 0, LayerNorm scales 1. Both the program and the reference get
those same weights.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

INIT_STD = 0.02


def param_shapes(cfg) -> Dict[str, Any]:
    """The tree with (kind, shape) leaves, kind in normal / zeros / ones."""
    M, C, H = cfg.num_modalities, cfg.n_embd, cfg.n_head
    hs = C // H
    hs2, C2 = hs // 2, C // 2

    def n(*s):
        return ("normal", s)

    def z(*s):
        return ("zeros", s)

    def o(*s):
        return ("ones", s)

    blocks = []
    for _ in range(cfg.n_layer):
        sa = {"proj_w1": n(M, H * hs, C2), "proj_b1": z(M, C2),
              "proj_w2": n(M, C2, C), "proj_b2": z(M, C)}
        for name in ("k", "q", "v"):
            sa[f"w1_{name}"] = n(M, C, H * hs2)
            sa[f"b1_{name}"] = z(M, H * hs2)
            sa[f"w2_{name}"] = n(M, H, hs2, hs)
        cross = {}
        for i in range(M):
            if cfg.cross_attention[i] and M > 1:
                cross[str(i)] = {"q_w": n(H, C, hs), "kv_w": n(M - 1, H, C, 2 * hs),
                                 "proj_w1": n(H * hs, C2), "proj_b1": z(C2),
                                 "proj_w2": n(C2, C), "proj_b2": z(C),
                                 "ln_scale": o(C), "ln_bias": z(C)}
        blocks.append({"ln1": {"scale": o(M, C), "bias": z(M, C)},
                       "ln2": {"scale": o(M, C), "bias": z(M, C)},
                       "sa": sa,
                       "ffwd": {"w1": n(M, C, 4 * C), "b1": z(M, 4 * C),
                                "w2": n(M, 4 * C, C), "b2": z(M, C)},
                       "cross": cross})
    return {"pre": {"tok_emb": [n(V, C) for V in cfg.vocab_sizes],
                    "pos_emb": n(cfg.block_size, C)},
            "blocks": blocks,
            "post": {"ln_scale": o(M, C), "ln_bias": z(M, C),
                     "heads": [{"w1": n(C, V // 2), "b1": z(V // 2),
                                "w2": n(V // 2, V), "b2": z(V)} for V in cfg.vocab_sizes]}}


def _is_leaf(node) -> bool:
    return isinstance(node, torch.Tensor) or (
        isinstance(node, tuple) and len(node) == 2 and isinstance(node[0], str))


def map_tree(fn, tree):
    """fn over every leaf, dict keys in sorted order."""
    if _is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k]) for k in sorted(tree)}
    return [map_tree(fn, v) for v in tree]


def leaves(tree) -> List:
    out: List = []
    map_tree(lambda t: out.append(t) or t, tree)
    return out


def make_weights(cfg, seed: int, device) -> Dict[str, Any]:
    """The weights of ``seed``, f32, on ``device``, drawn in one call."""
    shapes = param_shapes(cfg)
    n_normal = sum(math.prod(s) for kind, s in leaves(shapes) if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(n_normal, generator=gen, device=device, dtype=torch.float32).mul_(INIT_STD)
    offset = 0

    def draw(leaf):
        nonlocal offset
        kind, shape = leaf
        if kind == "zeros":
            return torch.zeros(shape, device=device)
        if kind == "ones":
            return torch.ones(shape, device=device)
        size = math.prod(shape)
        t = flat[offset:offset + size].view(shape).clone()
        offset += size
        return t

    return map_tree(draw, shapes)
