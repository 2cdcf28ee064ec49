"""The reference model's checkpoints (port of the JAX package's
``utils/torch_compat.py``).

Users moving from the reference framework have ``model.pth`` state_dicts
saved by ``torch.save(m.state_dict(), ...)`` (reference: main.py:627-637).
``convert_reference_state_dict`` maps that layout onto the port's parameter
tree (models/init.py), so training resumes from reference weights and the
generation entry serves them; ``reference_state_dict`` is its inverse, which
writes the port's weights in the reference layout (tests and the card's
smoke run use it to make reference files).

Reference module tree (state_dict key prefixes, reference: model.py):
    pre_block.token_embedding_tables.{i}.weight        (V_i, C)
    pre_block.position_embedding_table.weight          (block, C)
    blocks.{l}.sa_layers.{m}.heads.{h}.{key|query|value}.0.{weight,bias}
    blocks.{l}.sa_layers.{m}.heads.{h}.{key|query|value}.2.weight
    blocks.{l}.sa_layers.{m}.proj.{0,2}.{weight,bias}
    blocks.{l}.ffwd_layers.{m}.net.{0,2}.{weight,bias}
    blocks.{l}.{ln1|ln2}_layers.{m}.{weight,bias}
    blocks.{l}.cross_attention_layers.{i}.heads.{h}.query.weight
    blocks.{l}.cross_attention_layers.{i}.heads.{h}.kv_projections.{j}.weight
    blocks.{l}.cross_attention_layers.{i}.proj.{0,2}.{weight,bias}
    blocks.{l}.ln_cross_layers.{i}.{weight,bias}
    post_block.fin_norm_layers.{m}.{weight,bias}
    post_block.soft_score_layers.{m}.{0,2}.{weight,bias}

torch Linear stores weight as (out, in); the tree's layout is (in, out), so
every weight transposes. Per-head Linears concatenate head-major. ``tril``
buffers are masks, not parameters: skipped.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..models.config import ModelConfig

_QKV = (("k", "key"), ("q", "query"), ("v", "value"))


def _cross_modalities(cfg: ModelConfig):
    return [i for i in range(cfg.num_modalities) if cfg.cross_attention[i] and cfg.num_modalities > 1]


def convert_reference_state_dict(state: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameter tree (CPU tensors in the state's dtype) from a
    reference state_dict whose values are tensors or numpy arrays."""
    M, H = cfg.num_modalities, cfg.n_head

    def get(key: str) -> torch.Tensor:
        v = state[key]
        return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))

    def per_mod(fmt: str, transpose: bool = False) -> torch.Tensor:
        return torch.stack([get(fmt.format(m=m)).T if transpose else get(fmt.format(m=m))
                            for m in range(M)])

    params: Dict[str, Any] = {
        "pre": {
            "tok_emb": [get(f"pre_block.token_embedding_tables.{i}.weight") for i in range(M)],
            "pos_emb": get("pre_block.position_embedding_table.weight"),
        },
        "blocks": [],
    }
    for l in range(cfg.n_layer):
        pb = f"blocks.{l}"
        sa: Dict[str, torch.Tensor] = {}
        for name, ref in _QKV:
            head = f"{pb}.sa_layers.{{m}}.heads.{{h}}.{ref}"
            sa[f"w1_{name}"] = torch.stack([torch.cat(
                [get(f"{head}.0.weight".format(m=m, h=h)).T for h in range(H)], dim=1)
                for m in range(M)])  # (M, C, H*hs2)
            sa[f"b1_{name}"] = torch.stack([torch.cat(
                [get(f"{head}.0.bias".format(m=m, h=h)) for h in range(H)]) for m in range(M)])
            sa[f"w2_{name}"] = torch.stack([torch.stack(
                [get(f"{head}.2.weight".format(m=m, h=h)).T for h in range(H)])
                for m in range(M)])  # (M, H, hs2, hs)
        for n, ref in (("1", "0"), ("2", "2")):
            sa[f"proj_w{n}"] = per_mod(f"{pb}.sa_layers.{{m}}.proj.{ref}.weight", True)
            sa[f"proj_b{n}"] = per_mod(f"{pb}.sa_layers.{{m}}.proj.{ref}.bias")
        block: Dict[str, Any] = {
            "sa": sa,
            "ffwd": {f"{w}{n}": per_mod(f"{pb}.ffwd_layers.{{m}}.net.{ref}.{kind}", w == "w")
                     for n, ref in (("1", "0"), ("2", "2"))
                     for w, kind in (("w", "weight"), ("b", "bias"))},
            "cross": {},
        }
        for ln in ("ln1", "ln2"):
            block[ln] = {"scale": per_mod(f"{pb}.{ln}_layers.{{m}}.weight"),
                         "bias": per_mod(f"{pb}.{ln}_layers.{{m}}.bias")}
        for i in _cross_modalities(cfg):
            cb = f"{pb}.cross_attention_layers.{i}"
            block["cross"][str(i)] = {
                "q_w": torch.stack([get(f"{cb}.heads.{h}.query.weight").T for h in range(H)]),
                "kv_w": torch.stack([torch.stack(
                    [get(f"{cb}.heads.{h}.kv_projections.{j}.weight").T for h in range(H)])
                    for j in range(M - 1)]),
                "proj_w1": get(f"{cb}.proj.0.weight").T,
                "proj_b1": get(f"{cb}.proj.0.bias"),
                "proj_w2": get(f"{cb}.proj.2.weight").T,
                "proj_b2": get(f"{cb}.proj.2.bias"),
                "ln_scale": get(f"{pb}.ln_cross_layers.{i}.weight"),
                "ln_bias": get(f"{pb}.ln_cross_layers.{i}.bias"),
            }
        params["blocks"].append(block)
    params["post"] = {
        "ln_scale": per_mod("post_block.fin_norm_layers.{m}.weight"),
        "ln_bias": per_mod("post_block.fin_norm_layers.{m}.bias"),
        "heads": [{"w1": get(f"post_block.soft_score_layers.{m}.0.weight").T,
                   "b1": get(f"post_block.soft_score_layers.{m}.0.bias"),
                   "w2": get(f"post_block.soft_score_layers.{m}.2.weight").T,
                   "b2": get(f"post_block.soft_score_layers.{m}.2.bias")} for m in range(M)],
    }
    return _contiguous(params)


def _contiguous(tree):
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_contiguous(v) for v in tree]
    return tree.contiguous()


def load_reference_checkpoint(path: str, cfg: ModelConfig) -> Dict[str, Any]:
    """A reference ``model.pth`` as the port's tree (CPU tensors in the
    file's dtype). Reads tensors only (``weights_only``)."""
    return convert_reference_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                                        cfg)


def reference_state_dict(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_reference_state_dict``: the port's tree as a
    reference state_dict (CPU tensors, as ``torch.save`` of the reference
    model writes them)."""
    M, H, hs = cfg.num_modalities, cfg.n_head, cfg.head_size
    hs2 = hs // 2
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, t: torch.Tensor) -> None:
        out[key] = t.detach().cpu().contiguous()

    for i, t in enumerate(params["pre"]["tok_emb"]):
        put(f"pre_block.token_embedding_tables.{i}.weight", t)
    put("pre_block.position_embedding_table.weight", params["pre"]["pos_emb"])
    for l, block in enumerate(params["blocks"]):
        pb = f"blocks.{l}"
        sa = block["sa"]
        for m in range(M):
            for name, ref in _QKV:
                head = f"{pb}.sa_layers.{m}.heads.{{h}}.{ref}"
                for h in range(H):
                    put(f"{head}.0.weight".format(h=h), sa[f"w1_{name}"][m][:, h * hs2:(h + 1) * hs2].T)
                    put(f"{head}.0.bias".format(h=h), sa[f"b1_{name}"][m][h * hs2:(h + 1) * hs2])
                    put(f"{head}.2.weight".format(h=h), sa[f"w2_{name}"][m][h].T)
            for n, ref in (("1", "0"), ("2", "2")):
                put(f"{pb}.sa_layers.{m}.proj.{ref}.weight", sa[f"proj_w{n}"][m].T)
                put(f"{pb}.sa_layers.{m}.proj.{ref}.bias", sa[f"proj_b{n}"][m])
                put(f"{pb}.ffwd_layers.{m}.net.{ref}.weight", block["ffwd"][f"w{n}"][m].T)
                put(f"{pb}.ffwd_layers.{m}.net.{ref}.bias", block["ffwd"][f"b{n}"][m])
            for ln in ("ln1", "ln2"):
                put(f"{pb}.{ln}_layers.{m}.weight", block[ln]["scale"][m])
                put(f"{pb}.{ln}_layers.{m}.bias", block[ln]["bias"][m])
        for i in _cross_modalities(cfg):
            cp, cb = block["cross"][str(i)], f"{pb}.cross_attention_layers.{i}"
            for h in range(H):
                put(f"{cb}.heads.{h}.query.weight", cp["q_w"][h].T)
                for j in range(M - 1):
                    put(f"{cb}.heads.{h}.kv_projections.{j}.weight", cp["kv_w"][j, h].T)
            for n, ref in (("1", "0"), ("2", "2")):
                put(f"{cb}.proj.{ref}.weight", cp[f"proj_w{n}"].T)
                put(f"{cb}.proj.{ref}.bias", cp[f"proj_b{n}"])
            put(f"{pb}.ln_cross_layers.{i}.weight", cp["ln_scale"])
            put(f"{pb}.ln_cross_layers.{i}.bias", cp["ln_bias"])
    post = params["post"]
    for m in range(M):
        put(f"post_block.fin_norm_layers.{m}.weight", post["ln_scale"][m])
        put(f"post_block.fin_norm_layers.{m}.bias", post["ln_bias"][m])
        for n, ref in (("1", "0"), ("2", "2")):
            put(f"post_block.soft_score_layers.{m}.{ref}.weight", post["heads"][m][f"w{n}"].T)
            put(f"post_block.soft_score_layers.{m}.{ref}.bias", post["heads"][m][f"b{n}"])
    return out
