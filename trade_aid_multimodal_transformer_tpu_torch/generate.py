"""Inference CLI: load a checkpoint and generate tokens (port of the JAX
package's ``tools/generate.py``).

It reads the zero-flag configuration directory (config.yaml +
input_schemas.yaml, or a programmatic config.py), re-runs ingestion and
tokenization so that the vocabularies match training exactly (the vocabulary
is the tokenizer), loads the checkpoint named by ``model_file_name`` (an
``.npz`` of either package, or the reference model's ``.pth`` state_dict),
primes the context with the last ``block_size`` tokens of the dataset, and
samples autoregressively: one full-window forward per token
(models/sampler.py), or with ``--serve`` the KV-cached serving sampler
(models/cache.py: token-exact while the context grows, a chunked refresh
every ``--refresh`` tokens past a full window, ``--kv-dtype int8`` for an
int8 cache). It runs on the device the config names: ``auto``, ``cuda`` and
``gpu`` need a CUDA device and raise without one; ``cpu`` runs on the CPU.

Usage:
    python -m trade_aid_multimodal_transformer_tpu_torch.generate [config_dir]
        [--tokens N] [--modality I] [--seed S] [--checkpoint PATH]
        [--serve [--refresh R] [--kv-dtype int8]]

Prints one line per generated token: the sampled token id and its decoded
value in each modality's vocabulary.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .config.compat import (
    compatibility_layer,
    get_modality_parameters,
    get_system_configuration,
    initialize_compatibility_layer,
    is_modern_mode,
    reset_compatibility_layer,
)
from .config.schema import InputSchema
from .data.ingest import load_and_process_modality
from .data.vocab import numerical_representation
from .models.cache import generate_serve
from .models.config import ModelConfig
from .models.init import init_params
from .models.sampler import generate_fast
from .train.checkpoint import load_checkpoint


def _schemas_from_params(modality_params_list) -> List[InputSchema]:
    """Schemas for ingestion: in modern mode the live schema objects (so
    external steps and declared ordering are preserved); in programmatic mode
    reconstructed from the legacy lists (the JAX package's
    ``train/runner.py``)."""
    if is_modern_mode() and compatibility_layer.config_manager:
        return list(compatibility_layer.config_manager.schema_manager.schemas)
    return [
        InputSchema.from_legacy_list(p, f"Modality {i+1}")
        for i, p in enumerate(modality_params_list)
    ]


def load_config_and_data(config_dir: str = ".") -> Dict[str, Any]:
    """Read the configuration directory and tokenize every modality, as
    training did. Returns the system parameters (``sc``, device resolved:
    raises without CUDA unless the config names the CPU), the ``device``,
    the ``ModelConfig``, per-modality token ids, vocabularies and names."""
    cwd = os.getcwd()
    os.chdir(config_dir)  # config detection is CWD-relative
    here = str(Path.cwd())
    sys.path.insert(0, here)  # programmatic mode imports `config`
    try:
        reset_compatibility_layer()
        initialize_compatibility_layer({})
        sc = get_system_configuration()
        modality_params = get_modality_parameters()
        if not modality_params:
            raise ValueError("no modalities configured")
        schemas = _schemas_from_params(modality_params)
        ids_list, vocabs, names = [], [], []
        with contextlib.redirect_stdout(io.StringIO()):
            for schema in schemas:
                md = load_and_process_modality(schema, quiet=True)
                ids, vocab = numerical_representation(md.data)
                ids_list.append(np.asarray(ids, np.int64))
                vocabs.append(vocab)
                names.append(md.name)
    finally:
        sys.path.remove(here)
        os.chdir(cwd)
    lengths = {len(x) for x in ids_list}
    if len(lengths) != 1:
        raise ValueError(f"modalities have unequal lengths: {sorted(lengths)}")
    cfg = ModelConfig.from_modality_params(sc, [len(v) for v in vocabs], modality_params)
    return {
        "sc": sc, "device": torch.device(sc["device"]), "cfg": cfg,
        "ids": ids_list, "vocabs": vocabs, "names": names,
    }


def run(
    config_dir: str = ".",
    tokens: int = 16,
    modality: int = 0,
    seed: int = 0,
    checkpoint: Optional[str] = None,
    serve: bool = False,
    refresh: Optional[int] = None,
    kv_dtype: Optional[str] = None,
) -> Dict[str, Any]:
    """Generate ``tokens`` tokens for one modality from a configuration
    directory, with ``generate_fast`` or, with ``serve``, ``generate_serve``
    (``refresh`` and ``kv_dtype`` are its options). Returns what
    ``load_config_and_data`` returns, plus the checkpoint description
    (``model``), ``new``: (M, tokens) generated ids, and
    ``last_prompt_tokens``: (M,) the prompt's last ids."""
    data = load_config_and_data(config_dir)
    cfg, device, ids_list = data["cfg"], data["device"], data["ids"]
    if not 0 <= modality < cfg.num_modalities:
        raise ValueError(f"modality must be in [0, {cfg.num_modalities})")
    ckpt = Path(checkpoint) if checkpoint is not None else (
        Path(config_dir) / data["sc"]["model_file_name"]
    )
    if ckpt.exists():
        params, step = load_checkpoint(str(ckpt), cfg, device)
        trained = f"checkpoint {ckpt}" + (f" (step {step})" if step else "")
    elif checkpoint is not None:
        # an explicitly requested checkpoint must exist
        raise FileNotFoundError(f"checkpoint not found: {ckpt}")
    else:
        params = init_params(cfg, torch.Generator().manual_seed(0), device)
        trained = "RANDOM INIT (no checkpoint found — predictions are noise)"

    # prime with the last block_size tokens of each stream
    T0 = min(cfg.block_size, len(ids_list[0]))
    idx = torch.from_numpy(np.stack([x[-T0:] for x in ids_list])[:, None, :]).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if serve:
        out = generate_serve(params, cfg, idx, gen, max_new_tokens=tokens,
                             modality_to_generate=modality, refresh=refresh, kv_dtype=kv_dtype)
    else:
        out = generate_fast(params, cfg, idx, gen, max_new_tokens=tokens,
                            modality_to_generate=modality)
    return dict(
        data, model=trained, new=out[:, 0, T0:].cpu().numpy(),
        last_prompt_tokens=np.stack([x[-1] for x in ids_list]),
    )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config_dir", nargs="?", default=".",
                    help="directory with config.yaml + input_schemas.yaml")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--modality", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="override the config's model_file_name")
    ap.add_argument("--serve", action="store_true",
                    help="KV-cached serving sampler (models/cache.py): token-exact while "
                         "the context grows, chunked-refresh approximation past a full window")
    ap.add_argument("--refresh", type=int, default=None,
                    help="--serve refresh period (default block_size // 8)")
    ap.add_argument("--kv-dtype", default=None, choices=[None, "int8"],
                    help="--serve KV-cache storage type: int8 (quantized, serving only)")
    args = ap.parse_args(argv)
    res = run(args.config_dir, args.tokens, args.modality, args.seed, args.checkpoint,
              args.serve, args.refresh, args.kv_dtype)
    cfg, vocabs, names, new = res["cfg"], res["vocabs"], res["names"], res["new"]
    print(f"Model: {res['model']} on {res['device']}", file=sys.stderr)
    print(f"# generated {args.tokens} tokens for modality {args.modality} "
          f"({names[args.modality]}); other modalities repeat their last value")
    print("step  " + "  ".join(f"{n[:18]:>18}" for n in names))
    for t in range(args.tokens):
        cells = []
        for m in range(cfg.num_modalities):
            tok = int(new[m, t])
            val = vocabs[m][tok] if tok < len(vocabs[m]) else "?"
            cells.append(f"{val!s:>14} #{tok:<3}")
        print(f"{t + 1:>4}  " + "  ".join(cells))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
