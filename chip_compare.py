#!/usr/bin/env python3
"""Device times of the training path's kernels in two checkouts, on one card.

    python3 chip_compare.py PARENT_DIR [--rounds 1]

PARENT_DIR is another checkout of this repository (for instance the parent
commit, unpacked with ``git archive HEAD | tar -x -C dev_scratch/parent``).
In turns (parent, this checkout, this checkout, parent; ``--rounds``
times), a process of its own for each checkout builds that checkout's
kernels into its own ``ops/_build/`` and times K1f, K1b, K2f, K2b, K5f, K5b,
K6f-r and the ring's chunk pair K7f / K7b (causal and full mask) at the
production shapes of ``chip_smoke.py`` (bf16, dropout 0 and 0.2; device time
behind a spin kernel, ``chip_smoke.device_ms``), where the checkout's K7
takes a row base (modality x sequence parallelism) K7 with one as well, and,
where
the checkout's flash kernels take a row map (data parallelism), K5f and K5b
on half the self-attention rows with and without one, and with a map of two
levels (a head level inside the batch level, data x tensor parallelism)
where they take one. Prints one JSON line
per process (the checkout, the card, the times, the flash kernels'
registers and spills at D = 64) and, last, the change's median over the
parent's for each time. Needs a CUDA device.
"""

from __future__ import annotations

import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def time_checkout(root: Path, label: str) -> dict:
    """The times of one checkout's kernels (run in a process of its own)."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as S
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K

    if not Path(K.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {K.__file__}, not the kernels of {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    K.build_kernels()
    regs = [(f["function"][:64], f.get("registers"), f.get("spill_stores"))
            for f in S.ptxas_report(K.build_log("flash_attention")) if "ILi64" in f["function"]]
    g = torch.Generator().manual_seed(0)
    dev, bf = torch.device("cuda"), torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    M, B, T, C, H, hs = S.PROD_K1
    x, do1 = randn(M, B, T, C).to(bf), randn(M, H, B, T, hs).to(bf)
    w1, b1 = randn(M, C, 3 * H * hs // 2, scale=0.05), randn(M, 3 * H * hs // 2, scale=0.05)
    w2 = randn(M, 3 * H, hs // 2, hs, scale=0.2)
    o1 = K.fused_qkv_attention_fwd(x, w1, b1, w2, H, 0.2, S.SALTS)
    J2, n2 = 3, 6 * 32
    q2, d2 = randn(n2, 64, 64).to(bf), randn(n2, 64, 64).to(bf)
    k2, v2 = randn(J2, n2, 64, 64).to(bf), randn(J2, n2, 64, 64).to(bf)
    n5, T5, h5 = S.FLASH_PROD
    q5, k5, v5, d5 = (randn(n5, T5, h5).to(bf) for _ in range(4))
    o5, l5 = K.flash_attention_fwd(q5, k5, v5, 0.2, S.SALTS)
    J6, n6, T6, h6 = S.FLASH_CROSS_PROD
    q6 = randn(n6, T6, h6).to(bf)
    k6, v6 = randn(J6, n6, T6, h6).to(bf), randn(J6, n6, T6, h6).to(bf)
    n7, tq7, tk7, h7 = S.CP_SELF
    q7, o7g = randn(n7, tq7, h7).to(bf), randn(n7, tq7, h7).to(bf)
    k7, v7 = randn(n7, tk7, h7).to(bf), randn(n7, tk7, h7).to(bf)
    o7, l7 = K.flash_chunk_fwd(q7, k7, v7, True, 12345, 0.2)
    t = {}
    for rate in (0.0, 0.2):
        s = S.SALTS if rate else None
        t[f"K1f_{rate}"] = S.device_ms(
            lambda: K.fused_qkv_attention_fwd(x, w1, b1, w2, H, rate, s))
        t[f"K1b_{rate}"] = S.device_ms(
            lambda: K.fused_qkv_attention_bwd(x, w1, b1, w2, o1, do1, H, rate, s))
        t[f"K2f_{rate}"] = S.device_ms(lambda: K.short_cross_attention_fwd(q2, k2, v2, rate, s))
        t[f"K2b_{rate}"] = S.device_ms(
            lambda: K.short_cross_attention_bwd(q2, k2, v2, d2, rate, s))
        t[f"K5f_{rate}"] = S.device_ms(lambda: K.flash_attention_fwd(q5, k5, v5, rate, s))
        t[f"K5b_{rate}"] = S.device_ms(
            lambda: K.flash_attention_bwd(q5, k5, v5, o5, l5, d5, rate, s))
        t[f"K6fr_{rate}"] = S.device_ms(lambda: K.flash_cross_attention_res(q6, k6, v6, rate, s))
        seed = 12345 if rate else None
        for mask, causal in (("causal", True), ("full", False)):
            t[f"K7f_{mask}_{rate}"] = S.device_ms(
                lambda: K.flash_chunk_fwd(q7, k7, v7, causal, seed, rate))
            t[f"K7b_{mask}_{rate}"] = S.device_ms(
                lambda: K.flash_chunk_bwd(q7, k7, v7, o7, l7, o7g, causal, seed, rate))
    if "base" in inspect.signature(K.flash_chunk_fwd).parameters:
        # modality place 1 of {mod: 2} x seq: the rows from base n / 2 (the mapped instance)
        t["K7f_causal_based"] = S.device_ms(
            lambda: K.flash_chunk_fwd(q7, k7, v7, True, 12345, 0.2, n7 // 2))
        t["K7b_causal_based"] = S.device_ms(
            lambda: K.flash_chunk_bwd(q7, k7, v7, o7, l7, o7g, True, 12345, 0.2, n7 // 2))
    if "rows" in inspect.signature(K.flash_attention_fwd).parameters:
        # as many rows as data rank 1 of 2 holds of the (M 4, B 8, H 6) rows,
        # with its map (span, skip and base B/2 H = 24) and without one
        half, rows = n5 // 2, (4 * 6,) * 3
        qh, kh, vh, dh = (a[:half].contiguous() for a in (q5, k5, v5, d5))
        oh, lh = K.flash_attention_fwd(qh, kh, vh, 0.2, S.SALTS)
        maps = [("one_rank", None), ("mapped", rows)]
        from trade_aid_multimodal_transformer_tpu_torch.ops import layers

        if "head_axis" in inspect.signature(layers.batch_row_map).parameters:
            # rank (1, 1) of {data: 2, model: 2}: rows (4, 4, 3) of (4, 8, 6)
            maps.append(("two_levels", (24, 24, 27, 3, 3)))
        for name, rw in maps:
            t[f"K5f_half_{name}"] = S.device_ms(
                lambda: K.flash_attention_fwd(qh, kh, vh, 0.2, S.SALTS, rw))
            t[f"K5b_half_{name}"] = S.device_ms(
                lambda: K.flash_attention_bwd(qh, kh, vh, oh, lh, dh, 0.2, S.SALTS, rows=rw))
    return {"checkout": label, "root": str(root), "card": S.smi(), "ms": t, "flash_d64": regs}


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(time_checkout(Path(sys.argv[2]).resolve(), sys.argv[3])), flush=True)
        return 0
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 2
    order = [("parent", args.parent.resolve()), ("change", HERE),
             ("change", HERE), ("parent", args.parent.resolve())] * max(1, args.rounds)
    runs = []
    for label, root in order:
        out = subprocess.run([sys.executable, __file__, "--child", str(root), label],
                             capture_output=True, text=True, check=True).stdout
        runs.append(json.loads(out.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    ratio = {}
    change = [r for r in runs if r["checkout"] == "change"]
    if "K5f_half_two_levels" in change[0]["ms"]:  # the change's two levels over its one
        for k in ("K5f", "K5b"):
            ratio[f"{k}_two_levels_over_mapped"] = statistics.median(
                r["ms"][f"{k}_half_two_levels"] / r["ms"][f"{k}_half_mapped"] for r in change)
    if "K7f_causal_based" in change[0]["ms"]:  # the change's K7 with a row base over without
        for k in ("K7f", "K7b"):
            ratio[f"{k}_causal_based_over_unbased"] = statistics.median(
                r["ms"][f"{k}_causal_based"] / r["ms"][f"{k}_causal_0.2"] for r in change)
    for key in runs[0]["ms"]:
        par = statistics.median(r["ms"][key] for r in runs if r["checkout"] == "parent")
        chg = statistics.median(r["ms"][key] for r in runs if r["checkout"] == "change")
        ratio[key] = chg / par
    print(json.dumps({"change_over_parent": ratio}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
