#!/usr/bin/env python3
"""Variants of the bf16 whole-row forward (K2f, K3f, K4f) on one NVIDIA GPU.

    python3 chip_variants.py

Copies the port's kernel sources into a temporary directory once per
variant, edits a line or two of ``ops/csrc/short_attention_fwd.cuh`` (the
mma.sync body), builds each copy of the two sources that hold the forward
(every nvcc at once), and per variant prints the registers and spill bytes
of the mma.sync instances, the first bf16 gate of each forward at its
production shape (max-abs error against the plain version, dropout 0,
limit 2e-2, run twice for the same bits) and the device time of each
forward at production, at B = 1 and with dropout 0.2. Variants:

- ``base``: the sources as they are (timed first and last);
- ``warps1``, ``warps2``: blocks of 1 or 2 warps (16 or 32 query rows)
  in place of 4;
- ``stages2``: a ring of two cp.async stages in place of three;
- ``regs168``: the kernel capped to three blocks an SM
  (``__launch_bounds__(128, 3)``);
- ``divide``: o_j divided by l_j (1 - rate) element by element in place of
  the multiplication by its reciprocal;
- ``mask_late``: the causal mask one column late (a mutation: every gate
  must fail).

Exits non-zero when a variant does not build, a variant but the mutation
fails a gate, or the mutation passes one. Needs a CUDA device and the port package beside this
file; the last line is a JSON summary.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent
FWD = "short_attention_fwd.cuh"
SOURCES = ("short_cross_attention", "short_causal_attention")
MASK = "mask_scale<kSn>(s, ns, k0, qrow, a.sl2, mt, lane);"
BOUNDS = "__launch_bounds__(kFwdThreads) short_fwd_mma_kernel"
# variant: the (line, replacement) pairs of its edit
EDITS = {
    "base": [],
    "warps1": [("constexpr int kFwdWarps = 4;", "constexpr int kFwdWarps = 1;")],
    "warps2": [("constexpr int kFwdWarps = 4;", "constexpr int kFwdWarps = 2;")],
    "stages2": [("constexpr int kFwdStages = 3;", "constexpr int kFwdStages = 2;")],
    "regs168": [(BOUNDS, "__launch_bounds__(kFwdThreads, 3) short_fwd_mma_kernel")],
    "divide": [("l[h] = __frcp_rn(quad_sum(l[h]) * a.keepf);", "l[h] = quad_sum(l[h]) * a.keepf;"),
               ("acc[dt][i] += o[dt][i] * l[i >> 1];", "acc[dt][i] += o[dt][i] / l[i >> 1];")],
    "mask_late": [(MASK, "const int late[2] = {qrow[0] + 1, qrow[1] + 1};\n"
                         "      mask_scale<kSn>(s, ns, k0, late, a.sl2, mt, lane);")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "chip_smoke.py").is_file():
        print("chip_variants: chip_smoke.py and the port package are not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as S
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K

    S.emit(S.smi())
    signatures = {n: K._SIGNATURES[n] for n in SOURCES}
    work = Path(tempfile.mkdtemp(prefix="tat_variants_"))
    try:
        trees = {}
        for tag, edit in EDITS.items():
            csrc = work / tag / "csrc"
            shutil.copytree(K._CSRC, csrc)
            src = (csrc / FWD).read_text()
            for old, new in edit:
                if src.count(old) != 1:
                    raise RuntimeError(f"variant {tag}: {old!r} is not in {FWD} once")
                src = src.replace(old, new)
            (csrc / FWD).write_text(src)
            trees[tag] = csrc

        def use(tag):  # point the kernels module at a variant's sources
            K._CSRC, K._BUILD = trees[tag], trees[tag].parent / "_build"
            K._SIGNATURES = dict(signatures)
            K._libs.clear()

        procs = []
        for tag in trees:
            use(tag)
            K._BUILD.mkdir()
            for name in SOURCES:
                so = K._BUILD / f"lib{name}-{K._digest(name)}.so"
                procs.append((tag, name, so, subprocess.Popen(
                    [K._nvcc(), *K.NVCC_FLAGS, "-o", str(so), str(K._CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        registers = {}
        for tag, name, so, proc in procs:
            log, _ = proc.communicate()
            so.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"variant {tag}, {name}: nvcc exit {proc.returncode}:\n{log}")
            for f in S.ptxas_report(log):
                if "short_fwd_mma_kernel" in f["function"]:
                    registers.setdefault(tag, {})[f["function"]] = (
                        f["registers"], f.get("spill_stores", 0))

        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(0)

        def randn(*shape):
            return torch.randn(shape, generator=gen).to(dev).bfloat16()

        q2, k2, v2 = randn(192, 64, 64), randn(3, 192, 64, 64), randn(3, 192, 64, 64)
        b2 = (q2[:6].contiguous(), k2[:, :6].contiguous(), v2[:, :6].contiguous())
        x3 = [randn(768, 56, 64) for _ in range(3)]
        b3 = [x[:24].contiguous() for x in x3]
        x4 = randn(128, 18, 64, 64)
        b4 = x4[:4].contiguous()
        forwards = {
            "short_cross_attention": (
                lambda *r: K.short_cross_attention(q2, k2, v2, *r),
                lambda: K.short_cross_attention(*b2),
                lambda: K.short_cross_attention_plain(q2, k2, v2)),
            "short_causal_attention": (
                lambda *r: K.short_causal_attention(*x3, *r),
                lambda: K.short_causal_attention(*b3),
                lambda: K.short_causal_attention_plain(*x3)),
            "short_causal_attention_packed": (
                lambda *r: K.short_causal_attention_packed_fwd(x4, 6, *r),
                lambda: K.short_causal_attention_packed_fwd(b4, 6),
                lambda: K.short_causal_attention_packed_plain(x4, 6)),
        }
        summary, failed = {}, []
        for tag in list(EDITS) + ["base"]:
            use(tag)
            K.build_kernels()
            row = {"variant": tag, "registers_spill": registers[tag]}
            for name, (run, run_b1, plain) in forwards.items():
                out, again = run(), run()
                torch.cuda.synchronize()
                err = (out.float() - plain().float()).abs().max().item()
                same = bool(torch.equal(out, again))
                ok = err <= S.TOL["bfloat16"] and same
                if (tag == "mask_late") == ok:
                    failed.append((tag, name))
                row[name] = {"max_abs_err": err, "same_bits": same,
                             "ms": S.device_ms(run), "ms_b1": S.device_ms(run_b1),
                             "ms_dropout": S.device_ms(lambda: run(0.2, S.SALTS))}
            S.emit(row)
            summary.setdefault(tag, []).append(
                {n: row[n]["ms"] for n in forwards})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    S.emit({"card": S.smi(), "ms_by_variant": summary, "failed": failed, "ok": not failed})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
