#!/usr/bin/env python3
"""Variants of the port's mma.sync and warp-per-row bodies on one NVIDIA GPU.

    python3 chip_variants.py [group ...] [--against DIR]

Copies the port's kernel sources into a temporary directory once per
variant, edits a line or two of one source, builds each copy of the sources
that hold the body (every nvcc at once), and per variant prints the
registers and spill bytes of the body's instances, the first gate of each
entry at its production shape (max-abs error against the plain version,
dropout 0, bf16 limit 2e-2, run twice for the same bits) and the device
time of each entry at production, at B = 1 and (where it has dropout) at
dropout 0.2. Groups (all by default):

- ``whole_row``: the bf16 whole-row forward (K2f, K3f, K4f;
  ``ops/csrc/short_attention_fwd.cuh``). ``base``: the sources as they are
  (timed first and last); ``warps1``, ``warps2``: blocks of 1 or 2 warps in
  place of 4; ``stages2``: a ring of two cp.async stages in place of three;
  ``regs168``: the kernel capped to three blocks an SM; ``divide``: o_j
  divided by l_j (1 - rate) element by element in place of the
  multiplication by its reciprocal; ``mask_late``: the causal mask one
  column late (a mutation: every gate must fail).
- ``fused_qkv``: K1f's bf16 body (``ops/csrc/fused_qkv_attention.cu``).
  ``pair_stages3``: two-row blocks with three ring stages, one block an SM;
  ``pair_1block``: two-row blocks with two stages, uncapped registers (one
  block an SM); ``one_stages2``: one-row blocks (B = 1) with two stages in
  place of three; ``one_4warps``: one-row blocks of 4 warps, each holding
  all three groups, in place of 12 warps, one a group; ``chunk64``:
  contraction chunks of 64 in place of 32; ``rows1``: one-row blocks at
  every B in place of two-row blocks at even B; ``mask_late`` (mutation);
  ``no_loads`` (diagnostic: the ring's loads past its first stages and its
  waits taken out, so the time is that of the warps' own chains).
- ``decode``: the warp-per-row decode body (K8, K8p, K8q;
  ``ops/csrc/decode_attention.cu``) at the production cache (S 64) and the
  long rows (S 1024), timed at pos = S - 2 and gated there and at pos = 2
  (the mutation is held to the gates where one column matters, see
  ``entries``). ``batch_half``: half the position steps a batch of loads;
  ``v_early``: the value rows loaded with the key rows (before the scores)
  in place of after the scores; ``rows2``, ``rows8``: 2 or 8 rows a block
  in place of 4;
  ``rowwarps4``: at most 4 warps a long row in place of 8;
  ``rowwarps_max``: every long row on the most warps its positions give (at
  most 8), in place of fewer where the rows' blocks do not all fit at once;
  ``pos_plus_1``: reading column pos + 1 (mutation); ``one_position``
  (diagnostic: every row read to position 0 only, the time of a row's
  fixed chain).
- ``decode_t``: the transposed-cache decode body (K9, ``decode_t_kernel`` in
  ``ops/csrc/decode_attention.cu``) at the production rows (384, hs 64, S
  1024) and at B = 1 (24 rows), timed and gated at pos = S - 1 and gated at
  pos = 2. ``cluster1`` .. ``cluster8``: that many blocks a row in place of
  the launcher's choice; ``chunk128``, ``chunk256``, ``chunk512``: that
  many positions a block; ``blocks3``: registers capped for three blocks
  an SM in place of two; ``values_smem``: the first value batch by
  ``cp.async`` into shared memory in place of registers; ``v_early``: the
  first value batch issued with the first key batch in place of after the
  scores; ``pos_plus_1`` (mutation, must fail at pos 2) and
  ``local_softmax`` (mutation: each block rounds w against its own max and
  l; must fail at S - 1 wherever a row has more than one block);
  ``one_position`` (diagnostic: every row read to position 0 only).
  ``--against DIR`` adds the variant ``against``: the K9 body of the
  sources in DIR (``trade_aid_multimodal_transformer_tpu_torch/ops/csrc``
  of another checkout, such as the parent commit unpacked with ``git
  archive``), timed first and last, beside ``base``.

Exits non-zero when a variant does not build, a variant but a mutation or a
diagnostic fails a gate, or a mutation passes one where it must fail. Needs
a CUDA device and the port package beside this file; the last line is a JSON
summary.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent

WR_MASK = "mask_scale<kSn>(s, ns, k0, qrow, a.sl2, mt, lane);"
WR_BOUNDS = "__launch_bounds__(kFwdThreads) short_fwd_mma_kernel"
K1_MASK = "wr::mask_scale<kSn>(s, ns, 0, qrow, a.sl2, m2, lane);"
DEC_VIS = "const int n_vis = max(0, min(__ldg(a.pos_p) + 1, S));"
K1_LOAD = ("    if (nx < nk)\n      load_chunk<D, kBR, kGW, NG>(a, k, ring + (nx % kStages) * L::kStage, "
           "row0, nx * kChunkC,\n                                  gs);\n    else\n"
           "      mma::cp_async_commit();")
K1_WAIT = ("    mma::cp_async_wait<kStages - 2>();\n    __syncthreads();  // chunk kt landed; every warp "
           "is done with chunk kt - 1's stage")
DEC_REGS = "  Raw kv[kNB][kMaxC];\n  float sc[kNB];\n"
DEC_V = "  load(kv, sc, vr, a.v_scale, j_begin);  // the values, in flight while the softmax runs\n"
DEC_NB = "static constexpr int kNB = kVec ? (sizeof(KV) == 2 ? 16 : 8) : 4;"
T_VIS = "const int vis = max(0, min(__ldg(ta.pos_p) + 1, S));"
T_MAX = "for (int i = 0; i < C * kTWarps; ++i) mx = fmaxf(mx, cm[i]);"
T_SUM = "for (int i = 0; i < C * kTWarps; ++i) lt += cl[i];"
T_OWN = "for (int i = rank * kTWarps; i < (rank + 1) * kTWarps; ++i)"
T_CHUNK = "    int chunk = (S + C - 1) / C;"
T_V = "  if (nb > 0) load(vb, vr, 0, 0);  // the first values, in flight during the exchanges\n"
T_K = "  if (nb > 0) load(kb, kr, 0, 0);\n"
T_PO = "  float* po = cl + C * kTWarps;\n"
T_ACC = "    if (pass == 0)\n#pragma unroll\n      for (int i = 0; i < kTFeat; ++i) acc[i] = 0.f;\n"
T_SMEM = "  return sizeof(float) * (hp + 2 * kTWarps * kP + sl + 2 * C * kTWarps + C * hp);"
# values_smem: the first value batch (16-byte loads only) by cp.async into
# shared memory after the blocks' P.V sums (an offset of a multiple of 16
# floats), waited for at the first P.V batch
T_CP = """  if (nb > 0) {
    if constexpr (kVec) {
      const int c = min(c0 + lane * kE, last);
#pragma unroll
      for (int i = 0; i < kTFeat; ++i) {
        const unsigned dst = (unsigned)__cvta_generic_to_shared(vsm + (warp * kTFeat + i) * 32 + lane);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst),
                     "l"(vr + (size_t)min(warp * kTFeat + i, hs - 1) * S + c) : "memory");
      }
      asm volatile("cp.async.commit_group;\\n" ::: "memory");
    } else {
      load(vb, vr, 0, 0);
    }
  }
"""
T_WAIT = """    if constexpr (kVec) {
      if (b == 0) {
        asm volatile("cp.async.wait_all;\\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < kTFeat; ++i) vb[i] = vsm[(warp * kTFeat + i) * 32 + lane];
      }
    }
"""

# group -> the edited source, the sources built from it, the body's
# kernels (for the registers), the mutations, the diagnostic variants (timed,
# not gated: their output is not the function), and per variant its (line,
# replacement) pairs
GROUPS = {
    "whole_row": {
        "file": "short_attention_fwd.cuh",
        "sources": ("short_cross_attention", "short_causal_attention"),
        "kernels": ("short_fwd_mma_kernel",),
        "mutations": ("mask_late",),
        "diagnostic": (),
        "edits": {
            "base": [],
            "warps1": [("constexpr int kFwdWarps = 4;", "constexpr int kFwdWarps = 1;")],
            "warps2": [("constexpr int kFwdWarps = 4;", "constexpr int kFwdWarps = 2;")],
            "stages2": [("constexpr int kFwdStages = 3;", "constexpr int kFwdStages = 2;")],
            "regs168": [(WR_BOUNDS, "__launch_bounds__(kFwdThreads, 3) short_fwd_mma_kernel")],
            "divide": [("l[h] = __frcp_rn(quad_sum(l[h]) * a.keepf);",
                        "l[h] = quad_sum(l[h]) * a.keepf;"),
                       ("acc[dt][i] += o[dt][i] * l[i >> 1];", "acc[dt][i] += o[dt][i] / l[i >> 1];")],
            "mask_late": [(WR_MASK, "const int late[2] = {qrow[0] + 1, qrow[1] + 1};\n"
                                    "      mask_scale<kSn>(s, ns, k0, late, a.sl2, mt, lane);")],
        },
    },
    "fused_qkv": {
        "file": "fused_qkv_attention.cu",
        "sources": ("fused_qkv_attention",),
        "kernels": ("fqkv_fwd_mma_kernel",),
        "mutations": ("mask_late",),
        "diagnostic": ("no_loads",),
        "edits": {
            "base": [],
            "pair_stages3": [("constexpr int kStagesPair = 2;", "constexpr int kStagesPair = 3;"),
                             ("constexpr int kPairBlocksPerSM = 2;",
                              "constexpr int kPairBlocksPerSM = 1;")],
            "pair_1block": [("constexpr int kPairBlocksPerSM = 2;",
                             "constexpr int kPairBlocksPerSM = 1;")],
            "one_stages2": [("constexpr int kStagesOne = 3;", "constexpr int kStagesOne = 2;")],
            "one_4warps": [("constexpr int kGroupWarpsOne = 3;", "constexpr int kGroupWarpsOne = 1;")],
            "chunk64": [("constexpr int kChunkC = 32;", "constexpr int kChunkC = 64;")],
            "rows1": [("const bool pair = B % 2 == 0;", "const bool pair = false;")],
            "mask_late": [(K1_MASK, "const int late[2] = {qrow[0] + 1, qrow[1] + 1};\n"
                                    "      wr::mask_scale<kSn>(s, ns, 0, late, a.sl2, m2, lane);")],
            "no_loads": [(K1_LOAD, "    mma::cp_async_commit();"), (K1_WAIT, "")],
        },
    },
    "decode": {
        "file": "decode_attention.cu",
        "sources": ("decode_attention",),
        "kernels": ("decode_warp_kernel",),
        "mutations": ("pos_plus_1",),
        "diagnostic": ("one_position",),
        "edits": {
            "base": [],
            "batch_half": [(DEC_NB, "static constexpr int kNB = kVec ? (sizeof(KV) == 2 ? 8 : 4) : 2;")],
            "v_early": [(DEC_REGS, "  Raw kv[kNB][kMaxC], vv[kNB][kMaxC];\n  float sc[kNB], vsc[kNB];\n"
                                   "  load(vv, vsc, vr, a.v_scale, j_begin);\n"),
                        (DEC_V, "#pragma unroll\n  for (int u = 0; u < kNB; ++u) {\n"
                                "    sc[u] = vsc[u];\n#pragma unroll\n"
                                "    for (int ci = 0; ci < kMaxC; ++ci) kv[u][ci] = vv[u][ci];\n  }\n")],
            "rows2": [("constexpr int kRowWarps = 4;", "constexpr int kRowWarps = 2;")],
            "rows8": [("constexpr int kRowWarps = 4;", "constexpr int kRowWarps = 8;")],
            "rowwarps4": [("constexpr int kMaxRowWarps = 8;", "constexpr int kMaxRowWarps = 4;")],
            "rowwarps_max": [("if (err != cudaSuccess || (long long)per_sm * sms >= n) break;",
                              "break;")],
            "pos_plus_1": [(DEC_VIS, "const int n_vis = max(0, min(__ldg(a.pos_p) + 2, S));")],
            "one_position": [(DEC_VIS, "const int n_vis = min(1, max(0, min(__ldg(a.pos_p) + 1, S)));")],
        },
    },
    "decode_t": {
        "file": "decode_attention.cu",
        "sources": ("decode_attention",),
        "kernels": ("decode_t_kernel", "decode_kernel"),  # and the first body's (--against)
        "mutations": ("pos_plus_1", "local_softmax"),
        "diagnostic": ("one_position",),
        "edits": {
            "base": [],
            **{f"cluster{c}": [(T_CHUNK, f"    int chunk = (S + {c} - 1) / {c};")]
               for c in (1, 2, 4, 8)},
            **{f"chunk{c}": [(T_CHUNK, f"    int chunk = {c};")] for c in (128, 256, 512)},
            "blocks3": [("__launch_bounds__(kTThreads, 2) decode_t_kernel",
                         "__launch_bounds__(kTThreads, 3) decode_t_kernel")],
            "values_smem": [(T_PO, T_PO + "  uint4* vsm = reinterpret_cast<uint4*>(po + C * hp);\n"),
                            (T_V, T_CP), (T_ACC, T_WAIT + T_ACC),
                            (T_SMEM, T_SMEM[:-1] + " + (kVec ? sizeof(uint4) * kTThreads * kTFeat : 0);")],
            "v_early": [(T_V, ""), (T_K, T_K + "  if (nb > 0) load(vb, vr, 0, 0);\n")],
            "pos_plus_1": [(T_VIS, "const int vis = max(0, min(__ldg(ta.pos_p) + 2, S));")],
            "local_softmax": [(T_MAX, T_OWN + " mx = fmaxf(mx, cm[i]);"),
                              (T_SUM, T_OWN + " lt += cl[i];")],
            "one_position": [(T_VIS, "const int vis = min(1, max(0, min(__ldg(ta.pos_p) + 1, S)));")],
        },
    },
}


def entries(group, K, S, dev, gen):
    """name -> (run(*dropout), run at B = 1 or None, plain, has dropout,
    the mutations that must fail its gate: a set, or a function that gives
    it from the variant's build) of a group's entries at their production
    shapes."""
    import torch

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    if group == "whole_row":
        q2, k2, v2 = (randn(192, 64, 64).bfloat16(), randn(3, 192, 64, 64).bfloat16(),
                      randn(3, 192, 64, 64).bfloat16())
        b2 = (q2[:6].contiguous(), k2[:, :6].contiguous(), v2[:, :6].contiguous())
        x3 = [randn(768, 56, 64).bfloat16() for _ in range(3)]
        b3 = [x[:24].contiguous() for x in x3]
        x4 = randn(128, 18, 64, 64).bfloat16()
        b4 = x4[:4].contiguous()
        return {
            "short_cross_attention": (
                lambda *r: K.short_cross_attention(q2, k2, v2, *r),
                lambda: K.short_cross_attention(*b2),
                lambda: K.short_cross_attention_plain(q2, k2, v2), True, {"mask_late"}),
            "short_causal_attention": (
                lambda *r: K.short_causal_attention(*x3, *r),
                lambda: K.short_causal_attention(*b3),
                lambda: K.short_causal_attention_plain(*x3), True, {"mask_late"}),
            "short_causal_attention_packed": (
                lambda *r: K.short_causal_attention_packed_fwd(x4, 6, *r),
                lambda: K.short_causal_attention_packed_fwd(b4, 6),
                lambda: K.short_causal_attention_packed_plain(x4, 6), True, {"mask_late"}),
        }
    if group == "fused_qkv":
        M, B, T, C, H, hs = S.PROD_K1
        x = randn(M, B, T, C).bfloat16()
        w1, b1 = randn(M, C, 3 * H * hs // 2, scale=0.05), randn(M, 3 * H * hs // 2, scale=0.05)
        w2 = randn(M, 3 * H, hs // 2, hs, scale=0.2)
        x_b1 = x[:, :1].contiguous()
        return {"fused_qkv_attention": (
            lambda *r: K.fused_qkv_attention_fwd(x, w1, b1, w2, H, *r),
            lambda: K.fused_qkv_attention_fwd(x_b1, w1, b1, w2, H),
            lambda: K.fused_qkv_attention_plain(x, w1, b1, w2, H), True, {"mask_late"})}
    if group == "decode_t":
        return decode_t_entries(K, S, dev, randn)
    # decode: the production --serve cache (24 B rows, S 64, hs 64, packed by
    # 2) and the long rows (18 B rows at B = 16, S 1024), timed and gated at
    # pos = S - 2 and gated at pos = 2. The mutation (reading pos + 1) must
    # fail the gates where one column moves the result past the bf16 limit:
    # every gate at pos 2 and at S 64; at S - 2 of 1024 one column of 1023
    # is within bf16's rounding (chip_smoke.py's long serve gate), so that
    # gate is reported for it and not required.
    out = {}
    for tag, n, s_len in (("", 24 * 32, 64), ("_long", 18 * 16, 1024)):
        pack, hs = 2, 64
        shape = (n, s_len // pack, pack * hs)
        q = randn(n, 1, hs).bfloat16()
        kp, vp = randn(*shape).bfloat16(), randn(*shape).bfloat16()
        k8, v8 = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)
                  for _ in range(2))
        ks, vs = ((torch.rand(shape[:-1], generator=gen) * 3.5 + 0.5).to(dev) for _ in range(2))
        kd, vd = kp.view(n, s_len, hs), vp.view(n, s_len, hs)
        b1 = 24 if s_len == 64 else 18
        q1, kd1, vd1, kp1, vp1, k81, v81, ks1, vs1 = (
            t[:b1].contiguous() for t in (q, kd, vd, kp, vp, k8, v8, ks, vs))
        for at in (s_len - 2, 2):
            pos = torch.tensor([at], dtype=torch.int32, device=dev)
            name = tag + ("" if at == s_len - 2 else "_pos2")
            timed = at == s_len - 2
            catches = set() if timed and s_len > 64 else {"pos_plus_1"}
            out[f"decode_attention{name}"] = (
                lambda q=q, kd=kd, vd=vd, pos=pos: K.decode_attention(q, kd, vd, pos),
                (lambda q1=q1, kd1=kd1, vd1=vd1, pos=pos: K.decode_attention(q1, kd1, vd1, pos))
                if timed else None,
                lambda q=q, kd=kd, vd=vd, at=at: K.decode_attention_plain(q, kd, vd, at),
                False, catches)
            out[f"decode_attention_packed{name}"] = (
                lambda q=q, kp=kp, vp=vp, pos=pos: K.decode_attention_packed(q, kp, vp, pos),
                (lambda q1=q1, kp1=kp1, vp1=vp1, pos=pos: K.decode_attention_packed(
                    q1, kp1, vp1, pos)) if timed else None,
                lambda q=q, kp=kp, vp=vp, at=at: K.decode_attention_packed_plain(q, kp, vp, at),
                False, catches)
            out[f"decode_attention_packed_q8{name}"] = (
                lambda q=q, k8=k8, v8=v8, ks=ks, vs=vs, pos=pos: K.decode_attention_packed_q8(
                    q, k8, v8, ks, vs, pos),
                (lambda q1=q1, k81=k81, v81=v81, ks1=ks1, vs1=vs1, pos=pos:
                    K.decode_attention_packed_q8(q1, k81, v81, ks1, vs1, pos)) if timed else None,
                lambda q=q, k8=k8, v8=v8, ks=ks, vs=vs, at=at: K.decode_attention_packed_q8_plain(
                    q, k8, v8, ks, vs, at),
                False, catches)
    return out


def decode_t_entries(K, S, dev, randn):
    """K9 at the production rows (chip_smoke.py's K9_PROD, bf16) and at B = 1
    (24 rows), each timed at pos = S - 1 (the whole cache, as
    ``kernel_time``) and gated there and at pos = 2. Reading pos + 1 must
    fail at pos 2; rounding against each block's own max and l must fail at
    S - 1 wherever the launcher splits a row over more than one block."""
    import torch

    n, hs, s_len = S.K9_PROD
    prod = (randn(n, 1, hs).bfloat16(), randn(n, hs, s_len).bfloat16(),
            randn(n, hs, s_len).bfloat16())
    b1 = tuple(t[:24].contiguous() for t in prod)
    out = {}
    for tag, ops in (("", prod), ("_b1", b1)):
        for at in (s_len - 1, 2):
            pos = torch.tensor([at], dtype=torch.int32, device=dev)

            def run(ops=ops, pos=pos):
                return K.decode_attention_t(*ops, pos)

            def split(ops=ops):
                return {"local_softmax"} if K.decode_attention_t_plan(*ops)["cluster"] > 1 else set()

            timed = tag == "" and at == s_len - 1
            out["decode_attention_t" + tag + ("" if at == s_len - 1 else "_pos2")] = (
                run, (lambda pos=pos: K.decode_attention_t(*b1, pos)) if timed else None,
                lambda ops=ops, at=at: K.decode_attention_t_plain(*ops, at), False,
                split if at == s_len - 1 else {"pos_plus_1"})
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "chip_smoke.py").is_file():
        print("chip_variants: chip_smoke.py and the port package are not beside this script",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    against = None
    if "--against" in args:
        i = args.index("--against")
        if i + 1 >= len(args):
            print("chip_variants: --against needs a directory", file=sys.stderr)
            return 2
        against = Path(args[i + 1]).resolve()
        del args[i:i + 2]
        if (against / "trade_aid_multimodal_transformer_tpu_torch").is_dir():
            against = against / "trade_aid_multimodal_transformer_tpu_torch" / "ops" / "csrc"
        if not (against / GROUPS["decode_t"]["file"]).is_file():
            print(f"chip_variants: no {GROUPS['decode_t']['file']} in {against}", file=sys.stderr)
            return 2
    groups = args or list(GROUPS)
    unknown = [g for g in groups if g not in GROUPS]
    if unknown:
        print(f"chip_variants: unknown groups {unknown}; known: {list(GROUPS)}", file=sys.stderr)
        return 2
    if against is not None and "decode_t" not in groups:
        print("chip_variants: --against times the decode_t group", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as S
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K

    S.emit(S.smi())
    signatures = dict(K._SIGNATURES)
    work = Path(tempfile.mkdtemp(prefix="tat_variants_"))
    try:
        trees = {}
        if against is not None:
            trees[("decode_t", "against")] = work / "decode_t" / "against" / "csrc"
            shutil.copytree(against, trees[("decode_t", "against")])
        for group in groups:
            spec = GROUPS[group]
            for tag, edit in spec["edits"].items():
                csrc = work / group / tag / "csrc"
                shutil.copytree(K._CSRC, csrc)
                src = (csrc / spec["file"]).read_text()
                for old, new in edit:
                    if src.count(old) != 1:
                        raise RuntimeError(f"{group} {tag}: {old!r} is not in {spec['file']} once")
                    src = src.replace(old, new)
                (csrc / spec["file"]).write_text(src)
                trees[(group, tag)] = csrc

        def use(key):  # point the kernels module at a variant's sources and their C entries
            K._CSRC, K._BUILD = trees[key], trees[key].parent / "_build"
            K._SIGNATURES = {}
            for n in GROUPS[key[0]]["sources"]:
                text = (K._CSRC / f"{n}.cu").read_text()
                K._SIGNATURES[n] = {f: a for f, a in signatures[n].items() if f"{f}(" in text}
            K._libs.clear()

        procs = []
        for key in trees:
            use(key)
            K._BUILD.mkdir()
            for name in GROUPS[key[0]]["sources"]:
                so = K._BUILD / f"lib{name}-{K._digest(name)}.so"
                procs.append((key, name, so, subprocess.Popen(
                    [K._nvcc(), *K.NVCC_FLAGS, "-o", str(so), str(K._CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        registers = {}
        for key, name, so, proc in procs:
            log, _ = proc.communicate()
            so.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"variant {key}, {name}: nvcc exit {proc.returncode}:\n{log}")
            for f in S.ptxas_report(log):
                if any(k_ in f["function"] for k_ in GROUPS[key[0]]["kernels"]):
                    registers.setdefault(key, {})[f["function"]] = (
                        f["registers"], f.get("spill_stores", 0))

        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(0)
        summary, failed = {}, []
        for group in groups:
            spec = GROUPS[group]
            runs = entries(group, K, S, dev, gen)
            tags = list(spec["edits"]) + ["base"]
            if (group, "against") in trees:
                tags = ["against"] + tags + ["against"]
            for tag in tags:
                use((group, tag))
                K.build_kernels()
                row = {"group": group, "variant": tag,
                       "registers_spill": registers.get((group, tag), {}),
                       "diagnostic": tag in spec["diagnostic"]}
                for name, (run, run_b1, plain, drops, catches) in runs.items():
                    out, again = run(), run()
                    torch.cuda.synchronize()
                    err = (out.float() - plain().float()).abs().max().item()
                    same = bool(torch.equal(out, again))
                    ok = err <= S.TOL["bfloat16"] and same
                    if tag in spec["mutations"]:
                        must_fail = catches() if callable(catches) else catches
                        if ok and tag in must_fail:
                            failed.append((group, tag, name))
                    elif tag not in spec["diagnostic"] and not ok:
                        failed.append((group, tag, name))
                    row[name] = {"max_abs_err": err, "same_bits": same, "ok": ok}
                    if run_b1 is not None:
                        row[name].update(
                            ms=S.device_ms(run), ms_b1=S.device_ms(run_b1),
                            ms_dropout=S.device_ms(lambda: run(0.2, S.SALTS)) if drops else None)
                S.emit(row)
                summary.setdefault(group, {}).setdefault(tag, []).append(
                    {n: row[n]["ms"] for n in runs if "ms" in row[n]})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    S.emit({"card": S.smi(), "ms_by_variant": summary, "failed": failed, "ok": not failed})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
