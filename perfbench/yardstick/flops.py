"""The frozen arithmetic of the benchmark: peaks of one NVIDIA H100 SXM,
the model FLOPs of a training step and of a forecast, and the least time
of the attention work of a step or a request.

Peaks: NVIDIA's data sheet, dense rates at the full 700 W: 989 TFLOP/s
in bf16, 3.35 TB/s of HBM.

Model FLOPs count matmuls only (elementwise work, the embedding gather and
recomputation are left out), with the factored q/k/v projections as the
model has them (Quirk Q6): per token, layer and modality 3 (H C hs/2 + H
hs/2 hs) for q/k/v, 2 T C for the attention products over the whole
tile grid, C^2 for the output projection, 8 C^2 for the feed-forward;
per cross-attending modality C^2 + 2 J C^2 + 2 J T C + C^2; the heads
C V/2 + V/2 V a token. A training step is 3x its forward.

Least time of an attention kernel: the larger of its operations over the
bf16 peak and its bytes over the HBM peak, each input read once and each
output written once, the causal triangle T (T + 1) / 2 of the scores.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12
WHOLE_ROW_MAX_T = 512
BF16 = 2
F32 = 4


def _macs_per_token(spec, T: int) -> Tuple[float, float]:
    """(MACs a token of all layers, MACs a token of the heads)."""
    C, H, M = spec.n_embd, spec.n_head, spec.num_modalities
    hs = C // H
    hs2 = hs // 2
    per_mod = (3 * (H * C * hs2 + H * hs2 * hs) + 2 * T * C
               + (H * hs) * (C // 2) + (C // 2) * C + 8 * C * C)
    cross = 0
    for on in spec.cross_attention:
        if on and M > 1:
            J = M - 1
            cross += H * C * hs + J * H * C * 2 * hs + J * 2 * T * C + (H * hs) * (C // 2) + (C // 2) * C
    heads = sum(C * (V // 2) + (V // 2) * V for V in spec.vocab_sizes)
    return spec.n_layer * (M * per_mod + cross), heads


def training_flops_per_step(spec, batch: int) -> float:
    layers, heads = _macs_per_token(spec, spec.block_size)
    return 3.0 * 2.0 * (layers + heads) * batch * spec.block_size


def forecast_flops(spec, batch: int, T: int) -> float:
    """Forward FLOPs of one next-bar forecast of ``batch`` series over a
    window of T: every layer at every position, the head of the forecast
    modality at the last position only."""
    layers, _ = _macs_per_token(spec, T)
    C = spec.n_embd
    V = spec.vocab_sizes[0]
    return 2.0 * (layers * T + C * (V // 2) + (V // 2) * V) * batch


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES)


def attention_least_seconds(spec, batch: int, T: int, training: bool) -> Dict[str, float]:
    """Least seconds of the attention work of one forward (and, training,
    its backward), by kernel kind, at the model's shapes."""
    M, C, H = spec.num_modalities, spec.n_embd, spec.n_head
    hs = C // H
    hs2, D = hs // 2, H * hs // 2
    tri = T * (T + 1) // 2
    n_cross = sum(1 for on in spec.cross_attention if on and M > 1)
    J = M - 1
    L = spec.n_layer
    out: Dict[str, float] = {}
    if T <= WHOLE_ROW_MAX_T:
        # self-attention: projection and attention in one kernel
        w_bytes = F32 * (M * C * 3 * D + M * 3 * D + M * 3 * H * hs2 * hs)
        proj = 2 * M * batch * T * (C * 3 * D + 3 * H * hs2 * hs)
        fwd = proj + 2 * 2 * M * batch * H * tri * hs
        fwd_b = BF16 * M * batch * T * C + w_bytes + BF16 * M * H * batch * T * hs
        out["self_fwd"] = L * _bound(fwd, fwd_b)
        n = H * batch
        out["cross_fwd"] = L * n_cross * _bound(J * 2 * 2 * n * tri * hs,
                                                BF16 * n * T * hs * (1 + 2 * J + 1))
        if training:
            bwd = (proj + 5 * 2 * M * batch * H * tri * hs
                   + 2 * 2 * M * batch * T * 3 * H * hs2 * hs + 2 * 2 * M * batch * T * 3 * D * C)
            bwd_b = (BF16 * M * batch * T * C * 2 + BF16 * M * H * batch * T * hs * 2
                     + 2 * w_bytes)
            out["self_bwd"] = L * _bound(bwd, bwd_b)
            out["cross_bwd"] = L * n_cross * _bound(J * 5 * 2 * n * tri * hs,
                                                    BF16 * n * T * hs * (3 + 4 * J))
        return out
    n = M * batch * H
    plane = n * T * hs * BF16
    out["self_fwd"] = L * _bound(2 * 2 * n * tri * hs, 4 * plane + n * T * F32)
    nc = batch * H
    cplane = nc * T * hs * BF16
    res = (J * cplane + J * nc * T * F32) if training else 0
    out["cross_fwd"] = L * n_cross * _bound(J * 2 * 2 * nc * tri * hs, (2 + 2 * J) * cplane + res)
    if training:
        out["self_bwd"] = L * _bound(5 * 2 * n * tri * hs, 8 * plane + n * T * F32)
        out["cross_bwd"] = L * n_cross * J * _bound(5 * 2 * nc * tri * hs, 8 * cplane + nc * T * F32)
    return out
