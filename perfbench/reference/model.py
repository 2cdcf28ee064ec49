"""The plain reference of the multimodal transformer: float32 PyTorch
operations (TF32 off), no kernels, no cache, the batch in blocks of rows.

Architecture (the program's, SURVEY Quirk Q6 of the upstream model):
token + positional embedding; per block x += SA(LN1(x)), x += FF(LN2(x)),
then each cross-attending modality adds its cross-attention over the
other modalities' post-FF activations; a LayerNorm and a tanh-MLP head
per modality; the loss is the sum over modalities of the mean token
cross-entropy. Self-attention: factored q/k/v projections
Linear(C, hs/2) -> tanh -> Linear(hs/2, hs) per head, causal softmax of
q k^T / sqrt(hs), output Linear(H hs, C/2) -> tanh -> Linear(C/2, C).
Cross-attention: a no-bias query projection, per key/value modality a
no-bias (C, 2 hs) projection, causal attention per stream, the streams
summed. Feed-forward C -> 4C -> ReLU -> C. Dropout (training) at the
attention probabilities and after each projection output, with the
card's masks (masks.py).

``Matmul`` does every product: plain float32, or (the control) each
operand rounded to float8 with a per-tensor scale, and each gradient that
reaches a product rounded the same way in the backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from . import masks

LN_EPS = 1e-5


@dataclass(frozen=True)
class ModelSpec:
    vocab_sizes: Tuple[int, ...]
    cross_attention: Tuple[bool, ...]
    n_embd: int
    n_head: int
    n_layer: int
    block_size: int
    dropout: float
    compute_itemsize: int  # bytes of the stated compute type (the fused mask's batch group)

    @property
    def num_modalities(self) -> int:
        return len(self.vocab_sizes)

    @property
    def head_size(self) -> int:
        return self.n_embd // self.n_head

    @classmethod
    def from_config(cls, conf: Dict[str, Any]) -> "ModelSpec":
        mods = conf["modalities"]
        return cls(tuple(int(m["vocab_size"]) for m in mods),
                   tuple(bool(m["cross_attention"]) for m in mods),
                   int(conf["n_embd"]), int(conf["n_head"]), int(conf["n_layer"]),
                   int(conf["block_size"]), float(conf["dropout"]),
                   2 if conf["compute_dtype"] == "bfloat16" else 4)


# ------------------------------------------------------------------ products

class _RoundForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to the float8 type with one scale for the tensor (its
    largest magnitude at the type's largest finite value)."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).clamp(-top, top).to(dtype).to(x.dtype) / scale


class Matmul:
    """Every product of the reference: ``fp8=False`` plain float32;
    ``fp8=True`` the control, in float8 (e4m3 operands forward, e5m2
    gradients backward, float32 accumulation)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return torch.einsum(eq, a, b)
        out = torch.einsum(eq, _RoundForward.apply(a), _RoundForward.apply(b))
        return _RoundBackward.apply(out)


# -------------------------------------------------------------------- layers

def layernorm(x, scale, bias):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def _drop(x, keep, rate: float):
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


def _causal_softmax(s: torch.Tensor) -> torch.Tensor:
    T = s.shape[-1]
    hidden = torch.ones(T, T, dtype=torch.bool, device=s.device).triu(1)
    return torch.softmax(s.masked_fill(hidden, float("-inf")), dim=-1)


def _keep(seed: int, rows: torch.Tensor, T: int, rate: float) -> torch.Tensor:
    """Attention keep-mask of the band T falls in on the card."""
    if T <= masks.WHOLE_ROW_MAX_T:
        return masks.attention_keep(seed, rows, T, rate)
    return masks.flash_keep(seed, rows, T, rate)


class Forward:
    """One forward over a block of batch rows. ``b_rows``: the global
    indices of the block's rows in a batch of ``B``; ``salts``: the step's
    dropout key, None without dropout (evaluation)."""

    def __init__(self, spec: ModelSpec, mm: Matmul, B: int, b_rows: torch.Tensor,
                 salts: Optional[Tuple[int, int]]):
        self.spec, self.mm, self.B, self.b_rows = spec, mm, B, b_rows
        self.salts = salts
        self.train = salts is not None and spec.dropout > 0.0

    # row indices of the collapsed leading axes of each dropout site
    def _mb_rows(self, M: int) -> torch.Tensor:  # (M, b): m B + b
        return torch.arange(M, device=self.b_rows.device)[:, None] * self.B + self.b_rows[None, :]

    def self_attention(self, h, sa, keys: masks.SiteKeys):
        s = self.spec
        M, b, T, C = h.shape
        H, hs = s.n_head, s.head_size
        mm = self.mm

        def project(name):
            t = torch.tanh(mm("mbtc,mcd->mbtd", h, sa[f"w1_{name}"]) + sa[f"b1_{name}"][:, None, None])
            return mm("mbthd,mhde->mbhte", t.reshape(M, b, T, H, hs // 2), sa[f"w2_{name}"])

        q, k, v = project("q"), project("k"), project("v")
        p = _causal_softmax(mm("mbhtd,mbhsd->mbhts", q, k) * hs ** -0.5)
        site = keys()
        if self.train:
            seed = masks.kernel_seed(site)
            if T <= masks.WHOLE_ROW_MAX_T:
                gb = masks.fused_batch_group(self.B, H, T, hs, C, s.compute_itemsize)
                rows = masks.fused_rows(M, self.b_rows, self.B, H, gb)
            else:
                rows = (self._mb_rows(M)[..., None] * H
                        + torch.arange(H, device=h.device))
            p = _drop(p, _keep(seed, rows, T, s.dropout), s.dropout)
        att = mm("mbhts,mbhsd->mbhtd", p, v)
        out = att.transpose(2, 3).reshape(M, b, T, H * hs)
        t = torch.tanh(mm("mbtd,mdc->mbtc", out, sa["proj_w1"]) + sa["proj_b1"][:, None, None])
        out = mm("mbtc,mcd->mbtd", t, sa["proj_w2"]) + sa["proj_b2"][:, None, None]
        return self._site(out, keys(), self._mb_rows(M))

    def feed_forward(self, h, ff, keys: masks.SiteKeys):
        M = h.shape[0]
        mm = self.mm
        a = torch.relu(mm("mbtc,mcd->mbtd", h, ff["w1"]) + ff["b1"][:, None, None])
        out = mm("mbtd,mdc->mbtc", a, ff["w2"]) + ff["b2"][:, None, None]
        return self._site(out, keys(), self._mb_rows(M))

    def cross_attention(self, y, kv_x, cp, keys: masks.SiteKeys):
        s = self.spec
        b, T, _ = y.shape
        H, hs = s.n_head, s.head_size
        mm = self.mm
        q = mm("btc,hce->bhte", y, cp["q_w"])
        k = mm("jbtc,jhce->jbhte", kv_x, cp["kv_w"][..., :hs])
        v = mm("jbtc,jhce->jbhte", kv_x, cp["kv_w"][..., hs:])
        site = keys()
        if self.train:
            seed = masks.kernel_seed(site)
            hh = torch.arange(H, device=y.device)[None, :]
            if T <= masks.WHOLE_ROW_MAX_T:  # head-major rows h B + b
                rows = hh * self.B + self.b_rows[:, None]
            else:  # rows b H + h
                rows = self.b_rows[:, None] * H + hh
        att = 0.0
        for j in range(kv_x.shape[0]):
            p = _causal_softmax(mm("bhtd,bhsd->bhts", q, k[j]) * hs ** -0.5)
            if self.train:
                p = _drop(p, _keep(masks.stream_seed(seed, j), rows, T, s.dropout), s.dropout)
            att = att + mm("bhts,bhsd->bhtd", p, v[j])
        out = att.transpose(1, 2).reshape(b, T, H * hs)
        t = torch.tanh(mm("btd,dc->btc", out, cp["proj_w1"]) + cp["proj_b1"])
        out = mm("btc,cd->btd", t, cp["proj_w2"]) + cp["proj_b2"]
        return self._site(out, keys(), self.b_rows)

    def _site(self, x, site, rows):
        if not self.train:
            return x
        keep = masks.site_keep(site, rows, x.shape[-2], x.shape[-1], self.spec.dropout)
        return _drop(x, keep, self.spec.dropout)

    def block(self, x, blk, key):
        keys = masks.SiteKeys(key)
        x = x + self.self_attention(layernorm(x, blk["ln1"]["scale"][:, None, None],
                                              blk["ln1"]["bias"][:, None, None]), blk["sa"], keys)
        x = x + self.feed_forward(layernorm(x, blk["ln2"]["scale"][:, None, None],
                                            blk["ln2"]["bias"][:, None, None]), blk["ffwd"], keys)
        if not blk["cross"]:
            return x
        M = x.shape[0]
        updates = {}
        for i_str in sorted(blk["cross"]):
            cp = blk["cross"][i_str]
            i = int(i_str)
            others = [j for j in range(M) if j != i]
            y = layernorm(x[i], cp["ln_scale"], cp["ln_bias"])
            updates[i] = x[i] + self.cross_attention(y, x[others], cp, keys)
        return torch.stack([updates.get(i, x[i]) for i in range(M)])

    def logits(self, params, idx: torch.Tensor) -> List[torch.Tensor]:
        """Per-modality logits (b, T, V_i) of token ids idx (M, b, T)."""
        s = self.spec
        T = idx.shape[-1]
        pre = params["pre"]
        x = torch.stack([pre["tok_emb"][m][idx[m]] for m in range(s.num_modalities)])
        x = x + pre["pos_emb"][:T]
        keys = masks.SiteKeys(self.salts) if self.salts is not None else None
        for blk in params["blocks"]:
            x = self.block(x, blk, keys() if keys is not None else (0, 0))
        post = params["post"]
        h = layernorm(x, post["ln_scale"][:, None, None], post["ln_bias"][:, None, None])
        out = []
        for m, hd in enumerate(post["heads"]):
            t = torch.tanh(self.mm("btc,cd->btd", h[m], hd["w1"]) + hd["b1"])
            out.append(self.mm("btd,dv->btv", t, hd["w2"]) + hd["b2"])
        return out


def row_blocks(B: int, T: int) -> List[Tuple[int, int]]:
    """Blocks of batch rows the reference computes at a time."""
    per = max(1, min(B, (1 << 21) // (T * T)))
    return [(s, min(B, s + per)) for s in range(0, B, per)]


def loss_and_grads(spec: ModelSpec, mm: Matmul, params, wrt: Sequence[torch.Tensor],
                   xb: torch.Tensor, yb: torch.Tensor, salts) -> Tuple[float, List[torch.Tensor]]:
    """The summed per-modality mean cross-entropy of the batch (M, B, T)
    and its gradients with respect to ``wrt``, accumulated over blocks
    of rows."""
    M, B, T = xb.shape
    total = 0.0
    grads = [torch.zeros_like(w) for w in wrt]
    for lo, hi in row_blocks(B, T):
        rows = torch.arange(lo, hi, device=xb.device)
        logits = Forward(spec, mm, B, rows, salts).logits(params, xb[:, lo:hi])
        loss = 0.0
        for m, lg in enumerate(logits):
            logp = torch.log_softmax(lg, dim=-1)
            loss = loss - logp.gather(-1, yb[m, lo:hi, :, None])[..., 0].sum() / (B * T)
        for g, d in zip(grads, torch.autograd.grad(loss, list(wrt))):
            g += d
        total += float(loss.detach())
    return total, grads


@torch.no_grad()
def last_logits(spec: ModelSpec, mm: Matmul, params, idx: torch.Tensor,
                modality: int) -> torch.Tensor:
    """Logits (B, V) of ``modality`` at the last position of idx (M, B, T),
    without dropout, in blocks of rows."""
    M, B, T = idx.shape
    out = []
    for lo, hi in row_blocks(B, T):
        rows = torch.arange(lo, hi, device=idx.device)
        out.append(Forward(spec, mm, B, rows, None).logits(params, idx[:, lo:hi])[modality][:, -1])
    return torch.cat(out)


class AdamW:
    """AdamW as the configuration states it (betas 0.9 / 0.999, eps 1e-8,
    weight decay 0.01 on every parameter, constant learning rate), with
    both moments and all arithmetic in float32."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 wd: float = 0.01):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, wd
        self.count = 0

    @torch.no_grad()
    def step(self, ps, gs, ms, vs) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(ps, gs, ms, vs):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g.square(), alpha=1.0 - self.b2)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps) + self.wd * p
            p.sub_(self.lr * u)
