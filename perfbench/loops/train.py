"""The training loop: the program's ``Trainer.train_chunk`` over its
``BatchFeed``, built as the program's training entry builds them
(``make_optimizer``, the per-leaf AdamW of the configuration), closed
loop, one step after another.

Set-up builds the trainer, drives it through its first three steps (the
steps the reference follows) and hands the same object to the window,
which runs steps for ``--seconds``; with ``--trace 1`` a fixed slice of
steps after the window runs under the profiler.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Dict, List

import torch

from .. import harness, inputs
from ..reference import feed as ref_feed
from ..reference import model as ref_model
from ..reference import params as ref_params
from ..yardstick import compare, trace

FIRST_STEPS = 3
TRACED_STEPS = 3
FAULTS = ("unchanged", "half", "loss")


def batch_size(cell) -> int:
    """Rows a step: the traffic's tokens a step over block_size x modalities
    (every modality's token carries its own loss)."""
    return int(cell.traffic["tokens_per_step"]) // (int(cell.conf["block_size"])
                                                     * len(cell.conf["modalities"]))


@contextlib.contextmanager
def planted(fault: str):
    """The program with one of ``FAULTS`` planted in it, while open: a step
    that leaves the parameters unchanged, a step on half of each batch (the
    mean taken over the rest), a step whose returned loss is 1% off."""
    from trade_aid_multimodal_transformer_tpu_torch.sampling.feed import BatchFeed
    from trade_aid_multimodal_transformer_tpu_torch.train.steps import AdamW, Trainer

    if fault == "unchanged":
        owner, name = AdamW, "update_"
        broken = lambda self, params, grads, state: None  # noqa: E731
    elif fault == "half":
        owner, name = BatchFeed, "get_batch"
        whole = BatchFeed.get_batch

        def broken(self, *args):
            xb, yb = whole(self, *args)
            return xb[:, :xb.shape[1] // 2], yb[:, :yb.shape[1] // 2]
    elif fault == "loss":
        owner, name = Trainer, "step"
        right = Trainer.step
        broken = lambda self, *args: right(self, *args) * 1.01  # noqa: E731
    else:
        raise ValueError(f"unknown fault {fault!r}")
    kept = getattr(owner, name)
    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, kept)


class Program:
    """The program's trainer for one seed, on ``device``."""

    def __init__(self, cell, seed: int, device):
        from trade_aid_multimodal_transformer_tpu_torch.models.init import map_tree
        from trade_aid_multimodal_transformer_tpu_torch.sampling.feed import BatchFeed
        from trade_aid_multimodal_transformer_tpu_torch.train.steps import (
            StepRng, Trainer, make_optimizer)

        conf, traffic = cell.conf, cell.traffic
        self.spec = ref_model.ModelSpec.from_config(conf)
        self.cfg = harness.model_config(conf)
        self.B = batch_size(cell)
        self.tokens_per_step = self.B * self.cfg.block_size * self.cfg.num_modalities
        train, val, lengths = inputs.training_data(self.spec, traffic, seed, device)
        mods = conf["modalities"]
        feed = BatchFeed([t.cpu().numpy() for t in train], [t.cpu().numpy() for t in val],
                         lengths, self.cfg.block_size, self.B,
                         any(m["is_percent"] for m in mods),
                         [m["randomness_size"] for m in mods], list(self.cfg.vocab_sizes),
                         device=device)
        del train, val
        self.optimizer = make_optimizer(conf["learning_rate"], conf["adam_moment_dtype"],
                                        conf["adam_nu_dtype"], None, conf["params_dtype"])
        weights = ref_params.make_weights(self.spec, inputs.sub_seed(seed, inputs.WEIGHTS), device)
        self.params = map_tree(lambda t: t.requires_grad_(True), weights)
        self.state = self.optimizer.init(self.params)
        self.trainer = Trainer(self.cfg, feed, self.optimizer, [], 0,
                               fused_update=conf["fused_update"] is True)
        self.rng = StepRng(inputs.sub_seed(seed, inputs.STEPS), device)
        self.losses: List[torch.Tensor] = []

    def steps(self, n: int) -> torch.Tensor:
        self.params, self.state, losses = self.trainer.train_chunk(self.params, self.state,
                                                                   self.rng, n)
        self.losses.append(losses)
        return losses

    def first_steps(self) -> Dict[str, List[float]]:
        """The first three steps, with what the comparison reads of them."""
        from trade_aid_multimodal_transformer_tpu_torch.models.init import tree_leaves

        before = [t.detach().clone() for t in tree_leaves(self.params)]
        losses = [self.steps(1)]
        b1 = self.optimizer.b1
        grads = torch.stack([(m.float() / (1.0 - b1)).norm()
                             for m in tree_leaves(self.state["mu"])])
        losses.append(self.steps(FIRST_STEPS - 1))
        change = torch.stack([(p.detach() - p0).norm()
                              for p, p0 in zip(tree_leaves(self.params), before)])
        return {"losses": torch.cat(losses).tolist(), "grad_norms": grads.tolist(),
                "update_norms": change.tolist()}

    def free(self) -> None:
        self.trainer = self.params = self.state = self.optimizer = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def reference_readings(cell, seed: int, device, fp8: bool = False) -> Dict[str, List[float]]:
    """The plain reference's first three steps (``fp8``: the control)."""
    spec = ref_model.ModelSpec.from_config(cell.conf)
    mm = ref_model.Matmul(fp8)
    mods = cell.conf["modalities"]
    train, _, lengths = inputs.training_data(spec, cell.traffic, seed, device)
    weights = ref_params.make_weights(spec, inputs.sub_seed(seed, inputs.WEIGHTS), device)
    ws = ref_params.leaves(weights)
    for w in ws:
        w.requires_grad_(True)
    before = [w.detach().clone() for w in ws]
    ms = [torch.zeros_like(w) for w in ws]
    vs = [torch.zeros_like(w) for w in ws]
    opt = ref_model.AdamW(float(cell.conf["learning_rate"]))
    draws = ref_feed.batches(inputs.sub_seed(seed, inputs.STEPS), train, lengths,
                             spec.block_size, batch_size(cell), any(m["is_percent"] for m in mods),
                             [m["randomness_size"] for m in mods], spec.vocab_sizes)
    losses, first = [], None
    for _ in range(FIRST_STEPS):
        xb, yb, salts = next(draws)
        loss, grads = ref_model.loss_and_grads(spec, mm, weights, ws, xb, yb, salts)
        losses.append(loss)
        if first is None:
            first = [float(g.norm()) for g in grads]
        opt.step([w.detach() for w in ws], grads, ms, vs)
    change = [float((w.detach() - w0).norm()) for w, w0 in zip(ws, before)]
    return {"losses": losses, "grad_norms": first, "update_norms": change}


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> Dict[str, Any]:
    harness.build_kernels(device)
    prog = Program(cell, seed, device)
    first = prog.first_steps()
    harness.sync(device)
    setup_s = time.perf_counter() - t_start

    n, t0 = 0, time.perf_counter()
    while True:
        prog.steps(1)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    harness.sync(device)
    window_s = time.perf_counter() - t0
    ctx: Dict[str, Any] = {"loop": "train", "spec": prog.spec, "batch": prog.B,
                           "T": prog.cfg.block_size, "chips": cell.chips,
                           "untraced": {"units": n, "seconds": window_s}}
    if traced:
        ctx["slice"] = {"units": TRACED_STEPS}
        ctx["trace"] = trace.traced(lambda: prog.steps(TRACED_STEPS), device)
    losses = torch.cat(prog.losses[2:]).float()
    failed = int((~torch.isfinite(losses)).sum())
    peak = harness.memory_peak(device)
    prog.free()

    ref = reference_readings(cell, seed, device)
    checks = compare.held(compare.training_numbers(first, ref), cell.limits)
    metrics = {"train_tokens_per_s": n * prog.tokens_per_step / window_s, "setup_s": setup_s}
    return {"ctx": ctx, "metrics": metrics, "checks": checks, "attempted": int(losses.numel()),
            "failed": failed, "peak": peak}
